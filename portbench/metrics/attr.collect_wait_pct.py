"""attr.collect_wait_pct: the share of a job's wall time (its harness
spans `attr.new_run` to `attr.step_finish`) in which the host blocks on
the card, the program's span `collect.wait` (each chunk's one wait for
its downloads) summed over the job's chunks, the median over the
window's untraced jobs.  Near 0 while the host's enqueueing sets the
pace; it rises as the enqueueing shrinks and the card sets the pace,
hence higher is better."""

from portbench import spans


def read(ctx: dict):
    return spans.job_ms(ctx, "collect.wait", share=True)
