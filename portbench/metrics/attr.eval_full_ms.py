"""attr.eval_full_ms: the host's milliseconds a job spends enqueueing
the walk of the grid from the root (`BatchedVidpf.eval_full`: K3 at
every depth and the copies into the flat tree), the program's span
`vidpf.eval_full`, summed over the job's chunks and both aggregators,
the median over the window's untraced jobs."""

from portbench import spans


def read(ctx: dict):
    return spans.job_ms(ctx, "vidpf.eval_full")
