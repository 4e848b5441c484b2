"""attr.weight_check_ms: the host's milliseconds a job spends enqueueing
the FLP weight check (the beta share, the query rand, the helper's
proof share, the joint rand, `BatchedFlp.query`), the program's span
`prep.weight_check`, summed over the job's chunks and both aggregators,
the median over the window's untraced jobs."""

from portbench import spans


def read(ctx: dict):
    return spans.job_ms(ctx, "prep.weight_check")
