"""attr.eval_proof_ms: the host's milliseconds a job spends enqueueing
the eval proofs (`BatchedMastic.eval_proofs`: K1's binder sponge over
the flat tree, the counter check, the eval-proof XOF), the program's
span `prep.eval_proof`, summed over the job's chunks and both
aggregators, the median over the window's untraced jobs."""

from portbench import spans


def read(ctx: dict):
    return spans.job_ms(ctx, "prep.eval_proof")
