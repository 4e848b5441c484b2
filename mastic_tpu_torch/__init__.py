"""mastic_tpu_torch: the PyTorch/CUDA port of mastic_tpu.

A second package beside the JAX reference `mastic_tpu/`, built slice by
slice.  It serves both user modes.  Heavy-hitters collections run on
the resident incremental runner: batched client sharding
(`backend.mastic.BatchedMastic.shard_device`, with the joint-rand parts
of the Field128 circuits), per-level incremental rounds for both
aggregators (`backend.incremental.IncrementalMastic.agg_round`), the
level-0 FLP weight check, masked aggregation, unshard and decode, and
threshold pruning (`drivers.heavy_hitters.HeavyHittersRun`).  Attribute
metrics (`aggregate_by_attribute`) is one weight-checked round from the
root (`BatchedMastic.prep` over `backend.vidpf.BatchedVidpf.eval_full`),
which also serves heavy hitters with `incremental=False`; every round
of either engine gives a `RoundMetrics` record.  Wire reports enter
through `BatchedMastic.marshal_reports`.  All five circuits are served:
MasticCount and MasticSum over Field64, MasticSumVec, MasticHistogram
and MasticMultihotCountVec over Field128.

A collection whose carries outgrow the card streams chunks of reports
through it each round (`drivers.chunked.ChunkedIncrementalRunner` over
a pinned-memory `HostReportStore`, on the pipelined executor of
`drivers.pipeline`; `HeavyHittersRun(chunk_size=...)`), and the
attribute round takes a `chunk_size` too.

Reports shard over ranks of `torch.distributed` (`parallel`: one
process a rank, `parallel.spawn` starts them, `make_mesh` in each):
`HeavyHittersRun`, `compute_heavy_hitters`, the chunked runner and
`aggregate_by_attribute` take `mesh=`, every rank keeps its rows, and
the rounds' shares are summed and masks gathered over the ranks, so
every rank holds the unsharded run's results.  `python -m
mastic_tpu_torch.tools.multichip` checks a meshed collection against
the unsharded one.

The party layer runs the leader and the helper as processes of their
own, each on its own device, exchanging only the draft's wire
encodings (`wire.py`) under deadlines, retries, quarantine, respawn and
fault injection (`drivers/parties.py`: `ProcessCollector`,
`AggregationSession`; `drivers/session.py`, `drivers/faults.py`), over
loopback sockets or the reliable, mutually authenticated TCP transport
(`net/transport.py`) to standalone network parties (`python -m
mastic_tpu_torch.tools.party serve`).  Its bytes are the JAX package's
on every channel.

The scalar layer (`scalar/`, a standard-library copy of the JAX
package's) recomputes, one report at a time, the lanes whose batched
XOF sampling drew a value outside the field
(`drivers.heavy_hitters.splice_rejected`), and a heavy-hitters run
checkpoints between levels in the JAX package's format
(`HeavyHittersRun.to_bytes` / `from_bytes`).

The three TPU kernels under that path are hand-written CUDA C++ for
sm_90a in `csrc/` (built with nvcc at first use by `ops.kernels`):
Keccak-p[1600,12] and the TurboSHAKE sponge (`ops.keccak`, and the eval
proof's binder sponge, `ops.binder`), bitsliced AES-128 (`ops.aes`) and
the fused VIDPF level step (`ops.level`).  Every wrapper runs its kernel
for a CUDA tensor and its plain PyTorch version for a CPU tensor.  Entry
points take `device=` and default to "cuda"; they raise when no card is
present.

Nothing here imports jax or mastic_tpu.
"""

import torch


def resolve_device(device) -> torch.device:
    """The torch device for an entry point's `device=` argument.  A
    CUDA device without a card raises: nothing moves to the CPU on its
    own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev


# Imported last: the drivers import resolve_device from this package.
from .drivers.attribute_metrics import (AttributeMetricsRun,  # noqa: E402
                                        aggregate_by_attribute,
                                        hash_attribute)
from .drivers.chunked import (ChunkedIncrementalRunner,  # noqa: E402
                              HostReportStore)
from .metrics import RoundMetrics  # noqa: E402
from .parallel import ReportMesh, make_mesh, spawn  # noqa: E402

__all__ = ["AttributeMetricsRun", "ChunkedIncrementalRunner",
           "HostReportStore", "ReportMesh", "RoundMetrics",
           "aggregate_by_attribute", "hash_attribute", "make_mesh",
           "resolve_device", "spawn"]
