"""Report-chunked incremental heavy hitters (port of
`mastic_tpu/drivers/chunked.py`): the execution model for collections
that outgrow one card.

The incremental engine's carry is O(BITS x width) per report: about
2.0 MiB a report for MasticCount(256) at width 64, so one 80 GB card
holds a few tens of thousands of reports' carries.  The protocol is
independent across reports and aggregation is a sum, so this runner
keeps the report batch (`HostReportStore`) and every chunk's carries
in pinned host memory and streams fixed-size chunks through each
round: the card holds one chunk's state (two while the pipelined
executor, `drivers/pipeline.py`, has the next one in flight), the tail
chunk is padded with dead lanes (the chunk's first row repeated)
that stay out of acceptance, aggregation, `fallback` and the splice,
and each chunk's aggregate shares are summed on the host, so the
results equal the resident runner's bit for bit.

As in the JAX package, each round uploads every chunk's whole carry
(all BITS depths x width) and downloads it again, so at scale the
round is bound by the host link, not by the kernels.

The envelope (`memory_envelope`, `check_envelope`, `check_round_peak`)
prices the port's own allocations: the carries, round keys and report
rows the runner uploads, and the transients of `IncrementalMastic.
agg_rounds` on the card, where kernel K1 reads the binder rows in
place (no gathered copies).  The device budget defaults to a share of
the card's memory (`MASTIC_DEVICE_BUDGET_BYTES` overrides it; <= 0
disables it); the host budget is the machine's memory or its cgroup
limit (`MASTIC_HOST_BUDGET_BYTES`).  With `n_device_shards` > 1 the
`*_per_shard` fields price one rank's share of a chunk padded to the
shard multiple, as the JAX module's do.

Under a report mesh (`mesh=`, `parallel/mesh.py`) each chunk is padded
to the shard multiple, `-(-chunk_size // n) * n` rows, and each rank
uploads its contiguous block of them and keeps pinned host carries for
that block only; the dead lanes repeat the chunk's row 0, as the tail's
do.  Each chunk's shares and masks are exchanged over the mesh in the
collect, and the budgets (so the refusals and the degrade to serial)
are agreed over the ranks.  A checkpoint gathers every rank's rows, so
it equals the unsharded run's array by array.
"""

import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..backend.incremental import (Carry, IncrementalMastic, RoundPlan,
                                   round_inputs)
from ..backend.mastic import BatchedMastic, ReportBatch, all_checks
from ..backend.vidpf import BatchedCorrectionWords
from ..metrics import (RoundMetrics, attribute_rejections,
                       count_round_bytes, count_round_ops)
from ..parallel.mesh import agree_min, gather_rows, tree_map
from . import artifacts
from .heavy_hitters import IncrementalRunner, _ms, splice_rejected
from .pipeline import ChunkedRound, CopyStreams, pipeline_mode

# The default device budget: this share of the card's memory (the rest
# is the CUDA context and the caching allocator's slack).
DEVICE_BUDGET_SHARE = 0.9

# Double buffering: the pipelined executor keeps one more chunk's
# resident state on the card.
PIPELINE_CHUNKS_IN_FLIGHT = 2


def _device_budget(device: torch.device) -> int:
    env = os.environ.get("MASTIC_DEVICE_BUDGET_BYTES")
    if env is not None:
        return int(env)
    if device.type != "cuda":
        return 0
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * DEVICE_BUDGET_SHARE)


def _host_budget() -> int:
    env = os.environ.get("MASTIC_HOST_BUDGET_BYTES")
    if env is not None:
        return int(env)
    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 0
    # A cgroup limit below physical memory is where the OOM kill lands
    # (v2, then v1; "max" or no file means no limit).
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                text = f.read().strip()
        except OSError:
            continue
        if text.isdigit():
            total = min(total, int(text))
    return int(total * 0.9)


def _limb_bytes(bm: BatchedMastic) -> int:
    return bm.vidpf.VALUE_LEN * bm.spec.num_limbs * 4


def per_report_bytes(bm: BatchedMastic, width: int) -> dict:
    """Per-report bytes of the chunked runner: both carries, the round
    keys and the report store's row (the tensors it allocates; the CPU
    tests hold them against the real allocations), and the worst-case
    transients of one round on the card (every prefix of a full
    width)."""
    bits = bm.m.bits
    valid = bm.m.valid
    limb_bytes = _limb_bytes(bm)
    # Carry (backend/incremental.py), both aggregators: w and proof
    # over all BITS depths, seed and ctrl of the newest depth.
    carry = 2 * (bits * width * (limb_bytes + 32) + width * (16 + 1))
    roundkeys = 2 * 11 * 16
    store = (16                                  # nonce
             + bits * (16 + 2 + limb_bytes + 32)  # correction words
             + 2 * 16                            # VIDPF keys
             + valid.PROOF_LEN * bm.spec.num_limbs * 4
             + 32)                               # helper seed
    if valid.JOINT_RAND_LEN > 0:
        store += 32 + 2 * 32                     # leader seed, peer parts
    return {"carry": carry, "roundkeys": roundkeys, "store": store,
            "round_staging": _round_staging_bytes(bm, width, width)}


def _round_staging_bytes(bm: BatchedMastic, width: int, out_cap: int) -> int:
    """Per-report bytes of one round's transients on the card, beside
    the uploaded chunk (`IncrementalMastic.agg_rounds` and the runner's
    combine), at padded `width` with `out_cap` output slots: per
    aggregator the gathered parents (width/2 seeds and ctrl bits) and
    K3's outputs for `width` children (seed, ctrl, ok, payload, node
    proof), both alive until the binder launch; the correction words'
    level slice; K1's binder outputs (2 checks x 2 aggregators x 32
    bytes); and per aggregator eight out-share sized tensors: the
    gather, the negation and its zero operand, the truncated share, and
    the masked aggregation's zero operand, masked copy and first
    halving of its field sum (the limbs and the stacked sum).  K1 reads
    the binder rows where they lie, so nothing here grows with depth.
    chip_smoke.py's chunked Count phase holds a run's device peak
    against this model."""
    limb_bytes = _limb_bytes(bm)
    out_row = max(limb_bytes,
                  (1 + bm.m.valid.OUTPUT_LEN) * bm.spec.num_limbs * 4)
    per_agg = (width // 2 * (16 + 1)
               + width * (16 + 1 + 1 + limb_bytes + 32)
               + 8 * out_cap * out_row)
    return 2 * per_agg + (16 + 2 + limb_bytes + 32) + 4 * 32


def memory_envelope(bm: BatchedMastic, chunk_size: int, width: int,
                    num_reports: int,
                    device: torch.device = torch.device("cpu"),
                    n_device_shards: int = 1,
                    budgets: Optional[tuple] = None) -> dict:
    """The (chunk_size, width) envelope: what one chunk costs the card
    and what the whole run costs the host, and the largest chunk that
    fits the device budget at this width.  Carries and round keys are
    allocated per padded chunk row; the store holds exactly
    `num_reports` rows.  With `n_device_shards` > 1 the chunk pads to
    the shard multiple and each rank holds `rows_per_shard` of its rows:
    the `*_per_shard` fields price one rank's card.  `budgets` (device,
    host) replaces the ones read here (a meshed runner agrees them over
    its ranks)."""
    per = per_report_bytes(bm, width)
    per_chunk = per["carry"] + per["roundkeys"] + per["store"]
    (device_budget, host_budget) = (budgets if budgets is not None else
                                    (_device_budget(device), _host_budget()))
    padded_rows = -(-num_reports // chunk_size) * chunk_size
    host_total = (padded_rows * (per["carry"] + per["roundkeys"])
                  + num_reports * per["store"])
    staging = chunk_size * per["round_staging"]
    shards = max(1, n_device_shards)
    dev_rows = -(-chunk_size // shards) * shards
    shard_rows = dev_rows // shards
    return {
        "bits": bm.m.bits, "width": width,
        "chunk_size": chunk_size, "num_reports": num_reports,
        "per_report_bytes": per,
        "device_bytes_per_chunk": chunk_size * per_chunk,
        "device_peak_bytes_per_chunk": chunk_size * per_chunk + staging,
        # Pipelined, two chunks' resident state are on the card; only
        # the chunk in its compute holds the round's transients.
        "pipeline_chunks_in_flight": PIPELINE_CHUNKS_IN_FLIGHT,
        "device_bytes_per_chunk_pipelined":
            PIPELINE_CHUNKS_IN_FLIGHT * chunk_size * per_chunk,
        "device_peak_bytes_per_chunk_pipelined":
            PIPELINE_CHUNKS_IN_FLIGHT * chunk_size * per_chunk + staging,
        "max_pipelined_chunk_size_at_width": (
            device_budget // (PIPELINE_CHUNKS_IN_FLIGHT * per_chunk)
            if device_budget > 0 else 0),
        # One rank's card: its rows of the chunk padded to the shard
        # multiple (exact, since the padded rows divide evenly).
        "report_shards": shards,
        "device_rows_per_chunk": dev_rows,
        "rows_per_shard": shard_rows,
        "device_bytes_per_chunk_per_shard": shard_rows * per_chunk,
        "device_peak_bytes_per_chunk_per_shard":
            shard_rows * (per_chunk + per["round_staging"]),
        "device_bytes_per_chunk_pipelined_per_shard":
            PIPELINE_CHUNKS_IN_FLIGHT * shard_rows * per_chunk,
        "device_peak_bytes_per_chunk_pipelined_per_shard":
            PIPELINE_CHUNKS_IN_FLIGHT * shard_rows * per_chunk
            + shard_rows * per["round_staging"],
        "max_chunk_size_at_width_sharded": (
            shards * (device_budget // per_chunk)
            if device_budget > 0 else 0),
        "max_pipelined_chunk_size_at_width_sharded": (
            shards * (device_budget // (PIPELINE_CHUNKS_IN_FLIGHT
                                        * per_chunk))
            if device_budget > 0 else 0),
        "host_bytes_total": host_total,
        "device_budget_bytes": device_budget,
        "host_budget_bytes": host_budget,
        "max_chunk_size_at_width": (device_budget // per_chunk
                                    if device_budget > 0 else 0),
        "min_hosts": (-(-host_total // host_budget)
                      if host_budget > 0 else 1),
    }


def check_envelope(bm: BatchedMastic, chunk_size: int, width: int,
                   num_reports: int,
                   device: torch.device = torch.device("cpu"),
                   n_device_shards: int = 1,
                   budgets: Optional[tuple] = None) -> dict:
    """Refuse shapes outside the envelope with the remedy: the device
    check bounds one chunk's resident state (one rank's share of it over
    `n_device_shards` ranks), the host check the carries and the store
    of the whole run."""
    env = memory_envelope(bm, chunk_size, width, num_reports, device,
                          n_device_shards, budgets)
    per_chip = env["device_bytes_per_chunk_per_shard"]
    max_chunk = env["max_chunk_size_at_width_sharded"]
    budget = env["device_budget_bytes"]
    chip = (f" across {n_device_shards} chips" if n_device_shards > 1
            else "")
    if budget > 0 and per_chip > budget:
        if max_chunk == 0:
            raise ValueError(
                f"width {width} at {bm.m.bits} bits needs "
                f"{per_chip / 2**30:.1f} GiB per chip{chip} even for a "
                f"single-report chunk (budget {budget / 2**30:.1f} GiB) "
                f"— the width itself is infeasible at this budget; raise "
                f"MASTIC_DEVICE_BUDGET_BYTES or shard the chunk over "
                f"more devices")
        raise ValueError(
            f"chunk of {chunk_size} reports needs {per_chip / 2**30:.1f} "
            f"GiB per chip{chip} at width {width} (budget "
            f"{budget / 2**30:.1f} GiB); the largest feasible chunk_size "
            f"at this width is {max_chunk} — shrink the chunk, or raise "
            f"MASTIC_DEVICE_BUDGET_BYTES if the chip has more memory")
    if env["host_budget_bytes"] > 0 \
            and env["host_bytes_total"] > env["host_budget_bytes"]:
        raise ValueError(
            f"{num_reports} reports need "
            f"{env['host_bytes_total'] / 2**30:.1f} GiB of host memory "
            f"at width {width} (budget "
            f"{env['host_budget_bytes'] / 2**30:.1f} GiB); split the "
            f"report store across >= {env['min_hosts']} hosts, each "
            f"running its own chunked runner over its shard (carries, "
            f"round keys and store are all per-report; only the "
            f"per-round aggregate shares cross hosts), or raise "
            f"MASTIC_HOST_BUDGET_BYTES")
    return env


def round_peak_bytes(bm: BatchedMastic, width: int, out_cap: int,
                     chunk_rows: int, resident_bytes: int,
                     chunks_in_flight: int = 1,
                     n_device_shards: int = 1) -> int:
    """One card's peak in one round: `chunks_in_flight` chunks'
    resident state plus one chunk's transients (only the chunk in its
    compute holds them), over `n_device_shards` ranks (`chunk_rows` and
    `resident_bytes` are the whole padded chunk's).  The one cost model
    behind check_round_peak and the pipelined executor's degrade to
    serial."""
    return -(-(chunks_in_flight * resident_bytes
               + _round_staging_bytes(bm, width, out_cap) * chunk_rows)
             // n_device_shards)


def check_round_peak(bm: BatchedMastic, width: int, out_cap: int,
                     chunk_rows: int, resident_bytes: int, level: int,
                     device: torch.device = torch.device("cpu"),
                     n_device_shards: int = 1,
                     budget: Optional[int] = None) -> None:
    """The per-round device-memory gate at the round's real width and
    output slots, per card over `n_device_shards` ranks (`budget`
    replaces the one read here): a run that would not fit stops at this
    level with the remedy, everything before it checkpointable."""
    if budget is None:
        budget = _device_budget(device)
    if budget <= 0:
        return
    per_row = _round_staging_bytes(bm, width, out_cap)
    peak = round_peak_bytes(bm, width, out_cap, chunk_rows, resident_bytes,
                            n_device_shards=n_device_shards)
    if peak > budget:
        per_row_resident = resident_bytes // max(1, chunk_rows)
        max_rows = max(0, budget * n_device_shards
                       // (per_row + per_row_resident))
        raise ValueError(
            f"level {level}: the round's transients at width {width} "
            f"({out_cap} output slots) need "
            f"{per_row * chunk_rows / 2**30:.1f} GiB on top of "
            f"{resident_bytes / 2**30:.1f} GiB resident "
            f"({peak / 2**30:.1f} GiB peak per chip vs budget "
            f"{budget / 2**30:.1f} GiB) — checkpoint and resume with a "
            f"total chunk of <= {max_rows} reports, shard over more "
            f"devices, or raise MASTIC_DEVICE_BUDGET_BYTES")


# -- host memory -------------------------------------------------------

def _host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """`t` (on any device) in host memory, pinned when `pin`; a CPU
    tensor that need not be pinned is returned as it is."""
    if not pin:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _release_pinned() -> None:
    """Give the pinned blocks that PyTorch's host allocator caches after
    a free back to the system: a width growth frees every chunk's old
    carry, and a cache of them would hold as much pinned memory as the
    new carries."""
    accel = getattr(torch, "accelerator", None)
    if accel is not None and hasattr(accel, "empty_host_cache"):
        accel.empty_host_cache()
    elif hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def _tile(x: torch.Tensor, lo: int, live: int, rows: tuple,
          move=lambda t: t) -> torch.Tensor:
    """Rows [a, b) = `rows` of the chunk of `x` that starts at row `lo`
    and holds `live` reports, each piece passed through `move`: a row
    past `live` is a dead lane, the chunk's first row repeated (the JAX
    package's rule, so that dead lanes compute the same values in both
    packages and on any mesh)."""
    (a, b) = rows
    n = max(0, min(b, live) - a)
    if n == b - a:
        return move(x[lo + a:lo + b])
    dead = move(x[lo:lo + 1]).expand((b - a - n,) + tuple(x.shape[1:]))
    if n == 0:
        return dead.contiguous()
    return torch.cat([move(x[lo + a:lo + a + n]), dead])


def map_batch(batch: ReportBatch, fn) -> ReportBatch:
    """`fn` applied to every tensor of a report batch (None stays
    None)."""
    def f(t):
        return None if t is None else fn(t)

    return ReportBatch(
        nonces=f(batch.nonces),
        cws=BatchedCorrectionWords(*map(f, batch.cws)),
        keys=f(batch.keys), leader_proofs=f(batch.leader_proofs),
        helper_seeds=f(batch.helper_seeds),
        leader_seeds=f(batch.leader_seeds),
        peer_parts=tuple(map(f, batch.peer_parts)))


def cat_batches(batches: list) -> ReportBatch:
    """Report batches concatenated along the report axis (None stays
    None)."""
    first = batches[0]

    def cat(get):
        return None if get(first) is None else torch.cat(
            [get(b) for b in batches])

    return ReportBatch(
        nonces=cat(lambda b: b.nonces),
        cws=BatchedCorrectionWords(*(cat(lambda b, i=i: b.cws[i])
                                     for i in range(len(first.cws)))),
        keys=cat(lambda b: b.keys),
        leader_proofs=cat(lambda b: b.leader_proofs),
        helper_seeds=cat(lambda b: b.helper_seeds),
        leader_seeds=cat(lambda b: b.leader_seeds),
        peer_parts=tuple(cat(lambda b, a=a: b.peer_parts[a])
                         for a in range(len(first.peer_parts))))


def _widen(x: torch.Tensor, dim: int, width: int, pin: bool) -> torch.Tensor:
    """`x` with its node axis `dim` zero-padded to `width`, in a new
    host tensor."""
    shape = list(x.shape)
    old = shape[dim]
    shape[dim] = width
    out = torch.empty(shape, dtype=x.dtype, pin_memory=pin)
    out.narrow(dim, 0, old).copy_(x)
    out.narrow(dim, old, width - old).zero_()
    return out


class HostReportStore:
    """A report batch in host memory, cut into fixed-size chunks for the
    card: the aggregator's upload database.  `arrays` holds the JAX
    package's keys as tensors in the port's carrier dtypes (limbs as
    int32), pinned when the batch came from the card; `leader_seeds` is
    None and `peer_parts` (None, None) for circuits without joint
    randomness."""

    def __init__(self, arrays: dict, num_reports: int, chunk_size: int):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.arrays = arrays
        self.num_reports = num_reports
        self.chunk_size = chunk_size
        self.num_chunks = -(-num_reports // chunk_size)
        self.use_jr = arrays.get("leader_seeds") is not None

    @classmethod
    def from_batch(cls, batch: ReportBatch,
                   chunk_size: int) -> "HostReportStore":
        """Adopt a report batch; a batch on the card lands in pinned
        host memory."""
        pin = batch.nonces.is_cuda
        host = map_batch(batch, lambda t: _host(t, pin))
        arrays = {
            "nonces": host.nonces,
            "cws_seed": host.cws.seed,
            "cws_ctrl": host.cws.ctrl,
            "cws_w": host.cws.w,
            "cws_proof": host.cws.proof,
            "keys": host.keys,
            "leader_proofs": host.leader_proofs,
            "helper_seeds": host.helper_seeds,
            "leader_seeds": host.leader_seeds,
            "peer_parts": host.peer_parts,
        }
        return cls(arrays, int(batch.nonces.shape[0]), chunk_size)

    def chunk_bounds(self, i: int) -> tuple:
        lo = i * self.chunk_size
        return (lo, min(lo + self.chunk_size, self.num_reports))

    def host_slice(self, x: torch.Tensor, i: int,
                   rows: Optional[tuple] = None) -> torch.Tensor:
        """Rows `rows` (by default all chunk_size) of chunk i of a
        per-report host tensor, padded with dead lanes (the chunk's
        first row repeated)."""
        (lo, hi) = self.chunk_bounds(i)
        return _tile(x, lo, hi - lo, rows or (0, self.chunk_size))

    def device_chunk(self, i: int, device,
                     rows: Optional[tuple] = None) -> tuple:
        """Rows `rows` = (a, b) (by default all chunk_size) of chunk i
        on `device`, padded with dead lanes there: (ReportBatch, live
        mask (b - a,) bool).  The copies are `non_blocking` (from pinned
        memory they do not wait for the host), on the current stream."""
        (lo, hi) = self.chunk_bounds(i)
        rows = rows or (0, self.chunk_size)
        a = self.arrays
        batch = map_batch(
            ReportBatch(
                nonces=a["nonces"],
                cws=BatchedCorrectionWords(
                    seed=a["cws_seed"], ctrl=a["cws_ctrl"], w=a["cws_w"],
                    proof=a["cws_proof"]),
                keys=a["keys"], leader_proofs=a["leader_proofs"],
                helper_seeds=a["helper_seeds"],
                leader_seeds=a["leader_seeds"], peer_parts=a["peer_parts"]),
            lambda x: _tile(x, lo, hi - lo, rows,
                            lambda t: t.to(device, non_blocking=True)))
        live = np.arange(*rows) < hi - lo
        return (batch, live)

    def _tensors(self) -> list:
        a = self.arrays
        return [t for t in [a[k] for k in a if k != "peer_parts"]
                + list(a["peer_parts"]) if t is not None]

    def row_bytes(self) -> int:
        """Bytes of one report's row over every array."""
        return sum(t[:1].nbytes for t in self._tensors())

    def host_bytes(self) -> int:
        return sum(t.nbytes for t in self._tensors())


class _ChunkState(NamedTuple):
    """One chunk's host state: both aggregators' carries and the
    per-report AES round keys (kept so that later rounds skip the key
    schedule)."""
    carries: list   # [Carry of host tensors] x 2
    ext_rk: torch.Tensor
    conv_rk: torch.Tensor


def _carry_bytes(carry: Carry) -> int:
    return sum(x.nbytes for x in carry)


class ChunkedIncrementalRunner:
    """Drives backend/incremental.py chunk by chunk, with the resident
    runner's contract (`width`, `fallback`, `layouts`, `valid`; `round`
    runs a whole round and returns the decoded aggregates), so that
    `HeavyHittersRun` takes it when given a chunk size or a store.

    `fallback` (R,) bool, on the host: lanes whose XOF rejection
    sampling fired in some round (their carry is garbage from then on;
    they are spliced through the scalar layer every round, from
    `reports`).  `valid` (R,) bool: lanes left out of every aggregate
    without a recompute (e.g. the shard's `ok`).  Both are global under
    a mesh, on every rank: each rank folds every chunk's gathered
    masks.  `tile` is this rank's rows [a, b) of every chunk padded to
    the shard multiple (all chunk_size rows without a mesh)."""

    def __init__(self, bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                 store: HostReportStore, device="cuda",
                 valid: Optional[torch.Tensor] = None,
                 reports: Optional[Sequence] = None, width: int = 8,
                 mesh=None):
        device = resolve_device(device)
        self.bm = bm
        self.verify_key = verify_key
        self.ctx = ctx
        self.store = store
        self.device = device
        self.pin = device.type == "cuda"
        self.reports = reports
        self.num_reports = store.num_reports
        self.valid = (np.ones(self.num_reports, bool) if valid is None
                      else valid.cpu().numpy().astype(bool))
        self.fallback = np.zeros(self.num_reports, bool)
        self.width = max(4, width)
        self.max_width = self.width
        self.mesh = mesh
        per = self._device_rows() // self._report_shards()
        rank = mesh.report_rank if mesh is not None else 0
        self.tile = (rank * per, (rank + 1) * per)
        self._check_envelope(self.width)
        self.engine = IncrementalMastic(bm, self.width)
        self.streams = CopyStreams(device)
        self.chunks = [self._init_chunk(i) for i in range(store.num_chunks)]
        self.layouts: list = []

    # -- the mesh -----------------------------------------------------

    def _report_shards(self) -> int:
        """The ranks every chunk spreads over (1 without a mesh)."""
        return self.mesh.shape["reports"] if self.mesh is not None else 1

    def _device_rows(self) -> int:
        """Rows of one chunk's tile over all ranks: chunk_size padded to
        the shard multiple; the dead lanes stay out of acceptance,
        aggregation and `fallback`, as the tail chunk's do."""
        n = self._report_shards()
        return -(-self.store.chunk_size // n) * n

    def _budgets(self) -> tuple:
        """(device, host) budgets agreed over the ranks: the smallest one
        set (> 0) wins, so that every rank refuses or degrades alike."""
        unset = 1 << 62
        got = agree_min(self.mesh, [b if b > 0 else unset for b in
                                    (_device_budget(self.device),
                                     _host_budget())])
        return tuple(0 if b == unset else b for b in got)

    def _check_envelope(self, width: int) -> dict:
        return check_envelope(self.bm, self.store.chunk_size, width,
                              self.num_reports, self.device,
                              self._report_shards(), self._budgets())

    def _retile(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tile of a chunk's full host state (chunk_size
        rows, the dead lanes computed from the chunk's first row)."""
        return _host(_tile(x, 0, self.store.chunk_size, self.tile),
                     self.pin)

    def _init_chunk(self, i: int) -> _ChunkState:
        """Chunk i's first carries and round keys, for this rank's tile:
        only the nonces go to the card, for the key schedules, and the
        keys come back."""
        store = self.store
        nonces = store.host_slice(store.arrays["nonces"], i, self.tile)
        keys = store.host_slice(store.arrays["keys"], i, self.tile)
        (ext_rk, conv_rk) = self.bm.vidpf.roundkeys(
            self.ctx, nonces.to(self.device))
        rows = self.tile[1] - self.tile[0]
        carries = [Carry(*(_host(x, self.pin) for x in
                           self.engine.init_carry(rows, keys[:, a], a)))
                   for a in range(2)]
        return _ChunkState(carries=carries, ext_rk=_host(ext_rk, self.pin),
                           conv_rk=_host(conv_rk, self.pin))

    # The resident runner's: the plan at the current width, grown (by
    # this runner's _grow) until the frontier fits.
    _set_width = IncrementalRunner._set_width
    _plan = IncrementalRunner._plan

    def _grow(self, width: int) -> None:
        """Pad every chunk's carries to `width`, one carry at a time, so
        that only one carry's old and new copies coexist."""
        self._check_envelope(width)
        for cs in self.chunks:
            for a in range(2):
                c = cs.carries[a]
                cs.carries[a] = Carry(
                    w=_widen(c.w, 2, width, self.pin),
                    proof=_widen(c.proof, 2, width, self.pin),
                    seed=_widen(c.seed, 1, width, self.pin),
                    ctrl=_widen(c.ctrl, 1, width, self.pin))
                del c
                if self.pin:
                    _release_pinned()
        self._set_width(width)

    def _resident_dev_bytes(self) -> int:
        """One chunk's resident bytes over all ranks (this rank's tile
        scaled to the padded chunk)."""
        return (self.memory_accounting()["device_bytes_per_chunk"]
                * self._report_shards())

    def _pipeline_mode(self, plan: RoundPlan, budget: int) -> tuple:
        """(mode, fallback reason): the round runs pipelined, or serial
        with the reason named in the metrics (agreed over the ranks by
        `ChunkedRound`)."""
        (mode, reason) = pipeline_mode(self.store.num_chunks)
        if mode == "pipelined" and budget > 0:
            peak = round_peak_bytes(
                self.bm, plan.width, len(plan.out_idx), self._device_rows(),
                self._resident_dev_bytes(),
                chunks_in_flight=PIPELINE_CHUNKS_IN_FLIGHT,
                n_device_shards=self._report_shards())
            if peak > budget:
                return ("serial", "device-budget")
        return (mode, reason)

    def round(self, agg_param, metrics_out: Optional[list] = None) -> list:
        """One round over every chunk on the executor of
        `drivers/pipeline.py`.  Staging chunk i uploads this rank's tile
        of it, both carries, its round keys and its pre-round mask, then
        dispatches both aggregators' tree step, the level-0 weight
        check, the accept combine (the live, fallback and valid lanes
        folded in) and the masked aggregates, and downloads the new
        carries into the tile's host buffers.  Collecting it waits once,
        exchanges its shares and masks over the mesh and folds them on
        the host.  After every chunk, the scalar splice of the fallback
        lanes, as in the resident runner.  Returns one decoded aggregate
        per prefix."""
        mark = artifacts.stats_mark()
        (level, prefixes, do_weight_check) = agg_param
        bm = self.bm
        store = self.store
        chunk_size = store.chunk_size
        num = self.num_reports
        (a, b) = self.tile
        shards = self._report_shards()
        plan = self._plan(prefixes, level)
        (budget, _) = self._budgets()
        check_round_peak(bm, plan.width, len(plan.out_idx),
                         self._device_rows(), self._resident_dev_bytes(),
                         level, self.device, shards, budget)
        rnd = round_inputs(plan, self.device)
        rows = len(prefixes) * (1 + bm.m.valid.OUTPUT_LEN)
        cr = ChunkedRound(self.streams, [store.chunk_bounds(i) for i in
                                         range(store.num_chunks)],
                          *self._pipeline_mode(plan, budget), rows, bm.spec,
                          self.mesh)
        accept_all = np.zeros(num, bool)
        # Per-check masks over every chunk, for the rejection attribution.
        eval_ok_all = np.zeros(num, bool)
        wc_ok_all = np.zeros(num, bool) if do_weight_check else None
        jr_ok_all: list = [None]

        def stage(i: int) -> tuple:
            cs = self.chunks[i]
            (lo, hi) = store.chunk_bounds(i)
            xfer = cr.transfer(i)
            t0 = time.perf_counter()
            # The lanes of this rank's tile that may reach the
            # aggregates, known before the round: live, valid and not
            # yet fallen back.  This round's ok and checks fold in on
            # the card.
            live = max(0, min(b, hi - lo) - a)
            keep_pre = np.zeros(b - a, bool)
            keep_pre[:live] = (self.valid[lo + a:lo + a + live]
                               & ~self.fallback[lo + a:lo + a + live])
            with xfer.upload():
                (batch, _live) = store.device_chunk(i, self.device,
                                                    self.tile)
                carries = tuple(Carry(*map(xfer.to_device, c))
                                for c in cs.carries)
                (ext_rk, conv_rk) = (xfer.to_device(cs.ext_rk),
                                     xfer.to_device(cs.conv_rk))
                keep_dev = xfer.to_device(
                    _host(torch.from_numpy(keep_pre), self.pin))
            t_up = time.perf_counter()
            ((c0, proof0, out0, ok0), (c1, proof1, out1, ok1)) = \
                self.engine.agg_rounds((0, 1), self.verify_key, self.ctx,
                                       carries, rnd, ext_rk, conv_rk,
                                       batch.cws)
            checks = {"eval_proof": torch.all(proof0 == proof1, dim=-1)}
            ok = ok0 & ok1
            if do_weight_check:
                (wc_checks, wc_ok) = bm.weight_check_device(
                    self.verify_key, self.ctx, level, batch,
                    c0.w[:, 0, :2], c1.w[:, 0, :2])
                checks.update(wc_checks)
                ok = ok & wc_ok
            keep = all_checks(checks) & ok & keep_dev
            shares = torch.stack([bm.aggregate(out0, keep),
                                  bm.aggregate(out1, keep)])[:, :rows]
            names = sorted(checks)
            masks = torch.stack([keep, ok] + [checks[k] for k in names],
                                dim=1)
            host = xfer.download(
                [(h, d) for (hc, dc) in zip(cs.carries, (c0, c1))
                 for (h, d) in zip(hc, dc)]
                + [(None, shares), (None, masks)])
            # Every device tensor of the chunk stays referenced until
            # collect() has waited for the downloads.
            handle = {"shares": host[8], "masks": host[9], "names": names,
                      "device": (batch, carries, c0, c1, out0, out1,
                                 keep_dev, keep, ok, shares, masks,
                                 checks)}
            return (handle, {"upload_ms": _ms(t0, t_up),
                             "dispatch_ms": _ms(t_up, time.perf_counter())})

        def collect(i: int, handle: dict) -> dict:
            (lo, hi) = store.chunk_bounds(i)

            def fold(masks: np.ndarray) -> None:
                (keep, ok, *per_check) = masks.T
                checks = dict(zip(handle["names"], per_check))
                self.fallback[lo:hi] |= ~ok & self.valid[lo:hi]
                eval_ok_all[lo:hi] = checks["eval_proof"]
                if do_weight_check:
                    wc_ok_all[lo:hi] = checks["weight_check"]
                if "joint_rand" in checks:
                    if jr_ok_all[0] is None:
                        jr_ok_all[0] = np.zeros(num, bool)
                    jr_ok_all[0][lo:hi] = checks["joint_rand"]
                accept_all[lo:hi] = keep

            return cr.collect(i, handle, fold)

        timeline = cr.run(stage, collect)
        evals_per_report = 2 * plan.parent_count * 2  # both aggregators
        for rec in timeline:
            span_s = max(rec["wall_ms"], 1e-3) / 1e3
            rec["node_evals_per_sec"] = round(
                rec["reports"] * evals_per_report / span_s, 1)
            rec["node_evals_per_sec_padded"] = round(
                self._device_rows() * evals_per_report / span_s, 1)
            if self.mesh is not None:
                rec["node_evals_per_sec_per_shard"] = round(
                    rec["node_evals_per_sec"] / shards, 1)
                rec["node_evals_per_sec_padded_per_shard"] = round(
                    rec["node_evals_per_sec_padded"] / shards, 1)
        self.layouts.append(plan.layout_new)

        fallback = self.fallback
        metrics = RoundMetrics(level=level, frontier_width=len(prefixes),
                               padded_width=self.width, reports_total=num)
        attribute_rejections(metrics, eval_ok_all, wc_ok_all, jr_ok_all[0],
                             device_ok=~fallback & self.valid)
        count_round_ops(metrics, bm.m, num, 2 * plan.parent_count,
                        include_key_setup=(level == 0))
        count_round_bytes(metrics, bm.m, agg_param, num)
        t_splice = time.perf_counter()
        rejected_by = splice_rejected(bm.m, self.verify_key, self.ctx,
                                      agg_param, self.reports, ~fallback,
                                      accept_all, cr.agg_shares)
        metrics.accepted = int(accept_all.sum())
        metrics.xof_fallbacks = int(fallback.sum())
        metrics.rejected_fallback = int((fallback & ~accept_all).sum())
        metrics.extra["excluded_invalid"] = int((~self.valid).sum())
        metrics.extra["rejected_fallback_by"] = rejected_by
        metrics.extra["splice_ms"] = _ms(t_splice, time.perf_counter())
        metrics.extra["chunks"] = timeline
        metrics.extra["memory"] = self.memory_accounting()
        metrics.extra["pipeline"] = cr.pipeline_block()
        metrics.extra["artifacts"] = artifacts.round_block(mark)
        if self.mesh is not None:
            metrics.extra["mesh"] = cr.mesh_block(self._device_rows())
        if metrics_out is not None:
            metrics_out.append(metrics)
        return bm.m.unshard(cr.agg_shares)

    def memory_accounting(self) -> dict:
        """This rank's card (one chunk's tile: both carries, the round
        keys and the report rows) against its host (every chunk's tile
        and the whole store)."""
        cs = self.chunks[0]
        carry = _carry_bytes(cs.carries[0]) + _carry_bytes(cs.carries[1])
        rk = cs.ext_rk.nbytes + cs.conv_rk.nbytes
        store = self.store
        host = (sum(_carry_bytes(c.carries[0]) + _carry_bytes(c.carries[1])
                    + c.ext_rk.nbytes + c.conv_rk.nbytes
                    for c in self.chunks)
                + store.host_bytes())
        return {
            "chunk_size": store.chunk_size,
            "num_chunks": store.num_chunks,
            "device_bytes_per_chunk":
                carry + rk + store.row_bytes() * (self.tile[1]
                                                  - self.tile[0]),
            "device_carry_bytes": carry,
            "host_bytes_total": host,
        }

    # -- checkpoint hooks (HeavyHittersRun.to_bytes / from_bytes) ----

    def state_arrays(self) -> dict:
        """Every chunk's carries over all ranks (gathered under a mesh,
        the padding dropped), under the JAX package's keys."""
        from ..convert import carry_to_arrays

        size = self.store.chunk_size
        data: dict = {"chunk_size": np.int64(size)}
        for (i, cs) in enumerate(self.chunks):
            for a in range(2):
                carry = tree_map(lambda t: gather_rows(self.mesh, t, size),
                                 cs.carries[a])
                data.update(carry_to_arrays(carry, f"k{i}_c{a}_"))
        return data

    def load_state(self, arrays, num_chunks: int) -> None:
        """Adopt every chunk's carries from checkpoint arrays (all
        chunk_size rows each), keeping this rank's tile."""
        from ..convert import carry_from_arrays

        for i in range(num_chunks):
            for a in range(2):
                carry = carry_from_arrays(arrays, f"k{i}_c{a}_", "cpu")
                self.chunks[i].carries[a] = Carry(*map(self._retile, carry))
                if self.pin:
                    _release_pinned()
