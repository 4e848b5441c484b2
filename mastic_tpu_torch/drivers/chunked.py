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
limit (`MASTIC_HOST_BUDGET_BYTES`).  The JAX module's mesh terms
(`n_device_shards`) are left out with the mesh itself, which the port
does not have yet.
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
                    device: torch.device = torch.device("cpu")) -> dict:
    """The (chunk_size, width) envelope: what one chunk costs the card
    and what the whole run costs the host, and the largest chunk that
    fits the device budget at this width.  Carries and round keys are
    allocated per padded chunk row; the store holds exactly
    `num_reports` rows."""
    per = per_report_bytes(bm, width)
    per_chunk = per["carry"] + per["roundkeys"] + per["store"]
    device_budget = _device_budget(device)
    host_budget = _host_budget()
    padded_rows = -(-num_reports // chunk_size) * chunk_size
    host_total = (padded_rows * (per["carry"] + per["roundkeys"])
                  + num_reports * per["store"])
    staging = chunk_size * per["round_staging"]
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
                   device: torch.device = torch.device("cpu")) -> dict:
    """Refuse shapes outside the envelope with the remedy: the device
    check bounds one chunk's resident state, the host check the carries
    and the store of the whole run."""
    env = memory_envelope(bm, chunk_size, width, num_reports, device)
    per_chip = env["device_bytes_per_chunk"]
    max_chunk = env["max_chunk_size_at_width"]
    budget = env["device_budget_bytes"]
    if budget > 0 and per_chip > budget:
        if max_chunk == 0:
            raise ValueError(
                f"width {width} at {bm.m.bits} bits needs "
                f"{per_chip / 2**30:.1f} GiB per chip even for a "
                f"single-report chunk (budget {budget / 2**30:.1f} GiB) "
                f"— the width itself is infeasible at this budget; raise "
                f"MASTIC_DEVICE_BUDGET_BYTES or shard the chunk over "
                f"more devices")
        raise ValueError(
            f"chunk of {chunk_size} reports needs {per_chip / 2**30:.1f} "
            f"GiB per chip at width {width} (budget "
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
                     chunks_in_flight: int = 1) -> int:
    """The card's peak in one round: `chunks_in_flight` chunks'
    resident state plus one chunk's transients (only the chunk in its
    compute holds them).  The one cost model behind check_round_peak
    and the pipelined executor's degrade to serial."""
    return (chunks_in_flight * resident_bytes
            + _round_staging_bytes(bm, width, out_cap) * chunk_rows)


def check_round_peak(bm: BatchedMastic, width: int, out_cap: int,
                     chunk_rows: int, resident_bytes: int, level: int,
                     device: torch.device = torch.device("cpu")) -> None:
    """The per-round device-memory gate at the round's real width and
    output slots: a run that would not fit stops at this level with the
    remedy, everything before it checkpointable."""
    budget = _device_budget(device)
    if budget <= 0:
        return
    per_row = _round_staging_bytes(bm, width, out_cap)
    peak = round_peak_bytes(bm, width, out_cap, chunk_rows, resident_bytes)
    if peak > budget:
        per_row_resident = resident_bytes // max(1, chunk_rows)
        max_rows = max(0, budget // (per_row + per_row_resident))
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


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad the leading axis to `rows` with dead lanes: the first row
    repeated (the JAX package's rule, so that dead lanes compute the
    same values in both packages)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])


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

    def host_slice(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Chunk i of a per-report host tensor, padded to chunk_size with
        dead lanes (the chunk's first row repeated)."""
        (lo, hi) = self.chunk_bounds(i)
        return _pad_rows(x[lo:hi], self.chunk_size)

    def device_chunk(self, i: int, device) -> tuple:
        """Chunk i on `device`, padded to chunk_size with dead lanes
        there: (ReportBatch, live mask (chunk_size,) bool).  The copies
        are `non_blocking` (from pinned memory they do not wait for the
        host), on the current stream."""
        (lo, hi) = self.chunk_bounds(i)
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
            lambda x: _pad_rows(x[lo:hi].to(device, non_blocking=True),
                                self.chunk_size))
        live = np.zeros(self.chunk_size, bool)
        live[:hi - lo] = True
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
    without a recompute (e.g. the shard's `ok`)."""

    def __init__(self, bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                 store: HostReportStore, device="cuda",
                 valid: Optional[torch.Tensor] = None,
                 reports: Optional[Sequence] = None, width: int = 8):
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
        check_envelope(bm, store.chunk_size, self.width, self.num_reports,
                       device)
        self.engine = IncrementalMastic(bm, self.width)
        self.streams = CopyStreams(device)
        self.chunks = [self._init_chunk(i) for i in range(store.num_chunks)]
        self.layouts: list = []

    def _init_chunk(self, i: int) -> _ChunkState:
        """Chunk i's first carries and round keys: only the nonces go to
        the card, for the key schedules, and the keys come back."""
        store = self.store
        nonces = store.host_slice(store.arrays["nonces"], i)
        keys = store.host_slice(store.arrays["keys"], i)
        (ext_rk, conv_rk) = self.bm.vidpf.roundkeys(
            self.ctx, nonces.to(self.device))
        carries = [Carry(*(_host(x, self.pin) for x in
                           self.engine.init_carry(store.chunk_size,
                                                  keys[:, a], a)))
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
        check_envelope(self.bm, self.store.chunk_size, width,
                       self.num_reports, self.device)
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
        return self.memory_accounting()["device_bytes_per_chunk"]

    def _pipeline_mode(self, plan: RoundPlan) -> tuple:
        """(mode, fallback reason): the round runs pipelined, or serial
        with the reason named in the metrics."""
        (mode, reason) = pipeline_mode(self.store.num_chunks)
        budget = _device_budget(self.device)
        if mode == "pipelined" and budget > 0:
            peak = round_peak_bytes(
                self.bm, plan.width, len(plan.out_idx),
                self.store.chunk_size, self._resident_dev_bytes(),
                chunks_in_flight=PIPELINE_CHUNKS_IN_FLIGHT)
            if peak > budget:
                return ("serial", "device-budget")
        return (mode, reason)

    def round(self, agg_param, metrics_out: Optional[list] = None) -> list:
        """One round over every chunk on the executor of
        `drivers/pipeline.py`.  Staging chunk i uploads its tile, both
        carries, its round keys and its pre-round mask, then dispatches
        both aggregators' tree step, the level-0 weight check, the
        accept combine (the live, fallback and valid lanes folded in)
        and the masked aggregates, and downloads the new carries into
        the chunk's host buffers.  Collecting it waits once and folds
        its aggregate shares on the host.  After every chunk, the scalar
        splice of the fallback lanes, as in the resident runner.
        Returns one decoded aggregate per prefix."""
        (level, prefixes, do_weight_check) = agg_param
        bm = self.bm
        store = self.store
        chunk_size = store.chunk_size
        num = self.num_reports
        plan = self._plan(prefixes, level)
        check_round_peak(bm, plan.width, len(plan.out_idx), chunk_size,
                         self._resident_dev_bytes(), level, self.device)
        rnd = round_inputs(plan, self.device)
        rows = len(prefixes) * (1 + bm.m.valid.OUTPUT_LEN)
        cr = ChunkedRound(self.streams, [store.chunk_bounds(i) for i in
                                         range(store.num_chunks)],
                          *self._pipeline_mode(plan), rows,
                          bm.m.field.MODULUS)
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
            # The lanes that may reach the aggregates, known before the
            # round: live, valid and not yet fallen back.  This round's
            # ok and checks fold in on the card.
            keep_pre = np.zeros(chunk_size, bool)
            keep_pre[:hi - lo] = self.valid[lo:hi] & ~self.fallback[lo:hi]
            with xfer.upload():
                (batch, _live) = store.device_chunk(i, self.device)
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
            aggs = (bm.aggregate(out0, keep), bm.aggregate(out1, keep))
            names = sorted(checks)
            host = xfer.download(
                [(h, d) for (hc, dc) in zip(cs.carries, (c0, c1))
                 for (h, d) in zip(hc, dc)]
                + [(None, t) for t in (keep, ok) + aggs]
                + [(None, checks[k]) for k in names])
            # Every device tensor of the chunk stays referenced until
            # collect() has waited for the downloads.
            handle = {"host": host[8:], "names": names,
                      "device": (batch, carries, c0, c1, out0, out1,
                                 keep_dev, keep, ok, aggs, checks)}
            return (handle, {"upload_ms": _ms(t0, t_up),
                             "dispatch_ms": _ms(t_up, time.perf_counter())})

        def collect(i: int, handle: dict) -> dict:
            (lo, hi) = store.chunk_bounds(i)
            n = hi - lo

            def fold(arrays: list) -> None:
                (keep, ok, agg0, agg1, *masks) = arrays
                checks = dict(zip(handle["names"], masks))
                self.fallback[lo:hi] |= ~ok[:n] & self.valid[lo:hi]
                eval_ok_all[lo:hi] = checks["eval_proof"][:n]
                if do_weight_check:
                    wc_ok_all[lo:hi] = checks["weight_check"][:n]
                if "joint_rand" in checks:
                    if jr_ok_all[0] is None:
                        jr_ok_all[0] = np.zeros(num, bool)
                    jr_ok_all[0][lo:hi] = checks["joint_rand"][:n]
                accept_all[lo:hi] = keep[:n]
                cr.fold_shares([bm.agg_share_to_host(
                    torch.from_numpy(arr[:rows])) for arr in (agg0, agg1)])

            return cr.collect(i, handle, fold)

        timeline = cr.run(stage, collect)
        evals_per_report = 2 * plan.parent_count * 2  # both aggregators
        for rec in timeline:
            span_s = max(rec["wall_ms"], 1e-3) / 1e3
            rec["node_evals_per_sec"] = round(
                rec["reports"] * evals_per_report / span_s, 1)
            rec["node_evals_per_sec_padded"] = round(
                chunk_size * evals_per_report / span_s, 1)
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
        if metrics_out is not None:
            metrics_out.append(metrics)
        return bm.m.unshard(cr.agg_shares)

    def memory_accounting(self) -> dict:
        """The card's share (one chunk: both carries, the round keys and
        the report tile) against the host's (every chunk and the
        store)."""
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
                carry + rk + store.row_bytes() * store.chunk_size,
            "device_carry_bytes": carry,
            "host_bytes_total": host,
        }

    # -- checkpoint hooks (HeavyHittersRun.to_bytes / from_bytes) ----

    def state_arrays(self) -> dict:
        from ..convert import carry_to_arrays

        data: dict = {"chunk_size": np.int64(self.store.chunk_size)}
        for (i, cs) in enumerate(self.chunks):
            data.update(carry_to_arrays(cs.carries[0], f"k{i}_c0_"))
            data.update(carry_to_arrays(cs.carries[1], f"k{i}_c1_"))
        return data

    def load_state(self, arrays, num_chunks: int) -> None:
        from ..convert import carry_from_arrays

        for i in range(num_chunks):
            for a in range(2):
                carry = carry_from_arrays(arrays, f"k{i}_c{a}_", "cpu")
                self.chunks[i].carries[a] = Carry(
                    *(_host(x, self.pin) for x in carry))
                if self.pin:
                    _release_pinned()
