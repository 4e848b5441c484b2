"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--levels L]

1. Builds the three hand-written kernels from mastic_tpu_torch/csrc/
   (one nvcc per source, in parallel, into build/kernels/<hash>/) and
   prints nvcc's time, the libraries and ptxas's register/spill lines.
2. Holds each kernel bit-exact against its plain PyTorch version on the
   card at the main path's shapes, and times both: K1 (Keccak) as the
   eval proof's gathered binder sponge over two aggregators' distinct
   level-255 carries (both checks of both aggregators in one launch,
   payloads holding values >= p; also at depth 64 behind a 35-byte
   prefix), as the bare permutation over R x 2W node-proof states and
   as the in-place sponge; K2 (bitsliced AES) as the main path's
   `fixed_key_blocks` at the client sharding's extend and convert
   shapes, at R = 4093 with 3 blocks and at 64 seeds a report, and as
   the planes entry at the sharding's plane stack; K3 (the level
   step) at R = 4096 reports x 32 parents (the main path's widest
   level), x 64 parents, and x 32 parents with a 150-byte ctx (a node
   proof over two rate blocks).
3. Runs the main path at real size: MasticCount(256) over Field64 with
   R = 4096 reports (32 planted 256-bit strings x 64 reports each plus
   2048 uniform ones, weights 0/1, all from --seed), sharded on the
   card, then the whole 256-level heavy-hitters collection at threshold
   48, with every launch counter set to 0 just before and read just
   after (K1's binder sponge counts apart from its in-place sponge, K2's
   fixed-key entry apart from its planes entry, which the path does not
   launch; each of the path's four must have launched).  The aggregates of every level must equal
   a numpy plaintext count over the reports that were not rejected, and
   the heavy hitters must be the planted strings.  `--levels L` stops after L levels (a
   cut of depth, printed on its own line).
4. Prints the `kernels` JSON line, the card, the run's figures, and
   last `{"ok": true, "device": {...}}`.  Any failure exits non-zero
   before that line.

Exits 2 without a card.  Needs the repository beside it (it imports
mastic_tpu_torch).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# logic and shift instructions/s = 132 SMs x 64 results per clock (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0)
# x 1.98 GHz boost; the data sheet gives no integer rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

R = 4096
BITS = 256
PLANTED = 32
PER_PLANTED = 64
THRESHOLD = 48
# The launch counters of the main path's kernels (ops/kernels.py): K1's
# in-place sponge and binder sponge, K2's fixed-key entry, K3.
PATH_COUNTERS = ("keccak", "keccak_binder", "aes", "level")
CTX = b"mastic chip smoke"
LONG_CTX = bytes(range(150))

# Operation counts for the bounds, in 32-bit instructions as the card
# issues them: one LOP3 computes any function of three words, and a
# 64-bit rotate is two funnel shifts (SHF).
# Keccak round: theta parities 5 columns x 2 halves x 2 LOP3, their
# rotations 5 x 2 SHF, theta applied 25 x 2 LOP3 (a ^ c[x-1] ^ rot
# c[x+1]), rho 24 x 2 SHF, chi 25 x 2 LOP3 (b ^ (~c & d)), iota 2.
KECCAK_PERM_OPS = 12 * (20 + 10 + 50 + 48 + 50 + 2)
KECCAK_ABSORB_OPS = 42          # one rate block: 21 lanes x 2 XOR
# The payload check's arithmetic per Field64 element: 3 values from 4
# limbs (4 each: two halves of one LOP3 and one SHF), the add (2 IADD,
# 2 for the compare and the conditional subtract) and the sub (2 IADD,
# 2 for the borrow's conditional add of p).
PAYLOAD_ELEM_OPS = 3 * 4 + 4 + 4
# AES over one column of 32 blocks (a 32-bit word per state bit), in
# 2-input gates: 11 round keys x 128 XOR, 10 x 16 tower S-boxes of 195
# gates, 9 x 16 MixColumns bytes of 35 XOR; charged at two gates per
# LOP3, the most an LOP3 takes from an XOR tree.
SBOX_GATES = 195
AES_BLOCK_OPS = (11 * 128 + 10 * 16 * SBOX_GATES + 9 * 16 * 35) / 2


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _time(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, names: tuple, reps: int) -> dict:
    """Mean device milliseconds per call of fn() in each kernel whose
    name contains one of `names`, from a torch.profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        for name in names:
            if name in event.key:
                out[name] += event.self_device_time_total / 1e3 / reps
    return out


def _max_err(got, want) -> int:
    """Largest absolute difference over matching outputs (as int64)."""
    err = 0
    for (a, b) in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_kernels(dev: torch.device, gen: torch.Generator) -> list:
    """Each kernel against its plain version at main-path shapes."""
    from mastic_tpu_torch.backend.mastic import MasticCount
    from mastic_tpu_torch.backend.vidpf import BatchedVidpf
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.dst import (USAGE_NODE_PROOF, USAGE_ONEHOT_CHECK,
                                      dst, dst_alg)
    from mastic_tpu_torch.ops import keccak, level
    from mastic_tpu_torch.ops.field import FIELD64

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def rand_i32(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    rows = []

    # K1's gathered binder sponge at a level-255 carry (W = 64: 32
    # parents per depth), index lists shaped like RoundPlan's.
    k1 = check_binder_sponge(dev, gen)

    # K1, bare permutation over R x 2W node-proof states.
    states = R * 256
    lo = rand_i32(states, 25)
    hi = rand_i32(states, 25)
    err = _max_err(keccak.keccak_p1600(lo, hi), keccak.keccak_p1600_plain(lo, hi))
    perm_ms = _time(lambda: keccak.keccak_p1600(lo, hi), 5)
    perm_plain = _time(lambda: keccak.keccak_p1600_plain(lo, hi), 1)
    (perm_bound, perm_by) = _bound(states * 400.0, states * KECCAK_PERM_OPS)
    print(f"K1 permutation: {states} states, {perm_ms:.4f} ms "
          f"(plain {perm_plain:.3f} ms, bound {perm_bound:.4f} ms by "
          f"{perm_by}), max_abs_err {err}")
    if err:
        raise AssertionError("K1 permutation disagrees with its plain version")
    del lo, hi

    # K1, the in-place sponge (the eval-proof XOF's and the shard's) over
    # 4096 messages behind a dst prefix, and without one with a
    # multi-block squeeze.
    prefix = ts_prefix(dst_alg(CTX, USAGE_ONEHOT_CHECK, MasticCount.ID), 0)
    length = 4096
    msg = rand_u8(R, length)
    got = keccak.turbo_shake128_dynamic(msg, length, 1, 32, prefix=prefix)
    want = keccak.turbo_shake128_dynamic_plain(msg, length, 1, 32,
                                               prefix=prefix)
    err_s = _max_err([got], [want])
    short = [f(msg, 1000, 1, 200) for f in (keccak.turbo_shake128_dynamic,
                                           keccak.turbo_shake128_dynamic_plain)]
    err_s = max(err_s, _max_err(short[:1], short[1:]))
    sponge_ms = _time(lambda: keccak.turbo_shake128_dynamic(
        msg, length, 1, 32, prefix=prefix), 5)
    print(f"K1 in-place sponge: {R} messages x ({len(prefix)} + {length}) B, "
          f"{sponge_ms:.4f} ms, max_abs_err {err_s}")
    if err_s:
        raise AssertionError("K1's sponge disagrees with its plain version")
    del msg, got, want, short
    k1["max_abs_err"] = max(k1["max_abs_err"], err, err_s)
    k1["shape"] += (f"; permutation {states} states: {perm_ms:.4f} ms, bound "
                    f"{perm_bound:.4f} ms; in-place sponge {R} x "
                    f"{len(prefix) + length} B: {sponge_ms:.4f} ms")
    rows.append(k1)

    rows.append(check_aes(dev, gen))
    vid = BatchedVidpf(BITS, 2)

    # K3 with a level-255 node binder, at the main path's R x 32 parents
    # (padded width 64), at R x 64 parents, and at R x 32 parents with a
    # 150-byte ctx, whose node-proof message takes two rate blocks.
    nonces = rand_u8(R, 16)
    level_rows = {}
    for (parents, ctx) in ((64, CTX), (32, LONG_CTX), (32, CTX)):
        (ext_rk, conv_rk) = vid.roundkeys(ctx, nonces)
        prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), 16)
        pseed = rand_u8(R, parents, 16)
        pctrl = rand_u8(R, parents) >= 128
        cw = (rand_u8(R, 16), rand_u8(R, 2) >= 128,
              torch.randint(0, 1 << 16, (R, 2, 4), dtype=torch.int32,
                            device=dev, generator=gen),
              rand_u8(R, 32))
        binder = rand_u8(2 * parents, 36)
        args = (FIELD64, vid.convert_blocks, 2, ext_rk, conv_rk, pseed, pctrl,
                cw, prefix, binder, 36)
        err = _max_err(level.level_step(*args), level.level_step_plain(*args))
        # The whole call by CUDA events (what the main path pays: the
        # wrapper's template and copies, and the kernels), as in PR 1;
        # the kernels' own device time from a profiler trace beside it.
        split = _device_ms(lambda: level.level_step(*args),
                           ("level_kernel", "node_proof_kernel"), 5)
        ms = _time(lambda: level.level_step(*args), 5)
        plain_ms = _time(lambda: level.level_step_plain(*args), 1)
        pairs = (R // 32) * parents
        nb = (len(prefix) + 16 + 36) // 168 + 1
        in_bytes = 2 * 11 * 16 * R + R * parents * 17 \
            + R * (16 + 2 + 32 + 32) + len(prefix) + binder.numel()
        out_bytes = R * 2 * parents * (16 + 1 + 32 + 1 + 32)
        # Per (packed word x parent): 2 extend and 2 x 2 convert AES
        # columns, and 64 node-proof sponges of nb blocks each.
        ops = pairs * (6 * AES_BLOCK_OPS
                       + 64 * nb * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS))
        (bound, by) = _bound(float(in_bytes + out_bytes), float(ops))
        level_rows[(parents, len(ctx))] = {
            "name": "level_step", "route": "cuda",
            "source": "mastic_tpu_torch/csrc/level.cu",
            "replaces": "mastic_tpu/ops/level_pallas.py:521",
            "max_abs_err": err, "kernel_ms": ms, "ms": ms,
            "device_ms": sum(split.values()),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shape": f"{R} reports x {parents} parents, ctx {len(ctx)} B "
                     f"(node proof {nb} block{'s' if nb > 1 else ''}): "
                     f"level_kernel {split['level_kernel']:.4f} ms + "
                     f"node_proof_kernel {split['node_proof_kernel']:.4f} ms"
                     f" device time"}
    for ((parents, ctx_len), row) in level_rows.items():
        print(f"K3: whole call {row['ms']:.4f} ms, kernels "
              f"{row['device_ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at "
              f"{row['shape']}, max_abs_err {row['max_abs_err']}")
        if row["max_abs_err"]:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{row['shape']}")
    threads = 8 * 32 * (R // 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"K3 grid at {R} reports x 32 parents: level kernel "
          f"{threads // 128} blocks of 128 threads (four per (child, packed "
          f"word)) on {sms} SMs; node proofs {R * 64 // 128} blocks of 128 "
          f"threads (one per (report, child))")
    main = level_rows[(32, len(CTX))]
    long_row = level_rows[(32, len(LONG_CTX))]
    main["max_abs_err"] = max(r["max_abs_err"] for r in level_rows.values())
    wide = level_rows[(64, len(CTX))]
    main["shape"] += (f"; x 64 parents: whole call {wide['ms']:.4f} ms, "
                      f"kernels {wide['device_ms']:.4f} ms; ctx "
                      f"{len(LONG_CTX)} B: whole call {long_row['ms']:.4f} ms,"
                      f" kernels {long_row['device_ms']:.4f} ms, bound "
                      f"{long_row['bound_ms']:.4f} ms")
    rows.append(main)
    for row in rows:
        if row["max_abs_err"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return rows


def check_aes(dev: torch.device, gen: torch.Generator) -> dict:
    """K2 against its plain versions: the fixed-key entry (the main
    path's `fixed_key_blocks`) at the client shard's extend shape (next
    seeds sliced from the wider convert output, as `gen` passes them)
    and convert shape, at R - 3 reports with 3 blocks and at a
    throughput shape of 64 seeds a report; the planes entry at the
    shard's plane stack.  Times the whole `fixed_key_blocks` call (CUDA
    events), its kernel alone (profiler), the parent's path for the
    same call (PyTorch bit packing around the planes entry) and the
    planes entry."""
    from mastic_tpu_torch.backend.xof import (fixed_key_blocks,
                                              fixed_key_blocks_plain)
    from mastic_tpu_torch.backend.vidpf import BatchedVidpf
    from mastic_tpu_torch.ops import aes

    def inputs(reports, seeds, width=16):
        keys = torch.randint(0, 256, (reports, 16), dtype=torch.uint8,
                             device=dev, generator=gen)
        rows = torch.randint(0, 256, (reports, seeds, width),
                             dtype=torch.uint8, device=dev, generator=gen)
        return (aes.aes128_key_schedule(keys), rows[..., :16])

    def parent_path(round_keys, seeds, blocks):
        """The parent's `fixed_key_blocks` on the card: block indices
        uploaded from numpy, sigma and the feed-forward as byte
        tensors, PyTorch bit packing around the planes entry."""
        idx = np.zeros((blocks, 16), np.uint8)
        idx[:, 0] = np.arange(blocks)
        x = seeds[..., None, :] ^ torch.as_tensor(idx, device=dev)
        sigma = torch.cat([x[..., 8:], x[..., 8:] ^ x[..., :8]], dim=-1)
        planes = aes.bitslice_pack(sigma).contiguous()
        kp = aes.bitslice_keys(round_keys).contiguous()
        enc = aes.bitslice_unpack(aes.aes128_encrypt_bitsliced(kp, planes))
        out = enc ^ sigma
        return out.reshape(out.shape[:-2] + (blocks * 16,))

    def bound(reports, seeds, blocks):
        columns = (reports + 31) // 32 * seeds * blocks
        nbytes = reports * (11 * 16 + seeds * 16 + seeds * blocks * 16)
        return _bound(float(nbytes), columns * AES_BLOCK_OPS)

    convert_blocks = BatchedVidpf(BITS, 2).convert_blocks
    extend = (*inputs(R, 2, 16 * convert_blocks), 2)
    wide = (*inputs(R, 64), 2)
    cases = {"extend": extend, "convert": (*inputs(R, 2), convert_blocks),
             "ragged": (*inputs(R - 3, 2), 3), "throughput": wide}
    errs = {}
    for (name, args) in cases.items():
        errs[name] = _max_err([fixed_key_blocks(*args)],
                              [fixed_key_blocks_plain(*args)])
        (rk, seeds, blocks) = args
        print(f"K2 fixed_key_blocks ({name}): {rk.shape[0]} reports x "
              f"{seeds.shape[1]} seeds x {blocks} blocks, max_abs_err "
              f"{errs[name]}")
    kp = aes.bitslice_keys(extend[0]).contiguous()
    planes = torch.randint(-2 ** 31, 2 ** 31, (8, 16, 2, 2, R // 32),
                           dtype=torch.int32, device=dev, generator=gen)
    errs["planes"] = _max_err([aes.aes128_encrypt_bitsliced(kp, planes)],
                              [aes.aes128_encrypt_bitsliced_plain(kp, planes)])
    errs["parent"] = _max_err([parent_path(*extend)],
                              [fixed_key_blocks_plain(*extend)])
    print(f"K2 planes entry: planes (8, 16, 2, 2, {R // 32}), max_abs_err "
          f"{errs['planes']}; the parent's path through it at the extend "
          f"shape, max_abs_err {errs['parent']}")

    ms = _time(lambda: fixed_key_blocks(*extend), 20)
    device_ms = _device_ms(lambda: fixed_key_blocks(*extend),
                           ("fixed_key_kernel",), 20)["fixed_key_kernel"]
    plain_ms = _time(lambda: fixed_key_blocks_plain(*extend), 2)
    parent_ms = _time(lambda: parent_path(*extend), 20)
    planes_ms = _time(lambda: aes.aes128_encrypt_bitsliced(kp, planes), 20)
    wide_ms = _time(lambda: fixed_key_blocks(*wide), 20)
    wide_device = _device_ms(lambda: fixed_key_blocks(*wide),
                             ("fixed_key_kernel",), 20)["fixed_key_kernel"]
    (b, by) = bound(R, 2, 2)
    (wide_b, wide_by) = bound(R, 64, 2)
    threads = 4 * (R // 32) * 2 * 2
    print(f"K2 fixed_key_blocks at {R} reports x 2 seeds x 2 blocks "
          f"({threads // 64} blocks of 64 threads): whole call {ms:.4f} ms, "
          f"kernel {device_ms:.4f} ms (bound {b:.6f} ms by {by}); the "
          f"parent's path (bit packing + planes entry + unpacking) "
          f"{parent_ms:.4f} ms; plain {plain_ms:.3f} ms")
    print(f"K2 fixed_key_blocks at {R} reports x 64 seeds x 2 blocks: whole "
          f"call {wide_ms:.4f} ms, kernel {wide_device:.4f} ms (bound "
          f"{wide_b:.4f} ms by {wide_by}); planes entry at (8, 16, 2, 2, "
          f"{R // 32}) {planes_ms:.4f} ms")
    return {"name": "aes_fixed_key_blocks", "route": "cuda",
            "source": "mastic_tpu_torch/csrc/aes.cu",
            "replaces": "mastic_tpu/ops/aes_pallas.py:149",
            "max_abs_err": max(errs.values()), "kernel_ms": ms,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"fixed_key_blocks, {R} reports x 2 seeds x 2 blocks "
                     f"(the shard's extend; also checked at its convert, at "
                     f"{R - 3} reports x 3 blocks and at 64 seeds); the "
                     f"parent's path for this call {parent_ms:.4f} ms; {R} "
                     f"reports x 64 seeds x 2 blocks: whole call "
                     f"{wide_ms:.4f} ms, kernel {wide_device:.4f} ms, bound "
                     f"{wide_b:.4f} ms; planes entry at (8, 16, 2, 2, "
                     f"{R // 32}): {planes_ms:.4f} ms"}


def _binder_indices(gen_np: np.random.Generator, dev: torch.device,
                    bits: int) -> tuple:
    """onehot / payload row lists of a level-(bits-1) round at width 64
    with 32 parents per depth, as RoundPlan lays them out: per depth the
    nodes sit at creation-order positions (here a random permutation),
    onehot lists both children of every depth-(d-1) ancestor, payload
    every ancestor with its two children."""
    width = 64
    pos = [gen_np.permutation(width) for _ in range(bits)]
    anc = [min(2 ** (d + 1), PLANTED) for d in range(bits)]
    onehot = [d * width + pos[d][i] for d in range(bits)
              for i in range(2 if d == 0 else 2 * anc[d - 1])]
    (par, left, right) = ([], [], [])
    for d in range(bits - 1):
        for i in range(anc[d]):
            par.append(d * width + pos[d][i])
            left.append((d + 1) * width + pos[d + 1][2 * i])
            right.append((d + 1) * width + pos[d + 1][2 * i + 1])
    return tuple(torch.as_tensor(np.array(x, np.int64), device=dev)
                 for x in (onehot, par, left, right))


def _binder_carries(dev: torch.device, gen: torch.Generator,
                    bits: int) -> tuple:
    """Two independent random carries, one per aggregator, at width 64:
    ((w0, w1), (proof0, proof1)).  Every 97th element of w holds a value
    >= p (p, p + 1, 2^64 - 1 in turn), from a different first element in
    each carry."""
    from mastic_tpu_torch.ops.field import FIELD64

    p = FIELD64.modulus
    (ws, proofs) = ([], [])
    for first in (0, 41):
        w = torch.randint(0, 1 << 16, (R, bits, 64, 2, 4), dtype=torch.int32,
                          device=dev, generator=gen)
        flat = w.view(-1, 4)
        for (i, v) in enumerate((p, p + 1, 2 ** 64 - 1)):
            flat[first + i::3 * 97] = torch.as_tensor(FIELD64.int_to_limbs(v),
                                                      device=dev)
        ws.append(w)
        proofs.append(torch.randint(0, 256, (R, bits, 64, 32),
                                    dtype=torch.uint8, device=dev,
                                    generator=gen))
    return (tuple(ws), tuple(proofs))


def binder_inputs(dev: torch.device, gen: torch.Generator, bits: int,
                  ctx: bytes) -> tuple:
    """The arguments of `binder_checks` for two aggregators' distinct
    carries at depth `bits` with RoundPlan-shaped index lists."""
    from mastic_tpu_torch.backend.mastic import MasticCount
    from mastic_tpu_torch.backend.xof import ts_prefix
    from mastic_tpu_torch.dst import (USAGE_ONEHOT_CHECK, USAGE_PAYLOAD_CHECK,
                                      dst_alg)
    from mastic_tpu_torch.ops.field import FIELD64

    (ws, proofs) = _binder_carries(dev, gen, bits)
    idx = _binder_indices(np.random.default_rng(int(torch.randint(
        0, 2 ** 31, (1,), generator=gen, device=dev))), dev, bits)
    pre = tuple(ts_prefix(dst_alg(ctx, usage, MasticCount.ID), 0)
                for usage in (USAGE_ONEHOT_CHECK, USAGE_PAYLOAD_CHECK))
    return (FIELD64, ws, proofs, *idx, *pre)


def _binder_compare(dev: torch.device, gen: torch.Generator, bits: int,
                    ctx: bytes) -> tuple:
    """The binder sponge against its plain version on two aggregators'
    distinct carries at depth `bits`: (max_abs_err, plain ms, the
    inputs of the launch).  Fails unless the two aggregators' outputs
    differ at every report, so a kernel that read one aggregator's rows
    for the other's could not agree."""
    from mastic_tpu_torch.ops import binder

    args = binder_inputs(dev, gen, bits, ctx)
    pre = args[-2:]
    got = binder.binder_checks(*args)
    t0 = time.perf_counter()
    want = binder.binder_checks_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(got, want)
    for (check, out) in zip(("onehot", "payload"), got):
        if not (out[0] != out[1]).any(dim=-1).all():
            raise AssertionError(f"K1 binder sponge: the two aggregators' "
                                 f"{check} checks agree at some report")
    print(f"K1 binder sponge, depth {bits}, prefix {len(pre[0])} B "
          f"({len(pre[0]) % 8} past a lane), 2 aggregators' distinct carries "
          f"(values >= p in both): max_abs_err {err}")
    return (err, plain_ms, args)


def check_binder_sponge(dev: torch.device, gen: torch.Generator) -> dict:
    """K1's gathered binder sponge against its plain version at a
    level-255 carry (prefix 32 B) and at depth 64 with a 20-byte ctx
    (prefix 35 B: every message word straddles two rate lanes); times
    the first in the main path's form (both checks of both aggregators,
    one launch)."""
    from mastic_tpu_torch.ops import binder

    (err_odd, _ms, _args) = _binder_compare(dev, gen, 64, bytes(range(20)))
    (err, plain_ms, args) = _binder_compare(dev, gen, BITS, CTX)
    err = max(err, err_odd)
    ms = _time(lambda: binder.binder_checks(*args), 3)
    (_spec, ws, _proofs, *idx, prefix_onehot, _prefix_payload) = args
    (onehot_rows, payload_rows) = (idx[0].numel(), idx[1].numel())
    plen = len(prefix_onehot)
    blocks = ((plen + 32 * onehot_rows) // 168 + 1
              + (plen + 16 * payload_rows) // 168 + 1)
    # Each input read once: the onehot proof rows and the distinct w rows
    # (2 elements x 16 B) the payload check names, per aggregator and
    # report, and the index lists.
    payload_nodes = torch.unique(torch.cat(idx[1:])).numel()
    in_bytes = 2 * R * 32.0 * (onehot_rows + payload_nodes) \
        + 8.0 * (onehot_rows + 3 * payload_rows)
    out_bytes = 2 * 2 * R * 32.0
    ops = 2 * R * (blocks * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS)
                   + 2 * payload_rows * PAYLOAD_ELEM_OPS)
    (bound, by) = _bound(in_bytes + out_bytes, float(ops))
    print(f"K1 binder sponge: 2 aggregators x {R} reports x (onehot "
          f"{onehot_rows} rows, payload {payload_rows} rows), {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms; bound {bound:.4f} ms by "
          f"{by}), max_abs_err {err}")
    del args, ws, _proofs
    return {"name": "keccak_binder_sponge", "route": "cuda",
            "source": "mastic_tpu_torch/csrc/keccak.cu",
            "replaces": "mastic_tpu/ops/keccak_pallas.py:72",
            "max_abs_err": err, "kernel_ms": ms, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shape": f"binder sponge, 2 aggregators x {R} reports x (prefix "
                     f"{plen} B + onehot {onehot_rows} x 32 B, + payload "
                     f"{payload_rows} x 2 x 8 B); also checked at depth 64 "
                     f"with a 35-byte prefix"}


def measurements(seed: int) -> tuple:
    """32 planted 256-bit strings x 64 reports plus 2048 uniform strings
    (weights 0 or 1), shuffled: (alphas (R, BITS) bool, weights (R,))."""
    rng = np.random.default_rng(seed)
    planted = rng.integers(0, 2, (PLANTED, BITS)).astype(bool)
    uniform = rng.integers(0, 2, (R - PLANTED * PER_PLANTED, BITS)).astype(bool)
    alphas = np.concatenate([np.repeat(planted, PER_PLANTED, axis=0), uniform])
    weights = np.concatenate([np.ones(PLANTED * PER_PLANTED, np.int64),
                              rng.integers(0, 2, len(uniform))])
    order = rng.permutation(R)
    return (alphas[order], weights[order], planted)


def plaintext_counts(alphas: np.ndarray, weights: np.ndarray,
                     valid: np.ndarray, prefixes: list) -> list:
    """Weighted count of each candidate prefix over the valid reports."""
    level = len(prefixes[0])
    keys = {}
    packed = np.packbits(alphas[:, :level], axis=1)
    for r in np.flatnonzero(valid):
        key = packed[r].tobytes()
        keys[key] = keys.get(key, 0) + int(weights[r])
    return [keys.get(np.packbits(np.array(p, bool)).tobytes(), 0)
            for p in prefixes]


def main_path(dev: torch.device, seed: int, levels: int) -> dict:
    from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
    from mastic_tpu_torch.ops import kernels

    (alphas, weights, planted) = measurements(seed)
    mastic = MasticCount(BITS)
    bm = BatchedMastic(mastic)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    nonces = torch.randint(0, 256, (R, 16), dtype=torch.uint8, device=dev,
                           generator=gen)
    rand = torch.randint(0, 256, (R, mastic.RAND_SIZE), dtype=torch.uint8,
                         device=dev, generator=gen)
    vk = bytes(torch.randint(0, 256, (32,), dtype=torch.uint8, device=dev,
                             generator=gen).cpu().tolist())
    meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r]))
            for r in range(R)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (a_dev, b_dev) = bm.encode_measurements(meas, dev)
    (batch, shard_ok) = bm.shard_device(CTX, a_dev, b_dev, nonces, rand)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    shard_launches = dict(kernels.launches)

    run = HeavyHittersRun(mastic, CTX, {"default": THRESHOLD}, vk, batch,
                          valid=shard_ok, device=dev)
    excluded_per_level = []
    widths = []
    max_frontier = 0
    t0 = time.perf_counter()
    while run.level < levels:
        max_frontier = max(max_frontier, len(run.prefixes))
        more = run.step()
        excluded_per_level.append(run.excluded())
        widths.append(run.runner.width)
        if not more:
            break
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0

    # Every level's aggregates against the plaintext count.
    for ((prefixes, counts), excluded) in zip(run.level_results,
                                               excluded_per_level):
        want = plaintext_counts(alphas, weights, ~excluded, prefixes)
        if counts != want:
            raise AssertionError(
                f"level {len(prefixes[0]) - 1}: aggregates differ from the "
                f"plaintext count")
    done = len(run.level_results)
    valid = ~excluded_per_level[-1]
    expect = sorted({tuple(bool(b) for b in p[:done]) for p in planted})
    if done == BITS:
        got = sorted(run.result())
    else:
        got = sorted({p[:-1] for p in run.prefixes})
    missing = [p for p in expect if p not in got]
    # Shallow cuts keep uniform prefixes above the threshold too; the
    # full depth keeps the planted strings only.
    if missing or (done == BITS and len(got) != len(expect)):
        raise AssertionError(f"heavy hitters: {len(got)} found, "
                             f"{len(expect)} planted, {len(missing)} missing")
    # Node evals, both aggregators: children of live parents, and every
    # child the padded level step computes (width W per report).
    live = sum(2 * R * 2 * len({p[:-1] for p in prefixes})
               for (prefixes, _c) in run.level_results)
    padded = 2 * R * sum(widths)
    return {"levels": done, "shard_s": shard_s, "rounds_s": rounds_s,
            "rejected": int((~valid).sum()),
            "shard_rejected": int((~shard_ok).sum()),
            "live_evals": live, "padded_evals": padded,
            "max_frontier": max_frontier,
            "max_width": run.runner.max_width,
            "heavy_hitters": len(got), "shard_launches": shard_launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--levels", type=int, default=BITS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from mastic_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{kernels.build_info.get('seconds', 0.0):.1f} s), libraries "
          f"{', '.join(str(p) for p in paths.values())}")
    for name in kernels.SOURCES:
        log = (paths[name].parent / f"{name}.ptxas.txt").read_text()
        func = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {func}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = check_kernels(dev, gen)
    torch.cuda.empty_cache()

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    result = main_path(dev, args.seed, args.levels)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    for row in rows:
        key = {"keccak_binder_sponge": "keccak_binder",
               "aes_fixed_key_blocks": "aes",
               "level_step": "level"}[row["name"]]
        row["launches"] = counts[key]
    # K1's in-place sponge (the shard's and the eval-proof XOF's).
    rows[0]["launches_turboshake"] = counts["keccak"]
    idle = [name for name in PATH_COUNTERS if counts[name] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")

    if result["levels"] < BITS:
        print(f"cut: the collection stopped after {result['levels']} of "
              f"{BITS} levels (--levels); the frontier there matched numpy")
    print(f"main path: MasticCount({BITS}), {R} reports, threshold "
          f"{THRESHOLD}, {result['levels']} levels, {result['heavy_hitters']} "
          f"heavy hitters = the planted strings")
    print(f"rejected reports (excluded from the aggregates): "
          f"{result['rejected']} ({result['shard_rejected']} at sharding)")
    print(f"shard: {result['shard_s']:.3f} s; rounds: "
          f"{result['rounds_s']:.3f} s; node evals (both aggregators): "
          f"{result['padded_evals']} computed "
          f"({result['padded_evals'] / result['rounds_s']:.4g} evals/s), "
          f"{result['live_evals']} under live parents "
          f"({result['live_evals'] / result['rounds_s']:.4g} evals/s)")
    shard_n = result["shard_launches"]
    print("launches: " + ", ".join(
        f"{name} {shard_n[name]} in the shard + {n - shard_n[name]} in the "
        f"rounds ({(n - shard_n[name]) / result['levels']:.3g} per level)"
        for (name, n) in counts.items()))
    print(f"peak device memory: {peak} B ({peak / 2 ** 30:.2f} GiB); "
          f"largest frontier {result['max_frontier']} prefixes, padded "
          f"width {result['max_width']}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
