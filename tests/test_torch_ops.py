"""Differential tests: the PyTorch port's array primitives (the plain
versions of kernels K1 and K2, Field64, the XOF helpers) against the
JAX package, on the same numpy inputs, compared exactly (all integer
arithmetic: tolerance zero)."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastic_tpu.aes import SBOX as SCALAR_SBOX
from mastic_tpu.backend import xof_jax
from mastic_tpu.ops import aes_jax, keccak_jax
from mastic_tpu.ops import ntt_jax as jntt
from mastic_tpu.ops.field_jax import FIELD64 as JFIELD64
from mastic_tpu.ops.field_jax import field_sum as jfield_sum
from mastic_tpu_torch.backend import xof as txof
from mastic_tpu_torch.scalar.field import Field64
from mastic_tpu_torch.ops import aes as taes
from mastic_tpu_torch.ops import keccak as tkeccak
from mastic_tpu_torch.ops import ntt as tntt
from mastic_tpu_torch.ops import sbox_tower as tsbox
from mastic_tpu_torch.ops.field import FIELD64, field_sum, spec_for

REPO = pathlib.Path(__file__).resolve().parents[1]

# One compiled JAX sponge for every runtime length (the length is traced).
_JAX_SPONGE = jax.jit(
    lambda m, n: keccak_jax.turbo_shake128_dynamic(m, n, 1, 200))


def _words(arr: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 carrier."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- K1: Keccak-p[1600] and TurboSHAKE128 -----------------------------

@pytest.mark.parametrize("num_rounds", [12, 24])
def test_keccak_p1600_matches_jax(num_rounds):
    rng = np.random.default_rng(num_rounds)
    lo = rng.integers(0, 2 ** 32, (3, 2, 25), dtype=np.uint32)
    hi = rng.integers(0, 2 ** 32, (3, 2, 25), dtype=np.uint32)
    (jlo, jhi) = keccak_jax.keccak_p1600(jnp.asarray(lo), jnp.asarray(hi),
                                         num_rounds)
    (tlo, thi) = tkeccak.keccak_p1600(_words(lo), _words(hi), num_rounds)
    assert np.array_equal(_u32(tlo), np.asarray(jlo))
    assert np.array_equal(_u32(thi), np.asarray(jhi))


def test_lane_byte_conversions_match_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (4, 168), dtype=np.uint8)
    (jlo, jhi) = keccak_jax.bytes_to_lanes(jnp.asarray(data))
    (tlo, thi) = tkeccak.bytes_to_lanes(torch.from_numpy(data))
    assert np.array_equal(_u32(tlo), np.asarray(jlo))
    assert np.array_equal(_u32(thi), np.asarray(jhi))
    back = tkeccak.lanes_to_bytes(tlo, thi)
    assert np.array_equal(back.numpy(), data)


def _at_offset(arr: np.ndarray, offset: int) -> torch.Tensor:
    """arr as a contiguous tensor that starts `offset` bytes into its
    storage (a row view at an odd byte address)."""
    flat = np.zeros(offset + arr.size, np.uint8)
    flat[offset:] = arr.reshape(-1)
    return torch.from_numpy(flat)[offset:].view(arr.shape)


@pytest.mark.parametrize("length,offset", [
    *(pytest.param(n, 0, id=str(n)) for n in (0, 1, 167, 168, 169, 400, 505)),
    (167, 1), (400, 3), (505, 1)])
def test_turbo_shake128_dynamic_matches_jax(length, offset):
    """Runtime lengths across the block edges and several blocks, with
    a multi-block squeeze; also rows at an odd byte offset."""
    rng = np.random.default_rng(length)
    msg = rng.integers(0, 256, (3, 2, 505), dtype=np.uint8)
    want = _JAX_SPONGE(jnp.asarray(msg), jnp.int32(length))
    got = tkeccak.turbo_shake128_dynamic(_at_offset(msg, offset), length, 1,
                                         200)
    assert np.array_equal(got.numpy(), np.asarray(want))


# Prefixes of 1-15 bytes (each lane split between prefix and message
# in its own way) at lengths that put the total on a block edge.
_PREFIX_CASES = [(14, 0), (14, 154), (14, 505), (170, 3), (170, 400)]
_PREFIX_CASES += [(p, n) for p in range(1, 16)
                  for n in sorted({0, 167 - p, 168 - p, 169 - p, 400})
                  if (p, n) not in _PREFIX_CASES]


@pytest.mark.parametrize("plen,length", _PREFIX_CASES)
def test_turbo_shake128_dynamic_prefix_matches_jax(plen, length):
    """A shared prefix in front of the rows, also one that spans a
    block, hashes as the prefix and row concatenated."""
    rng = np.random.default_rng(plen + length)
    prefix = rng.integers(0, 256, plen, dtype=np.uint8)
    msg = rng.integers(0, 256, (3, 2, 505), dtype=np.uint8)
    whole = np.concatenate([np.broadcast_to(prefix, (3, 2, plen)), msg], -1)
    if plen < 14:   # the 14-byte prefix's width: no new JAX program
        whole = np.concatenate([whole, np.zeros((3, 2, 14 - plen), np.uint8)],
                               -1)
    want = _JAX_SPONGE(jnp.asarray(whole), jnp.int32(plen + length))
    got = tkeccak.turbo_shake128_dynamic(torch.from_numpy(msg), length, 1,
                                         200, prefix=prefix.tobytes())
    assert np.array_equal(got.numpy(), np.asarray(want))


def _template_sponge(msg: np.ndarray, length: int, prefix: bytes,
                     domain: int, out_len: int) -> np.ndarray:
    """TurboSHAKE128 absorbed as the sponge kernel absorbs: each rate
    block is the row's bytes where they fall in it, anything elsewhere
    (here random bytes), and in the template's blocks those bytes masked
    and the template XORed in (`sponge_template`)."""
    (tmpl, head) = tkeccak.sponge_template(prefix, length, domain)
    tmpl = np.frombuffer(tmpl, np.uint8).reshape(2, -1, tkeccak.RATE)
    total = len(prefix) + length
    nblk = total // tkeccak.RATE + 1
    rng = np.random.default_rng(total)
    buf = rng.integers(0, 256, msg.shape[:-1] + (nblk * tkeccak.RATE,),
                       dtype=np.uint8)
    buf[..., len(prefix):total] = msg[..., :length]
    state = torch.zeros((25,) + msg.shape[:-1], dtype=torch.int64)
    for k in range(nblk):
        block = buf[..., k * tkeccak.RATE:(k + 1) * tkeccak.RATE]
        j = k if k < head else head if k == nblk - 1 else None
        if j is not None:
            block = (block & tmpl[1, j]) ^ tmpl[0, j]
        lanes = tkeccak._bytes_lane64(torch.from_numpy(block.copy()))
        state = torch.cat([state[:21] ^ torch.movedim(lanes, -1, 0),
                           state[21:]])
        state = tkeccak._permute_plain(state, 12)
    out = []
    for n in range(-(-out_len // tkeccak.RATE)):
        if n:
            state = tkeccak._permute_plain(state, 12)
        out.append(tkeccak._lane64_bytes(torch.movedim(state[:21], 0, -1)))
    return torch.cat(out, dim=-1)[..., :out_len].numpy()


@pytest.mark.parametrize("plen,length", [(0, 0), (0, 167), (0, 168),
                                         (5, 162), (5, 163), (13, 400),
                                         (14, 505), (170, 0), (170, 400)])
def test_sponge_template_absorb_matches_jax(plen, length):
    """The kernel's host-side lane template (prefix, domain byte and
    pad10*1 for the blocks that hold them, masks for the message's
    bytes) driving a plain absorb equals the JAX sponge."""
    rng = np.random.default_rng(100 + plen + length)
    prefix = rng.integers(0, 256, plen, dtype=np.uint8)
    msg = rng.integers(0, 256, (3, 2, 505), dtype=np.uint8)
    whole = np.concatenate([np.broadcast_to(prefix, (3, 2, plen)), msg], -1)
    if plen <= 14:
        whole = np.concatenate([whole, np.zeros((3, 2, 14 - plen), np.uint8)],
                               -1)
    want = _JAX_SPONGE(jnp.asarray(whole), jnp.int32(plen + length))
    got = _template_sponge(msg, length, prefix.tobytes(), 1, 200)
    assert np.array_equal(got, np.asarray(want))


def test_turbo_shake128_static_matches_jax():
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 256, (5, 80), dtype=np.uint8)
    for (domain, out_len) in ((1, 32), (2, 16), (7, 0)):
        want = keccak_jax.turbo_shake128(jnp.asarray(msg), domain, out_len)
        got = tkeccak.turbo_shake128(torch.from_numpy(msg), domain, out_len)
        assert np.array_equal(got.numpy(), np.asarray(want))


# -- K2: AES-128, byte path and bitsliced -----------------------------

def test_sbox_circuit_matches_table():
    planes = taes._planes(torch.arange(256, dtype=torch.int32))
    out = taes._unplanes(tsbox.sbox_planes_tower(planes, 1))
    assert bytes(out.to(torch.uint8).numpy()) == SCALAR_SBOX
    assert taes.SBOX == SCALAR_SBOX


def test_generated_sbox_header_is_current():
    """csrc/sbox_tower.cuh is what the generator emits now."""
    committed = (REPO / "mastic_tpu_torch" / "csrc" /
                 "sbox_tower.cuh").read_text()
    assert committed == tsbox.emit_cuda()


def test_generated_sbox_circuit_matches_table():
    """Interpret the emitted straight-line code on the 256 byte values
    (packed 32 per word) and compare with the S-box table."""
    src = tsbox.emit_cuda()
    values = np.arange(256, dtype=np.uint8).reshape(8, 32)
    env = {}
    for b in range(8):
        bits = (values >> b) & 1
        env[f"b{b}"] = int(sum(int(bits[w, j]) << (32 * w + j)
                               for w in range(8) for j in range(32)))
    mask = (1 << 256) - 1
    for line in src.splitlines():
        line = line.strip()
        if line.startswith("const uint32_t "):
            (name, expr) = line[len("const uint32_t "):-1].split(" = ")
            if expr.startswith("~"):
                env[name] = ~env[expr[1:]] & mask
            else:
                (x, op, y) = expr.split(" ")
                env[name] = env[x] ^ env[y] if op == "^" else env[x] & env[y]
        elif line.startswith("b") and " = t" in line:
            (name, src_name) = line[:-1].split(" = ")
            env["out_" + name] = env[src_name]
    got = []
    for v in range(256):
        got.append(sum(((env[f"out_b{b}"] >> v) & 1) << b for b in range(8)))
    assert bytes(got) == SCALAR_SBOX


def test_aes_byte_path_matches_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 256, (6, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (6, 3, 16), dtype=np.uint8)
    jrk = aes_jax.aes128_key_schedule(jnp.asarray(keys))
    trk = taes.aes128_key_schedule(torch.from_numpy(keys))
    assert np.array_equal(trk.numpy(), np.asarray(jrk))
    want = aes_jax.aes128_encrypt(jrk[:, None], jnp.asarray(blocks))
    got = taes.aes128_encrypt(trk[:, None], torch.from_numpy(blocks))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_aes_bitsliced_matches_jax():
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (64, 3, 2, 16), dtype=np.uint8)
    jkp = aes_jax.bitslice_keys(aes_jax.aes128_key_schedule(
        jnp.asarray(keys)))
    jpl = aes_jax.bitslice_pack(jnp.asarray(blocks))
    tkp = taes.bitslice_keys(taes.aes128_key_schedule(
        torch.from_numpy(keys)))
    tpl = taes.bitslice_pack(torch.from_numpy(blocks))
    assert np.array_equal(_u32(tkp), np.asarray(jkp))
    assert np.array_equal(_u32(tpl), np.asarray(jpl))
    want = aes_jax.aes128_encrypt_bitsliced(jkp, jpl)
    got = taes.aes128_encrypt_bitsliced(tkp, tpl)
    assert np.array_equal(_u32(got), np.asarray(want))
    assert np.array_equal(taes.bitslice_unpack(got).numpy(),
                          np.asarray(aes_jax.bitslice_unpack(want)))


def test_pack_mask_and_block_index_planes_match_jax():
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, (96, 5)).astype(bool)
    jw = aes_jax.pack_mask(jnp.asarray(bits))
    tw = taes.pack_mask(torch.from_numpy(bits))
    assert np.array_equal(_u32(tw), np.asarray(jw))
    assert np.array_equal(taes.unpack_mask(tw, 90).numpy(),
                          np.asarray(aes_jax.unpack_mask(jw, 90)))
    assert np.array_equal(taes.block_index_planes(5).view(np.uint32),
                          aes_jax.block_index_planes(5))


# -- Field64 ----------------------------------------------------------

def _field_inputs(seed: int, shape: tuple) -> np.ndarray:
    """Random Field64 elements as plain limbs, with the edge values
    0, 1, p-1 and p-2 mixed in."""
    rng = np.random.default_rng(seed)
    p = JFIELD64.modulus
    vals = [int(x) for x in rng.integers(0, 2 ** 63, int(np.prod(shape)))]
    vals[:4] = [0, 1, p - 1, p - 2]
    vals = [v % p for v in vals]
    return np.stack([JFIELD64.int_to_limbs(v) for v in vals]).reshape(
        shape + (4,))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "to_mont",
                                "from_mont"])
def test_field64_ops_match_jax(op):
    a = _field_inputs(1, (6, 3))
    b = _field_inputs(2, (6, 3))
    (ja, jb) = (jnp.asarray(a), jnp.asarray(b))
    (ta, tb) = (_words(a), _words(b))
    if op in ("neg", "to_mont", "from_mont"):
        want = getattr(JFIELD64, op)(ja)
        got = getattr(FIELD64, op)(ta)
    else:
        want = getattr(JFIELD64, op)(ja, jb)
        got = getattr(FIELD64, op)(ta, tb)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_field64_sum_and_bytes_match_jax():
    a = _field_inputs(3, (7, 2))
    want = jnp.asarray(a)
    assert np.array_equal(field_sum(FIELD64, _words(a), 0).numpy(),
                          np.asarray(jfield_sum(JFIELD64, want, 0)))
    assert np.array_equal(FIELD64.plain_to_le_bytes(_words(a)).numpy(),
                          np.asarray(JFIELD64.plain_to_le_bytes(want)))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_field64_add_sub_match_jax_at_and_above_p(op):
    """Carried payloads can hold 64-bit values >= p (the level step
    stores a sampled value whose in-range mask failed): add and sub
    must still equal the JAX package's limb code bit for bit."""
    p = JFIELD64.modulus
    edge = [0, 1, p - 1, p, p + 1, 2 ** 64 - 1, 2 ** 63, 2 ** 32, p - 2 ** 32]
    pairs = [(x, y) for x in edge for y in edge]
    a = np.stack([JFIELD64.int_to_limbs(x) for (x, _y) in pairs])
    b = np.stack([JFIELD64.int_to_limbs(y) for (_x, y) in pairs])
    want = getattr(JFIELD64, op)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(FIELD64, op)(_words(a), _words(b))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,inverse", [(2, True), (4, False),
                                          (4, True)])
def test_ntt_plans_match_jax(size, inverse):
    """The FLP's transforms (Montgomery limbs along axis -2)."""
    x = FIELD64.to_mont(_words(_field_inputs(4, (3, size))))
    want = jntt.ntt_plan(JFIELD64, size, inverse)(
        jnp.asarray(x.numpy().view(np.uint32)))
    got = tntt.ntt_plan(FIELD64, size, inverse)(x)
    assert np.array_equal(_u32(got), np.asarray(want))


def test_poly_eval_pow_and_power_chain_match_jax():
    coeffs = _words(_field_inputs(5, (4, 3)))
    t = _words(_field_inputs(6, (4,)))
    (jc, jt) = (jnp.asarray(_u32(coeffs)), jnp.asarray(_u32(t)))
    assert np.array_equal(
        _u32(tntt.poly_eval_mont(FIELD64, coeffs, t)),
        np.asarray(jntt.poly_eval_mont(JFIELD64, jc, jt)))
    for exponent in (1, 2, 5):
        assert np.array_equal(
            _u32(tntt.pow_static(FIELD64, t, exponent)),
            np.asarray(jntt.pow_static(JFIELD64, jt, exponent)))
    assert np.array_equal(_u32(tntt.power_chain(FIELD64, t, 3)),
                          np.asarray(jntt.power_chain(JFIELD64, jt, 3)))
    assert spec_for(Field64) is FIELD64


def test_limbs_from_le_bytes_in_range_mask_matches_jax():
    """The rejection predicate value < p, at and around p."""
    p = JFIELD64.modulus
    vals = [0, 1, p - 1, p, p + 1, 2 ** 64 - 1, 2 ** 63, 2 ** 32]
    data = np.stack([np.frombuffer(v.to_bytes(8, "little"), np.uint8)
                     for v in vals])
    (jl, jok) = JFIELD64.limbs_from_le_bytes(jnp.asarray(data))
    (tl, tok) = FIELD64.limbs_from_le_bytes(torch.from_numpy(data))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().tolist() == [v < p for v in vals]


# -- XOF helpers ------------------------------------------------------

def test_sample_vec_matches_jax():
    rng = np.random.default_rng(21)
    stream = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    stream[3, 8:16] = 0xFF          # one element >= p: out of range
    (jl, jok) = xof_jax.sample_vec(JFIELD64, jnp.asarray(stream), 4, 8)
    (tl, tok) = txof.sample_vec(FIELD64, torch.from_numpy(stream), 4, 8)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert not tok[3] and tok.sum() == 39


def test_turboshake_xof_and_fixed_key_match_jax():
    rng = np.random.default_rng(22)
    seeds = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    binder = rng.integers(0, 256, (4, 9), dtype=np.uint8)
    dst = b"mastic test dst"
    want = xof_jax.turboshake_xof(dst, jnp.asarray(seeds),
                                  (jnp.asarray(binder), b"\x01\x02"), 40,
                                  (4,))
    got = txof.turboshake_xof(dst, torch.from_numpy(seeds),
                              (torch.from_numpy(binder), b"\x01\x02"), 40,
                              (4,), "cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    jrk = xof_jax.fixed_key_schedule(dst, jnp.asarray(seeds), (4,))
    trk = txof.fixed_key_schedule(dst, torch.from_numpy(seeds), (4,))
    assert np.array_equal(trk.numpy(), np.asarray(jrk))
    assert txof.ts_prefix(dst, 16) == xof_jax.ts_prefix(dst, 16)


@pytest.mark.parametrize("reports", [8, 64])
def test_fixed_key_blocks_match_jax(reports):
    """The port always encrypts bitsliced (K2's path); the JAX package
    takes its byte path below 32 reports: both must give the same
    bytes."""
    rng = np.random.default_rng(reports)
    keys = rng.integers(0, 256, (reports, 16), dtype=np.uint8)
    seeds = rng.integers(0, 256, (reports, 2, 16), dtype=np.uint8)
    jrk = aes_jax.aes128_key_schedule(jnp.asarray(keys))
    trk = taes.aes128_key_schedule(torch.from_numpy(keys))
    want = xof_jax.fixed_key_blocks(jrk, jnp.asarray(seeds), 3)
    got = txof.fixed_key_blocks(trk, torch.from_numpy(seeds), 3)
    assert np.array_equal(got.numpy(), np.asarray(want))


_FIXED_KEY_SHAPES = [(r, s, b) for r in (8, 40, 64) for s in (1, 3)
                     for b in (2, 3)]


@functools.lru_cache(maxsize=None)
def _fixed_key_case(reports: int, seeds: int, blocks: int) -> tuple:
    """Keys and seeds from a seed per shape, and the JAX package's
    blocks for them (computed once for both entries under test)."""
    rng = np.random.default_rng(1000 * reports + 10 * seeds + blocks)
    keys = rng.integers(0, 256, (reports, 16), dtype=np.uint8)
    seed_rows = rng.integers(0, 256, (reports, seeds, 16), dtype=np.uint8)
    jrk = aes_jax.aes128_key_schedule(jnp.asarray(keys))
    want = xof_jax.fixed_key_blocks(jrk, jnp.asarray(seed_rows), blocks)
    return (keys, seed_rows, np.asarray(want))


@pytest.mark.parametrize("entry", ["fixed_key_blocks",
                                   "fixed_key_blocks_plain"])
@pytest.mark.parametrize("reports,seeds,blocks", _FIXED_KEY_SHAPES)
def test_fixed_key_blocks_shapes_match_jax(reports, seeds, blocks, entry):
    """K2's function over report counts below 32 (the JAX byte path),
    with a partial last packed word (40) and whole words (64), one or
    several seeds a report and two or three blocks: the port's entry on
    a CPU tensor (its plain version) and the plain version called
    directly, byte for byte against the JAX package."""
    (keys, seed_rows, want) = _fixed_key_case(reports, seeds, blocks)
    trk = taes.aes128_key_schedule(torch.from_numpy(keys))
    got = getattr(txof, entry)(trk, torch.from_numpy(seed_rows), blocks)
    assert got.shape == (reports, seeds, 16 * blocks)
    assert np.array_equal(got.numpy(), want)
