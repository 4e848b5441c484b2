"""The field kernel (`csrc/field.cu`) against the plain limb code
(`FieldSpec.plain`), bit for bit: each operation on both fields, on
limbs that encode values >= p and all-ones limbs, with host constants,
broadcast operands, the NTT's strided halves and the gadget's 0::2 rows,
an empty batch; the batched FLP's prove, query and decide on the card
against the same calls on CPU tensors; and the launch counters.

The `card` tests need a CUDA card (the kernel has no CPU mode) and skip
without one; run them on the card with `python -m pytest --noconftest
tests/test_torch_field_kernel.py -q` (`tests/conftest.py` imports jax).
The CPU test holds the CPU path to the plain version with no launch."""

import numpy as np
import pytest
import torch

from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.ops import kernels
from mastic_tpu_torch.ops.field import FIELD64, FIELD128

FIELDS = {"field64": FIELD64, "field128": FIELD128}
OPS = ("add", "sub", "neg", "mul", "to_mont", "from_mont")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the field kernel runs only there")
    return torch.device("cuda", torch.cuda.current_device())


def _limbs(rng: np.random.Generator, spec, shape: tuple) -> torch.Tensor:
    """Random int32 limbs of `shape` + (n,): uniform 16-bit limbs, every
    other row replaced by an edge value (all-ones limbs, p, p + 1,
    p - 1, 0) or a random value at or above p."""
    n = spec.num_limbs
    x = rng.integers(0, 1 << 16, shape + (n,), dtype=np.int64)
    flat = x.reshape(-1, n)
    top = 1 << (16 * n)
    edges = [top - 1, spec.modulus, spec.modulus + 1, spec.modulus - 1, 0]
    for i in range(0, flat.shape[0], 2):
        v = edges[(i // 2) % len(edges)] if i % 4 == 0 else \
            spec.modulus + int.from_bytes(rng.bytes(2 * n), "little") % (
                top - spec.modulus)
        flat[i] = spec.int_to_limbs(v)
    return torch.from_numpy(x.astype(np.int32))


def _operand_cases(rng: np.random.Generator, spec) -> list:
    """(name, a, b) on the CPU; b may be a host constant."""
    n = spec.num_limbs
    x = _limbs(rng, spec, (6, 3, 16))
    t = _limbs(rng, spec, (9,))
    return [
        ("rows", _limbs(rng, spec, (1000,)), _limbs(rng, spec, (1000,))),
        ("host_constant", _limbs(rng, spec, (33, 5)), spec.R2_LIMBS),
        ("constant_first", spec.int_to_limbs(spec.modulus - 1),
         _limbs(rng, spec, (17,))),
        ("broadcast", _limbs(rng, spec, (9, 1, 7)),
         _limbs(rng, spec, (4, 1))),
        ("expanded", _limbs(rng, spec, (9, 11)),
         t[:, None, :].expand(9, 11, n)),
        ("ntt_halves", x[..., 8:, :], x[..., :8, :]),
        ("gadget_rows", x[..., 0::2, :], x[..., 1::2, :]),
        ("unaligned", _limbs(rng, spec, (65,))[1:],
         _limbs(rng, spec, (65,))[:-1]),
        ("transposed", _limbs(rng, spec, (5, 7)).transpose(0, 1),
         _limbs(rng, spec, (7, 5))),
        ("empty", _limbs(rng, spec, (0, 3)), _limbs(rng, spec, (0, 3))),
    ]


def _apply(spec, op: str, a, b) -> torch.Tensor:
    if op in ("neg", "to_mont", "from_mont"):
        return getattr(spec, op)(a)
    return getattr(spec, op)(a, b)


def _on(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


@pytest.mark.card
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", list(FIELDS))
def test_kernel_equals_the_plain_version(card, field, op):
    spec = FIELDS[field]
    rng = np.random.default_rng([len(field), OPS.index(op)])
    for (name, a, b) in _operand_cases(rng, spec):
        if op in ("neg", "to_mont", "from_mont") and \
                not isinstance(a, torch.Tensor):
            continue
        want = _apply(spec.plain, op, a, b)
        got = _apply(spec, op, _on(a, card), _on(b, card))
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32, name
        assert torch.equal(got.cpu(), want), (field, op, name)


@pytest.mark.card
@pytest.mark.parametrize("field", list(FIELDS))
def test_launch_counters(card, field):
    """A call on the card is one launch under the field's counter; a
    call on CPU tensors launches nothing."""
    spec = FIELDS[field]
    rng = np.random.default_rng(7)
    (a, b) = (_limbs(rng, spec, (4, 3)), _limbs(rng, spec, (4, 3)))
    before = dict(kernels.launches)
    spec.mul(a.to(card), b.to(card))
    spec.to_mont(a.to(card))
    spec.neg(b.to(card))
    after = dict(kernels.launches)
    assert after[spec.counter] - before[spec.counter] == 3
    assert {k: v for (k, v) in after.items() if k != spec.counter} == {
        k: v for (k, v) in before.items() if k != spec.counter}
    spec.mul(a, b)
    spec.neg(a)
    assert kernels.launches == after


def flp_case(mastic, num: int, seed: int) -> tuple:
    """Plain-limb inputs of the FLP's prove and query for `num` reports
    of `mastic`'s circuit, one of them an invalid measurement: (meas,
    prove_rand, query_rand, joint_rand or None) as CPU int32 tensors."""
    valid = mastic.valid
    bflp = tm.BatchedMastic(mastic).bflp
    spec = bflp.spec
    rng = np.random.default_rng(seed)

    def rand(count: int) -> list:
        return [int.from_bytes(rng.bytes(spec.encoded_size + 8), "little")
                % spec.modulus for _ in range(count)]

    if isinstance(valid, tm.Histogram):
        meas = [valid.encode(int(rng.integers(0, valid.length)))
                for _ in range(num)]
    else:
        meas = [valid.encode(int(rng.integers(0, valid.max_measurement + 1)))
                for _ in range(num)]
    meas[1] = rand(valid.MEAS_LEN)

    def limbs(rows: list) -> torch.Tensor:
        return torch.from_numpy(np.stack([
            np.stack([spec.int_to_limbs(v) for v in row]) for row in rows]))

    jr = limbs([rand(valid.JOINT_RAND_LEN) for _ in range(num)]) \
        if valid.JOINT_RAND_LEN else None
    return (bflp, limbs(meas),
            limbs([rand(valid.PROVE_RAND_LEN) for _ in range(num)]),
            limbs([rand(valid.QUERY_RAND_LEN) for _ in range(num)]), jr)


def flp_flow(bflp, meas, prove_rand, query_rand, joint_rand,
             device) -> list:
    """prove, query over the whole measurement and over a share of two,
    and decide, on `device`; every output on the CPU."""
    (meas, prove_rand, query_rand) = (x.to(device) for x in (
        meas, prove_rand, query_rand))
    jr = None if joint_rand is None else joint_rand.to(device)
    proof = bflp.prove(meas, prove_rand, jr)
    (verifier, ok) = bflp.query(meas, proof, query_rand, jr, 1)
    (verifier2, ok2) = bflp.query(meas, proof, query_rand, jr, 2)
    out = [proof, verifier, ok, bflp.decide(verifier), verifier2, ok2]
    return [x.cpu() for x in out]


FLP_CIRCUITS = {"histogram64": lambda: tm.MasticHistogram(64, 16, 4),
                "sum32": lambda: tm.MasticSum(32, 255)}


@pytest.mark.card
@pytest.mark.parametrize("name", list(FLP_CIRCUITS))
def test_flp_on_the_card_equals_the_cpu(card, name):
    (bflp, *inputs) = flp_case(FLP_CIRCUITS[name](), 24, len(name))
    before = kernels.launches[bflp.spec.counter]
    got = flp_flow(bflp, *inputs, card)
    want = flp_flow(bflp, *inputs, "cpu")
    assert kernels.launches[bflp.spec.counter] > before
    for (g, w) in zip(got, want):
        assert torch.equal(g, w)
    assert want[3].tolist() == [i != 1 for i in range(24)]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Off the card every operation is the plain limb code and no
    launch is made."""

    def no_launch(*args, **kw):
        raise AssertionError("a CPU tensor reached the field kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    rng = np.random.default_rng(3)
    for spec in FIELDS.values():
        (a, b) = (_limbs(rng, spec, (12,)), _limbs(rng, spec, (12,)))
        for op in OPS:
            assert torch.equal(_apply(spec, op, a, b),
                               _apply(spec.plain, op, a, b))
        assert spec.plain is not spec and spec.plain.plain is spec.plain
