"""Checkpoints of the resident runner across the two packages: the
port's `HeavyHittersRun.to_bytes` / `from_bytes` against the JAX
package's, in its v3 npz format.

A MasticCount(4) collection over six reports with lane 4 forced to the
XOF fallback at level 0 (as in test_torch_rejection.py), checkpointed
after two levels by each package: the two checkpoints hold the same
arrays (the fallback mask and both carries included), a JAX checkpoint
resumes in the port and a port checkpoint resumes in JAX, and both
finish with every level's counts of an uninterrupted, unforced run.
"""

import io

import numpy as np
import pytest
import torch

import mastic_tpu.backend.mastic_jax as jmastic
import mastic_tpu.backend.vidpf_jax as jvidpf
import mastic_tpu.backend.xof_jax as jxof
import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
import mastic_tpu_torch.backend.vidpf as tbv
import mastic_tpu_torch.ops.level as tlv
from mastic_tpu_torch.backend.xof import sample_vec
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun

BITS = 4
CTX = b"torch port checkpoint test"
VK = bytes(range(7, 39))
VALUES = [0b1001, 0b0000, 0b0000, 0b1001, 0b1100, 0b0011]
THRESHOLDS = {"default": 2}
FORCED = 4
SPLIT = 2  # levels run before the checkpoint


def _force(mp, modules, real, zeros):
    """Patch `real` (a sample_vec) in `modules` so lane FORCED reads as
    rejected."""
    def fake(spec, stream, length, offset=0):
        (limbs, ok) = real(spec, stream, length, offset)
        bad = zeros(ok.shape[0])
        return (limbs, ok & ~bad.reshape((-1,) + (1,) * (ok.ndim - 1)))

    for mod in modules:
        mp.setattr(mod, "sample_vec", fake)


def _force_port(mp):
    def zeros(n):
        bad = torch.zeros(n, dtype=torch.bool)
        bad[FORCED] = True
        return bad

    _force(mp, (tlv, tbv, tbm), sample_vec, zeros)


def _force_jax(mp):
    import jax.numpy as jnp

    _force(mp, (jvidpf, jmastic), jxof.sample_vec,
           lambda n: jnp.zeros((n,), bool).at[FORCED].set(True))


def _reports() -> tuple:
    """The same six reports from both scalar layers."""
    rng = np.random.default_rng(21)
    port = tbm.MasticCount(BITS).scalar()
    ref = jm.MasticCount(BITS)
    (reports, jreports) = ([], [])
    for v in VALUES:
        meas = (port.vidpf.test_index_from_int(v, BITS), 1)
        (nonce, rand) = (rng.bytes(16), rng.bytes(port.RAND_SIZE))
        reports.append((nonce,) + port.shard(CTX, meas, nonce, rand))
        jreports.append((nonce,) + ref.shard(CTX, meas, nonce, rand))
    return (reports, jreports)


def _jax_steps(run, levels=None) -> list:
    """Step a JAX HeavyHittersRun (all levels, or `levels`), returning
    [(prefixes, counts)] per level."""
    out = []
    while levels is None or len(out) < levels:
        handle = run.step_begin()
        if handle is None:
            break
        more = run.step_finish(handle)
        out.append((list(handle["agg_param"][1]), handle["result"]))
        if not more:
            break
    return out


def _port_run(reports, **kw) -> HeavyHittersRun:
    return HeavyHittersRun(tbm.MasticCount(BITS), CTX, THRESHOLDS, VK,
                           device="cpu", reports=reports, **kw)


def _finish(run) -> HeavyHittersRun:
    while run.step():
        pass
    return run


@pytest.fixture(scope="module")
def state() -> dict:
    """Both packages' forced runs checkpointed after SPLIT levels, the
    JAX run carried on to the end, the port's checkpoint resumed in
    JAX, and the unforced port run."""
    from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JRun

    (reports, jreports) = _reports()
    want = _finish(_port_run(reports))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        _force_jax(mp)
        jrun = JRun(jm.MasticCount(BITS), CTX, THRESHOLDS, jreports,
                    verify_key=VK)
        jlevels = _jax_steps(jrun, SPLIT)
        jckpt = jrun.to_bytes()
        jlevels += _jax_steps(jrun)
    with pytest.MonkeyPatch.context() as mp:
        _force_port(mp)
        trun = _port_run(reports)
        for _ in range(SPLIT):
            trun.step()
        tckpt = trun.to_bytes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        back = JRun.from_bytes(jm.MasticCount(BITS), CTX, THRESHOLDS,
                               jreports, VK, tckpt)
        back_levels = _jax_steps(back)
    return {"reports": reports, "want": want, "jlevels": jlevels,
            "jresult": jrun.result(), "jckpt": jckpt, "tckpt": tckpt,
            "back_levels": back_levels, "back_result": back.result(),
            "back_fallback": back.runner.fallback}


def _arrays(data: bytes) -> dict:
    arrays = np.load(io.BytesIO(data), allow_pickle=False)
    return {k: arrays[k] for k in arrays.files}


def test_checkpoints_hold_the_same_arrays(state):
    """The port's checkpoint after two levels equals the JAX package's,
    array by array: meta, binding, frontier, layouts, width, the
    fallback mask with the forced lane, and both carries."""
    (got, want) = (_arrays(state["tckpt"]), _arrays(state["jckpt"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert np.flatnonzero(got["fallback"]).tolist() == [FORCED]


def test_jax_checkpoint_resumes_in_the_port(state):
    """A JAX checkpoint resumes in the port, which splices the fallback
    lane at every remaining level and finishes with the uninterrupted
    runs' counts and heavy hitters."""
    want = state["want"]
    assert state["jlevels"] == want.level_results
    run = _finish(HeavyHittersRun.from_bytes(
        tbm.MasticCount(BITS), CTX, THRESHOLDS, VK, None, state["jckpt"],
        device="cpu", reports=state["reports"]))
    assert run.level_results == want.level_results[SPLIT:]
    assert run.result() == want.result() == state["jresult"]
    assert [m.xof_fallbacks for m in run.metrics] == [1] * (BITS - SPLIT)
    assert run.runner.fallback.tolist() == [False] * FORCED + [True, False]


def test_port_checkpoint_resumes_in_jax_and_the_port(state):
    """The port's checkpoint resumes in JAX and in a fresh port run, and
    both finish with the uninterrupted run's counts."""
    want = state["want"]
    assert state["back_levels"] == want.level_results[SPLIT:]
    assert state["back_result"] == want.result()
    assert np.flatnonzero(state["back_fallback"]).tolist() == [FORCED]
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    batch = bm.marshal_reports(state["reports"], "cpu")
    run = _finish(HeavyHittersRun.from_bytes(
        tbm.MasticCount(BITS), CTX, THRESHOLDS, VK, batch, state["tckpt"],
        device="cpu", reports=state["reports"]))
    assert run.level_results == want.level_results[SPLIT:]
    assert run.result() == want.result()


def _rewritten(data: bytes, **changes) -> bytes:
    arrays = _arrays(data)
    arrays.update(changes)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_restore_refuses_what_it_cannot_resume(state):
    """A checkpoint whose meta claims a chunk_size but that holds no
    per-chunk carries, another verify key or thresholds, another report
    count, and another format version are refused with a clear
    error."""
    (reports, ckpt) = (state["reports"], state["tckpt"])
    meta = _arrays(ckpt)["meta"].copy()
    meta[6] = 3

    def restore(data, vk=VK, thresholds=THRESHOLDS, reps=reports):
        return HeavyHittersRun.from_bytes(
            tbm.MasticCount(BITS), CTX, thresholds, vk, None, data,
            device="cpu", reports=reps)

    with pytest.raises(ValueError, match="lacks the carries of its 2 "
                                         "chunks"):
        restore(_rewritten(ckpt, meta=meta))
    with pytest.raises(ValueError, match="different verify_key"):
        restore(ckpt, vk=bytes(32))
    with pytest.raises(ValueError, match="different verify_key"):
        restore(ckpt, thresholds={"default": 3})
    with pytest.raises(ValueError, match="does not match"):
        restore(ckpt, reps=reports[:5])
    meta = _arrays(ckpt)["meta"].copy()
    meta[0] = 2
    with pytest.raises(ValueError, match="version 2"):
        restore(_rewritten(ckpt, meta=meta))
