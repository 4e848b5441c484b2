"""The kernel store (`mastic_tpu_torch/drivers/artifacts.py`) on the CPU:
no card, no nvcc and no JAX program.

* The gates, with stand-in blobs: a digest mismatch is ``corrupt``
  before anything is loaded, a manifest of another version or runtime
  or a card of another capability is ``version_skew``, a foreign source
  digest is a ``miss``, a probe mismatch is ``probe_fail``, and failed
  loads are memoized.  The outcome labels and the metric equal the JAX
  package's and land in the registry.
* The write order: the blob is durable before the manifest names it.
* The probe: its digests are the plain versions' outputs, and the K1
  and K2 probe outputs equal the JAX package's pure-Python Keccak and
  AES on the same inputs; the bake seals the plain versions' digests
  and refuses a library whose kernels disagree.
* `ops.kernels.lib`: the store before nvcc, a failed gate built inline
  or, with no nvcc, an error naming the outcome, never the plain
  version.
* The CPU paths open no store, and every round carries an
  `extra["artifacts"]` block that passes the port's schema.
"""

import ctypes
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from mastic_tpu import aes as jaes
from mastic_tpu import keccak as jkeccak
from mastic_tpu.drivers import artifacts as jartifacts
from mastic_tpu_torch.backend.mastic import MasticCount
from mastic_tpu_torch.backend.xof import fixed_key_blocks_plain
from mastic_tpu_torch.drivers import artifacts, service
from mastic_tpu_torch.drivers.attribute_metrics import (aggregate_by_attribute,
                                                        hash_attribute)
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
from mastic_tpu_torch.obs import registry as tregistry
from mastic_tpu_torch.obs.schema import validate_extra
from mastic_tpu_torch.ops import kernels
from mastic_tpu_torch.ops.aes import (aes128_encrypt_bitsliced_plain,
                                      aes128_key_schedule, bitslice_keys,
                                      bitslice_pack, bitslice_unpack)
from mastic_tpu_torch.ops.binder import binder_checks_plain
from mastic_tpu_torch.ops.field import FIELD64, FIELD128
from mastic_tpu_torch.ops.keccak import (keccak_p1600_plain,
                                         turbo_shake128_dynamic_plain)
from mastic_tpu_torch.ops.level import level_step_plain
from mastic_tpu_torch.tools import bake as bake_tool

CTX = b"torch artifacts"
VK = bytes(range(16))


# -- a store of stand-in blobs ------------------------------------------

class _Fake:
    """A stand-in loaded library."""

    def __init__(self, name: str):
        self.name = name


def _probes(name: str, tag: str = "ok") -> dict:
    return {fn: f"{tag}-{fn}" for fn in kernels.SIGNATURES[name]}


@pytest.fixture
def gates(monkeypatch):
    """Seams of the load side: a (9, 0) card, loads recorded and served
    by stand-ins, probe digests that equal `_probes`, a fresh registry."""
    loads = []

    def dlopen(payload, name):
        loads.append((name, payload))
        return _Fake(name)

    monkeypatch.setattr(artifacts, "device_capability", lambda: (9, 0))
    monkeypatch.setattr(artifacts, "probe_device", lambda: "card")
    monkeypatch.setattr(artifacts, "_dlopen_private", dlopen)
    monkeypatch.setattr(kernels, "bind", lambda handle, name: handle)
    monkeypatch.setattr(artifacts, "probe_digest",
                        lambda fn, device, seed: f"ok-{fn}")
    tregistry.configure()
    return loads


def _sealed(path, name: str = "aes", key=None, blob: bytes = b"\x7fELF aes",
            **kw) -> tuple:
    store = artifacts.ArtifactStore(str(path))
    key = key or artifacts.library_key(name)
    store.save(key, blob, _probes(name), nvcc="release 12.x", ptxas="log",
               **kw)
    return (artifacts.ArtifactStore(str(path)), key)


def _loads(outcome: str) -> float:
    return tregistry.get_registry().counter(
        "mastic_artifact_loads_total", outcome=outcome).value()


def test_outcome_labels_and_metric_equal_jax(tmp_path, gates):
    """The outcome constants are the JAX package's, and every load lands
    in mastic_artifact_loads_total under its label (a hit and a miss
    here) and in an artifact.load span."""
    for name in ("HIT", "MISS", "PROBE_FAIL", "VERSION_SKEW", "CORRUPT"):
        assert getattr(artifacts, name) == getattr(jartifacts, name)
    assert (artifacts.ARTIFACT_VERSION, artifacts.MANIFEST_NAME) == \
        (jartifacts.ARTIFACT_VERSION, jartifacts.MANIFEST_NAME)
    (store, key) = _sealed(tmp_path)
    assert isinstance(store.load(key), _Fake)
    assert store.load(artifacts.library_key("level")) is None
    assert (_loads("hit"), _loads("miss")) == (1, 1)
    text = tregistry.get_registry().prometheus_text()
    assert 'mastic_artifact_loads_total{outcome="hit"} 1' in text
    assert store.outcome_counts == {"hit": 1, "miss": 1}


def test_hit_loads_the_checked_bytes_and_probes_every_function(
        tmp_path, gates, monkeypatch):
    calls = []
    (store, key) = _sealed(tmp_path, "keccak", blob=b"keccak bytes")

    def probe(fn, device, seed):
        calls.append((fn, device, seed))
        return f"ok-{fn}"

    monkeypatch.setattr(artifacts, "probe_digest", probe)
    handle = store.load(key)
    assert isinstance(handle, _Fake)
    assert gates == [("keccak", b"keccak bytes")]
    assert calls == [(fn, "card", artifacts._PROBE_SEED)
                     for fn in kernels.SIGNATURES["keccak"]]
    assert store.load(key) is handle and len(gates) == 1
    assert set(store.timings["keccak"]) == {"load_ms", "probe_ms"}


def test_digest_mismatch_is_corrupt_before_any_load(tmp_path, gates,
                                                    monkeypatch):
    (store, key) = _sealed(tmp_path)
    blob = tmp_path / store.entry(key)["blob"]
    data = bytearray(blob.read_bytes())
    data[3] ^= 0x01
    blob.write_bytes(bytes(data))

    def refuse(*args, **kw):
        raise AssertionError("a library was loaded before its digest")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    monkeypatch.setattr(artifacts, "_dlopen_private", refuse)
    assert store.load(key) is None
    assert store.outcome(key) == artifacts.CORRUPT
    assert _loads("corrupt") == 1


def test_missing_blob_is_corrupt(tmp_path, gates):
    (store, key) = _sealed(tmp_path)
    os.unlink(tmp_path / store.entry(key)["blob"])
    assert store.load(key) is None
    assert store.outcome(key) == artifacts.CORRUPT
    assert gates == []


@pytest.mark.parametrize("skew", ["version", "runtime", "capability"])
def test_other_version_runtime_or_card_is_version_skew(tmp_path, gates,
                                                       monkeypatch, skew):
    (store, key) = _sealed(tmp_path)
    manifest = tmp_path / artifacts.MANIFEST_NAME
    man = json.loads(manifest.read_text())
    if skew == "version":
        man["version"] = artifacts.ARTIFACT_VERSION + 1
    elif skew == "runtime":
        man["runtime"] = "cuda-11.0-ppc64le"
    else:
        monkeypatch.setattr(artifacts, "device_capability", lambda: (8, 0))
    manifest.write_text(json.dumps(man))
    store = artifacts.ArtifactStore(str(tmp_path))
    assert store.load(key) is None
    assert store.outcome(key) == artifacts.VERSION_SKEW
    assert gates == [] and _loads("version_skew") == 1


def test_foreign_source_digest_is_a_miss(tmp_path, gates):
    """An entry built from other sources is never this tree's library."""
    foreign = ("level", "0" * 16, artifacts.ARCH)
    (store, _key) = _sealed(tmp_path, "level", key=foreign)
    assert store.entry(foreign) is not None
    assert store.load(artifacts.library_key("level")) is None
    assert store.outcome(artifacts.library_key("level")) == artifacts.MISS
    assert store.preload() == {"miss": len(kernels.SOURCES)}
    assert gates == []


def test_probe_mismatch_is_probe_fail_and_is_memoized(tmp_path, gates,
                                                      monkeypatch):
    """A library whose probe output differs is refused; the negative
    memo answers every later load without loading again."""
    (store, key) = _sealed(tmp_path)
    monkeypatch.setattr(artifacts, "probe_digest",
                        lambda fn, device, seed: "other bytes")
    assert store.load(key) is None
    assert store.outcome(key) == artifacts.PROBE_FAIL
    assert store.load(key) is None
    assert len(gates) == 1
    assert _loads("probe_fail") == 2


def test_probe_that_raises_is_probe_fail(tmp_path, gates, monkeypatch):
    (store, key) = _sealed(tmp_path)

    def launch_fails(fn, device, seed):
        raise RuntimeError("CUDA launch aes.fixed_key_blocks failed")

    monkeypatch.setattr(artifacts, "probe_digest", launch_fails)
    assert store.load(key) is None
    assert store.outcome(key) == artifacts.PROBE_FAIL


def test_probe_launches_are_served_to_the_prober_and_not_counted(
        monkeypatch):
    handle = _Fake("aes")
    monkeypatch.setattr(kernels, "_libs", {})
    with kernels.serving("aes", handle):
        assert kernels.lib("aes") is handle
    assert "aes" not in kernels._libs


def test_blob_is_durable_before_the_manifest_names_it(tmp_path,
                                                      monkeypatch):
    """save() fsyncs the blob and its directory, then renames the
    manifest into place (tmp, fsync, rename) and fsyncs the store."""
    events = []
    key = artifacts.library_key("aes")
    name = artifacts.key_name(key)
    blob_path = tmp_path / "blobs" / f"{name}.so"
    real_replace = os.replace
    real_fsync = os.fsync

    def fsync(fd):
        events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        real_fsync(fd)

    def replace(src, dst):
        assert blob_path.read_bytes() == b"library"
        assert name not in artifacts.ArtifactStore(str(tmp_path)).manifest[
            "entries"]
        events.append(("replace", os.path.basename(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    artifacts.ArtifactStore(str(tmp_path)).save(key, b"library",
                                                _probes("aes"))
    assert events == [("fsync", str(blob_path)),
                      ("fsync", str(tmp_path / "blobs")),
                      ("fsync", str(tmp_path / "manifest.json.tmp")),
                      ("replace", "manifest.json"),
                      ("fsync", str(tmp_path))]
    entry = artifacts.ArtifactStore(str(tmp_path)).entry(key)
    assert entry["sha256"] == hashlib.sha256(b"library").hexdigest()
    assert (entry["bytes"], entry["probe"]) == (7, _probes("aes"))
    assert entry["key"] == list(key)


# -- the probe -----------------------------------------------------------

def _digest(outputs) -> str:
    h = hashlib.sha256()
    for out in outputs:
        out = out.contiguous()
        h.update(f"{tuple(out.shape)} {out.dtype}".encode())
        h.update(out.numpy().tobytes())
    return h.hexdigest()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plain_outputs(fn: str, inp: dict) -> list:
    """The plain versions called directly on the probe inputs."""
    if fn == "keccak_permute":
        (lo, hi) = (_t(inp["lo"]), _t(inp["hi"]))
        return [*keccak_p1600_plain(lo, hi, 12),
                *keccak_p1600_plain(lo, hi, 24)]
    if fn == "turboshake":
        msg = _t(inp["msg"])
        return [turbo_shake128_dynamic_plain(msg, 333, 1, 200,
                                             prefix=inp["prefix"]),
                turbo_shake128_dynamic_plain(msg, 400, 2, 32)]
    if fn == "binder_sponge":
        out = []
        for (spec, case) in ((FIELD64, inp["f64"]), (FIELD128, inp["f128"])):
            out.extend(binder_checks_plain(
                spec, tuple(_t(w) for w in case["ws"]),
                tuple(_t(p) for p in case["proofs"]),
                *(_t(case[k]) for k in ("onehot_idx", "par", "left",
                                        "right")),
                case["prefix_onehot"], case["prefix_payload"]))
        return out
    if fn == "fixed_key_blocks":
        rk = aes128_key_schedule(_t(inp["keys"]))
        return [fixed_key_blocks_plain(rk, _t(inp["seeds"]),
                                       inp["num_blocks"])]
    if fn == "aes_bitsliced":
        rk = aes128_key_schedule(_t(inp["keys"]))
        return [aes128_encrypt_bitsliced_plain(
            bitslice_keys(rk).contiguous(),
            bitslice_pack(_t(inp["blocks"])).contiguous())]
    if fn == "field_op":
        out = []
        for (spec, case) in ((FIELD64, inp["f64"]), (FIELD128, inp["f128"])):
            (a, b, plain) = (_t(case["a"]), _t(case["b"]), spec.plain)
            out.extend([plain.add(a, b), plain.sub(a[:, :1], b),
                        plain.mul(a, b), plain.to_mont(a[1:]),
                        plain.neg(b[:, 0::2])])
        return out
    out = []
    for (spec, case) in ((FIELD64, inp["f64"]), (FIELD128, inp["f128"])):
        cw = tuple(_t(case[k]) for k in ("seed_cw", "ctrl_cw", "w_cw",
                                         "proof_cw"))
        out.extend(level_step_plain(
            spec, case["convert_blocks"], case["value_len"],
            _t(case["ext_rk"]), _t(case["conv_rk"]), _t(case["parent_seed"]),
            _t(case["parent_ctrl"]), cw, case["prefix"],
            _t(case["node_binder"]), case["binder_len"]))
    return out


@pytest.mark.parametrize("fn", artifacts.FUNCTIONS)
def test_probe_digest_is_the_plain_versions(fn):
    """On the CPU the probe runs the plain versions: its digest is theirs,
    recomputed here from the same inputs, and every function of
    `kernels.SIGNATURES` has a probe."""
    inp = artifacts.probe_inputs(fn)
    assert artifacts.probe_digest(fn, "cpu") == \
        _digest(_plain_outputs(fn, inp))
    assert artifacts.probe_digest(fn, "cpu", seed=1) != \
        artifacts.probe_digest(fn, "cpu")


def _lanes(lo: np.ndarray, hi: np.ndarray) -> list:
    return [(int(h) & 0xFFFFFFFF) << 32 | (int(l) & 0xFFFFFFFF)
            for (l, h) in zip(lo, hi)]


def _blocks_jax(key: bytes, seed: bytes, num_blocks: int) -> bytes:
    """XofFixedKeyAes128's blocks of `seed` under the expanded `key`."""
    cipher = jaes.Aes128(key)
    out = b""
    for i in range(num_blocks):
        x = bytes(a ^ b for (a, b) in zip(seed, i.to_bytes(16, "little")))
        sigma = x[8:] + bytes(a ^ b for (a, b) in zip(x[8:], x[:8]))
        enc = cipher.encrypt_block(sigma)
        out += bytes(a ^ b for (a, b) in zip(enc, sigma))
    return out


def _elements(spec, limbs: np.ndarray) -> list:
    return [spec.limbs_to_int(v) for v in limbs.reshape(-1, spec.num_limbs)]


@pytest.mark.parametrize("fn", ["keccak_permute", "turboshake",
                                "binder_sponge", "fixed_key_blocks",
                                "aes_bitsliced"])
def test_k1_k2_probe_outputs_equal_the_jax_scalar_layer(fn):
    """K1's and K2's probe outputs (the plain versions, on the CPU) equal
    the JAX package's pure-Python Keccak and AES on the same inputs."""
    inp = artifacts.probe_inputs(fn)
    out = [o.numpy() for o in artifacts.probe_outputs(fn, inp, "cpu")]
    if fn == "keccak_permute":
        for (k, rounds) in ((0, 12), (2, 24)):
            got = [_lanes(lo, hi) for (lo, hi) in zip(out[k], out[k + 1])]
            want = [jkeccak.keccak_p1600(_lanes(lo, hi), rounds)
                    for (lo, hi) in zip(inp["lo"], inp["hi"])]
            assert got == want
    elif fn == "turboshake":
        for row in range(inp["msg"].shape[0]):
            msg = inp["msg"][row].tobytes()
            assert out[0][row].tobytes() == jkeccak.turbo_shake128(
                inp["prefix"] + msg[:333], 1, 200)
            assert out[1][row].tobytes() == jkeccak.turbo_shake128(msg, 2, 32)
    elif fn == "binder_sponge":
        for (k, (spec, case)) in enumerate(((FIELD64, inp["f64"]),
                                            (FIELD128, inp["f128"]))):
            (onehot, payload) = (out[2 * k], out[2 * k + 1])
            for a in range(2):
                (w, proof) = (case["ws"][a], case["proofs"][a])
                reports = w.shape[0]
                w = w.reshape(reports, -1, *w.shape[3:])
                proof = proof.reshape(reports, -1, 32)
                for r in range(reports):
                    msg = b"".join(proof[r, i].tobytes()
                                   for i in case["onehot_idx"])
                    assert onehot[a, r].tobytes() == jkeccak.turbo_shake128(
                        case["prefix_onehot"] + msg, 1, 32)
                    msg = b""
                    for (p, lf, rt) in zip(case["par"], case["left"],
                                           case["right"]):
                        for (x, y, z) in zip(_elements(spec, w[r, p]),
                                             _elements(spec, w[r, lf]),
                                             _elements(spec, w[r, rt])):
                            msg += ((x - y - z) % spec.modulus).to_bytes(
                                spec.encoded_size, "little")
                    assert payload[a, r].tobytes() == jkeccak.turbo_shake128(
                        case["prefix_payload"] + msg, 1, 32)
    elif fn == "fixed_key_blocks":
        for (r, key) in enumerate(inp["keys"]):
            for s in range(inp["seeds"].shape[1]):
                assert out[0][r, s].tobytes() == _blocks_jax(
                    key.tobytes(), inp["seeds"][r, s].tobytes(),
                    inp["num_blocks"])
    else:
        blocks = bitslice_unpack(torch.from_numpy(out[0])).numpy()
        for (r, key) in enumerate(inp["keys"]):
            cipher = jaes.Aes128(key.tobytes())
            for m in range(inp["blocks"].shape[1]):
                assert blocks[r, m].tobytes() == cipher.encrypt_block(
                    inp["blocks"][r, m].tobytes())


# -- the bake ---------------------------------------------------------------

@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """nvcc and dlopen replaced: `kernels.build` writes stand-in
    libraries and ptxas reports into the bake's build root."""
    def build(names, root):
        out = root / "h"
        out.mkdir()
        for name in names:
            (out / f"lib{name}.so").write_bytes(f"lib{name}".encode())
            (out / f"{name}.ptxas.txt").write_text(f"ptxas {name}")
        return {name: out / f"lib{name}.so" for name in names}

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(bake_tool, "nvcc_release",
                        lambda nvcc: "Cuda compilation tools, release 12.x")
    monkeypatch.setattr(ctypes, "CDLL", _Fake)
    monkeypatch.setattr(kernels, "bind", lambda handle, name: handle)
    return tmp_path / "store"


def test_bake_seals_the_plain_versions_digests(fake_build):
    """With the check's device standing in for the card (the CPU, so the
    'kernels' are the plain versions and agree), the bake seals every
    library with the plain versions' digests, its bytes, nvcc's release
    and ptxas's report."""
    rec = bake_tool.bake(str(fake_build), "cpu")
    assert rec["entries"] == len(kernels.SOURCES)
    assert set(rec["libraries"]) == set(kernels.SOURCES)
    store = artifacts.ArtifactStore(str(fake_build))
    for name in kernels.SOURCES:
        entry = store.entry(artifacts.library_key(name))
        assert entry["probe"] == {fn: artifacts.probe_digest(fn, "cpu")
                                  for fn in kernels.SIGNATURES[name]}
        assert (fake_build / entry["blob"]).read_bytes() == \
            f"lib{name}".encode()
        assert (entry["ptxas"], entry["nvcc"]) == (
            f"ptxas {name}", "Cuda compilation tools, release 12.x")


def test_bake_refuses_a_kernel_that_disagrees(fake_build, monkeypatch):
    real = artifacts.probe_digest

    def probe(fn, device, seed=artifacts._PROBE_SEED):
        if device == "cpu" or fn != "turboshake":
            return real(fn, "cpu", seed)
        return "0" * 64

    monkeypatch.setattr(artifacts, "probe_digest", probe)
    with pytest.raises(RuntimeError, match="refusing to seal libkeccak.so: "
                                           r"\['turboshake'\]"):
        bake_tool.bake(str(fake_build), "card")
    assert artifacts.ArtifactStore(str(fake_build)).entry(
        artifacts.library_key("keccak")) is None


# -- ops.kernels.lib ---------------------------------------------------------

@pytest.fixture
def loader(tmp_path, monkeypatch, gates):
    """kernels.lib with an empty memo, stats from zero, a store armed
    at tmp_path/store and an empty build root."""
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "stats", dict(
        inline_compiles=0, artifact_hits=0, artifact_load_ms=0.0,
        store=None))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(artifacts, "_stores", {})
    monkeypatch.setenv("MASTIC_ARTIFACT_DIR", str(tmp_path / "store"))
    return tmp_path / "store"


def test_lib_takes_the_store_before_nvcc(loader, monkeypatch):
    _sealed(loader, "aes")

    def no_nvcc():
        raise AssertionError("nvcc ran for a library the store holds")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    mark = artifacts.stats_mark()
    handle = kernels.lib("aes")
    assert isinstance(handle, _Fake) and kernels.lib("aes") is handle
    block = artifacts.round_block(mark)
    assert (block["store"], block["hits"], block["inline_compiles"]) == (
        str(loader), 1, 0)
    assert validate_extra({"artifacts": block}) == []
    assert _loads("hit") == 1


@pytest.mark.parametrize("gate", ["corrupt", "probe_fail", "miss"])
def test_failed_gate_without_nvcc_raises_and_never_runs_the_plain_version(
        loader, monkeypatch, gate):
    (store, key) = _sealed(loader, "keccak")
    if gate == "corrupt":
        (loader / store.entry(key)["blob"]).write_bytes(b"swapped")
    elif gate == "probe_fail":
        monkeypatch.setattr(artifacts, "probe_digest",
                            lambda fn, device, seed: "other bytes")
    else:
        os.unlink(loader / artifacts.MANIFEST_NAME)

    def never(*args, **kw):
        raise AssertionError("the plain version ran in place of a kernel")

    monkeypatch.setattr(
        kernels, "_nvcc",
        lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr("mastic_tpu_torch.ops.keccak.keccak_p1600_plain",
                        never)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match=f"gave '{gate}'.*nvcc not found"):
        kernels.launch("keccak", "keccak_permute", 0, 0, 0, 0, 1, 12, 0)
    assert "keccak" not in kernels._libs
    assert kernels.stats["inline_compiles"] == 0
    assert kernels.launches == before


def test_failed_gate_builds_inline(loader, monkeypatch):
    """A library that fails its gate is built with nvcc in this process,
    in one nvcc run with every other library that fails, and loaded from
    the build's own path; the libraries that pass are the store's."""
    sealed = {name: _sealed(loader, name) for name in kernels.SOURCES}
    (store, key) = sealed["level"]
    (loader / store.entry(key)["blob"]).write_bytes(b"swapped")
    built = []

    def build(names):
        built.append(names)
        kernels.stats["inline_compiles"] += len(names)
        return {name: loader.parent / f"lib{name}.so" for name in names}

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", _Fake)
    mark = artifacts.stats_mark()
    handle = kernels.lib("level")
    assert built == [("level",)]
    assert handle.name == str(loader.parent / "liblevel.so")
    kernels.preload()
    assert [kernels._libs[n].name for n in ("keccak", "aes")] == [
        "keccak", "aes"]
    block = artifacts.round_block(mark)
    served = len(kernels.SOURCES) - 1
    assert (block["inline_compiles"], block["hits"]) == (1, served)
    assert (_loads("corrupt"), _loads("hit")) == (2, 2 * served)
    os.unlink(loader / artifacts.MANIFEST_NAME)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(artifacts, "_stores", {})
    kernels.lib("aes")
    assert built[1:] == [kernels.SOURCES]


# -- the CPU paths ---------------------------------------------------------

def test_cpu_service_with_a_store_armed_opens_nothing(tmp_path, monkeypatch):
    def refuse(path):
        raise AssertionError(f"a CPU service opened the store {path}")

    monkeypatch.setenv("MASTIC_ARTIFACT_DIR", str(tmp_path / "store"))
    monkeypatch.setattr(artifacts, "default_store", refuse)
    spec = service.TenantSpec(name="count",
                              spec={"class": "MasticCount", "args": [2]},
                              ctx=CTX, verify_key=VK,
                              thresholds={"default": 1})
    svc = service.CollectorService([spec], device="cpu")
    svc.add_tenant(service.TenantSpec(
        name="more", spec={"class": "MasticCount", "args": [2]}, ctx=CTX,
        verify_key=VK, thresholds={"default": 1}))
    assert not (tmp_path / "store").exists()


def _count_reports(m, alphas: list) -> list:
    rng = np.random.default_rng(3)
    scalar = m.scalar()
    out = []
    for alpha in alphas:
        (nonce, rand) = (rng.bytes(16), rng.bytes(scalar.RAND_SIZE))
        out.append((nonce,) + scalar.shard(CTX, (alpha, True), nonce, rand))
    return out


def _from_root_records(chunk_size):
    m = MasticCount(4)
    (a, b) = (hash_attribute(m, "a"), hash_attribute(m, "b"))
    records = []
    aggregate_by_attribute(m, CTX, ["a", "b"], VK, metrics_out=records,
                           device="cpu", chunk_size=chunk_size,
                           reports=_count_reports(m, [a, a, b]))
    return records


@pytest.mark.parametrize("kind", ["resident", "chunked", "from_root",
                                  "from_root_chunked"])
def test_cpu_rounds_carry_the_artifacts_block(kind, monkeypatch):
    """Every round's extra["artifacts"]: no store consulted, nothing
    built or loaded, and the port's schema accepts it."""
    monkeypatch.setattr(kernels, "stats", dict(
        inline_compiles=0, artifact_hits=0, artifact_load_ms=0.0,
        store=None))
    if kind.startswith("from_root"):
        records = _from_root_records(2 if kind.endswith("chunked") else None)
    else:
        m = MasticCount(2)
        vidpf = m.scalar().vidpf
        run = HeavyHittersRun(m, CTX, {"default": 1}, VK, device="cpu",
                              reports=_count_reports(m, [
                                  vidpf.test_index_from_int(v, 2)
                                  for v in (0, 3, 3, 1)]),
                              chunk_size=2 if kind == "chunked" else None)
        while run.step():
            pass
        records = run.metrics
    assert records
    for rec in records:
        assert rec.extra["artifacts"] == {"store": None, "hits": 0,
                                          "inline_compiles": 0,
                                          "load_ms": 0.0}
        assert validate_extra(rec.extra) == []
    if kind == "chunked":
        assert records[0].extra["chunks"]

