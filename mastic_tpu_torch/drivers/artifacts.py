"""The kernel store (port of `mastic_tpu/drivers/artifacts.py`): the
four CUDA kernel libraries, sealed into a directory that a fresh
process on the card loads without nvcc.

The JAX package stores compiled XLA round programs; the port's build
products are the four nvcc libraries of `ops/kernels.py` (keccak, aes,
level, field), generic over shape and instantiation, so the store holds one
entry per library:

* **what is stored** -- under the key (name, `kernels._digest()`,
  "sm_90a"): the `.so` bytes under ``blobs/``, their SHA-256 and size,
  the nvcc release that built them, ptxas's report, the probe seed, and
  one probe digest per exported function of `kernels.SIGNATURES`.  The
  probe digests are the plain PyTorch versions' outputs on the probe
  inputs, computed on the CPU at bake time, so a store is held against
  the reference functions, not against itself; the bake refuses to
  seal a library whose kernels disagree with them (`tools/bake.py`);

* **how loads are gated** -- in the JAX package's order: (a) the
  blob's SHA-256, checked before any `dlopen` (``corrupt``), the
  checked bytes then loaded from a sealed anonymous file of this
  process (`memfd`), so nothing can swap them between the check and
  the load; (b) the manifest's version and runtime tag, and the card's
  compute capability (9, 0), the only one `sm_90a` code runs on
  (``version_skew``); (c) a probe: every exported function of the
  loaded library launched on the card on inputs made from the probe
  seed with numpy, each output digest equal to the manifest's
  (``probe_fail``).  A key whose source digest is not this tree's is
  a ``miss``.  `dlopen` runs a library's initialisers, so the digest
  is the trust boundary, with the store directory's permissions, as
  the JAX package's digest-before-unpickle is; and a library built for
  another toolkit or card can be silently wrong, which the probe
  catches;

* **who loads** -- `ops.kernels.lib` (its memo, then this store, then
  nvcc), the collector service at boot and at tenant admission
  (`CollectorService._preload_artifacts`), and every tool through
  `MASTIC_ARTIFACT_DIR` (`tools/serve.py --artifact-dir` sets it).

Loads write nothing into the store, so parties, mesh ranks and other
processes may read one store at once.  `ctypes` cannot unload a
library: one that fails its probe stays mapped, and the inline rebuild
loads from its own path.  Each loaded library keeps its anonymous file
open for the life of the process, so no two loads share a path, which
glibc would take for one library.
"""

import ctypes
import fcntl
import hashlib
import json
import os
import platform
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..ops import kernels
from . import wal as wal_mod

ARTIFACT_VERSION = 1
MANIFEST_NAME = "manifest.json"
ARCH = "sm_90a"
CAPABILITY = (9, 0)

# Load outcomes (the mastic_artifact_loads_total label values).
HIT = "hit"
MISS = "miss"
PROBE_FAIL = "probe_fail"
VERSION_SKEW = "version_skew"
CORRUPT = "corrupt"

_PROBE_SEED = 0x6D617374  # "mast"; shared by bake and load sides
# Every exported function, in `kernels.SIGNATURES` order.
FUNCTIONS = tuple(fn for name in kernels.SOURCES
                  for fn in kernels.SIGNATURES[name])


def runtime_tag() -> str:
    """The runtime a stored library is only valid under: the CUDA
    release this process's PyTorch runs on, and the host's machine
    type (the libraries link the CUDA runtime statically and run host
    code of that machine)."""
    return f"cuda-{torch.version.cuda}-{platform.machine()}"


def device_capability() -> tuple:
    """The current card's compute capability."""
    return tuple(torch.cuda.get_device_capability())


def probe_device() -> torch.device:
    """The card a load is probed on: the current one."""
    return torch.device("cuda", torch.cuda.current_device())


def library_key(name: str) -> tuple:
    """The store key of one kernel library of this tree."""
    return (name, kernels._digest(), ARCH)


def key_name(key: Sequence) -> str:
    """Content-addressed entry name for a key."""
    canon = json.dumps([str(el) for el in key])
    return hashlib.sha256(canon.encode()).hexdigest()[:24]


# -- deterministic probe inputs ---------------------------------------

def _bytes(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _field_limbs(rng: np.random.Generator, spec, shape: tuple) -> np.ndarray:
    """In-range field elements as plain limbs, shape + (n,) int32."""
    size = spec.encoded_size
    values = [int.from_bytes(rng.bytes(size + 8), "little") % spec.modulus
              for _ in range(int(np.prod(shape)))]
    return np.stack([spec.int_to_limbs(v) for v in values]).reshape(
        shape + (spec.num_limbs,))


def _binder_case(rng: np.random.Generator, spec, value_len: int) -> dict:
    (reports, bits, width) = (5, 3, 4)
    return {
        "ws": [_field_limbs(rng, spec, (reports, bits, width, value_len))
               for _ in range(2)],
        "proofs": [_bytes(rng, (reports, bits, width, 32)) for _ in range(2)],
        "onehot_idx": rng.integers(0, bits * width, 5),
        "par": rng.integers(0, bits * width, 3),
        "left": rng.integers(0, bits * width, 3),
        "right": rng.integers(0, bits * width, 3),
        "prefix_onehot": rng.bytes(9),
        "prefix_payload": rng.bytes(9),
    }


def _level_case(rng: np.random.Generator, spec, value_len: int) -> dict:
    (reports, parents) = (37, 3)
    return {
        "value_len": value_len,
        "convert_blocks": 1 + (value_len * spec.encoded_size + 15) // 16,
        "ext_rk": _bytes(rng, (reports, 11, 16)),
        "conv_rk": _bytes(rng, (reports, 11, 16)),
        "parent_seed": _bytes(rng, (reports, parents, 16)),
        "parent_ctrl": rng.integers(0, 2, (reports, parents)).astype(bool),
        "seed_cw": _bytes(rng, (reports, 16)),
        "ctrl_cw": rng.integers(0, 2, (reports, 2)).astype(bool),
        "w_cw": _field_limbs(rng, spec, (reports, value_len)),
        "proof_cw": _bytes(rng, (reports, 32)),
        "prefix": rng.bytes(20),
        "node_binder": _bytes(rng, (2 * parents, 40)),
        "binder_len": 33,
    }


def _limb_pair(rng: np.random.Generator, spec) -> dict:
    """Two operands of raw 16-bit limbs (values >= p among them, the
    first row all ones) for the field kernel."""
    (a, b) = rng.integers(0, 1 << 16, (2, 37, 3, spec.num_limbs),
                          dtype=np.int64).astype(np.int32)
    a[0] = 0xFFFF
    return {"a": a, "b": b}


def probe_inputs(fn: str, seed: int = _PROBE_SEED) -> dict:
    """The probe inputs of one exported function, made from `seed` with
    numpy: small shapes with ragged edges (batches that are not a
    multiple of a warp or a block's messages, multi-block messages and
    squeezes, both payload fields)."""
    from ..ops.field import FIELD64, FIELD128

    rng = np.random.default_rng([seed, FUNCTIONS.index(fn)])
    if fn == "keccak_permute":
        words = rng.integers(-2 ** 31, 2 ** 31, (2, 67, 25), dtype=np.int64)
        return {"lo": words[0].astype(np.int32),
                "hi": words[1].astype(np.int32)}
    if fn == "turboshake":
        return {"msg": _bytes(rng, (37, 400)), "prefix": rng.bytes(13)}
    if fn == "binder_sponge":
        return {"f64": _binder_case(rng, FIELD64, 2),
                "f128": _binder_case(rng, FIELD128, 1)}
    if fn == "fixed_key_blocks":
        return {"keys": _bytes(rng, (37, 16)), "seeds": _bytes(rng, (37, 3, 16)),
                "num_blocks": 4}
    if fn == "aes_bitsliced":
        return {"keys": _bytes(rng, (64, 16)), "blocks": _bytes(rng, (64, 3, 16))}
    if fn == "level_step":
        return {"f64": _level_case(rng, FIELD64, 2),
                "f128": _level_case(rng, FIELD128, 1)}
    if fn == "field_op":
        return {key: _limb_pair(rng, spec) for (key, spec) in (
            ("f64", FIELD64), ("f128", FIELD128))}
    raise KeyError(fn)


def probe_outputs(fn: str, inputs: dict, device) -> list:
    """One exported function's outputs on its probe inputs, through the
    public wrapper that launches it: its kernel on a CUDA device, its
    plain version on the CPU."""
    from ..backend.xof import fixed_key_blocks
    from ..ops.aes import (aes128_encrypt_bitsliced, aes128_key_schedule,
                           bitslice_keys, bitslice_pack)
    from ..ops.binder import binder_checks
    from ..ops.field import FIELD64, FIELD128
    from ..ops.keccak import keccak_p1600, turbo_shake128_dynamic
    from ..ops.level import level_step

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if fn == "keccak_permute":
        (lo, hi) = (t(inputs["lo"]), t(inputs["hi"]))
        return [*keccak_p1600(lo, hi, 12), *keccak_p1600(lo, hi, 24)]
    if fn == "turboshake":
        msg = t(inputs["msg"])
        return [turbo_shake128_dynamic(msg, 333, 1, 200,
                                       prefix=inputs["prefix"]),
                turbo_shake128_dynamic(msg, 400, 2, 32)]
    if fn == "binder_sponge":
        out = []
        for (spec, case) in ((FIELD64, inputs["f64"]),
                             (FIELD128, inputs["f128"])):
            out.extend(binder_checks(
                spec, tuple(t(w) for w in case["ws"]),
                tuple(t(p) for p in case["proofs"]),
                *(t(case[k]) for k in ("onehot_idx", "par", "left", "right")),
                case["prefix_onehot"], case["prefix_payload"]))
        return out
    if fn == "fixed_key_blocks":
        rk = aes128_key_schedule(torch.from_numpy(inputs["keys"]))
        return [fixed_key_blocks(rk.to(device), t(inputs["seeds"]),
                                 inputs["num_blocks"])]
    if fn == "aes_bitsliced":
        rk = aes128_key_schedule(torch.from_numpy(inputs["keys"]))
        key_planes = bitslice_keys(rk).contiguous().to(device)
        planes = bitslice_pack(torch.from_numpy(inputs["blocks"]))
        return [aes128_encrypt_bitsliced(key_planes,
                                         planes.contiguous().to(device))]
    if fn == "level_step":
        out = []
        for (spec, case) in ((FIELD64, inputs["f64"]),
                             (FIELD128, inputs["f128"])):
            cw = tuple(t(case[k]) for k in ("seed_cw", "ctrl_cw", "w_cw",
                                            "proof_cw"))
            out.extend(level_step(
                spec, case["convert_blocks"], case["value_len"],
                t(case["ext_rk"]), t(case["conv_rk"]), t(case["parent_seed"]),
                t(case["parent_ctrl"]), cw, case["prefix"],
                t(case["node_binder"]), case["binder_len"]))
        return out
    if fn == "field_op":
        out = []
        for (spec, case) in ((FIELD64, inputs["f64"]),
                             (FIELD128, inputs["f128"])):
            (a, b) = (t(case["a"]), t(case["b"]))
            out.extend([spec.add(a, b), spec.sub(a[:, :1], b),
                        spec.mul(a, b), spec.to_mont(a[1:]),
                        spec.neg(b[:, 0::2])])
        return out
    raise KeyError(fn)


def probe_digest(fn: str, device, seed: int = _PROBE_SEED) -> str:
    """SHA-256 over one exported function's probe outputs (shapes,
    types and bytes): on the CPU the plain versions' at bake time, on
    the card the loaded kernels' at load time; the two must be equal."""
    h = hashlib.sha256()
    for out in probe_outputs(fn, probe_inputs(fn, seed), device):
        out = out.detach().cpu().contiguous()
        h.update(f"{tuple(out.shape)} {out.dtype}".encode())
        h.update(out.numpy().tobytes())
    return h.hexdigest()


def _dlopen_private(payload: bytes, name: str) -> ctypes.CDLL:
    """Load checked library bytes from a sealed anonymous file of this
    process.  The file stays open (and its path unique) for as long as
    the process lives, as the mapping does."""
    fd = os.memfd_create(f"mastic-{name}",
                         os.MFD_CLOEXEC | os.MFD_ALLOW_SEALING)
    view = memoryview(payload)
    while view:
        view = view[os.write(fd, view):]
    fcntl.fcntl(fd, fcntl.F_ADD_SEALS,
                fcntl.F_SEAL_SHRINK | fcntl.F_SEAL_GROW
                | fcntl.F_SEAL_WRITE | fcntl.F_SEAL_SEAL)
    try:
        return ctypes.CDLL(f"/proc/self/fd/{fd}")
    except OSError:
        os.close(fd)
        raise


# -- the store --------------------------------------------------------

class ArtifactStore:
    """A directory of digest-sealed kernel libraries.

    Layout: ``manifest.json`` plus one blob per entry under ``blobs/``.
    Loaded-and-probed libraries are memoized, and so are failed loads
    (the negative memo): a process tries each entry once.  Single-
    threaded by design, like the scheduler that owns it."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._loaded: dict = {}     # name -> probed library handle
        self._failed: dict = {}     # name -> outcome (negative memo)
        # Per library: this process's load (read, digest, dlopen) and
        # probe times, milliseconds.
        self.timings: dict = {}
        self.outcome_counts: dict = {}
        self.manifest = self._read_manifest()

    def _read_manifest(self) -> dict:
        try:
            with open(os.path.join(self.path, MANIFEST_NAME)) as fh:
                man = json.load(fh)
        except (OSError, ValueError):
            return {"version": ARTIFACT_VERSION, "runtime": runtime_tag(),
                    "entries": {}}
        if not isinstance(man.get("entries"), dict):
            man["entries"] = {}
        return man

    def _write_manifest(self) -> None:
        # Crash-safe: tmp -> fsync(file) -> atomic rename -> fsync(dir).
        os.makedirs(self.path, exist_ok=True)
        tmp = os.path.join(self.path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(self.manifest, fh, indent=1, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))
        wal_mod.fsync_dir(self.path)

    def entry(self, key) -> Optional[dict]:
        return self.manifest["entries"].get(key_name(key))

    def entry_count(self) -> int:
        return len(self.manifest["entries"])

    def store_bytes(self) -> int:
        return sum(int(e.get("bytes", 0))
                   for e in self.manifest["entries"].values())

    # -- save (bake side) ------------------------------------------

    def save(self, key, blob: bytes, probe: dict, nvcc: str = "",
             ptxas: str = "", handle: Optional[ctypes.CDLL] = None) -> dict:
        """Seal one library: its bytes behind a SHA-256 digest, and the
        plain versions' probe digest of each exported function as the
        load-time reference.  `handle`, the baked library as this
        process loaded and probed it, is memoized."""
        name = key_name(key)
        entry = {
            "key": [str(el) for el in key],
            "blob": f"blobs/{name}.so",
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
            "nvcc": nvcc,
            "ptxas": ptxas,
            "probe_seed": _PROBE_SEED,
            "probe": dict(probe),
        }
        os.makedirs(os.path.join(self.path, "blobs"), exist_ok=True)
        # The blob is durable before the manifest names it: an entry
        # pointing at unsynced bytes would fail its digest after a crash.
        blob_path = os.path.join(self.path, entry["blob"])
        with open(blob_path, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        wal_mod.fsync_dir(os.path.dirname(blob_path))
        self.manifest["version"] = ARTIFACT_VERSION
        self.manifest["runtime"] = runtime_tag()
        self.manifest["entries"][name] = entry
        self._write_manifest()
        if handle is not None:
            self._loaded[name] = handle
        return entry

    # -- load (serve side) -----------------------------------------

    def _gated_load(self, entry: dict) -> tuple:
        """(handle | None, outcome) through the three gates; no
        memoization, no counting: `load` owns those."""
        lib = entry["key"][0]
        t0 = time.perf_counter()
        try:
            with open(os.path.join(self.path, entry["blob"]), "rb") as f:
                payload = f.read()
        except OSError:
            return (None, CORRUPT)
        # Gate (a): the digest, before anything is loaded.
        if hashlib.sha256(payload).hexdigest() != entry["sha256"]:
            return (None, CORRUPT)
        # Gate (b): the runtime and the card.
        if self.manifest.get("version") != ARTIFACT_VERSION \
                or self.manifest.get("runtime") != runtime_tag() \
                or device_capability() != CAPABILITY:
            return (None, VERSION_SKEW)
        try:
            handle = kernels.bind(_dlopen_private(payload, lib), lib)
        except (OSError, AttributeError):
            return (None, CORRUPT)
        t1 = time.perf_counter()
        # Gate (c): the probe, every exported function against the plain
        # versions' digests.  A kernel that raises fails it too.
        device = probe_device()
        seed = int(entry.get("probe_seed", _PROBE_SEED))
        ok = True
        with kernels.serving(lib, handle):
            for fn in kernels.SIGNATURES[lib]:
                try:
                    digest = probe_digest(fn, device, seed)
                except Exception:  # any failure of the candidate
                    ok = False
                    break
                if digest != entry["probe"].get(fn):
                    ok = False
                    break
        self.timings[lib] = {"load_ms": (t1 - t0) * 1e3,
                             "probe_ms": (time.perf_counter() - t1) * 1e3}
        return (handle, HIT) if ok else (None, PROBE_FAIL)

    def load(self, key) -> Optional[ctypes.CDLL]:
        """The gated load: the probed library, or None (the caller
        builds inline).  Every call lands one observation in
        `mastic_artifact_loads_total{outcome=...}` and one
        ``artifact.load`` span with the store path and key."""
        name = key_name(key)
        with obs_trace.get_tracer().span(
                "artifact.load", store=self.path,
                key="/".join(str(k) for k in key)) as span:
            if name in self._loaded:
                (handle, outcome) = (self._loaded[name], HIT)
            elif name in self._failed:
                (handle, outcome) = (None, self._failed[name])
            else:
                entry = self.manifest["entries"].get(name)
                if entry is None:
                    (handle, outcome) = (None, MISS)
                else:
                    (handle, outcome) = self._gated_load(entry)
                    if handle is not None:
                        self._loaded[name] = handle
                    else:
                        self._failed[name] = outcome
            span.set(outcome=outcome)
        get_registry().counter("mastic_artifact_loads_total",
                               outcome=outcome).inc()
        self.outcome_counts[outcome] = self.outcome_counts.get(outcome, 0) + 1
        return handle

    def outcome(self, key) -> str:
        """What a load of `key` gives in this process now."""
        name = key_name(key)
        if name in self._loaded:
            return HIT
        return self._failed.get(name, MISS)

    def preload(self, keys: Optional[Sequence] = None) -> dict:
        """Load (and probe) `keys`, by default this tree's three
        libraries: service boot and tenant admission call this, so no
        round pays the load.  Returns outcome counts."""
        counts: dict = {}
        for key in keys if keys is not None else [
                library_key(n) for n in kernels.SOURCES]:
            self.load(key)
            outcome = self.outcome(key)
            counts[outcome] = counts.get(outcome, 0) + 1
        return counts


# -- process-wide store registry --------------------------------------

_stores: dict = {}


def default_store(path: str) -> ArtifactStore:
    """One shared ArtifactStore per path: its memo of loaded libraries
    is the process's."""
    path = os.path.abspath(path)
    store = _stores.get(path)
    if store is None:
        store = ArtifactStore(path)
        _stores[path] = store
    return store


def store_from_env() -> Optional[ArtifactStore]:
    """The `MASTIC_ARTIFACT_DIR` lever, read per call (a long-lived
    process can be pointed at a store without restarting)."""
    path = os.environ.get("MASTIC_ARTIFACT_DIR", "").strip()
    return default_store(path) if path else None


# -- the per-round block ----------------------------------------------

def stats_mark() -> dict:
    """`ops.kernels.stats` at a round's start."""
    return dict(kernels.stats)


def round_block(mark: dict) -> dict:
    """The round's `extra["artifacts"]` block (obs/schema.py): the store
    the libraries came from (None while no store was consulted), and
    the store hits, inline nvcc builds and load time since `mark`."""
    s = kernels.stats
    return {"store": s["store"],
            "hits": s["artifact_hits"] - mark["artifact_hits"],
            "inline_compiles": s["inline_compiles"] - mark["inline_compiles"],
            "load_ms": round(s["artifact_load_ms"]
                             - mark["artifact_load_ms"], 2)}


def process_summary() -> dict:
    """This process's kernel loading, for a tool's output line: the
    stats, and once a store was consulted its outcome counts and
    per-library load and probe times."""
    out = {k: (round(v, 3) if isinstance(v, float) else v)
           for (k, v) in kernels.stats.items()}
    store = _stores.get(kernels.stats["store"])
    if store is not None:
        out["outcomes"] = dict(store.outcome_counts)
        out["timings"] = {lib: {k: round(v, 3) for (k, v) in t.items()}
                          for (lib, t) in store.timings.items()}
    return out
