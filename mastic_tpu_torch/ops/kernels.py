"""Build, load and count the hand-written CUDA kernels.

Each source in `csrc/` that holds kernels (`keccak.cu`, `aes.cu`,
`level.cu`, `field.cu`) compiles on its own into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

All four nvcc processes start together at the first use of any
kernel, into `build/kernels/<hash>/` at the repository root, where
<hash> covers every source, header and flag, so an edited source
rebuilds and an unchanged one is reused.  ptxas's register, spill and
shared-memory report lands beside each library as `<name>.ptxas.txt`.
The libraries are loaded with ctypes; every pointer and the stream
cross as `c_void_p` (the wrappers pass `tensor.data_ptr()` and
`torch.cuda.current_stream().cuda_stream`).

With a kernel store armed (`MASTIC_ARTIFACT_DIR`, `drivers/artifacts.py`)
`lib` looks for a library in this process's memo first, then in the
store, whose three gates (digest before `dlopen`, runtime, probe against
the plain versions) every library passes before it serves, and only
then builds with nvcc.  A failed gate builds inline and is counted;
with no nvcc it raises, naming the gate's outcome: nothing falls back
to the plain versions.  nvcc is looked for on PATH, then under
`$CUDA_HOME/bin` (default /usr/local/cuda).  `stats` keeps the JAX
`ProgramCache`'s keys: `inline_compiles` (libraries nvcc built in this
process), `artifact_hits` and `artifact_load_ms` (libraries the store
served, and the time their loads took), and `store` (the path of the
store `lib` consulted, None while none was).

`launches` counts, per kernel, the launches its wrappers made: each
wrapper adds one where it launches, and nowhere else.  K1's binder
sponge counts under its own keys, "keccak_binder" on Field64 carries
and "keccak_binder_f128" on Field128 ones; "keccak" counts the in-place
sponge and "keccak_permute" the bare permutation.  K2's fixed-key entry
(the one `fixed_key_blocks` launches) counts as "aes", its planes entry
as "aes_planes".  K3 counts as "level" on Field64 payloads and
"level_f128" on Field128 ones.  The field kernel counts as "field" on
Field64 limbs and "field_f128" on Field128 ones.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("keccak", "aes", "level", "field")
# Every header in csrc/, so that a new or renamed one changes the hash.
HEADERS = tuple(sorted(path.name for path in CSRC.glob("*.cuh")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every exported launch function (all return the
# cudaError_t of the launch as an int).
SIGNATURES = {
    "keccak": {
        "keccak_permute": (_P, _P, _P, _P, _I, _I, _P),
        "turboshake": (_P, _I, _I, _P, _L, _I, _I, _P, _I, _I, _P),
        "binder_sponge": (_P, _P, _P, _P, _L, _I, _I, _P, _L, _P, _P, _P,
                          _L, _P, _P, _I, _P, _I, _I, _P),
    },
    "aes": {
        "fixed_key_blocks": (_P, _P, _L, _L, _P, _I, _I, _I, _P),
        "aes_bitsliced": (_P, _P, _P, _I, _I, _P),
    },
    "level": {
        "level_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                       _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "field": {
        "field_op": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
}

launches = {name: 0 for name in SOURCES + ("keccak_permute", "keccak_binder",
                                           "aes_planes", "keccak_binder_f128",
                                           "level_f128", "field_f128")}
build_info: dict = {}
stats = {"inline_compiles": 0, "artifact_hits": 0, "artifact_load_ms": 0.0,
         "store": None}
_libs: dict = {}
_load_lock = threading.RLock()
# Libraries on probe (`serving`), per thread: they serve only the probing
# thread's launches, and those launches are not counted.
_probing = threading.local()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for name in HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(names: tuple = SOURCES, root: pathlib.Path = None) -> dict:
    """Build each library of `names` that is not built yet under `root`
    (default BUILD_ROOT), one nvcc per source, all in parallel.  Returns
    {name: path of the .so}."""
    out_dir = (root or BUILD_ROOT) / _digest()
    paths = {name: out_dir / f"lib{name}.so" for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    failed = []
    for (name, (proc, tmp)) in procs.items():
        (log, _) = proc.communicate()
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, paths[name])
    stats["inline_compiles"] += len(todo) - len(failed)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    build_info["dir"] = str(out_dir)
    return paths


def bind(handle: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C signature of every exported function of library
    `name` on a loaded handle (AttributeError if one is missing)."""
    for (fn, argtypes) in SIGNATURES[name].items():
        getattr(handle, fn).argtypes = list(argtypes)
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source: this process's memo,
    else the armed kernel store's, else built with nvcc."""
    handle = getattr(_probing, "libs", {}).get(name)
    if handle is None:
        handle = _libs.get(name)
    if handle is not None:
        return handle
    with _load_lock:
        if name not in _libs:
            _libs[name] = _load(name)
        return _libs[name]


def preload() -> None:
    """Load every library now, as `lib` does, so that no launch pays
    for it."""
    for name in SOURCES:
        lib(name)


def _load(name: str) -> ctypes.CDLL:
    from ..drivers import artifacts

    store = artifacts.store_from_env()
    (outcome, names) = (None, SOURCES)
    if store is not None:
        stats["store"] = store.path
        key = artifacts.library_key(name)
        t0 = time.perf_counter()
        handle = store.load(key)
        if handle is not None:
            stats["artifact_hits"] += 1
            stats["artifact_load_ms"] += (time.perf_counter() - t0) * 1e3
            return handle
        outcome = store.outcome(key)
        # Every library's gates, so that one nvcc run builds all that
        # failed them and none that the store serves.
        store.preload()
        names = tuple(n for n in SOURCES if n not in _libs and store.outcome(
            artifacts.library_key(n)) != artifacts.HIT)
    try:
        path = build(names)[name]
    except RuntimeError as exc:
        if outcome is None:
            raise
        raise RuntimeError(
            f"kernel library {name}: the store {store.path} gave "
            f"{outcome!r} and the library cannot be built here: {exc}"
        ) from exc
    return bind(ctypes.CDLL(str(path)), name)


@contextlib.contextmanager
def serving(name: str, handle: ctypes.CDLL):
    """Serve `handle` as library `name` to this thread's launches inside
    the block, uncounted: how a library is probed before it is trusted."""
    probing = getattr(_probing, "libs", None)
    if probing is None:
        probing = _probing.libs = {}
    probing[name] = handle
    try:
        yield
    finally:
        del probing[name]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, fn: str, *args, counter: str = "") -> None:
    """Call one exported launch function, raise on a refused launch,
    and count it under `counter` (by default the kernel's name)."""
    err = getattr(lib(name), fn)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch {name}.{fn} failed: error {err}")
    if name not in getattr(_probing, "libs", {}):
        launches[counter or name] += 1


@functools.lru_cache(maxsize=1024)
def const_bytes(data: bytes, device: torch.device) -> torch.Tensor:
    """A constant byte string (a dst prefix) as a uint8 tensor on the
    card, uploaded once: a copy from pageable host memory would wait
    for the stream at every launch.  Kernels only read it."""
    return torch.tensor(list(data), dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=1024)
def const_array(data: bytes, dtype: str, shape: tuple,
                device: torch.device) -> torch.Tensor:
    """A constant numpy array (its bytes, dtype and shape) on `device`,
    uploaded once, as `const_bytes`: index maps and the field kernel's
    host operands.  Callers only read it."""
    return torch.from_numpy(np.frombuffer(data, dtype).reshape(
        shape).copy()).to(device)


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Wrapper-side validation of one kernel argument."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
