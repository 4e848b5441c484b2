"""The PyTorch port's boundaries: import hygiene (no jax, nothing of
mastic_tpu), devices (CUDA by default, no silent CPU fallback), and the
kernel wrappers' CPU routing and argument checks."""

import ast
import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mastic_tpu_torch
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
from mastic_tpu_torch.backend.xof import fixed_key_blocks
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
from mastic_tpu_torch.ops import kernels, level
from mastic_tpu_torch.ops.field import FIELD128
from mastic_tpu_torch.ops.keccak import turbo_shake128

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import mastic_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mastic_tpu_torch.__path__,
                                               "mastic_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "mastic_tpu" or m.startswith("mastic_tpu.")]
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_mastic_tpu():
    """In a fresh interpreter (this session has jax loaded): importing
    every module of the port loads neither jax nor mastic_tpu."""
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(None, 1)
    assert int(out[0]) >= 20
    assert out[1].strip() == "[]"


def test_every_module_imports_here():
    names = [m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "mastic_tpu_torch.ops.level" in names
    assert "mastic_tpu_torch.scalar.mastic" in names


def _imported_roots(path: pathlib.Path) -> set:
    """The top-level packages a module imports absolutely."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_scalar_layer_is_a_standard_library_copy():
    """Every module of `mastic_tpu_torch.scalar` is a copy of the JAX
    package's module of the same name, says so first in its docstring,
    is reached by the package walk (so the import probe above covers
    it), and imports nothing but the standard library and the scalar
    layer itself."""
    pkg = REPO / "mastic_tpu_torch"
    names = {m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")}
    files = sorted((pkg / "scalar").rglob("*.py"))
    assert len(files) == 13
    for path in files:
        rel = path.relative_to(pkg / "scalar")
        name = ".".join(("mastic_tpu_torch",)
                        + path.relative_to(pkg).with_suffix("").parts)
        assert name.removesuffix(".__init__") in names
        roots = _imported_roots(path)
        assert roots <= set(sys.stdlib_module_names), (rel, roots)
        if rel != pathlib.Path("__init__.py"):
            assert (REPO / "mastic_tpu" / rel).exists(), rel
            doc = ast.get_docstring(ast.parse(path.read_text()))
            assert doc.startswith(f"Copy of `mastic_tpu/{rel.as_posix()}`")


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mastic_tpu_torch.resolve_device("cuda")
    bm = BatchedMastic(MasticCount(4))
    with pytest.raises(RuntimeError):
        bm.encode_measurements([((True,) * 4, 1)])
    assert mastic_tpu_torch.resolve_device("cpu").type == "cpu"


def test_run_defaults_to_cuda(monkeypatch):
    """HeavyHittersRun's device defaults to "cuda": a CPU batch is
    refused rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    bm = BatchedMastic(MasticCount(4))
    (alphas, betas) = bm.encode_measurements([((True,) * 4, 1)] * 2, "cpu")
    rng = np.random.default_rng(0)
    nonces = torch.from_numpy(rng.integers(0, 256, (2, 16), dtype=np.uint8))
    rand = torch.from_numpy(rng.integers(0, 256, (2, 96), dtype=np.uint8))
    (batch, _ok) = bm.shard_device(b"ctx", alphas, betas, nonces, rand)
    with pytest.raises(ValueError, match="not on cuda"):
        HeavyHittersRun(MasticCount(4), b"ctx", {"default": 1}, bytes(32),
                        batch)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: nothing is built or counted."""
    before = dict(kernels.launches)
    out = turbo_shake128(torch.zeros((3, 10), dtype=torch.uint8), 1, 32)
    assert out.shape == (3, 32)
    assert kernels.launches == before


def test_kernel_argument_checks():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda(t, torch.int32, "x")
    with pytest.raises(ValueError, match="binder_len"):
        level.level_step(None, 2, 2, None, None, None, None, None,
                         bytes(28), torch.zeros((2, 4), dtype=torch.uint8),
                         6)
    # Any payload length is served (the TPU kernel's 8-block limit is
    # gone); the block count must match the payload.
    with pytest.raises(ValueError, match="convert_blocks"):
        level.level_step(FIELD128, 10, 10, None, None, None, None, None,
                         bytes(28), torch.zeros((2, 4), dtype=torch.uint8),
                         4)


def test_kernel_build_is_keyed_by_every_source():
    """The build directory sits under build/ (listed in .gitignore) and
    its name changes with any source or header."""
    assert kernels.BUILD_ROOT == REPO / "build" / "kernels"
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").exists()
    for name in kernels.HEADERS:
        assert (kernels.CSRC / name).exists()
    assert len(kernels._digest()) == 16
    assert "/build/" in (REPO / ".gitignore").read_text().split()


def test_kernel_build_hash_covers_every_include():
    """Every header a kernel source includes is hashed into the build
    directory's name, so a new, moved or edited header cannot leave a
    stale library in use."""
    included = set()
    for path in kernels.CSRC.iterdir():
        if path.suffix in (".cu", ".cuh"):
            included.update(re.findall(r'#include "([^"]+)"',
                                       path.read_text()))
    assert included and included <= set(kernels.HEADERS)


def test_fixed_key_blocks_argument_checks():
    """K2's fixed-key wrapper refuses shapes the kernel cannot take and
    routes a CPU tensor to its plain version without a launch."""
    rk = torch.zeros((4, 11, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="round keys"):
        fixed_key_blocks(rk, torch.zeros((3, 2, 16), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="round keys"):
        fixed_key_blocks(rk[:, :10], torch.zeros((4, 2, 16),
                                                 dtype=torch.uint8), 2)
    before = dict(kernels.launches)
    out = fixed_key_blocks(rk, torch.zeros((4, 16), dtype=torch.uint8), 3)
    assert out.shape == (4, 48)
    assert kernels.launches == before


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    sys.path.insert(0, str(REPO))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    assert smoke.main() == 2
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name", ["mastic_tpu_torch.drivers.chunked",
                                  "mastic_tpu_torch.drivers.pipeline"])
def test_chunked_modules_import_no_jax(name):
    """The chunked runner and the executor are reached by the package
    walk (so the probe above covers them) and, in a fresh interpreter,
    load neither jax nor mastic_tpu."""
    names = [m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")]
    assert name in names
    probe = (f"import sys, {name}\n"
             "print([m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'mastic_tpu')])")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


_PARTY_PROBE = """
import sys
import {name}
{run}
print([m for m in sys.modules if m.split('.')[0] in ('jax', 'mastic_tpu')])
"""


@pytest.mark.parametrize("name,run", [
    # What a spawned party process imports (`python -m
    # mastic_tpu_torch.drivers.parties`), up to its engine.
    ("mastic_tpu_torch.drivers.parties",
     "from mastic_tpu_torch.drivers.parties import instantiate\n"
     "instantiate({'class': 'MasticCount', 'args': [2]}).scalar()"),
    ("mastic_tpu_torch.net.transport", ""),
    # A network party (`python -m mastic_tpu_torch.tools.party`) imports
    # the session layer and the rest of its serve loop when it starts.
    ("mastic_tpu_torch.tools.party",
     "import mastic_tpu_torch.drivers.session, "
     "mastic_tpu_torch.drivers.faults, mastic_tpu_torch.obs.trace, "
     "mastic_tpu_torch.tools.certs, "
     "mastic_tpu_torch.drivers.communication"),
])
def test_party_layer_imports_no_jax(name, run):
    """The party layer's entry modules are reached by the package walk
    (so the probe above covers them) and, in a fresh interpreter as a
    party process starts, load neither jax nor mastic_tpu."""
    names = [m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")]
    assert name in names
    out = subprocess.run(
        [sys.executable, "-c", _PARTY_PROBE.format(name=name, run=run)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True).stdout
    assert out.strip() == "[]"


SERVICE_MODULES = ["drivers.service", "drivers.wal", "net.ingest",
                   "net.admission", "net.loadgen", "obs.schema",
                   "obs.devtime", "obs.statusz", "tools.serve",
                   "tools.loadgen"]


@pytest.mark.parametrize("name", SERVICE_MODULES)
def test_service_layer_is_in_the_package_walk(name):
    """Each module of the service layer is reached by the package walk,
    so the probe of the whole package covers it."""
    names = [m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")]
    assert f"mastic_tpu_torch.{name}" in names


NEW_MODULES = ["oracle", "gen_test_vec", "tools.northstar"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_north_star_modules_are_in_the_package_walk(name):
    """The oracle, the test-vector generator and the north-star tool are
    reached by the package walk, so the probe of the whole package
    covers them."""
    names = [m.name for m in pkgutil.walk_packages(
        mastic_tpu_torch.__path__, "mastic_tpu_torch.")]
    assert f"mastic_tpu_torch.{name}" in names


def test_north_star_modules_import_no_jax():
    """In a fresh interpreter, the oracle, the generator (rendering a
    vector) and the north-star tool (parsing its arguments and drawing
    its reports) load neither jax nor mastic_tpu."""
    probe = "\n".join(
        ["import sys"]
        + [f"import mastic_tpu_torch.{n}" for n in NEW_MODULES]
        + ["from mastic_tpu_torch import gen_test_vec as g",
           "(_, m, a, ms) = g.all_test_vecs()[0]",
           "g.render_test_vec(g.gen_test_vec(m, a, b'c', ms))",
           "from mastic_tpu_torch.tools import northstar as ns",
           "ns.synthetic_reports(ns.parse_args(['--reports', '8']))",
           "print([m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'mastic_tpu')])"])
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_service_layer_imports_no_jax():
    """In a fresh interpreter, the service layer (the service, the WAL,
    the upload front, the observability modules and both tools) loads
    neither jax nor mastic_tpu, and neither does building a service on
    the CPU."""
    probe = "\n".join(
        ["import sys"]
        + [f"import mastic_tpu_torch.{n}" for n in SERVICE_MODULES]
        + ["from mastic_tpu_torch.drivers import service as s",
           "s.CollectorService([s.TenantSpec('t', {'class': 'MasticCount', "
           "'args': [2]}, b'c', bytes(32), thresholds={'default': 1})], "
           "s.ServiceConfig(), device='cpu').metrics()",
           "print([m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'mastic_tpu')])"])
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"
