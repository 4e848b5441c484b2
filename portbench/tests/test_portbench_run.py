"""The run's contract on the CPU: no card, no result; the last line's
keys; nothing of JAX or the JAX package loaded; the reference imports
nothing of the program."""

import json
import subprocess
import sys

from portbench import catalog
from portbench.tests.tiny import run_tiny

ROOT = str(catalog.ROOT)


def test_cli_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "histogram64.a16_r100000", "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 3
    assert out.stdout == ""


def test_last_line_keys():
    line = run_tiny("attr", trace=True)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}


def test_imports_hold_no_jax():
    """A tiny run in a fresh process, then its module graph: no module
    whose top-level name is jax, jaxlib, flax or mastic_tpu (compared
    whole: mastic_tpu_torch is the program)."""
    code = (
        "import sys\n"
        "from portbench.tests.tiny import run_tiny\n"
        "from portbench import run, control, catalog\n"
        "for m in catalog.readers(): catalog.reader(m)\n"
        "run_tiny('hh', seconds=0.2)\n"
        "print(run.forbidden_modules(), 'mastic_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.heavy_hitters\n"
            "import portbench.reference.attributes\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('mastic_tpu', 'mastic_tpu_torch', 'torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
