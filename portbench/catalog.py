"""Where the harness finds what `BENCHMARK.json` names: each by its name,
in a file of its own, so that a later change adds a configuration, a
cell or a per-layer metric by adding a file.

    portbench/configs/<config>.json      a configuration (a deployment)
    portbench/workloads/<cell>.json      a cell: its configuration, mode,
                                         traffic generator and parameters
    portbench/modes/<mode>.py            a mode's set-up, window, check
    portbench/metrics/<metric>.py        a per-layer metric's reader
"""

import importlib
import importlib.util
import json
import pathlib
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> Optional[dict]:
    """BENCHMARK.json at the checkout's root, or None."""
    path = root / "BENCHMARK.json"
    return _json(path) if path.exists() else None


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def mode(name: str):
    return importlib.import_module(f"portbench.modes.{name}")


def reader(name: str):
    """The per-layer metric's reader module (its file name holds dots,
    so it is loaded from its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readers() -> list:
    """Every per-layer metric that has a reader file."""
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                  if not p.stem.startswith("_"))


def metrics_for(bench: Optional[dict], key: str, cell_name: str,
                reported: set) -> list:
    """[(name, unit)] of `bench[key]` that the cell reports: those that
    list it under "workloads", and those without the key whose `moves`
    (per-layer) or name (end-to-end) is among `reported`."""
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append((m["name"], m["unit"]))
        elif m.get("moves", m["name"]) in reported:
            out.append((m["name"], m["unit"]))
    return out
