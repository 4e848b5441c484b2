"""Kernel-store baker (port of `tools/bake.py`; run as `python -m
mastic_tpu_torch.tools.bake`): build the four kernel libraries with
nvcc, hold every exported function against its plain version on the
card, and seal them into a kernel store (`drivers/artifacts.py`) that a
process on a machine without nvcc loads.

    # bake on a machine with the CUDA toolkit and a card:
    python -m mastic_tpu_torch.tools.bake --out build/store

    # serve from it anywhere with the same card, runtime and tree:
    python -m mastic_tpu_torch.tools.serve --artifact-dir build/store
    # (or MASTIC_ARTIFACT_DIR=build/store for any tool or driver)

The libraries are built in a temporary build root, so a bake never
reuses a build directory.  Each library's probe digests are its plain
versions' outputs on the probe inputs, computed on the CPU; the bake
refuses to seal a library whose kernels give other bytes on the card.

``--smoke`` is the store's end-to-end gate: bake into a temporary
store, then run the serve tool's default scenario as fresh children,
each from a temporary copy of the package (no `build/kernels/` to
reuse): (i) without a store, so nvcc runs inline; (ii) the same copy
again, reusing the build directory (i) left, which has no gates; (iii)
with `--artifact-dir` and nvcc taken off PATH and out of CUDA_HOME.
It asserts (iii) made no inline build and four store hits, that no
round of (iii) reports an inline build, and that (iii)'s results and
per-round counters equal (i)'s, and prints each child's time from its
spawn to the end of its first round.

Like every tool of the port, the bake runs on the card and exits
non-zero without one.
"""

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def fail(msg: str) -> None:
    print(f"bake: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvcc_release(nvcc: str) -> str:
    """The release line of `nvcc --version`."""
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return (lines or out.splitlines() or [""])[-1].strip()


def bake(out: str, device) -> dict:
    """Build, check and seal the four libraries into the store at
    `out`.  Returns the bake's record."""
    from mastic_tpu_torch.drivers import artifacts
    from mastic_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    store = artifacts.default_store(out)
    release = nvcc_release(kernels._nvcc())
    libraries = {}
    with tempfile.TemporaryDirectory(prefix="mastic_bake_") as root:
        t0 = time.perf_counter()
        paths = kernels.build(kernels.SOURCES, root=pathlib.Path(root))
        build_s = time.perf_counter() - t0
        for name in kernels.SOURCES:
            path = paths[name]
            handle = kernels.bind(ctypes.CDLL(str(path)), name)
            t0 = time.perf_counter()
            expect = {fn: artifacts.probe_digest(fn, "cpu")
                      for fn in kernels.SIGNATURES[name]}
            t1 = time.perf_counter()
            with kernels.serving(name, handle):
                got = {fn: artifacts.probe_digest(fn, device)
                       for fn in kernels.SIGNATURES[name]}
            t2 = time.perf_counter()
            bad = sorted(fn for fn in expect if got[fn] != expect[fn])
            if bad:
                raise RuntimeError(
                    f"refusing to seal lib{name}.so: {bad} disagree with "
                    f"their plain versions on the probe inputs")
            ptxas = (path.parent / f"{name}.ptxas.txt").read_text()
            entry = store.save(artifacts.library_key(name), path.read_bytes(),
                               expect, nvcc=release, ptxas=ptxas,
                               handle=handle)
            libraries[name] = {"bytes": entry["bytes"],
                               "sha256": entry["sha256"],
                               "plain_probe_s": round(t1 - t0, 3),
                               "kernel_probe_s": round(t2 - t1, 3)}
    return {"mode": "bake", "store": store.path,
            "runtime": artifacts.runtime_tag(), "nvcc": release,
            "key": list(artifacts.library_key("keccak")[1:]),
            "entries": store.entry_count(),
            "store_bytes": store.store_bytes(), "libraries": libraries,
            "build_seconds": round(build_s, 3),
            "wall_seconds": round(time.perf_counter() - t_start, 3)}


# -- fresh serve children ---------------------------------------------

def package_copy(dest: str) -> str:
    """A copy of the package under `dest` (no build directory, no
    bytecode); returns the root a child runs from."""
    shutil.copytree(PACKAGE, os.path.join(dest, PACKAGE.name),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def child_env(hide_nvcc: bool = False, **extra) -> dict:
    """The environment of a fresh child: no MASTIC_* setting (no store,
    no faults, no trace file) and no path into this checkout, then
    `extra`; with `hide_nvcc`, no nvcc on PATH or under CUDA_HOME."""
    env = {k: v for (k, v) in os.environ.items()
           if not k.startswith("MASTIC_") and k != "PYTHONPATH"}
    if hide_nvcc:
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        env["CUDA_HOME"] = os.path.join(tempfile.gettempdir(),
                                        "mastic-no-cuda-toolkit")
    env.update(extra)
    return env


def serve_child(root: str, args: list, env: dict, timeout: float = 600.0,
                check: bool = True) -> dict:
    """Run `tools.serve` from the package copy at `root`.  Returns its
    JSON line (with `first_round_s`, from the spawn to the end of its
    first round, and `rc`); with `check`, raises on a failed child."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "mastic_tpu_torch.tools.serve", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else {}
    if check and (proc.returncode != 0 or out.get("ok") is not True):
        raise RuntimeError(f"serve child {args} rc={proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    out["rc"] = proc.returncode
    out["stderr_tail"] = proc.stderr[-3000:]
    if out.get("first_round_at") is not None:
        out["first_round_s"] = out["first_round_at"] - t0
    return out


def epoch_inline_compiles(out: dict) -> list:
    """Each epoch record's sum of its rounds' inline builds."""
    return [rec.get("inline_compiles", 0)
            for t in out["metrics"]["tenants"].values()
            for rec in t["epochs"]]


def compare_children(ref: dict, got: dict, what: str) -> list:
    """Problems of `got` against the reference child: results and
    per-round counters must be equal."""
    problems = []
    if got["results"] != ref["results"]:
        problems.append(f"{what}: results diverge: {got['results']} != "
                        f"{ref['results']}")
    if got["round_counters"] != ref["round_counters"]:
        problems.append(f"{what}: per-round counters diverge")
    return problems


def smoke(device) -> dict:
    from mastic_tpu_torch.ops import kernels

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="mastic_store_smoke_")
    try:
        rec = bake(os.path.join(tmp, "store"), device)
        print(f"[smoke] baked {rec['entries']} libraries in "
              f"{rec['wall_seconds']} s (nvcc {rec['build_seconds']} s)",
              file=sys.stderr, flush=True)
        copy = package_copy(os.path.join(tmp, "inline"))
        inline = serve_child(copy, [], child_env())
        reuse = serve_child(copy, [], child_env())
        warm = serve_child(package_copy(os.path.join(tmp, "warm")),
                           ["--artifact-dir", rec["store"]],
                           child_env(hide_nvcc=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    problems = []
    sources = len(kernels.SOURCES)
    if inline["kernel_store"]["inline_compiles"] != sources:
        problems.append(f"the inline child built "
                        f"{inline['kernel_store']['inline_compiles']} "
                        f"libraries, not {sources}")
    if reuse["kernel_store"]["inline_compiles"] != 0:
        problems.append("the reusing child ran nvcc")
    ks = warm["kernel_store"]
    if ks["inline_compiles"] != 0 or ks["artifact_hits"] != sources:
        problems.append(f"the store child: {ks['inline_compiles']} inline "
                        f"builds, {ks['artifact_hits']} hits")
    if any(epoch_inline_compiles(warm)):
        problems.append(f"a round of the store child built inline: "
                        f"{epoch_inline_compiles(warm)}")
    problems += compare_children(inline, warm, "store child")
    problems += compare_children(inline, reuse, "reusing child")
    for p in problems:
        print(f"bake --smoke: FAIL: {p}", file=sys.stderr, flush=True)
    return {
        "mode": "smoke", "ok": not problems,
        "libraries": rec["libraries"], "nvcc": rec["nvcc"],
        "bake_seconds": rec["wall_seconds"],
        "build_seconds": rec["build_seconds"],
        "first_round_s": {"inline_nvcc": inline["first_round_s"],
                          "build_dir_reused": reuse["first_round_s"],
                          "store_nvcc_hidden": warm["first_round_s"]},
        "store_child": ks,
        "results": warm["results"],
        "wall_seconds": round(time.time() - t0, 1),
    }


def main() -> None:
    parser = argparse.ArgumentParser(
        description="bake the kernel libraries into a kernel store")
    parser.add_argument("--out", type=str, default=None,
                        help="store directory (MASTIC_ARTIFACT_DIR / "
                             "serve --artifact-dir at serve time)")
    parser.add_argument("--smoke", action="store_true",
                        help="bake into a temporary store and run the "
                             "serve tool from it in fresh children")
    args = parser.parse_args()
    if not args.smoke and not args.out:
        parser.error("give --out DIR or --smoke")

    from mastic_tpu_torch import resolve_device

    try:
        device = resolve_device("cuda")
    except RuntimeError as exc:
        fail(str(exc))
    out = smoke(device) if args.smoke else bake(args.out, device)
    print(json.dumps(out), flush=True)
    if not out.get("ok", True):
        sys.exit(1)


if __name__ == "__main__":
    main()
