"""K1's in-place sponge and bare permutation alone, for a short call on
the card: build the kernels of one tree of the package, print ptxas's
lines for K1 and K3 and a SASS summary of the sponge and permutation
kernels, then `chip_smoke.check_k1_entries` (every sponge and
permutation shape held bit-exact against the plain versions, the path
shapes timed).  The tree defaults to this repository; `--root DIR`
takes the package from an unpacked `git archive` of another commit
(the checks and timings stay this repository's, so two trees are
compared on the same shapes).  Run from the repository's root:

    python3 artifacts/torch_port_pr12/probe_k1.py [--root DIR] [--label L]
        [--out DIR]

Writes the row to <out>/<label>.json (default out: build/probe_k1).
"""
import argparse
import collections
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
SASS_KERNELS = ("turboshake", "keccak_permute")


def sass_summary(lib: pathlib.Path) -> list:
    """Per kernel whose name holds one of SASS_KERNELS: its instruction
    count, and for each backward branch (a loop) the instructions of
    the loop body by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if not any(k in name for k in SASS_KERNELS):
            continue
        insts = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            body = m.group(2).strip()
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            insts.append((int(m.group(1), 16), body))
        opcodes = collections.Counter(b.split()[0].split(".")[0]
                                      for (_a, b) in insts)
        lines = [f"SASS {name}: {len(insts)} instructions; "
                 + ", ".join(f"{k} {v}" for (k, v) in opcodes.most_common(12))]
        for (addr, body) in insts:
            m = re.match(r"BRA\S*\s+.*?(0x[0-9a-f]+)\s*$", body)
            if not m or int(m.group(1), 16) >= addr:
                continue
            target = int(m.group(1), 16)
            loop = [b for (a, b) in insts if target <= a <= addr]
            ops = collections.Counter(b.split()[0].split(".")[0] for b in loop)
            lines.append(f"  loop {target:#x}-{addr:#x}: {len(loop)} "
                         "instructions; " + ", ".join(
                             f"{k} {v}" for (k, v) in ops.most_common(12)))
        out.extend(lines)
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--label", default="change")
    parser.add_argument("--out", default=str(REPO / "build" / "probe_k1"))
    args = parser.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import mastic_tpu_torch
    from mastic_tpu_torch.ops import kernels

    assert pathlib.Path(mastic_tpu_torch.__file__).resolve().is_relative_to(
        root), mastic_tpu_torch.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        sys.exit("probe_k1: no CUDA card")
    print(f"[{args.label}] package {mastic_tpu_torch.__file__}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for name in ("keccak", "level"):
        func = "?"
        for line in (paths[name].parent / f"{name}.ptxas.txt").read_text(
                ).splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {func}: {line.strip()}")
    for line in sass_summary(paths["keccak"]):
        print(line)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    row = cs.check_k1_entries(dev, gen)
    print(f"[{args.label}] K1 entries {time.perf_counter() - t0:.1f} s")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.label}.json").write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main()
