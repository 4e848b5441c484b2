"""K1's in-place sponge in its two split forms, side by side on one
card: a state over a pair of threads (the port's `turboshake`,
csrc/keccak_pair.cuh) and over five threads (`turboshake_col`, built
from five_thread.cu beside this script, the form that lost).  Builds
both, prints ptxas's lines and a SASS summary of both sponge kernels,
holds each form bit-exact against the plain version at every shape of
`chip_smoke.k1_sponge_cases`, and times both at the timed (path) shapes
in the order pair, five, five, pair: whole call by CUDA events, device
time by the profiler.  Run from the repository's root:

    python3 artifacts/torch_port_pr12/probe_forms.py
"""
import ctypes
import importlib.util
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))
FORMS = (("pair", "turboshake_kernel"), ("five", "turboshake_col_kernel"))


def build_five(kernels) -> pathlib.Path:
    """five_thread.cu as its own library, with kernels.py's flags."""
    out = REPO / "build" / "probe_forms"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libfive.so"
    log = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
         "-o", str(lib), str(HERE / "five_thread.cu")],
        capture_output=True, text=True)
    (out / "five.ptxas.txt").write_text(log.stdout + log.stderr)
    if log.returncode:
        sys.exit(f"five_thread.cu does not build:\n{log.stdout}{log.stderr}")
    return lib


def ptxas_lines(path: pathlib.Path) -> None:
    func = "?"
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and "turboshake" in func:
            print(f"ptxas {func}: {line.strip()}")


def main() -> None:
    import torch
    from mastic_tpu_torch.ops import keccak, kernels
    import probe_k1

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        sys.exit("probe_forms: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    paths = kernels.build()
    five_path = build_five(kernels)
    print(f"build {time.perf_counter() - t0:.1f} s")
    ptxas_lines(paths["keccak"].parent / "keccak.ptxas.txt")
    ptxas_lines(five_path.parent / "five.ptxas.txt")
    for lib in (paths["keccak"], five_path):
        for line in probe_k1.sass_summary(lib):
            if "turboshake" in line or line.startswith("  "):
                print(line)
    five = ctypes.CDLL(str(five_path)).turboshake_col
    five.argtypes = list(kernels.SIGNATURES["keccak"]["turboshake"])
    five.restype = ctypes.c_int

    def five_form(msg, length, domain, out_len, prefix):
        out = torch.empty(msg.shape[:-1] + (out_len,), dtype=torch.uint8,
                          device=msg.device)
        (tmpl, head, nt) = keccak._device_template(bytes(prefix), length,
                                                   domain, msg.device)
        err = five(tmpl.data_ptr(), head, nt, msg.data_ptr(), msg.shape[-1],
                   len(prefix), length, out.data_ptr(), out_len,
                   msg.numel() // msg.shape[-1],
                   kernels.stream_ptr(msg.device))
        if err:
            raise RuntimeError(f"turboshake_col: error {err}")
        return out

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for (name, timed, msg, length, domain, out_len, prefix) in \
            cs.k1_sponge_cases(dev, gen):
        args = (msg, length, domain, out_len)
        want = keccak.turbo_shake128_dynamic_plain(*args, prefix=prefix)
        calls = {
            "pair": lambda: keccak.turbo_shake128_dynamic(*args,
                                                          prefix=prefix),
            "five": lambda: five_form(*args, prefix)}
        for (form, call) in calls.items():
            if cs._max_err([call()], [want]):
                raise AssertionError(f"{form} form disagrees at {name}")
        batch = msg.numel() // msg.shape[-1]
        (blocks, _perms, bound, by) = cs._sponge_cost(batch, len(prefix),
                                                      length, out_len)
        desc = (f"{name}: {batch} x ({len(prefix)} + {length}) B, {blocks} "
                f"blocks, {out_len} B out")
        if not timed:
            print(f"{desc}: both forms max_abs_err 0")
            continue
        got = {form: [] for (form, _k) in FORMS}
        for (form, kernel) in FORMS + FORMS[::-1]:
            ms = cs._time(calls[form], 20)
            dev_ms = cs._device_ms(calls[form], (kernel,), 20)[kernel]
            got[form].append((dev_ms, ms))
        print(f"{desc}: bound {bound:.4f} ms by {by}; " + "; ".join(
            f"{form} kernel " + ", ".join(f"{d:.4f}" for (d, _m) in v)
            + " (whole call " + ", ".join(f"{m:.4f}" for (_d, m) in v)
            + f"), {bound / min(d for (d, _m) in v):.1%} of the bound"
            for (form, v) in got.items()) + "; max_abs_err 0")


if __name__ == "__main__":
    main()
