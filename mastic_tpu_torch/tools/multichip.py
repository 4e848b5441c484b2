"""Multi-rank proof run: a pipelined chunked heavy-hitters collection on a
report mesh of `--ranks` processes, held bit for bit against the
unsharded run (the counterpart of the JAX package's
`tools/multichip.py`).

    python -m mastic_tpu_torch.tools.multichip --ranks 1   # NCCL, a card
    python -m mastic_tpu_torch.tools.multichip --ranks 2 --backend gloo \\
        --device cpu

The recipe is the JAX tool's: MasticCount(3), ten reports
(0, 0, 0, 7, 7, 7, 3, 1, 6, 6) from the port's scalar layer with report
6's leader key tampered, chunk_size 4 (three chunks, the tail padded
with dead lanes, each chunk padded again to the shard multiple),
threshold 2.  The collection runs unsharded in this process, then on
the mesh (`parallel.launch.spawn`, one process a rank).  Prints one
JSON line and exits 1 unless all of these hold:
  * the heavy hitters, every level's aggregates and counters, the
    `fallback` mask and the state arrays (every chunk's carries,
    gathered) equal the unsharded run's;
  * every rank returned the same;
  * every multi-chunk round ran pipelined with no fallback.
The JAX tool's `zero_inline_after_first` and `aot_predicted` checks have
no counterpart: the port compiles no programs.

By default every rank runs on a card (rank r on card r mod the card
count) over NCCL, which needs a card per rank; with no card the tool
raises.  `--device cpu` (with `--backend gloo`) runs the plain versions
on the host.
"""

import argparse
import io
import json
import sys
import time

import numpy as np

CTX = b"multichip"
VALUES = (0, 0, 0, 7, 7, 7, 3, 1, 6, 6)
TAMPERED = 6
SEED = 0


def reports(bits: int) -> list:
    """The recipe's scalar reports, report TAMPERED's leader key with
    its first byte flipped."""
    from ..backend.mastic import MasticCount

    m = MasticCount(bits).scalar()
    rng = np.random.default_rng(SEED)
    out = []
    for v in VALUES:
        (nonce, rand) = (rng.bytes(16), rng.bytes(m.RAND_SIZE))
        alpha = m.vidpf.test_index_from_int(v % 2 ** bits, bits)
        out.append((nonce,) + m.shard(CTX, (alpha, 1), nonce, rand))
    (nonce, public_share, shares) = out[TAMPERED]
    (key, proof, seed_, part) = shares[0]
    out[TAMPERED] = (nonce, public_share, [
        (bytes([key[0] ^ 1]) + key[1:], proof, seed_, part), shares[1]])
    return out


def _arrays(data: bytes) -> dict:
    arrays = np.load(io.BytesIO(data), allow_pickle=False)
    return {k: arrays[k] for k in arrays.files}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        default="nccl")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bits", type=int, default=3)
    parser.add_argument("--chunk-size", type=int, default=4,
                        help="not a multiple of --ranks by default: the "
                             "chunks pad to the shard multiple")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..backend.mastic import MasticCount
    from ..drivers.heavy_hitters import HeavyHittersRun
    from ..parallel import jobs, spawn

    resolve_device(args.device)
    print(f"multichip: {args.ranks} ranks over {args.backend} on "
          f"{args.device}", file=sys.stderr)
    case = {"mastic": ("MasticCount", (args.bits,)), "ctx": CTX,
            "verify_key": bytes(range(32)), "thresholds": {"default": 2},
            "reports": reports(args.bits),
            "chunk_size": args.chunk_size}

    t0 = time.perf_counter()
    serial = HeavyHittersRun(MasticCount(args.bits), CTX, case["thresholds"],
                             case["verify_key"], device=args.device,
                             reports=case["reports"],
                             chunk_size=args.chunk_size)
    while serial.step():
        pass
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn(jobs.heavy_hitters, args.ranks, args.backend, args.device,
                  case)
    mesh_s = time.perf_counter() - t0
    meshed = ranks[0][0]

    failures = []

    def check(name: str, cond: bool) -> None:
        if not cond:
            failures.append(name)

    check("ranks_agree", all(r[0]["levels"] == meshed["levels"]
                             and r[0]["final"] == meshed["final"]
                             for r in ranks))
    check("result", meshed["result"] == serial.result())
    check("levels", meshed["levels"] == serial.level_results)
    want = [jobs.counters(m) for m in serial.metrics]
    check("level_count", len(meshed["counters"]) == len(want))
    for (got, ref) in zip(meshed["counters"], want):
        check(f"counters_l{ref['level']}", got == ref)
    (got, ref) = (_arrays(meshed["final"]), _arrays(serial.to_bytes()))
    check("quarantine_union_mask",
          np.array_equal(got["fallback"], ref["fallback"]))
    check("state_keys", sorted(got) == sorted(ref))
    for k in ref:
        check(f"state_{k}", k in got and np.array_equal(got[k], ref[k]))
    pipes = meshed["pipeline"]
    check("pipelined", all(p["mode"] == "pipelined" for p in pipes))
    check("no_fallback", all(p["fallback"] is None for p in pipes))

    blocks = meshed["mesh"]
    out = {
        "ranks": args.ranks, "backend": args.backend,
        "device": args.device, "bits": args.bits,
        "reports": len(case["reports"]), "chunk_size": args.chunk_size,
        "levels": len(meshed["levels"]),
        "serial_seconds": round(serial_s, 3),
        "mesh_seconds": round(mesh_s, 3),
        "device_rows_per_chunk": blocks[0]["device_rows_per_chunk"],
        "rows_per_shard": blocks[0]["rows_per_shard"],
        "psum_bytes_total": sum(b["psum_bytes_per_round"] for b in blocks),
        "pipeline_modes": sorted({p["mode"] for p in pipes}),
        "launches": [r[1] for r in ranks],
        "hitters": len(meshed["result"]),
        "failures": failures,
        "ok": not failures,
    }
    print(json.dumps(out), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
