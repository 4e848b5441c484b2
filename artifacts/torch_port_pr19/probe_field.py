"""The field kernel alone on the card: build the kernel libraries and
print ptxas's report for `csrc/field.cu`, run `chip_smoke.py`'s field
rows (add, sub and mul at the weight check's shapes, each held bit-equal
to the plain limb code), and hold the kernel store's probe of
`field_op` on the card to its digest on the CPU.  Run from the
repository's root on a machine with an NVIDIA card:

    python3 artifacts/torch_port_pr19/probe_field.py [--seed N]

Prints one JSON line with the rows last.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from mastic_tpu_torch.drivers import artifacts
    from mastic_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("probe_field: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    paths = kernels.build()
    print((paths["field"].parent / "field.ptxas.txt").read_text())
    on_card = artifacts.probe_digest("field_op", dev)
    on_cpu = artifacts.probe_digest("field_op", "cpu")
    print(f"field_op probe digest: card {on_card}, cpu {on_cpu}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = chip_smoke.check_field(dev, gen)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "probe_equal": on_card == on_cpu, "rows": rows}))
    return 0 if on_card == on_cpu else 1


if __name__ == "__main__":
    sys.exit(main())
