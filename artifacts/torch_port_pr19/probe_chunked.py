"""`chip_smoke.py`'s chunked Count phase alone, under one variant, with
each level's counts against numpy printed as they are checked.  Run from
the root of a checkout on a machine with an NVIDIA card:

    python3 artifacts/torch_port_pr19/probe_chunked.py VARIANT

VARIANT is `kernel` (as the program runs), `serial` (give it
MASTIC_PIPELINE=0 in the environment), `sync` (a device synchronise
after every field-kernel launch) or `plain` (the plain field code on
the card).  How the chunked runner's round keys were found to be freed
while a chunk's level steps still read them."""
import os, sys, time, traceback
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from mastic_tpu_torch.ops import field as F, kernels

variant = sys.argv[1]
orig = chip_smoke.plaintext_counts

class Diff(list):
    def __ne__(self, other):
        bad = [i for i, (a, b) in enumerate(zip(other, self)) if a != b]
        if bad or len(other) != len(self):
            print(f"  mismatch: {len(bad)} of {len(self)} prefixes, first {[(i, other[i], self[i]) for i in bad[:8]]}", flush=True)
        else:
            print(f"  level ok ({len(self)} prefixes)", flush=True)
        return bool(bad) or len(other) != len(self)

chip_smoke.plaintext_counts = lambda *a, **k: Diff(orig(*a, **k))
if variant == "sync":
    k0 = F.FieldSpec._kernel
    def k1(self, op, a, b):
        out = k0(self, op, a, b); torch.cuda.synchronize(); return out
    F.FieldSpec._kernel = k1
if variant == "plain":
    F.FieldSpec._either = lambda self, op, a, b: getattr(self.plain, op)(a, b)
    F.FieldSpec.neg = lambda self, a: self.plain.neg(a)
dev = torch.device("cuda", 0)
t0 = time.time()
try:
    r = chip_smoke.count_chunked(dev, 0, chip_smoke.CHUNKED_LEVELS)
    print(variant, "PASS", {k: r[k] for k in ("reports", "levels", "rounds_s", "rejected", "xof_fallbacks", "max_width")})
except AssertionError as e:
    print(variant, "FAIL", e)
print(variant, "launches", {k: v for k, v in kernels.launches.items() if v}, round(time.time() - t0, 1), "s", flush=True)
