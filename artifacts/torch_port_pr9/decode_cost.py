"""The per-report cost of the scalar upload path on the CPU: decoding a
MasticSum(32, 255) leader upload blob (`wire.decode_report`) and
marshalling the decoded reports (`marshal_party_reports`), beside the
byte-level parse a party runs (`marshal_party_blobs`).  Run from the
repository's root:

    python3 artifacts/torch_port_pr9/decode_cost.py
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from mastic_tpu_torch import wire  # noqa: E402
from mastic_tpu_torch.backend.mastic import (BatchedMastic,  # noqa: E402
                                             MasticSum)

N = 500
m = MasticSum(32, 255)
bm = BatchedMastic(m)
rng = np.random.default_rng(0)
nonce = rng.bytes(16)
(ps, shares) = m.scalar().shard(b"ctx", ((True,) * 32, 5), nonce,
                                rng.bytes(m.RAND_SIZE))
blobs = [wire.encode_report(m, 0, nonce, ps, shares[0])] * N
t0 = time.perf_counter()
reports = [wire.decode_report(m, 0, b) for b in blobs]
t1 = time.perf_counter()
bm.marshal_party_reports(0, reports, "cpu")
t2 = time.perf_counter()
bm.marshal_party_blobs(0, np.frombuffer(b"".join(blobs), np.uint8).copy()
                       .reshape(N, -1), "cpu")
t3 = time.perf_counter()
print(f"{N} reports of {len(blobs[0])} B: decode_report "
      f"{(t1 - t0) / N * 1e3:.3f} ms a report, marshal_party_reports "
      f"{(t2 - t1) / N * 1e3:.3f} ms, marshal_party_blobs "
      f"{(t3 - t2) / N * 1e3:.4f} ms")
