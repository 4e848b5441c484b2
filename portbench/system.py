"""The benchmark's boundary with the program under test,
`mastic_tpu_torch`: the instantiation a configuration names, the
client shard of a traffic batch on the card, and the scalar reports
behind it.  Every import of the program sits in a function here or in
a mode, so that the harness's own modules load without it.
"""

import numpy as np

CTX = b"portbench"


def instantiate(config: dict):
    """The configuration's Mastic instantiation, e.g.
    {"class": "MasticCount", "args": [256]}."""
    from mastic_tpu_torch.backend import mastic

    inst = config["instantiation"]
    return getattr(mastic, inst["class"])(*inst["args"])


class ScalarReports:
    """Frozen copy of `chip_smoke.py::ScalarReports`: the scalar reports
    behind a batch, each built on first access (lane r's scalar shard,
    `Mastic.scalar().shard`, of the same measurement, nonce and
    randomness, then the batch's tampering).  The drivers read a lane
    only where its XOF sampling fired, so a run where none fires builds
    none."""

    def __init__(self, mastic, traffic):
        self.scalar = mastic.scalar()
        self.traffic = traffic
        self.built: dict = {}

    def __len__(self) -> int:
        return len(self.traffic.weights)

    def clean(self, r: int):
        """Lane r's report as the client shards it, untampered."""
        t = self.traffic
        nonce = t.nonces[r].tobytes()
        meas = (tuple(bool(b) for b in t.alphas[r]), int(t.weights[r]))
        return (nonce,) + self.scalar.shard(CTX, meas, nonce,
                                            t.rand[r].tobytes())

    def __getitem__(self, r: int):
        r = int(r)
        if r not in self.built:
            self.built[r] = tamper_report(self.traffic, r, self.clean(r))
        return self.built[r]


def tamper_report(traffic, r: int, report: tuple) -> tuple:
    """The batch's tampering on lane r's scalar report (frozen copy of
    `chip_smoke.py::attribute_inputs`' hook): the correction word's
    seed byte, or the leader proof share's element whose low limb's
    bit 0 flipped."""
    (nonce, public_share, shares) = report
    if r in traffic.tamper_cw:
        (d, i, x) = traffic.tamper_cw[r]
        public_share = list(public_share)
        (seed, ctrl, w, proof) = public_share[d]
        seed = bytearray(seed)
        seed[i] ^= x
        public_share[d] = (bytes(seed), ctrl, w, proof)
    if r in traffic.tamper_proof:
        j = traffic.tamper_proof[r]
        (key, proof_share, seed, part) = shares[0]
        proof_share = list(proof_share)
        proof_share[j] = type(proof_share[j])(proof_share[j].int() ^ 1)
        shares = [(key, proof_share, seed, part), shares[1]]
    return (nonce, public_share, shares)


def shard(bm, traffic, reports: ScalarReports, device, chunk: int) -> tuple:
    """The client shard of a traffic batch on `device`
    (`BatchedMastic.encode_measurements` and `shard_device`, `chunk`
    reports a call), then its tampering.  A lane whose XOF sampling
    fired in the shard is sharded again through the scalar layer, whose
    sampler runs the true rejection loop, as the client would, and its
    row replaced.  Returns (the ReportBatch, lanes re-sharded)."""
    import torch

    from mastic_tpu_torch.drivers.chunked import cat_batches

    R = len(traffic.weights)
    parts = []
    fired = []
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        (alphas, betas) = bm.encode_measurements(
            [(traffic.alphas[r], int(traffic.weights[r]))
             for r in range(lo, hi)], device)
        (part, ok) = bm.shard_device(
            CTX, alphas, betas, torch.as_tensor(traffic.nonces[lo:hi],
                                                device=device),
            torch.as_tensor(traffic.rand[lo:hi], device=device))
        fired += [lo + int(r) for r in np.flatnonzero(~ok.cpu().numpy())]
        parts.append(part)
        del alphas, betas, ok
    batch = cat_batches(parts) if len(parts) > 1 else parts[0]
    del parts
    for r in fired:
        row = bm.marshal_reports([reports.clean(r)], device)
        for (dst, src) in zip(batch.tensors(), row.tensors()):
            dst[r] = src[0]
    if traffic.tamper_cw:
        (rows, at) = zip(*sorted(traffic.tamper_cw.items()))
        (d, i, x) = (torch.as_tensor(v, device=device) for v in zip(*at))
        rows = torch.as_tensor(rows, device=device)
        batch.cws.seed[rows, d, i] ^= x.to(torch.uint8)
    if traffic.tamper_proof:
        (rows, j) = zip(*sorted(traffic.tamper_proof.items()))
        batch.leader_proofs[torch.as_tensor(rows, device=device),
                            torch.as_tensor(j, device=device), 0] ^= 1
    return (batch, fired)
