"""The port's test-vector generator and oracle against the JAX package's,
and the port's batched engine against the nine rendered vectors.

`mastic_tpu_torch.gen_test_vec` runs the port's scalar layer and must
render each of the nine configurations exactly as the JAX generator
does.  Then the batched engine (`BatchedMastic.encode_measurements`,
`shard_device`, `prep_both`, `aggregate` and `unshard`, on the CPU)
reproduces every hex field of each rendered vector: public and input
shares, prep shares and messages, out shares, agg shares and the
result.  This is the port's counterpart of `tests/test_conformance.py`,
and it needs no reference files: the JAX generator's rendering stands
in for them (it re-emits the draft's vectors byte for byte where those
are present, `tests/test_gen_test_vec.py`)."""

import functools
import json

import numpy as np
import pytest
import torch

from mastic_tpu import gen_test_vec as jax_gen
from mastic_tpu import oracle as jax_oracle
from mastic_tpu_torch import gen_test_vec as port_gen
from mastic_tpu_torch import oracle as port_oracle
from mastic_tpu_torch.backend import mastic as batched

CTX = b"some application"
CONFIGS = port_gen.all_test_vecs()
NAMES = [c[0] for c in CONFIGS]


@functools.lru_cache(maxsize=None)
def _rendered(name: str) -> str:
    (_, mastic, agg_param, meas) = CONFIGS[NAMES.index(name)]
    return port_gen.render_test_vec(
        port_gen.gen_test_vec(mastic, agg_param, CTX, meas))


@pytest.mark.parametrize("name", NAMES)
def test_renders_the_jax_generators_vector(name):
    (_, mastic, agg_param, meas) = jax_gen.all_test_vecs()[NAMES.index(name)]
    assert _rendered(name) == jax_gen.render_test_vec(
        jax_gen.gen_test_vec(mastic, agg_param, CTX, meas))


def test_all_test_vecs_are_the_jax_configurations():
    port_cfgs = [(n, type(m).__name__, a, ms) for (n, m, a, ms) in CONFIGS]
    jax_cfgs = [(n, type(m).__name__, a, ms)
                for (n, m, a, ms) in jax_gen.all_test_vecs()]
    assert port_cfgs == jax_cfgs
    assert port_gen.deterministic_bytes(300) == \
        jax_gen.deterministic_bytes(300)


def test_main_writes_each_configuration(tmp_path, capsys, monkeypatch):
    """`main` writes one file a configuration, each the rendering (two
    of the nine here: the rest are rendered above)."""
    some = [CONFIGS[0], CONFIGS[-1]]
    monkeypatch.setattr(port_gen, "all_test_vecs", lambda: some)
    port_gen.main(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(c[0] for c in some)
    for (name, *_rest) in some:
        assert (tmp_path / name).read_text() == _rendered(name)
    assert capsys.readouterr().out.count("wrote ") == 2


# -- the batched engine against the rendered vectors ------------------------

def _batched(vec: dict, name: str):
    bits = vec["vidpf_bits"]
    if name.startswith("MasticCount"):
        return batched.MasticCount(bits)
    if name.startswith("MasticSumVec"):
        return batched.MasticSumVec(bits, vec["length"], vec["bits"],
                                    vec["chunk_length"])
    if name.startswith("MasticSum"):
        return batched.MasticSum(bits, vec["max_measurement"])
    if name.startswith("MasticHistogram"):
        return batched.MasticHistogram(bits, vec["length"],
                                       vec["chunk_length"])
    return batched.MasticMultihotCountVec(bits, vec["length"],
                                          vec["max_weight"],
                                          vec["chunk_length"])


def _hex_rows(t: torch.Tensor) -> list:
    return [bytes(row).hex() for row in t.reshape(t.shape[0], -1).numpy()]


@pytest.mark.parametrize("name", NAMES)
def test_batched_engine_reproduces_every_field(name):
    vec = json.loads(_rendered(name))
    m = _batched(vec, name)
    bm = batched.BatchedMastic(m)
    spec = bm.spec
    preps = vec["prep"]
    num = len(preps)

    def column(key: str) -> torch.Tensor:
        return torch.as_tensor(np.stack([
            np.frombuffer(bytes.fromhex(p[key]), np.uint8) for p in preps]))

    def le(t: torch.Tensor) -> torch.Tensor:
        return spec.plain_to_le_bytes(t).reshape(t.shape[0], -1)

    # Client: one batch of every measurement.
    meas = [(tuple(bool(b) for b in p["measurement"][0]),
             p["measurement"][1]) for p in preps]
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    (batch, ok) = bm.shard_device(CTX, alphas, betas, column("nonce"),
                                  column("rand"))
    assert bool(ok.all())
    cws = batch.cws
    ctrl = np.packbits(cws.ctrl.reshape(num, -1).numpy(), axis=1,
                       bitorder="little")
    public = torch.cat([torch.as_tensor(ctrl), cws.seed.reshape(num, -1),
                        le(cws.w), cws.proof.reshape(num, -1)], dim=1)
    assert _hex_rows(public) == [p["public_share"] for p in preps]
    use_jr = m.valid.JOINT_RAND_LEN > 0
    shares = ([batch.keys[:, 0], le(batch.leader_proofs)],
              [batch.keys[:, 1], batch.helper_seeds])
    if use_jr:
        shares[0].extend([batch.leader_seeds, batch.peer_parts[0]])
        shares[1].append(batch.peer_parts[1])
    for a in range(2):
        assert _hex_rows(torch.cat(shares[a], dim=1)) == \
            [p["input_shares"][a] for p in preps], f"input share {a}"

    # Aggregators: both preps from the root, the prep messages, the
    # out shares, the aggregates and the result.
    vk = bytes.fromhex(vec["verify_key"])
    agg_param = m.scalar().decode_agg_param(bytes.fromhex(vec["agg_param"]))
    wc = agg_param[2]
    prep = bm.prep_both(vk, CTX, agg_param, batch)
    for (a, p) in enumerate(prep):
        parts = [p.eval_proof]
        if wc:
            if use_jr:
                parts.append(p.joint_rand_part)
            parts.append(le(p.verifier))
        assert _hex_rows(torch.cat(parts, dim=1)) == \
            [x["prep_shares"][0][a] for x in preps], f"prep share {a}"
        out = [[bytes(e).hex() for e in row] for row in
               spec.plain_to_le_bytes(p.out_share).numpy()]
        assert out == [x["out_shares"][a] for x in preps], f"out share {a}"
    if wc and use_jr:
        msgs = _hex_rows(bm.joint_rand_seed(CTX, prep[0].joint_rand_part,
                                            prep[1].joint_rand_part))
    else:
        msgs = [""] * num
    assert msgs == [p["prep_messages"][0] for p in preps]
    accept = bm.accept_mask(prep[0], prep[1], wc) & prep[0].ok & prep[1].ok
    assert bool(accept.all())
    aggs = [bm.aggregate(p.out_share, accept) for p in prep]
    assert [bytes(le(a[None])[0].numpy()).hex() for a in aggs] == \
        vec["agg_shares"]
    assert m.unshard([bm.agg_share_to_host(a) for a in aggs]) == \
        vec["agg_result"]


# -- the oracle ------------------------------------------------------------

def _measurements(seed: int, num: int, bits: int, weighted: bool) -> list:
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 2, (3, bits)).astype(bool)
    rows = np.concatenate([hot[rng.integers(0, 3, num // 2)],
                           rng.integers(0, 2, (num - num // 2, bits))
                           .astype(bool)])
    weights = rng.integers(1, 8, num) if weighted else np.ones(num, int)
    return [(tuple(bool(b) for b in r), int(w))
            for (r, w) in zip(rows, weights)]


@pytest.mark.parametrize("seed,num,bits,threshold,weighted", [
    (0, 64, 4, 5, False), (1, 200, 8, 12, True), (2, 50, 1, 20, False),
    (3, 300, 12, 40, True)])
def test_oracle_matches_jax(seed, num, bits, threshold, weighted):
    meas = _measurements(seed, num, bits, weighted)
    assert port_oracle.weighted_heavy_hitters(meas, threshold, bits) == \
        jax_oracle.weighted_heavy_hitters(meas, threshold, bits)
    prefixes = sorted({a[:2] for (a, _w) in meas}) if bits >= 2 else \
        [(False,), (True,)]
    vec_add = (lambda: [0, 0], lambda x, w: [x[0] + 1, x[1] + w])
    for (zero, add) in ((lambda: 0, lambda x, w: x + w), vec_add):
        assert port_oracle.prefix_weights(meas, prefixes, zero, add) == \
            jax_oracle.prefix_weights(meas, prefixes, zero, add)


def test_oracle_refuses_an_empty_tree():
    with pytest.raises(ValueError, match="bit_len"):
        port_oracle.weighted_heavy_hitters([], 1, 0)
