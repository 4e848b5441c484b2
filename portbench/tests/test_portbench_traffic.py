"""The generators: the same seed gives the same inputs, another seed
others; the attribute hash is the program's."""

import numpy as np
import pytest

from portbench import traffic
from portbench.tests.tiny import ATTR_CELL, HH_CELL


def _arrays(col):
    return [col.verify_key] + [a for t in col.batches for a in (
        t.alphas, t.weights, t.nonces, t.rand)] + [
        sorted(t.tamper_cw.items()) for t in col.batches] + [
        sorted(t.tamper_proof.items()) for t in col.batches]


@pytest.mark.parametrize("cell", [HH_CELL, ATTR_CELL],
                         ids=["planted", "attributes"])
def test_generator_deterministic_per_seed(cell):
    args = (cell["generator"], cell["params"], 12, 48, 7)
    big = 2 ** 31 + 99
    (a, b, c) = (traffic.generate(*args, big), traffic.generate(*args, big),
                 traffic.generate(*args, big + 1))
    for (x, y) in zip(_arrays(a), _arrays(b)):
        assert np.array_equal(np.asarray(x, object), np.asarray(y, object))
    assert any(not np.array_equal(x, y) for (x, y) in zip(
        [t.alphas for t in a.batches], [t.alphas for t in c.batches]))


def test_planted_recipe_shape():
    params = dict(HH_CELL["params"], reports=1000)
    col = traffic.generate("planted", params, 16, 8, 1, 3)
    t = col.batches[0]
    assert col.threshold == 100
    heavy = (t.alphas[:, None, :] == col.planted[None]).all(-1).any(-1)
    assert heavy[:600].all()
    # Row 1 shares row 0's first 3/4 of the tree, then diverges.
    assert np.array_equal(col.planted[1, :12], col.planted[0, :12])
    assert col.planted[1, 12] != col.planted[0, 12]


def test_attribute_tampering_disjoint_and_on_grid():
    params = dict(ATTR_CELL["params"], reports=400)
    col = traffic.generate("attributes", params, 12, 8, 5, 4)
    asked = np.stack([traffic.hash_path(a, 12) for a in col.attributes])
    for t in col.batches:
        assert not set(t.tamper_cw) & set(t.tamper_proof)
        rows = list(t.tamper_cw)
        assert (t.alphas[rows][:, None] == asked[None]).all(-1).any(-1).all()


@pytest.mark.parametrize("bits", [12, 32])
def test_hash_path_is_the_programs(bits):
    from mastic_tpu_torch import hash_attribute
    from mastic_tpu_torch.backend.mastic import MasticSum

    m = MasticSum(bits, 255)
    for name in ("attribute-0", "other-123456789"):
        assert tuple(bool(b) for b in traffic.hash_path(name, bits)) \
            == tuple(hash_attribute(m, name))
