"""The comparison has to fail: the control (the reference with one
guarantee broken) and faults planted under the timed path each come out
as not correct."""

import pytest
import torch

from portbench import control
from portbench.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("which", ["hh", "attr", "hist"])
def test_control_is_not_correct(which):
    (cell, config) = CELLS[which]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        compared = control.control(cell, config, seed)
        assert any(v > limit for (v, limit) in compared.values()), compared


def _unchanged_carry(monkeypatch):
    """A step that returns its state unchanged: the incremental round
    hands back the carries it was given; the attribute job, resident or
    chunked, hands back the first job's result."""
    from mastic_tpu_torch.backend.incremental import IncrementalMastic
    from mastic_tpu_torch.drivers import attribute_metrics

    orig = IncrementalMastic.agg_rounds

    def agg_rounds(self, agg_ids, vk, ctx, carries, *args):
        out = orig(self, agg_ids, vk, ctx, carries, *args)
        return [(c,) + o[1:] for (c, o) in zip(carries, out)]

    first = []

    def first_of(fn):
        def wrapped(*args, **kw):
            first.append(fn(*args, **kw))
            return first[0]
        return wrapped

    monkeypatch.setattr(IncrementalMastic, "agg_rounds", agg_rounds)
    for name in ("run_round_collect", "_run_round_chunked"):
        monkeypatch.setattr(attribute_metrics, name,
                            first_of(getattr(attribute_metrics, name)))


def _half_batch(monkeypatch):
    """Half of the batch left out of the aggregate, the rest doubled."""
    from mastic_tpu_torch.backend.mastic import BatchedMastic

    orig = BatchedMastic.aggregate

    def aggregate(self, out_share, accept):
        keep = accept.clone()
        keep[keep.shape[0] // 2:] = False
        agg = orig(self, out_share, keep)
        return self.spec.add(agg, agg)

    monkeypatch.setattr(BatchedMastic, "aggregate", aggregate)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: the first aggregate of
    every unshard (a histogram's first bucket) off by one."""
    from mastic_tpu_torch.backend.mastic import Mastic

    orig = Mastic.unshard

    def bump(value):
        if isinstance(value, (list, tuple)):
            return [bump(value[0])] + list(value[1:])
        return value + 1

    def unshard(self, agg_shares):
        out = orig(self, agg_shares)
        return [bump(out[0])] + out[1:]

    monkeypatch.setattr(Mastic, "unshard", unshard)


@pytest.mark.parametrize("fault", [_unchanged_carry, _half_batch,
                                   _altered_answer],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("which", ["hh", "attr", "hist"])
def test_fault_is_not_correct(monkeypatch, which, fault):
    fault(monkeypatch)
    line = run_tiny(which, seconds=2.0 if which == "hh" else 1.5)
    assert not line["correct"], line["compared"]
    assert line["failed"] > 0
    assert torch.device("cpu").type == line["device"]["platform"]
