"""The harness finds every configuration, cell and per-layer reader that
BENCHMARK.json names, by name."""

import numpy as np
import pytest

from portbench import catalog


def test_benchmark_names_resolve():
    bench = catalog.benchmark()
    assert bench is not None
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        config = catalog.config(c["name"])
        assert config["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell["config"] == w["config"] in names
        assert cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"]
        assert cell.get("chips", 1) == w["chips"]
        catalog.mode(cell["mode"])
        config = catalog.config(cell["config"])
        scale = config.get("reports", config.get("reports_per_job"))
        assert cell["params"]["reports"] == scale
    readers = set(catalog.readers())
    for m in bench["per_layer"]:
        assert m["name"] in readers
        assert callable(catalog.reader(m["name"]).read)


def test_metrics_for_a_cell():
    bench = catalog.benchmark()
    for w in bench["workloads"]:
        e2e = catalog.metrics_for(bench, "end_to_end", w["name"],
                                  {"setup_s"})
        assert ("setup_s", "s") in e2e and len(e2e) >= 2
        layer = catalog.metrics_for(bench, "per_layer", w["name"],
                                    {n for (n, _u) in e2e})
        assert layer


def test_instantiation_widths_match_the_config():
    from mastic_tpu_torch.backend.mastic import BatchedMastic

    from portbench import bounds, system

    for c in catalog.benchmark()["configs"]:
        config = catalog.config(c["name"])
        m = system.instantiate(config)
        assert m.bits == config["bits"]
        assert m.value_len == config["value_len"]
        assert m.field.__name__ == config["field"]
        assert bounds.LIMBS[config["field"]] == \
            BatchedMastic(m).spec.num_limbs
        assert config["reduced"] == c["reduced"]
        if "buckets" in config:
            assert m.valid.length == config["buckets"]


@pytest.mark.parametrize("shape,want", [
    (("level", 15360, 16, 255, 17, 17, 8), 0.3931),
    (("level", 4096, 32, 255, 17, 17, 8), 0.2097),
    (("level", 10000, 64, 255, 17, 17, 4), 0.6647),
    (("binder", 15360, 1, 1928, 963, 1928, 17, 17, 8), 5.0922),
    (("binder", 4096, 2, 1950, 974, 1950, 17, 17, 8), 2.7468),
    (("binder", 10000, 1, 3332, 1665, 3332, 17, 17, 4), 3.0239)],
    ids=["k3_f128_hist100k", "k3_f128_hist", "k3_f64_attr",
         "k1_f128_hist100k", "k1_f128_hist", "k1_f64_attr"])
def test_bounds_match_the_smokes_recorded_bounds(shape, want):
    """The frozen arithmetic gives the bounds `chip_smoke.py` recorded
    for these kernel shapes (PERF.md's kernel table, ms)."""
    from portbench import bounds

    (kind, *args) = shape
    fn = bounds.level_ms if kind == "level" else bounds.binder_ms
    assert round(fn(*args), 4) == want


def test_bounds_count_the_programs_round_structure():
    """The frozen arithmetic's rows and parents against the program's
    own plan (RoundPlan) and grid (LevelSchedule)."""
    from mastic_tpu_torch.backend.incremental import RoundPlan
    from mastic_tpu_torch.backend.schedule import LevelSchedule

    from portbench import bounds

    rng = np.random.default_rng(5)
    for (k, level) in ((1, 0), (4, 3), (6, 9), (16, 11)):
        prefixes = np.unique(rng.integers(0, 2, (k, level + 1)).astype(bool),
                             axis=0)
        tuples = [tuple(bool(b) for b in p) for p in prefixes]
        anc = bounds.distinct_prefixes(prefixes)
        for d in range(level + 1):
            assert anc[d] == len({p[:d + 1] for p in tuples})
        sched = LevelSchedule(tuples, level, 16)
        (onehot, par, left, right) = sched.check_indices()
        parents = np.concatenate([[1], anc[:level]])
        assert int(2 * parents.sum()) == len(onehot) == sched.total_nodes
        assert int(parents[1:].sum()) == len(par)
        if level:
            assert int(parents[1]) + len(onehot) - 2 == len(
                np.unique(np.concatenate([par, left, right])))
    # The incremental plan, level by level down one frontier.
    layouts = []
    survivors = [()]
    for level in range(6):
        cands = [p + (b,) for p in survivors for b in (False, True)]
        plan = RoundPlan(cands, level, 16, 16, layouts)
        layouts.append(plan.layout_new)
        anc = bounds.distinct_prefixes(np.array(cands, bool))
        assert plan.onehot_rows == 2 + int(2 * anc[:level].sum())
        assert plan.payload_rows == int(anc[:level].sum())
        assert plan.parent_count == (int(anc[level - 1]) if level else 1)
        n = plan.payload_rows
        if level:
            assert len(np.unique(np.concatenate([
                plan.payload_parent[:n], plan.payload_left[:n],
                plan.payload_right[:n]]))) == int(anc[0]) \
                + plan.onehot_rows - 2
        survivors = cands[::3][:4]


def test_benchmark_file_keeps_the_contracts_forms():
    """Names, units and one-line texts within the forms the benchmark's
    contract allows; every metric's cells exist; every cell reports
    setup_s, another end-to-end metric and a per-layer metric."""
    import re

    bench = catalog.benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for text in [w["why"] for w in bench["workloads"]] + [
            c["why"] for c in bench["configs"]] + [
            c["source"] for c in bench["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text
    for w in bench["workloads"]:
        e2e = {m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", cells)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in bench["per_layer"])
    assert 1 <= bench["run_seconds"] <= 51
