"""The port's north-star tool (`python -m mastic_tpu_torch.tools.northstar`)
against the JAX package's `tools/northstar.py`, on the CPU: the
checkpoint helpers and planted paths, the parse-time refusals, and at a
small shape (two chunks, the tail padded) the JSON line, the checkpoint
bytes and a resume of each tool's checkpoint by the other.  Both tools
run in this process; the verify key (drawn with `gen_rand` by both) is
fixed on both sides, and both read one device budget, so that the
envelope's budget terms agree.  The JAX tool's fresh run (its level
programs, ~60 s) is the compile this file pays for in the fast tier; its
resume of the port's checkpoint (one more shard and level program) is
`-m slow`."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import mastic_tpu.common
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
from mastic_tpu_torch.drivers.chunked import memory_envelope
from mastic_tpu_torch.oracle import weighted_heavy_hitters
from mastic_tpu_torch.scalar import common as port_common
from mastic_tpu_torch.tools import northstar as port

REPO = pathlib.Path(__file__).resolve().parents[1]
VK = bytes(range(100, 132))
BUDGET = str(1 << 30)
# Two chunks of 64, the second padded; 2 bits keep the JAX run to its
# level-0 and level-1 programs.  The checkpoint is taken after level 1.
# (At seed 0 a tail value of the 2-bit tree reaches the threshold.)
SHAPE = ["--reports", "96", "--bits", "2", "--chunk-size", "64",
         "--planted", "2", "--seed", "2", "--checkpoint-every", "1"]
# A deeper shape for the port's own modes (no JAX run).
DEEP = ["--reports", "96", "--bits", "4", "--chunk-size", "64",
        "--planted", "2"]
# The timings, and what each package's tracer and compiler leave.
TIMED = {"shard_seconds", "wall_seconds", "node_evals_per_sec",
         "per_chunk_evals_per_sec_p50",
         "per_chunk_evals_per_sec_per_shard_p50", "obs", "platform"}
# The envelope's transient terms: the JAX package prices its binder's
# gathered rows (`binder_peak`), the port its round staging
# (`round_staging`: K1 reads the binder rows where they lie).
TRANSIENT = {"device_peak_bytes_per_chunk",
             "device_peak_bytes_per_chunk_per_shard",
             "device_peak_bytes_per_chunk_pipelined",
             "device_peak_bytes_per_chunk_pipelined_per_shard"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_northstar_tool", REPO / "tools" / "northstar.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(tool, mp, argv: list) -> dict:
    """The JAX tool's main() in this process: its JSON line."""
    mp.setattr(sys, "argv", ["northstar.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            tool.main()
        except SystemExit as exc:
            assert exc.code in (0, None), exc.code
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _run_port(argv: list) -> dict:
    (_args, result, launches) = port.collect(argv + ["--device", "cpu"])
    assert launches == []
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both tools at SHAPE with a checkpoint, then the port resuming the
    JAX tool's checkpoint."""
    tmp = tmp_path_factory.mktemp("northstar")
    tool = _jax_tool()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mastic_tpu.common, "gen_rand", lambda n: VK[:n])
        mp.setattr(port_common, "gen_rand", lambda n: VK[:n])
        mp.setenv("MASTIC_DEVICE_BUDGET_BYTES", BUDGET)
        (jck, pck) = (str(tmp / "jax.ck"), str(tmp / "port.ck"))
        out = {"port": _run_port(SHAPE + ["--checkpoint", pck]),
               "jax": _run_jax(tool, mp, SHAPE + ["--checkpoint", jck])}
        out["jax_ck"] = pathlib.Path(jck).read_bytes()
        out["port_ck"] = pathlib.Path(pck).read_bytes()
        out["port_resumes_jax"] = _run_port(
            SHAPE + ["--checkpoint", jck, "--resume"])
    return out


@pytest.fixture(scope="module")
def jax_resumes_port(runs, tmp_path_factory):
    """The JAX tool resuming a copy of the port's checkpoint (the key
    comes from the checkpoint), in a process of its own."""
    ck = tmp_path_factory.mktemp("northstar_resume") / "port.ck"
    ck.write_bytes(runs["port_ck"])
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "northstar.py")] + SHAPE
        + ["--checkpoint", str(ck), "--resume"], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 MASTIC_DEVICE_BUDGET_BYTES=BUDGET))
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


# -- (a) the helpers ----------------------------------------------------

@pytest.mark.parametrize("planted,bits,seed", [
    (1, 4, 0), (2, 2, 3), (3, 16, 7), (4, 3, 1), (5, 64, 11)])
def test_plant_paths_match_jax(planted, bits, seed):
    tool = _jax_tool()
    (a, b) = (np.random.default_rng(seed), np.random.default_rng(seed))
    assert np.array_equal(port.plant_paths(a, planted, bits),
                          tool.plant_paths(b, planted, bits))
    # The generator is left where the JAX tool leaves it.
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


def test_plant_paths_refuses_too_many():
    with pytest.raises(ValueError, match="distinct paths"):
        port.plant_paths(np.random.default_rng(0), 5, 2)


def test_checkpoint_helpers_match_jax():
    tool = _jax_tool()
    params = {"inst": "sum", "reports": 100, "bits": 16, "seed": 7,
              "planted": 3, "max_weight": 7, "tail_weight": 1}
    raw = port.write_checkpoint_bytes(VK, params, b"run state")
    assert raw == tool.write_checkpoint_bytes(VK, params, b"run state")
    assert port.read_checkpoint_bytes(raw) == \
        tool.read_checkpoint_bytes(raw) == (VK, params, b"run state")
    other = dict(params, seed=8, planted=2)
    assert port.verify_shard_params(params, other) == \
        tool.verify_shard_params(params, other) == ["planted", "seed"]
    assert port.SHARD_PARAM_KEYS == tool.SHARD_PARAM_KEYS
    old = len(VK).to_bytes(2, "little") + VK + b"\x00" * 64
    with pytest.raises(ValueError, match="header"):
        port.read_checkpoint_bytes(old)


# -- (b) refusals before any report is built ------------------------------

def _cli(args: list, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "mastic_tpu_torch.tools.northstar"] + args,
        cwd=REPO, capture_output=True, text=True, timeout=120, **kw)


@pytest.mark.parametrize("args,needle", [
    (["--checkpoint-every", "0"], "--checkpoint-every"),
    (["--checkpoint-every", "-3"], "--checkpoint-every"),
    (["--resume"], "--resume needs --checkpoint"),
    (["--mesh", "3", "--resident", "--reports", "64"], "divisible"),
    (["--mesh", "2", "--device", "cpu"], "--backend nccl needs a card"),
])
def test_refused_at_parse_time(args, needle, capsys, monkeypatch):
    """Exit 2 from the argument check, before any report is built."""
    monkeypatch.setattr(port, "synthetic_reports", None)
    with pytest.raises(SystemExit) as exc:
        port.collect(args)
    assert exc.value.code == 2
    (out, err) = capsys.readouterr()
    assert needle in err and out == ""


def test_resume_of_other_shard_params_refused(tmp_path):
    """A checkpoint written at one --seed, resumed at another: exit 2,
    naming the parameter, before any report is built."""
    ck = tmp_path / "run.ck"
    params = {"inst": "count", "reports": 64, "bits": 4, "seed": 1,
              "planted": 2, "max_weight": 7, "tail_weight": 1}
    ck.write_bytes(port.write_checkpoint_bytes(VK, params, b""))
    proc = _cli(["--reports", "64", "--bits", "4", "--planted", "2",
                 "--seed", "2", "--checkpoint", str(ck), "--resume"])
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert "seed" in proc.stderr and "--resume refused" in proc.stderr


def test_cuda_default_fails_without_a_card():
    """The default device is the card: with none, the tool fails and
    prints no line (this machine has no card)."""
    proc = _cli(["--reports", "8", "--bits", "2", "--chunk-size", "8"],
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and proc.stdout == ""


# -- (c) the JAX tool's line, checkpoint and resumes ----------------------

def test_line_matches_jax(runs):
    (jax_line, port_line) = (runs["jax"], runs["port"]["line"])
    assert jax_line["ok"] and port_line["ok"]
    assert port_line["platform"] == "cpu"
    assert sorted(port_line) == sorted(jax_line)
    for key in sorted(set(jax_line) - TIMED - {"pipeline", "envelope"}):
        assert port_line[key] == jax_line[key], key
    (jp, pp) = (dict(jax_line["pipeline"]), dict(port_line["pipeline"]))
    assert pp.pop("compile_inline_ms_total") == 0.0
    jp.pop("compile_inline_ms_total")
    assert pp == jp


def test_envelope_matches_jax_bar_the_transients(runs):
    (jenv, penv) = (runs["jax"]["envelope"], runs["port"]["line"]["envelope"])
    assert sorted(penv) == sorted(jenv)
    for key in sorted(set(jenv) - TRANSIENT - {"per_report_bytes"}):
        assert penv[key] == jenv[key], key
    (jper, pper) = (dict(jenv["per_report_bytes"]),
                    dict(penv["per_report_bytes"]))
    assert jper.pop("binder_peak") > 0 and pper.pop("round_staging") > 0
    assert pper == jper
    # The port's transient terms are its own model's.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_DEVICE_BUDGET_BYTES", BUDGET)
        own = memory_envelope(BatchedMastic(MasticCount(2)), 64,
                              penv["width"], 96)
    assert penv == own


def test_checkpoint_bytes_match_jax(runs):
    assert runs["port_ck"] == runs["jax_ck"]
    (vk, params, _blob) = port.read_checkpoint_bytes(runs["port_ck"])
    assert vk == VK and params["reports"] == 96


def _check_resumed(line: dict, fresh: dict) -> None:
    assert line["ok"] and line["resumed_from_level"] == 1
    assert line["levels"] == 1
    assert line["heavy_hitters_found"] == fresh["line"]["heavy_hitters_found"]


def test_port_resumes_the_jax_checkpoint(runs):
    got = runs["port_resumes_jax"]
    _check_resumed(got["line"], runs["port"])
    assert got["heavy_hitters"] == runs["port"]["heavy_hitters"]


@pytest.mark.slow
def test_jax_resumes_the_port_checkpoint(runs, jax_resumes_port):
    _check_resumed(jax_resumes_port, runs["port"])
    for key in ("threshold", "node_evals_total", "memory"):
        assert jax_resumes_port[key] == runs["port_resumes_jax"]["line"][key]


# -- (d) the port's other modes -----------------------------------------------

@pytest.fixture(scope="module")
def deep_chunked():
    return {inst: _run_port(DEEP + ["--inst", inst])
            for inst in ("count", "sum")}


def _oracle(argv: list) -> list:
    args = port.parse_args(argv)
    rep = port.synthetic_reports(args)
    meas = [(tuple(bool(b) for b in a), int(w))
            for (a, w) in zip(rep.alphas, rep.weights)]
    return weighted_heavy_hitters(meas, rep.threshold, args.bits)


@pytest.mark.parametrize("inst", ["count", "sum"])
def test_chunked_run_matches_the_oracle(deep_chunked, inst):
    got = deep_chunked[inst]
    assert got["line"]["ok"] and got["line"]["levels"] == 4
    assert sorted(got["heavy_hitters"]) == _oracle(DEEP + ["--inst", inst])
    assert ("max_weight" in got["line"]) == (inst == "sum")


@pytest.mark.parametrize("inst", ["count", "sum"])
def test_resident_run_matches_the_chunked_run(deep_chunked, inst):
    chunked = deep_chunked[inst]
    got = _run_port(DEEP + ["--inst", inst, "--resident"])
    (line, ref) = (got["line"], chunked["line"])
    assert got["heavy_hitters"] == chunked["heavy_hitters"]
    for key in ("ok", "levels", "threshold", "node_evals_total",
                "heavy_hitters_found", "reports", "bits"):
        assert line[key] == ref[key], key
    assert (line["mode"], line["chunk_size"]) == ("resident", 0)
    assert line["memory"]["chunk_size"] == 0
    assert line["memory"]["device_carry_bytes"] == \
        ref["memory"]["device_carry_bytes"] * 96 // 64
    assert line["pipeline"]["mode"] == "resident-deferred"


def test_mesh_over_gloo_matches_the_unsharded_run(deep_chunked):
    """--mesh 2 on the CPU (two spawned ranks over gloo, each sharding
    its rows): the unsharded run's heavy hitters and counters, and the
    mesh block."""
    (args, got, launches) = port.collect(
        DEEP + ["--mesh", "2", "--backend", "gloo", "--device", "cpu"])
    ref = deep_chunked["count"]
    assert got["heavy_hitters"] == ref["heavy_hitters"]
    for key in ("ok", "levels", "threshold", "node_evals_total"):
        assert got["line"][key] == ref["line"][key], key
    assert got["line"]["mesh_devices"] == 2
    mesh = got["line"]["mesh"]
    assert (mesh["report_shards"], mesh["device_rows_per_chunk"],
            mesh["rows_per_shard"]) == (2, 64, 32)
    assert len(launches) == 2 and all(not any(x.values()) for x in launches)
