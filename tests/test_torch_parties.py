"""The port's party layer (`mastic_tpu_torch/drivers/parties.py`,
`tools/party.py`) against the JAX package's, byte for byte.

* One party's engine in process: the port's `AggregatorParty` gives the
  JAX package's bytes for the prep blob, the leader's resolution and
  accept bitmap, the helper's confirmation and both aggregate shares.
  MasticCount (a round without the weight check) is held against
  JAX's `AggregatorParty` itself; a
  MasticSum batch with a tampered VIDPF key and a tampered proof share,
  and MasticHistogram (joint randomness), against what JAX's party pair
  sends by construction, computed from the JAX package's scalar layer
  (`prep_init`, `prep_shares_to_prep`, `prep_next`) — JAX's party
  compiles its prep program anew at every call (15-35 s a party on a
  CPU), so running it for every circuit would not fit this file's
  budget; the slow tier runs it for Sum and Histogram, with the
  weight check, too.
* A lane forced through the scalar fallback gives the unforced bytes.
* Spawned port parties (`ProcessCollector(device="cpu")`) give the
  in-process result, and a JAX `ProcessCollector(connect=...)` driving
  two `python -m mastic_tpu_torch.tools.party serve --device cpu`
  processes gets the JAX parties' shares.
* A party asked for "cuda" on a machine without a card NAKs and exits
  non-zero, on the spawn path and as a network party.

The spawned parties run with OMP_NUM_THREADS=1, so parallel test
workers do not oversubscribe the host.
"""

import inspect
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
import mastic_tpu_torch.backend.vidpf as tbv
import mastic_tpu_torch.ops.level as tlv
from mastic_tpu import testvec_codec as jcodec
from mastic_tpu import wire as jwire
from mastic_tpu.drivers import parties as jparties
from mastic_tpu.drivers import session as jsession
from mastic_tpu_torch.backend.xof import sample_vec
from mastic_tpu_torch.drivers import parties as tparties
from mastic_tpu_torch.drivers.session import SessionConfig, SessionError

REPO = pathlib.Path(__file__).resolve().parents[1]
CTX = b"party layer"
VK = bytes(range(32))
CFG = SessionConfig(connect_timeout=60.0, exchange_timeout=60.0,
                    ack_timeout=30.0, round_deadline=120.0,
                    shutdown_timeout=10.0, retries=1, backoff=0.1)

COUNT = ("MasticCount", (1,), [(1, True), (1, True), (0, False), (0, True)],
         (0, ((False,), (True,)), False))
SUM = ("MasticSum", (3, 7), [(0b110, 5), (0b001, 7), (0b110, 2),
                             (0b000, 3)],
       (2, ((True, True, False), (False, False, False)), True))
HIST = ("MasticHistogram", (2, 4, 2), [(0b10, 3), (0b01, 1), (0b10, 0)],
        (1, ((True, False), (False, True)), True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_parties():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _path(value: int, bits: int) -> tuple:
    return tuple(bool((value >> (bits - 1 - i)) & 1) for i in range(bits))


def _reports(name: str, args: tuple, meas: list, seed: int) -> tuple:
    """(port Mastic, JAX Mastic, port reports, JAX reports): the same
    shards from both scalar layers."""
    rng = np.random.default_rng(seed)
    port = getattr(tbm, name)(*args)
    ref = getattr(jm, name)(*args)
    (preps, jreps) = ([], [])
    for (alpha, weight) in meas:
        m = (_path(alpha, args[0]), weight)
        (nonce, rand) = (rng.bytes(16), rng.bytes(ref.RAND_SIZE))
        preps.append((nonce,) + port.scalar().shard(CTX, m, nonce, rand))
        jreps.append((nonce,) + ref.shard(CTX, m, nonce, rand))
    return (port, ref, preps, jreps)


def _blobs(ref, jreps: list) -> list:
    return [[jwire.encode_report(ref, a, n, ps, sh[a])
             for (n, ps, sh) in jreps] for a in range(2)]


def _engine(make_party, blobs: list, agg_param) -> dict:
    """Both parties of one engine through one round, in process (the
    two preps on two threads: JAX's compiles overlap)."""
    parties = [make_party(a) for a in range(2)]
    for a in range(2):
        parties[a].load_reports(blobs[a])
    with ThreadPoolExecutor(2) as pool:
        prep = list(pool.map(lambda p: p.prep_blob(agg_param), parties))
    (accept0, resolution) = parties[0].resolve(agg_param, prep[1])
    accept1 = parties[1].confirm(agg_param, resolution)
    return {"prep": prep, "resolution": resolution,
            "accept": (list(map(bool, accept0)), list(map(bool, accept1))),
            "agg": (parties[0].agg_share(agg_param, accept0),
                    parties[1].agg_share(agg_param, accept1))}


def _port_engine(port, blobs: list, agg_param) -> dict:
    return _engine(lambda a: tparties.AggregatorParty(port, a, VK, CTX,
                                                      device="cpu"),
                   blobs, agg_param)


def _scalar_engine(ref, jreps: list, agg_param) -> dict:
    """What JAX's AggregatorParty pair sends for `jreps`, from the JAX
    package's scalar layer: per report both prep shares, the prep
    message (a rejected report's is empty), each party's confirmation,
    and the sums of the accepted out shares."""
    prep = [b"", b""]
    (accept, frames, outs) = (([], []), [], ([], []))
    for (nonce, ps, shares) in jreps:
        inits = [ref.prep_init(VK, CTX, a, agg_param, nonce, ps, shares[a])
                 for a in range(2)]
        for a in range(2):
            prep[a] += jcodec.encode_prep_share(ref, inits[a][1])
        try:
            msg = ref.prep_shares_to_prep(CTX, agg_param,
                                          [i[1] for i in inits])
        except jm.ReportRejected:
            msg = False
        for a in range(2):
            ok = msg is not False
            if ok:
                try:
                    out = ref.prep_next(CTX, inits[a][0], msg)
                except jm.ReportRejected:
                    ok = False
            accept[a].append(ok)
            if ok:
                outs[a].append(out)
        frames.append(jwire.frame(
            jcodec.encode_prep_msg(ref, msg) if accept[0][-1] else b""))
    bitmap = np.packbits(accept[0], bitorder="little").tobytes()
    agg = tuple(jcodec.encode_agg_share(
        ref, ref.merge(agg_param, outs[a]) if outs[a]
        else ref.agg_init(agg_param)) for a in range(2))
    return {"prep": prep, "resolution": bitmap + b"".join(frames),
            "accept": accept, "agg": agg}


def _as_json(out: dict) -> dict:
    """An engine's outputs with every byte string as hex: comparable
    with what the helper process of `count_case` prints."""
    return json.loads(json.dumps(out, default=bytes.hex))


# The helper process of `count_case`: JAX's own AggregatorParty pair
# through `_engine` (its source pasted in, so the process imports
# neither torch nor this file) on a CPU JAX, the job on stdin.
_JAX_CHILD = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
import jax
jax.config.update("jax_platforms", "cpu")
import mastic_tpu.mastic as jm
from mastic_tpu.drivers import parties as jparties
{engine}
job = json.loads(sys.stdin.read())
ref = getattr(jm, job["class"])(*job["args"])
(level, prefixes, wc) = job["agg_param"]
agg_param = (level, tuple(tuple(p) for p in prefixes), wc)
(vk, ctx) = (bytes.fromhex(job["vk"]), bytes.fromhex(job["ctx"]))
blobs = [[bytes.fromhex(b) for b in bl] for bl in job["blobs"]]
print(json.dumps(_engine(lambda a: jparties.AggregatorParty(ref, a, vk,
                                                             ctx),
                         blobs, agg_param), default=bytes.hex))
"""


@pytest.fixture(scope="module")
def count_case():
    """MasticCount(1), one round from the root at level 0: the
    reports, the port's in-process engine, and JAX's own
    AggregatorParty pair on the CPU (the one JAX program set of this
    file).  JAX's party compiles its programs in a process of its own
    while the cases that need only the port's engine run; `want()`
    waits for its outputs (bytes as hex).  The one-level tree and the
    round without the weight check keep JAX's compile short (each
    doubles it); the Sum and Histogram cases and the session tests run
    both."""
    (name, args, meas, agg_param) = COUNT
    (port, ref, preps, jreps) = _reports(name, args, meas, 11)
    blobs = _blobs(ref, jreps)
    child = subprocess.Popen(
        [sys.executable, "-c",
         _JAX_CHILD.format(engine=inspect.getsource(_engine))], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
    child.stdin.write(json.dumps(
        {"class": name, "args": list(args), "agg_param": agg_param,
         "vk": VK.hex(), "ctx": CTX.hex(), "blobs": blobs},
        default=bytes.hex))
    child.stdin.close()

    outputs: list = []

    def want() -> dict:
        if not outputs:
            out = child.stdout.read()
            assert child.wait(timeout=600) == 0
            outputs.append(json.loads(out.strip().splitlines()[-1]))
        return outputs[0]

    try:
        yield {"port": port, "ref": ref, "preps": preps, "jreps": jreps,
               "blobs": blobs, "agg_param": agg_param, "want": want,
               "engine": _port_engine(port, blobs, agg_param),
               "spec": {"class": name, "args": list(args)}}
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


@pytest.mark.parametrize("case", ["count", "histogram"])
def test_forced_fallback_gives_the_unforced_bytes(case, count_case,
                                                  monkeypatch):
    """`sample_vec` patched (as in test_torch_rejection.py) to flag
    report lane 1 at every batched sampling: each party's prep marks the
    lane, `_scalar_fallback` recomputes it through the scalar layer, and
    every byte equals the unforced run's (for Histogram the joint-rand
    part and seed rows are spliced too)."""
    if case == "count":
        (port, ref, jreps) = (count_case["port"], count_case["ref"],
                              count_case["jreps"])
        (agg_param, want) = (count_case["agg_param"], count_case["engine"])
    else:
        (name, args, meas, agg_param) = HIST
        (port, ref, _preps, jreps) = _reports(name, args, meas, 12)
        want = _scalar_engine(ref, jreps, agg_param)
    calls = []

    def fake(spec, stream, length, offset=0):
        (limbs, ok) = sample_vec(spec, stream, length, offset)
        bad = torch.zeros(ok.shape[0], dtype=torch.bool, device=ok.device)
        bad[1] = True
        calls.append(1)
        return (limbs, ok & ~bad.reshape((-1,) + (1,) * (ok.dim() - 1)))

    for mod in (tlv, tbv, tbm):
        monkeypatch.setattr(mod, "sample_vec", fake)
    spliced = []
    orig = tparties.AggregatorParty._scalar_fallback

    def spy(self, agg_param, p):
        spliced.append(np.flatnonzero(~p.ok.cpu().numpy()).tolist())
        return orig(self, agg_param, p)

    monkeypatch.setattr(tparties.AggregatorParty, "_scalar_fallback", spy)
    got = _port_engine(port, _blobs(ref, jreps), agg_param)
    assert calls and spliced == [[1], [1]]
    assert got == want


def _tamper(jreps: list) -> list:
    """Report 1 with a flipped byte of the helper's VIDPF key, report 2
    with a changed leader proof-share element."""
    out = list(jreps)
    (nonce, ps, (s0, s1)) = out[1]
    key = bytes([s1[0][0] ^ 0x40]) + s1[0][1:]
    out[1] = (nonce, ps, [s0, (key,) + tuple(s1[1:])])
    (nonce, ps, (s0, s1)) = out[2]
    proof = list(s0[1])
    proof[1] = proof[1] + type(proof[1])(1)
    out[2] = (nonce, ps, [(s0[0], proof) + tuple(s0[2:]), s1])
    return out


@pytest.mark.parametrize("case", ["sum_tampered", "histogram"])
def test_engine_matches_jax_scalar_layer(case):
    """MasticSum with a tampered key and a tampered proof share (both
    rejected, the key at the eval proof and the proof share at the FLP
    decide), and MasticHistogram's joint-rand round."""
    (name, args, meas, agg_param) = SUM if case == "sum_tampered" else HIST
    (port, ref, _preps, jreps) = _reports(name, args, meas, 12)
    if case == "sum_tampered":
        jreps = _tamper(jreps)
    want = _scalar_engine(ref, jreps, agg_param)
    got = _port_engine(port, _blobs(ref, jreps), agg_param)
    assert got == want
    n = len(meas)
    assert want["accept"] == (([True, False, False, True],) * 2
                              if case == "sum_tampered"
                              else ([True] * n,) * 2)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["sum_tampered", "histogram"])
def test_engine_matches_jax_party_slow(case):
    """The same two cases against JAX's AggregatorParty pair itself
    (four JAX prep compiles: the slow tier)."""
    (name, args, meas, agg_param) = SUM if case == "sum_tampered" else HIST
    (port, ref, _preps, jreps) = _reports(name, args, meas, 12)
    if case == "sum_tampered":
        jreps = _tamper(jreps)
    blobs = _blobs(ref, jreps)
    want = _engine(lambda a: jparties.AggregatorParty(ref, a, VK, CTX),
                   blobs, agg_param)
    assert _port_engine(port, blobs, agg_param) == want


def _port_collector(case: dict, **kwargs):
    return tparties.ProcessCollector(case["port"], case["spec"], CTX, VK,
                                     config=CFG, device="cpu", **kwargs)


def test_spawned_port_parties_match_in_process(count_case):
    """ProcessCollector(device="cpu") over two spawned port parties:
    the shares and bitmap are the in-process engines' (which
    test_engine_count_matches_jax_party holds to JAX's party pair), the
    result JAX's unshard of them."""
    coll = _port_collector(count_case)
    try:
        coll.upload(count_case["preps"])
        metrics: list = []
        (result, accept, shares) = coll.round(count_case["agg_param"],
                                              metrics_out=metrics)
    finally:
        coll.close()
    want = count_case["engine"]
    assert shares == want["agg"]
    assert list(accept) == want["accept"][0]
    ref = count_case["ref"]
    agg_param = count_case["agg_param"]
    assert result == ref.unshard(agg_param, [
        jwire.decode_agg_share(ref, agg_param, s) for s in want["agg"]], 4)
    assert result == [1, 2]
    m = metrics[0]
    assert (m.accepted, m.respawns, m.quarantined) == (4, 0, 0)
    assert m.bytes_agg_shares == 2 * len(shares[0])
    assert all(p.returncode == 0 for p in coll.procs)


def _serve(args: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "mastic_tpu_torch.tools.party", "serve",
         "--listen", "127.0.0.1:0", "--once"] + args,
        cwd=REPO, env=dict(os.environ, **CFG.child_env()),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _ports(path: pathlib.Path, proc: subprocess.Popen) -> dict:
    deadline = time.monotonic() + 60
    while not path.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"party did not start: {proc.stderr.read()}")
        time.sleep(0.05)
    return json.loads(path.read_text())


def test_cuda_without_a_card_naks(count_case, tmp_path, monkeypatch):
    """No fallback: a party asked for "cuda" where there is no card
    raises through resolve_device and NAKs, on the spawn path (the
    collector's constructor raises the party's own error) and as a
    network party (the dialing collector gets the NAK, the server exits
    1)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _serve(["--port-file", str(tmp_path / "p.json")])
    try:
        with pytest.raises(SessionError) as ei:
            tparties.ProcessCollector(count_case["port"],
                                      count_case["spec"], CTX, VK,
                                      config=CFG)
        assert (ei.value.step, ei.value.kind) == ("spawn", "protocol")
        assert "torch.cuda.is_available() is False" in ei.value.detail
        port = _ports(tmp_path / "p.json", proc)["listen"]
        with pytest.raises(SessionError) as ei:
            tparties.ProcessCollector(
                count_case["port"], count_case["spec"], CTX, VK, config=CFG,
                connect={"leader": ("127.0.0.1", port),
                         "helper": ("127.0.0.1", 1),
                         "leader_peer": ("127.0.0.1", 1)})
        assert (ei.value.party, ei.value.kind) == ("leader", "protocol")
        assert "cuda" in ei.value.detail
        assert proc.wait(timeout=30) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tparties.AggregatorParty(count_case["port"], 0, VK, CTX)


def test_jax_collector_drives_port_network_parties(count_case, tmp_path):
    """The JAX package's ProcessCollector in connect mode (reliable
    channels over TCP) dials two port network parties on the CPU and
    gets the JAX in-process parties' shares and bitmap."""
    want = count_case["want"]()
    procs = [_serve(["--peer-listen", "127.0.0.1:0", "--device", "cpu",
                     "--port-file", str(tmp_path / "leader.json")]),
             _serve(["--device", "cpu",
                     "--port-file", str(tmp_path / "helper.json")])]
    try:
        (lp, hp) = (_ports(tmp_path / "leader.json", procs[0]),
                    _ports(tmp_path / "helper.json", procs[1]))
        jcfg = jsession.SessionConfig(**vars(CFG))
        coll = jparties.ProcessCollector(
            count_case["ref"], count_case["spec"], CTX, VK, config=jcfg,
            connect={"leader": ("127.0.0.1", lp["listen"]),
                     "helper": ("127.0.0.1", hp["listen"]),
                     "leader_peer": ("127.0.0.1", lp["peer_listen"])})
        try:
            coll.upload(count_case["jreps"])
            (_result, accept, shares) = coll.round(count_case["agg_param"])
        finally:
            coll.close()
        assert [x.hex() for x in shares] == want["agg"]
        assert list(map(bool, accept)) == want["accept"][0]
        for proc in procs:
            assert proc.wait(timeout=30) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_engine_count_matches_jax_party(count_case):
    """Last in the file: JAX's party pair has compiled meanwhile.  Its
    prep blobs, resolution, both accept bitmaps and both aggregate
    shares are the port's."""
    got = count_case["engine"]
    assert got["accept"] == ([True] * 4, [True] * 4)
    assert _as_json(got) == count_case["want"]()
    # JAX's party pair and the scalar layer agree (the reference the
    # other circuits' cases are held to).
    assert _scalar_engine(count_case["ref"], count_case["jreps"],
                          count_case["agg_param"]) == got
