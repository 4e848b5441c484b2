"""Process-separated aggregators (port of `mastic_tpu/drivers/parties.py`):
leader and helper as OS processes exchanging the draft's wire encodings
over sockets.

    collector ──spawn──> leader (agg 0)     helper (agg 1)
        │ upload: nonce‖public share‖input share   (per party view)
        │ round:  encoded agg param ‖ quarantine mask
        │                  ▲
        │   helper ──prep share blob──> leader
        │   leader ──accept bitmap + prep msgs──> helper
        │ agg share bytes ──> collector (leader adds the bitmap)

Each party runs the port's batched from-root prep over its whole report
batch on its own device (`BatchedMastic.prep`: K3 a depth, K1's binder
sponge and XOFs), and the cross-party logic as tensor ops over the
report axis: the leader's `resolve` (eval-proof equality, the FLP
decide over the summed verifier shares, the joint-rand seed) and the
helper's `confirm`.  Lanes where XOF rejection sampling fired are
recomputed through the party's own scalar layer before the exchange,
so the fallback never crosses a trust boundary.  The bytes on every
channel are the JAX package's: its collector drives these parties and
this collector drives its parties.

Fault tolerance (the session layer in drivers/session.py):

* every blocking call carries a deadline (per-exchange timeout plus a
  session-level round budget), so a dead or hung peer fails the round
  in bounded time with a `SessionError` naming the party and step;
* a party that hits a protocol error NAKs the collector with a
  structured error frame before exiting, so attribution does not have
  to wait out the deadline; a party asked for a CUDA device on a
  machine without one NAKs in place of its hello;
* a malformed report blob is *quarantined* (that report is excluded
  from the batch with a reason code, both parties agree via the
  collector's union mask) instead of aborting the upload;
* the idempotent exchanges (upload, agg-param dispatch, agg-share
  fetch) retry with bounded backoff; prep shares are recomputable
  from the marshaled arrays, so `AggregationSession` restarts a whole
  round after respawning a crashed party and the rerun is
  bit-identical;
* every outcome (timeouts, retries, quarantines, respawns, reconnects)
  lands in `RoundMetrics` counters.

Each party process counts its kernel launches (`ops.kernels.launches`)
and, on a card, its device peak; both ride its last `party_step` trace
event, "shutdown" (`MASTIC_TRACE_FILE`).

The JAX package's party sets its JAX platform and compile cache up at
start and caches one jitted resolve program per round kind; the port
compiles no programs, so neither has a counterpart here.
"""

import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, wire
from ..backend import mastic as mastic_mod
from ..metrics import RoundMetrics, count_round_bytes
from ..obs import trace as obs_trace
from ..ops import kernels
from . import faults as faults_mod
from . import session as session_mod
from .session import (Channel, Deadline, SessionConfig, SessionError,
                      with_retries)

# Collector -> party command bytes.
CMD_UPLOAD = b"\x01"
CMD_ROUND = b"\x02"
CMD_SHUTDOWN = b"\x03"
# Party -> collector reply framing: ACK prefix + payload, or NAK
# prefix + a JSON-encoded structured error (party/step/kind/detail).
REPLY_ACK = b"\x06"
REPLY_NAK = b"\x15"

# Quarantine reason codes (the per-report rejection taxonomy the
# upload ack reports; names in REASON_NAMES for metrics/debugging).
REASON_MALFORMED = 1      # decode raised: bad length / framing
REASON_RANGE = 2          # decoded but out of range (field element)
REASON_NAMES = {REASON_MALFORMED: "malformed", REASON_RANGE: "range"}

# The instantiations a party config may name (the JAX package's class
# names, mapped onto the port's classes).
CLASSES = {cls.__name__: cls for cls in (
    mastic_mod.MasticCount, mastic_mod.MasticSum, mastic_mod.MasticSumVec,
    mastic_mod.MasticHistogram, mastic_mod.MasticMultihotCountVec)}


def instantiate(spec: dict) -> mastic_mod.Mastic:
    """{"class": "MasticCount", "args": [2]} -> the port's instance."""
    cls = CLASSES.get(spec["class"])
    if cls is None:
        raise ValueError(f"unknown Mastic class {spec['class']!r}")
    return cls(*spec["args"])


class _PartyReports:
    """The scalar reports behind a party's batch, each decoded from its
    upload blob on first access (the scalar fallback reads only the
    lanes whose XOF sampling fired); a quarantined lane reads as the
    report its row was padded with."""

    def __init__(self, mastic, agg_id: int, blobs: list, pad: dict):
        self.m = mastic
        self.agg_id = agg_id
        self.blobs = blobs
        self.pad = pad
        self.decoded: dict = {}

    def __len__(self) -> int:
        return len(self.blobs)

    def __getitem__(self, r: int) -> tuple:
        r = self.pad.get(r, r)
        if r not in self.decoded:
            self.decoded[r] = wire.decode_report(self.m, self.agg_id,
                                                 self.blobs[r])
        return self.decoded[r]


class AggregatorParty:
    """One aggregator's protocol engine (transport-agnostic), on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, mastic: mastic_mod.Mastic, agg_id: int,
                 verify_key: bytes, ctx: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.m = mastic
        self.agg_id = agg_id
        self.verify_key = verify_key
        self.ctx = ctx
        self.bm = mastic_mod.BatchedMastic(mastic)
        self.reports: list = []
        self.quarantined: list = []   # [(index, reason code, detail)]
        self.arrays: Optional[dict] = None
        self._prep = None

    # -- upload channel --------------------------------------------

    def load_reports(self, blobs: list) -> list:
        """Decode the upload blobs; a malformed blob quarantines that
        report (returned as (index, reason, detail)) instead of
        aborting the batch — the lane is padded with a copy of the
        first good report and masked out of every later stage.
        Raises ValueError when no report decodes (there is no batch
        to pad).

        The blobs are parsed on the device (`marshal_party_blobs`);
        only a refused blob goes through the scalar decoder, whose
        message is the quarantine detail."""
        size = wire.report_size(self.m, self.agg_id)
        sized = np.array([len(b) == size for b in blobs], bool)
        rows = np.zeros((len(blobs), size), np.uint8)
        if sized.any():
            rows[sized] = np.frombuffer(
                b"".join(b for (b, ok) in zip(blobs, sized) if ok),
                np.uint8).reshape(-1, size)
        (arrays, well_formed) = self.bm.marshal_party_blobs(
            self.agg_id, rows, self.device)
        bad = ~(sized & well_formed.cpu().numpy())
        quarantined: list = []
        for i in np.flatnonzero(bad):
            try:
                wire.decode_report(self.m, self.agg_id, blobs[i])
            except (ValueError, EOFError) as exc:
                reason = (REASON_RANGE if "out of range" in str(exc)
                          else REASON_MALFORMED)
                quarantined.append((int(i), reason, str(exc)))
                continue
            raise RuntimeError(f"report {i}: refused by the batched parse "
                               f"but decoded by the scalar one")
        if bad.all():
            raise ValueError(
                f"all {len(blobs)} uploaded reports are malformed — "
                f"no batch to aggregate")
        good = int(np.flatnonzero(~bad)[0])
        if bad.any():
            rows[bad] = rows[good]
            (arrays, _ok) = self.bm.marshal_party_blobs(
                self.agg_id, rows, self.device)
        self.reports = _PartyReports(self.m, self.agg_id, list(blobs),
                                     {int(i): good
                                      for i in np.flatnonzero(bad)})
        self.quarantined = quarantined
        self.arrays = arrays
        return quarantined

    # -- prep ------------------------------------------------------

    def prep_blob(self, agg_param) -> bytes:
        """Run the batched prep and encode this party's prep shares:
        R fixed-size rows (eval proof ‖ [jr part] ‖ [verifier])."""
        if self.arrays is None:
            raise SessionError(
                "leader" if self.agg_id == 0 else "helper",
                "agg_param", session_mod.KIND_PROTOCOL,
                "round requested before any report upload")
        a = self.arrays
        p = self.bm.prep(self.agg_id, self.verify_key, self.ctx, agg_param,
                         a["nonces"], a["cws"], a["keys"],
                         proof_shares=a["proof_shares"], seeds=a["seeds"],
                         peer_jr_parts=a["peer_jr_parts"])
        self._prep = self._scalar_fallback(agg_param, p)
        return self._encode_prep(agg_param, self._prep)

    def _scalar_fallback(self, agg_param, p):
        """Recompute lanes where XOF rejection sampling fired through
        this party's scalar layer (vdaf-13 §6.2 rejection loop) and
        splice the exact rows in."""
        ok = p.ok.cpu().numpy()
        if ok.all():
            return p
        spec = self.bm.spec
        scalar = self.m.scalar()
        lanes = np.flatnonzero(~ok)
        rows: dict = {"out_share": [], "eval_proof": [], "verifier": [],
                      "joint_rand_part": [], "joint_rand_seed": []}
        for r in lanes:
            (nonce, public_share, input_share) = self.reports[r]
            ((out, seed), (proof, ver, part)) = scalar.prep_init(
                self.verify_key, self.ctx, self.agg_id, agg_param,
                nonce, public_share, input_share)
            rows["out_share"].append([spec.int_to_limbs(x.int())
                                      for x in out])
            rows["eval_proof"].append(np.frombuffer(proof, np.uint8))
            if ver is not None:
                rows["verifier"].append([spec.int_to_limbs(x.int())
                                         for x in ver])
            if part is not None:
                rows["joint_rand_part"].append(np.frombuffer(part, np.uint8))
            if seed is not None:
                rows["joint_rand_seed"].append(np.frombuffer(seed, np.uint8))
        idx = torch.as_tensor(lanes, device=self.device)
        spliced = {}
        for (name, new) in rows.items():
            old = getattr(p, name)
            if old is None or not new:
                continue
            old = old.clone()
            old[idx] = torch.as_tensor(np.asarray(new), dtype=old.dtype,
                                       device=self.device)
            spliced[name] = old
        return p._replace(**spliced)

    def _encode_prep(self, agg_param, p) -> bytes:
        (_level, _prefixes, do_weight_check) = agg_param
        parts = [p.eval_proof]
        if do_weight_check:
            if self.m.valid.JOINT_RAND_LEN > 0:
                parts.append(p.joint_rand_part)
            parts.append(self.bm.spec.plain_to_le_bytes(p.verifier).reshape(
                p.verifier.shape[0], -1))
        return torch.cat(parts, dim=-1).cpu().numpy().tobytes()

    # -- leader: the prep-share exchange ---------------------------

    def resolve(self, agg_param, peer_blob: bytes,
                exclude: Optional[np.ndarray] = None) -> tuple:
        """Leader side of prep_shares_to_prep over the report batch:
        returns (accept bitmap bytes, prep-msg blob).

        Tensor ops over the report axis on the party's device (scalar
        semantics: mastic.py prep_shares_to_prep + the leader's own
        joint-rand confirmation): eval-proof equality, the FLP decide
        over the summed verifier shares, and the joint-rand seed (K1)
        against the leader's own.  A verifier element outside the field
        (possible only from a misbehaving helper) rejects that report
        instead of aborting the batch.  `exclude` masks quarantined
        lanes (the collector's union mask) out of acceptance before the
        bitmap is built."""
        (_level, _prefixes, do_wc) = agg_param
        size = wire.prep_share_size(self.m, agg_param)
        num = len(self.reports)
        p = self._prep
        if len(peer_blob) != num * size:
            # A protocol-level refusal, not a reshape traceback: a
            # truncated or oversized exchange from a misbehaving peer
            # aborts the round loudly and attributably.
            raise ValueError(
                f"malformed prep-share exchange from peer: got "
                f"{len(peer_blob)} bytes, expected {num} x {size}")
        peer = torch.frombuffer(bytearray(peer_blob), dtype=torch.uint8
                                ).reshape(num, size).to(self.device)
        accept = torch.all(p.eval_proof == peer[:, :wire.PROOF_SIZE], dim=-1)
        prep_msgs = None
        if do_wc:
            spec = self.bm.spec
            elem = self.m.field.ENCODED_SIZE
            off = wire.PROOF_SIZE
            use_jr = self.m.valid.JOINT_RAND_LEN > 0
            if use_jr:
                part1 = peer[:, off:off + wire.SEED_SIZE].contiguous()
                off += wire.SEED_SIZE
            ver_bytes = peer[:, off:]
            (ver1, in_range) = spec.limbs_from_le_bytes(
                ver_bytes.reshape(num, -1, elem))
            accept &= self.bm.bflp.decide(spec.add(p.verifier, ver1))
            accept &= torch.all(in_range, dim=-1)
            if use_jr:
                # prep msg = joint-rand seed from [leader, helper]
                # parts; the leader's confirmation compares it to its
                # own predicted seed (prep_next semantics — the helper
                # runs the same check in confirm()).
                prep_msgs = self.bm.joint_rand_seed(
                    self.ctx, p.joint_rand_part, part1)
                accept &= torch.all(prep_msgs == p.joint_rand_seed, dim=-1)
                prep_msgs = prep_msgs.cpu().numpy()
        accept = accept.cpu().numpy()
        if exclude is not None:
            accept &= ~np.asarray(exclude, bool)

        bitmap = np.packbits(accept, bitorder="little").tobytes()
        blob = b"".join(
            wire.frame(prep_msgs[r].tobytes()
                       if accept[r] and prep_msgs is not None else b"")
            for r in range(num))
        return (accept, bitmap + blob)

    def confirm(self, agg_param, resolution: bytes) -> np.ndarray:
        """Helper side: parse the leader's bitmap + prep msgs, run the
        joint-rand confirmation (prep_next semantics) per report."""
        num = len(self.reports)
        nbytes = (num + 7) // 8
        if len(resolution) < nbytes:
            # Same protocol-level refusal as the leader's resolve():
            # a truncating peer aborts loudly, not via struct
            # tracebacks mid-parse.
            raise ValueError(
                f"malformed resolution from leader: got "
                f"{len(resolution)} bytes, accept bitmap alone needs "
                f"{nbytes}")
        accept = np.unpackbits(
            np.frombuffer(resolution[:nbytes], np.uint8),
            bitorder="little")[:num].astype(bool)
        use_jr = (self.m.valid.JOINT_RAND_LEN > 0 and agg_param[2])
        jr_seed = (None if self._prep.joint_rand_seed is None
                   else self._prep.joint_rand_seed.cpu().numpy())
        offset = nbytes
        for r in range(num):
            try:
                (msg, offset) = wire.unframe_at(resolution, offset)
            except ValueError as exc:
                raise ValueError(
                    f"malformed resolution from leader: prep msg "
                    f"{r} of {num} truncated") from exc
            if not accept[r]:
                continue
            if use_jr:
                if jr_seed is None:
                    raise ValueError(
                        "malformed resolution from leader: prep msg "
                        "present but this round has no joint rand")
                if msg != jr_seed[r].tobytes():
                    accept[r] = False  # joint-rand confirmation failed
            elif msg != b"":
                accept[r] = False
        if offset != len(resolution):
            # Strict length symmetry with resolve(): trailing bytes
            # are a malformed exchange, not ignorable padding.
            raise ValueError(
                f"malformed resolution from leader: "
                f"{len(resolution) - offset} trailing bytes after the "
                f"last prep msg")
        return accept

    # -- aggregation -----------------------------------------------

    def agg_share(self, agg_param, accept: np.ndarray) -> bytes:
        agg = self.bm.aggregate(
            self._prep.out_share,
            torch.as_tensor(np.asarray(accept, bool), device=self.device))
        return self.bm.spec.plain_to_le_bytes(agg).cpu().numpy().tobytes()


# -- quarantine ack / round-command codecs ----------------------------

def encode_quarantine(entries: list) -> bytes:
    """(index, reason, detail) list -> compact ack payload (details
    stay party-local; the wire carries index + reason code)."""
    out = [np.uint32(len(entries)).tobytes()]
    for (idx, reason, _detail) in entries:
        out.append(np.uint32(idx).tobytes() + bytes([reason]))
    return b"".join(out)


def decode_quarantine(payload: bytes) -> list:
    if len(payload) < 4:
        raise ValueError("malformed upload ack: truncated count")
    (num,) = np.frombuffer(payload[:4], np.uint32)
    body = payload[4:]
    if len(body) != int(num) * 5:
        raise ValueError(
            f"malformed upload ack: {len(body)} bytes for "
            f"{int(num)} quarantine entries")
    entries = []
    for i in range(int(num)):
        (idx,) = np.frombuffer(body[i * 5:i * 5 + 4], np.uint32)
        entries.append((int(idx), body[i * 5 + 4]))
    return entries


def encode_round_cmd(encoded_param: bytes, mask: np.ndarray) -> bytes:
    """CMD_ROUND ‖ u32 param length ‖ param ‖ quarantine mask bits."""
    mask_bytes = np.packbits(np.asarray(mask, bool),
                             bitorder="little").tobytes()
    return (CMD_ROUND + np.uint32(len(encoded_param)).tobytes()
            + encoded_param + mask_bytes)


def decode_round_cmd(msg: bytes, num_reports: int) -> tuple:
    """-> (encoded agg param, quarantine mask over num_reports)."""
    if len(msg) < 5:
        raise ValueError("malformed round command: truncated header")
    (plen,) = np.frombuffer(msg[1:5], np.uint32)
    plen = int(plen)
    if len(msg) < 5 + plen:
        raise ValueError(
            f"malformed round command: param needs {plen} bytes, "
            f"{len(msg) - 5} present")
    encoded_param = msg[5:5 + plen]
    mask_bytes = msg[5 + plen:]
    need = (num_reports + 7) // 8
    if len(mask_bytes) != need:
        raise ValueError(
            f"malformed round command: quarantine mask is "
            f"{len(mask_bytes)} bytes, want {need}")
    mask = np.unpackbits(
        np.frombuffer(mask_bytes, np.uint8),
        bitorder="little")[:num_reports].astype(bool)
    return (encoded_param, mask)


def nak_payload(err: SessionError) -> bytes:
    """The NAK reply carrying a structured error."""
    return REPLY_NAK + json.dumps({"party": err.party, "step": err.step,
                                   "kind": err.kind,
                                   "detail": err.detail}).encode()


def build_party(cfg: dict, device) -> AggregatorParty:
    """The engine a party config names, on `device`.  A device the
    machine does not have is this party's protocol error (the caller
    NAKs it), not a silent move to the CPU."""
    agg_id = cfg["agg_id"]
    try:
        return AggregatorParty(instantiate(cfg["mastic"]), agg_id,
                               bytes.fromhex(cfg["verify_key"]),
                               bytes.fromhex(cfg["ctx"]), device=device)
    except (RuntimeError, ValueError) as exc:
        raise SessionError("leader" if agg_id == 0 else "helper", "spawn",
                           session_mod.KIND_PROTOCOL, str(exc))


def device_stats(party: AggregatorParty) -> dict:
    """This process's kernel launches so far, and on a card its device
    peak: the fields of the party's shutdown event."""
    stats: dict = {"launches": dict(kernels.launches)}
    if party.device.type == "cuda":
        stats["device_peak"] = torch.cuda.max_memory_allocated(party.device)
    return stats


# -- the party process main loop -------------------------------------

def party_main(argv: list) -> None:
    debug = os.environ.get("MASTIC_PARTY_DEBUG") == "1"

    # Config arrives on stdin (the collector's private-pipe handoff —
    # key material must not ride argv, which is world-readable in
    # /proc/<pid>/cmdline).  An explicit argv blob still wins for
    # by-hand debugging of a single party.
    cfg = json.loads(argv[0] if argv else sys.stdin.readline())
    agg_id = cfg["agg_id"]
    me = "leader" if agg_id == 0 else "helper"
    config = SessionConfig.from_env()
    injector = faults_mod.injector_from_env(me)

    def trace(what: str, **fields) -> None:
        # Every step lands as a span event (the party's JSONL trace,
        # MASTIC_TRACE_FILE, interleaves with the collector's); the
        # stderr echo stays behind the MASTIC_PARTY_DEBUG lever for
        # watching a live two-process session by eye.
        obs_trace.event("party_step", party=me, step=what, **fields)
        if debug:
            print(f"[party {agg_id}] {what}", file=sys.stderr, flush=True)

    def checkpoint(step: str) -> None:
        if injector is not None:
            injector.checkpoint(step)

    checkpoint("spawn")
    # Every link this party sends on is paced by MASTIC_NET_SHAPE
    # (bandwidth / RTT / jitter) — each process parses the lever
    # itself, exactly like MASTIC_FAULTS, so one env var shapes the
    # whole session.
    from ..net.transport import shape_from_env

    shaper = shape_from_env()
    coll = session_mod.connect(
        "127.0.0.1", cfg["collector_port"], "collector",
        config.connect_timeout, config.exchange_timeout, injector,
        shaper=shaper)
    try:
        party = build_party(cfg, cfg.get("device", "cuda"))
        trace("engine up, connecting"
              + (" (shaped link)" if shaper is not None else ""))
        _party_loop(party, coll, config, injector, trace, checkpoint,
                    shaper=shaper)
    except SessionError as err:
        trace(f"session error: {err}")
        try:
            coll.send_msg(nak_payload(err), "nak")
        except SessionError:
            trace("collector unreachable for the error report")
        sys.exit(1)


def _party_loop(party: AggregatorParty, coll: Channel,
                config: SessionConfig, injector, trace,
                checkpoint, shaper=None) -> None:
    agg_id = party.agg_id
    coll.send_msg(bytes([agg_id]), "hello")

    peer = None
    try:
        if agg_id == 0:
            lst = socket.create_server(("127.0.0.1", 0))
            try:
                coll.send_msg(
                    lst.getsockname()[1].to_bytes(2, "little"),
                    "leader_port")
                trace("listening for helper")
                peer = session_mod.accept(lst, "helper",
                                          config.connect_timeout,
                                          config.exchange_timeout,
                                          injector, shaper=shaper)
            finally:
                lst.close()
        else:
            port_msg = coll.recv_msg("leader_port")
            if port_msg is None or len(port_msg) != 2:
                raise SessionError("collector", "leader_port",
                                   session_mod.KIND_CLOSED,
                                   "no leader port from collector")
            peer = session_mod.connect(
                "127.0.0.1", int.from_bytes(port_msg, "little"),
                "leader", config.connect_timeout,
                config.exchange_timeout, injector, shaper=shaper)
        trace("peer channel up")
        _command_loop(party, coll, peer, config, injector, trace,
                      checkpoint)
    finally:
        if peer is not None:
            peer.close()


def _command_loop(party: AggregatorParty, coll, peer,
                  config: SessionConfig, injector, trace,
                  checkpoint) -> None:
    """The command-driven protocol engine shared by the loopback
    spawn path (`_party_loop`) and the standalone network party
    (`tools/party.py`): upload / round / shutdown over whatever
    channel pair the caller built (plain or reliable, plaintext or
    mTLS)."""
    del injector  # faults reach this loop via `checkpoint` + channels
    agg_id = party.agg_id
    scalar = party.m.scalar()
    while True:
        # Idle wait for the next command: bounded by the round
        # deadline, not the (shorter) exchange timeout — a collector
        # pacing rounds or retrying an upload is normal; a collector
        # that DIED closes the socket and lands here as None at once.
        msg = coll.recv_msg("command", timeout=config.round_deadline)
        if msg is None or msg[:1] == CMD_SHUTDOWN:
            trace("shutdown", **device_stats(party))
            break
        if msg[:1] == CMD_UPLOAD:  # upload
            if len(msg) < 2:
                raise SessionError("collector", "upload",
                                   session_mod.KIND_MALFORMED,
                                   "upload without a generation byte")
            gen = msg[1:2]   # echoed in the ack so a retried upload
            #                  cannot be satisfied by a stale ack
            body = msg[2:]
            try:
                blobs = _parse_upload_body(body)
                quarantined = party.load_reports(blobs)
            except (ValueError, EOFError) as exc:
                raise SessionError("collector", "upload",
                                   session_mod.KIND_MALFORMED,
                                   str(exc))
            checkpoint("reports_loaded")
            trace(f"loaded {len(party.reports)} reports "
                  f"({len(quarantined)} quarantined)")
            coll.send_msg(
                REPLY_ACK + gen + encode_quarantine(quarantined),
                "upload_ack")
        elif msg[:1] == CMD_ROUND:  # one aggregation round
            try:
                (encoded_param, mask) = decode_round_cmd(
                    msg, len(party.reports))
                agg_param = scalar.decode_agg_param(encoded_param)
            except (ValueError, EOFError) as exc:
                raise SessionError("collector", "agg_param",
                                   session_mod.KIND_MALFORMED,
                                   str(exc))
            checkpoint("round_start")
            trace(f"round level={agg_param[0]} prep")
            blob = party.prep_blob(agg_param)
            checkpoint("prep_done")
            trace("prep done, exchanging", bytes=len(blob))
            if agg_id == 1:
                peer.send_msg(blob, "prep_share")
                resolution = peer.recv_msg("resolution")
                if resolution is None:
                    raise SessionError("leader", "resolution",
                                       session_mod.KIND_CLOSED,
                                       "leader closed before the "
                                       "resolution")
                try:
                    accept = party.confirm(agg_param, resolution)
                except ValueError as exc:
                    raise SessionError("leader", "resolution",
                                       session_mod.KIND_MALFORMED,
                                       str(exc))
                accept &= ~mask
                checkpoint("confirm_done")
                coll.send_msg(
                    REPLY_ACK + party.agg_share(agg_param, accept),
                    "agg_share")
            else:
                peer_blob = peer.recv_msg("prep_share")
                if peer_blob is None:
                    raise SessionError("helper", "prep_share",
                                       session_mod.KIND_CLOSED,
                                       "helper closed before its "
                                       "prep share")
                try:
                    (accept, resolution) = party.resolve(
                        agg_param, peer_blob, exclude=mask)
                except ValueError as exc:
                    raise SessionError("helper", "prep_share",
                                       session_mod.KIND_MALFORMED,
                                       str(exc))
                checkpoint("resolve_done")
                peer.send_msg(resolution, "resolution")
                bitmap = np.packbits(accept,
                                     bitorder="little").tobytes()
                coll.send_msg(
                    REPLY_ACK + bitmap
                    + party.agg_share(agg_param, accept),
                    "agg_share")
            trace("round done")
        else:
            raise SessionError("collector", "command",
                               session_mod.KIND_PROTOCOL,
                               f"unknown command byte "
                               f"{msg[:1].hex()}")


def _parse_upload_body(body: bytes) -> list:
    if len(body) < 4:
        raise ValueError("malformed upload: truncated report count")
    (num,) = np.frombuffer(body[:4], np.uint32)
    offset = 4
    blobs = []
    for i in range(int(num)):
        try:
            (blob, offset) = wire.unframe_at(body, offset)
        except ValueError as exc:
            raise ValueError(
                f"malformed upload: report frame {i} of {int(num)}: "
                f"{exc}")
        blobs.append(blob)
    if offset != len(body):
        raise ValueError(
            f"malformed upload: {len(body) - offset} trailing bytes "
            f"after the last report frame")
    return blobs


def _raise_nak(chan, msg: bytes, step: str) -> None:
    """A NAK reply (`REPLY_NAK` + JSON) as the party's own structured
    error (attribution without waiting out the deadline)."""
    try:
        err = json.loads(msg[1:])
    except ValueError:
        raise SessionError(chan.remote, step,
                           session_mod.KIND_MALFORMED, "unparsable NAK")
    raise SessionError(
        err.get("party", chan.remote), err.get("step", step),
        err.get("kind", session_mod.KIND_PROTOCOL),
        f"(reported by {chan.remote}) {err.get('detail', '')}")


# -- collector side --------------------------------------------------

class ProcessCollector:
    """Spawns the two aggregator processes and drives rounds against
    them; the in-process analog is drivers/attribute_metrics'
    from-root round.

    One spawn generation: a transport fault surfaces as a
    `SessionError` attributed to a party and step.  `respawn()` tears
    the pair down and rebuilds it (replaying the stored upload), which
    is how `AggregationSession` survives a crashed party.

    `mastic` is a `backend.mastic.Mastic` and `mastic_spec` its
    {"class", "args"} form, which the parties instantiate.  `device`
    goes to each spawned party in its config ("cuda" unless the
    caller asks for the CPU); standalone network parties
    (`connect=`) run on the device of their own `--device` flag.
    """

    def __init__(self, mastic: mastic_mod.Mastic, mastic_spec: dict,
                 ctx: bytes, verify_key: bytes,
                 config: Optional[SessionConfig] = None,
                 faults_spec: Optional[str] = None,
                 connect: Optional[dict] = None, tls=None,
                 device="cuda"):
        self.m = mastic
        self.spec = mastic_spec
        self.ctx = ctx
        self.verify_key = verify_key
        self.device = str(torch.device(device))
        self.config = config or SessionConfig.from_env()
        self.faults_spec = faults_spec
        # Connect mode: parties are standalone network processes
        # (`tools/party.py serve`) instead of spawned children —
        # `connect` maps {"leader"/"helper"/"leader_peer" -> (host,
        # port)}, `tls` is a net.transport.TlsConfig (this end's cert;
        # peer names pinned per link).  Channels are reliable
        # (sequence-numbered acked frames, reconnect-and-replay), and
        # the verify-key-bearing party config crosses the mTLS channel
        # instead of a local stdin pipe.
        self.connect = connect
        self.tls = tls
        self.injector = (
            faults_mod.FaultInjector(
                faults_mod.parse_faults(faults_spec), "collector")
            if faults_spec is not None
            else faults_mod.injector_from_env("collector"))
        self.counters = {"timeouts": 0, "retries": 0, "respawns": 0,
                         "quarantined": 0, "reconnects": 0,
                         "replayed_frames": 0}
        self.quarantine: dict = {}       # report index -> reason code
        self.num_reports = 0
        self._upload_bodies: Optional[list] = None
        self._upload_gen = 0
        # Injected party faults are one-generation: a respawned pair
        # comes up clean (otherwise a kill-at-step fault would kill
        # every respawn and recovery could never be tested or used).
        self._arm_child_faults = True
        # The collector's own sends ride the same shaped link the
        # parties arm from MASTIC_NET_SHAPE (upload bodies are the
        # largest payloads of a session).
        from ..net.transport import shape_from_env
        self.shaper = shape_from_env()
        self.procs: list = []
        self.server: Optional[socket.socket] = None
        self.leader: Optional[Channel] = None
        self.helper: Optional[Channel] = None
        try:
            self._spawn()
        except SessionError:
            # A failed handshake must not leak the surviving party
            # process or the server port.
            self._teardown(kill=True)
            raise

    # -- spawn / teardown / respawn --------------------------------

    def _spawn(self) -> None:
        if self.connect is not None:
            self._connect_parties()
            return
        cfg = self.config
        self.server = socket.create_server(("127.0.0.1", 0))
        port = self.server.getsockname()[1]
        env_cfg = {"mastic": self.spec, "ctx": self.ctx.hex(),
                   "verify_key": self.verify_key.hex(),
                   "collector_port": port, "device": self.device}
        env = {**os.environ, **self.config.child_env()}
        if self.faults_spec is not None and self._arm_child_faults:
            env["MASTIC_FAULTS"] = self.faults_spec
        else:
            env.pop("MASTIC_FAULTS", None)
        # The party config (which binds the VERIFY KEY) crosses on the
        # child's private stdin pipe, NOT argv: every local user can
        # read /proc/<pid>/cmdline.
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-m", "mastic_tpu_torch.drivers.parties"],
                cwd=_repo_root(), env=env, stdin=subprocess.PIPE,
                stdout=sys.stderr, stderr=sys.stderr)
            for agg_id in range(2)
        ]
        for (agg_id, proc) in enumerate(self.procs):
            blob = (json.dumps({**env_cfg, "agg_id": agg_id})
                    + "\n").encode()
            try:
                proc.stdin.write(blob)
                proc.stdin.flush()
                proc.stdin.close()
            except OSError as exc:
                # A party dead before reading its config: attribute
                # now instead of waiting out the handshake accept.
                raise SessionError(
                    "leader" if agg_id == 0 else "helper", "spawn",
                    session_mod.KIND_CRASHED,
                    f"config handoff failed: {exc}")
        chans: dict = {}
        for _ in range(2):
            try:
                chan = self._accept_party(cfg)
            except SessionError as err:
                raise self._attributed(err)
            # The accepted channel closes on every raise out of the
            # hello exchange — a malformed peer must not strand its fd.
            try:
                try:
                    hello = chan.recv_msg("hello")
                except SessionError as err:
                    raise self._attributed(err)
                if hello is not None and hello[:1] == REPLY_NAK:
                    _raise_nak(chan, hello, "spawn")
                if hello is None or len(hello) != 1 \
                        or hello[0] not in (0, 1):
                    raise SessionError(
                        "party", "hello", session_mod.KIND_MALFORMED,
                        f"bad hello {hello!r}")
                if hello[0] in chans:
                    raise SessionError(
                        "leader" if hello[0] == 0 else "helper",
                        "hello", session_mod.KIND_PROTOCOL,
                        "duplicate hello")
                chan.remote = "leader" if hello[0] == 0 else "helper"
                chans[hello[0]] = chan
            except BaseException:
                chan.close()
                raise
        (self.leader, self.helper) = (chans[0], chans[1])
        try:
            leader_port = self.leader.recv_msg("leader_port")
        except SessionError as err:
            raise self._attributed(err)
        if leader_port is None:
            raise SessionError("leader", "leader_port",
                               session_mod.KIND_CLOSED,
                               "leader closed before sending its "
                               "peer port")
        self.helper.send_msg(leader_port, "leader_port")

    def _accept_party(self, cfg: SessionConfig) -> Channel:
        """One party's connection, within the connect timeout; a party
        process that exits before it connects fails the accept at once
        (as a timeout, which `_attributed` turns into its crash)."""
        deadline = Deadline(cfg.connect_timeout)
        while True:
            step = min(0.25, deadline.remaining())
            try:
                return session_mod.accept(
                    self.server, "party", step, cfg.exchange_timeout,
                    self.injector, shaper=self.shaper)
            except SessionError as err:
                if err.kind != session_mod.KIND_TIMEOUT \
                        or deadline.expired() \
                        or any(p.poll() not in (None, 0)
                               for p in self.procs):
                    raise SessionError(
                        err.party, err.step, err.kind,
                        f"no connection within "
                        f"{cfg.connect_timeout:.1f}s"
                        if err.kind == session_mod.KIND_TIMEOUT
                        else err.detail)

    def _connect_parties(self) -> None:
        """The network deployment shape: dial each standalone party
        over the reliable (mTLS) transport and hand it its session
        config as the first framed message — hello (or the party's
        NAK) comes back on the same authenticated channel."""
        from .session import reliable_connect

        cfg = self.config
        base = {"mastic": self.spec, "ctx": self.ctx.hex(),
                "verify_key": self.verify_key.hex()}
        if self.faults_spec is not None and self._arm_child_faults:
            base["faults"] = self.faults_spec
        chans: dict = {}
        try:
            for (agg_id, name) in ((0, "leader"), (1, "helper")):
                (host, port) = self.connect[name]
                chan = reliable_connect(
                    host, int(port), name, cfg, tls=self.tls,
                    injector=self.injector, shaper=self.shaper,
                    deadline=Deadline(cfg.round_deadline))
                chans[agg_id] = chan
                party_cfg = dict(base, agg_id=agg_id)
                if agg_id == 1:
                    (ph, pp) = self.connect["leader_peer"]
                    party_cfg["peer"] = [ph, int(pp)]
                chan.send_msg(json.dumps(party_cfg).encode(),
                              "config")
                hello = chan.recv_msg(
                    "hello", timeout=cfg.connect_timeout)
                if hello is not None and hello[:1] == REPLY_NAK:
                    _raise_nak(chan, hello, "spawn")
                if hello != bytes([agg_id]):
                    raise SessionError(
                        name, "hello", session_mod.KIND_PROTOCOL,
                        f"bad hello {hello!r} from {host}:{port}")
        except SessionError:
            for chan in chans.values():
                chan.close()
            raise
        (self.leader, self.helper) = (chans[0], chans[1])

    def _fold_reliability(self) -> None:
        """Fold the live channels' recovery counters into the
        session-cumulative ledger before the channels are dropped
        (teardown/respawn), so attribution survives the channels."""
        for chan in (self.leader, self.helper):
            if chan is not None:
                self.counters["reconnects"] += \
                    getattr(chan, "reconnects", 0)
                self.counters["replayed_frames"] += \
                    getattr(chan, "replayed_frames", 0)

    def _teardown(self, kill: bool = False) -> None:
        self._fold_reliability()
        for chan in (self.leader, self.helper):
            if chan is not None:
                chan.close()
        (self.leader, self.helper) = (None, None)
        for proc in self.procs:
            if proc.poll() is None:
                if kill:
                    proc.kill()
                else:
                    proc.terminate()
                try:
                    proc.wait(timeout=self.config.shutdown_timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self.procs = []
        if self.server is not None:
            self.server.close()
            self.server = None

    def respawn(self) -> None:
        """Kill and rebuild the party pair, replaying the stored
        upload — the crash-recovery path.  Prep state is recomputed
        from the replayed reports, so a rerun round is bit-identical
        to an unfaulted one."""
        self.counters["respawns"] += 1
        self._teardown(kill=True)
        self._arm_child_faults = False
        try:
            self._spawn()
        except SessionError:
            self._teardown(kill=True)
            raise
        if self._upload_bodies is not None:
            self._send_upload()

    def reliability_counters(self) -> dict:
        """Session-cumulative transport recovery attribution: folded
        counts from torn-down channels plus the live channels'."""
        out = {"reconnects": self.counters["reconnects"],
               "replayed_frames": self.counters["replayed_frames"]}
        for chan in (self.leader, self.helper):
            if chan is not None:
                out["reconnects"] += getattr(chan, "reconnects", 0)
                out["replayed_frames"] += \
                    getattr(chan, "replayed_frames", 0)
        return out

    def wire_bytes(self) -> dict:
        """Measured collector-side wire traffic (the Channel
        counters).  Party<->party prep-exchange bytes are invisible
        from here; `metrics.count_round_bytes`' model covers those."""
        out = {"sent": 0, "received": 0}
        for chan in (self.leader, self.helper):
            if chan is not None:
                out["sent"] += chan.sent_bytes
                out["received"] += chan.recv_bytes
        return out

    def _party_status(self) -> str:
        out = []
        for (name, proc) in zip(("leader", "helper"), self.procs):
            rc = proc.poll()
            out.append(f"{name}: "
                       + ("running" if rc is None
                          else f"exited rc={rc}"))
        return "; ".join(out) if out else "no processes"

    def _attributed(self, err: SessionError) -> SessionError:
        """Sharpen a transport error with process liveness: a timeout
        whose party is dead becomes a crash, attributed to the dead
        party.  A party that exited rc=1 NAKed a structured error of
        its own first — a harder death (kill, signal, injected exit)
        is the better root cause when both are down."""
        if err.kind in (session_mod.KIND_CLOSED,
                        session_mod.KIND_TIMEOUT):
            # A dying party closes its socket an instant before the
            # kernel reaps it — give poll() a short grace window so
            # the crash is attributed as a crash, not a closed chan.
            grace = Deadline(0.5)
            while not grace.expired() \
                    and all(p.poll() is None for p in self.procs):
                time.sleep(0.02)
        dead = [(name, rc)
                for (name, proc) in zip(("leader", "helper"),
                                        self.procs)
                for rc in [proc.poll()]
                if rc is not None and rc != 0
                and err.party in (name, "party")]
        if dead:
            hard = [d for d in dead if d[1] != 1]
            (name, rc) = hard[0] if hard else dead[0]
            return SessionError(
                name, err.step, session_mod.KIND_CRASHED,
                f"party process exited rc={rc} ({err.detail})")
        if err.kind == session_mod.KIND_TIMEOUT:
            self.counters["timeouts"] += 1
        return SessionError(err.party, err.step, err.kind,
                            f"{err.detail} [{self._party_status()}]")

    # -- upload ----------------------------------------------------

    def upload(self, reports: list) -> None:
        """reports: [(nonce, public_share, input_shares)] of the scalar
        layer with BOTH input shares (the collector here doubles as the
        upload relay — clients talk to aggregators directly in a real
        deployment).  Malformed report blobs are quarantined per report
        (reason codes in `self.quarantine`), not fatal; the upload
        exchange retries with backoff (it is idempotent: parties
        reload the batch wholesale)."""
        self.num_reports = len(reports)
        bodies = []
        for agg_id in range(2):
            blobs = []
            for (nonce, ps, shares) in reports:
                blob = wire.encode_report(self.m, agg_id, nonce, ps,
                                          shares[agg_id])
                if self.injector is not None:
                    blob = self.injector.split_report_blob(
                        "upload_report", blob)
                blobs.append(blob)
            bodies.append(upload_body(blobs))
        self._upload_bodies = bodies
        self._send_upload()

    def upload_encoded(self, bodies: list, num_reports: int) -> None:
        """Upload pre-encoded per-party bodies (`upload_body` of each
        party's blobs) verbatim: the resume path of
        AggregationSession, and a relay that holds wire reports."""
        self.num_reports = num_reports
        self._upload_bodies = list(bodies)
        self._send_upload()

    def _send_upload(self) -> None:
        cfg = self.config
        # The whole retry ladder shares one round-deadline budget:
        # with_retries clamps each backoff sleep to what remains and
        # fails fast (attributed) once it is gone, so a retried
        # upload cannot overrun the round budget by the backoff.
        deadline = Deadline(cfg.round_deadline)

        def attempt():
            self.quarantine = {}
            self._upload_gen = (self._upload_gen + 1) % 256
            gen = bytes([self._upload_gen])
            try:
                for (chan, body) in ((self.leader,
                                      self._upload_bodies[0]),
                                     (self.helper,
                                      self._upload_bodies[1])):
                    chan.send_msg(CMD_UPLOAD + gen + body, "upload")
                for chan in (self.leader, self.helper):
                    ack = self._recv_ack(chan, gen)
                    for (idx, reason) in decode_quarantine(ack):
                        self.quarantine[idx] = reason
            except SessionError as err:
                raise self._attributed(err)

        with_retries(attempt, cfg.retries, cfg.backoff,
                     on_retry=self._on_retry, deadline=deadline)
        self.counters["quarantined"] = len(self.quarantine)
        if len(self.quarantine) >= self.num_reports \
                and self.num_reports > 0:
            reasons = {k: REASON_NAMES.get(v, v)
                       for (k, v) in sorted(self.quarantine.items())}
            raise SessionError(
                "collector", "upload", session_mod.KIND_PROTOCOL,
                f"all {self.num_reports} reports quarantined "
                f"(reasons: {reasons})")

    def _on_retry(self, err: SessionError, attempt: int) -> None:
        self.counters["retries"] += 1

    def quarantine_mask(self) -> np.ndarray:
        mask = np.zeros(self.num_reports, bool)
        for idx in self.quarantine:
            if idx < self.num_reports:
                mask[idx] = True
        return mask

    def _recv_ack(self, chan: Channel, gen: bytes) -> bytes:
        """One upload ack matching this attempt's generation byte; a
        stale ack from a timed-out earlier attempt is discarded (the
        resend is idempotent, but its ack must not be double-read)."""
        deadline = Deadline(self.config.ack_timeout)
        while True:
            ack = self._recv_reply(chan, "upload_ack", deadline,
                                   timeout=self.config.ack_timeout)
            if len(ack) < 1:
                raise SessionError(chan.remote, "upload_ack",
                                   session_mod.KIND_MALFORMED,
                                   "empty upload ack")
            if ack[:1] == gen:
                return ack[1:]
            # stale generation: drop and keep the window open

    def _recv_reply(self, chan: Channel, step: str,
                    deadline: Optional[Deadline] = None,
                    timeout: Optional[float] = None) -> bytes:
        """One ACK payload; a NAK raises the party's own structured
        error (attribution without waiting out the deadline)."""
        msg = chan.recv_msg(step, deadline, timeout)
        if msg is None:
            raise SessionError(chan.remote, step,
                               session_mod.KIND_CLOSED,
                               "party closed the channel")
        if msg[:1] == REPLY_NAK:
            _raise_nak(chan, msg, step)
        if msg[:1] != REPLY_ACK:
            raise SessionError(chan.remote, step,
                               session_mod.KIND_MALFORMED,
                               f"bad reply prefix {msg[:1].hex()}")
        return msg[1:]

    # -- rounds ----------------------------------------------------

    def round(self, agg_param,
              metrics_out: Optional[list] = None) -> tuple:
        """Run one aggregation round under the session deadline;
        returns (agg_result, accept, (leader share, helper share)).
        Timeout/retry/quarantine/respawn counters land in a
        RoundMetrics appended to `metrics_out`."""
        cfg = self.config
        scalar = self.m.scalar()
        deadline = Deadline(cfg.round_deadline)
        encoded = encode_round_cmd(scalar.encode_agg_param(agg_param),
                                   self.quarantine_mask())
        try:
            self.leader.send_msg(encoded, "agg_param", deadline)
            self.helper.send_msg(encoded, "agg_param", deadline)
            # Round replies are governed by the round deadline alone:
            # a party legitimately spends long in its first prep, and
            # a party-side fault reaches us earlier as a NAK anyway.
            leader_msg = self._recv_reply(
                self.leader, "agg_share", deadline,
                timeout=cfg.round_deadline)
            helper_msg = self._recv_reply(
                self.helper, "agg_share", deadline,
                timeout=cfg.round_deadline)
        except SessionError as err:
            raise self._attributed(err)
        # leader payload: accept bitmap + agg share
        share_size = wire.agg_share_size(self.m, agg_param)
        nbytes = len(leader_msg) - share_size
        if nbytes != (self.num_reports + 7) // 8 \
                or len(helper_msg) != share_size:
            raise SessionError(
                "leader" if nbytes != (self.num_reports + 7) // 8
                else "helper",
                "agg_share", session_mod.KIND_MALFORMED,
                f"malformed round payload: leader sent "
                f"{len(leader_msg)} bytes (want bitmap "
                f"{(self.num_reports + 7) // 8} + share {share_size}),"
                f" helper sent {len(helper_msg)} (want {share_size})")
        accept = np.unpackbits(
            np.frombuffer(leader_msg[:nbytes], np.uint8),
            bitorder="little")[:self.num_reports].astype(bool)
        accept &= ~self.quarantine_mask()
        agg0 = wire.decode_agg_share(self.m, agg_param,
                                     leader_msg[nbytes:])
        agg1 = wire.decode_agg_share(self.m, agg_param, helper_msg)
        num = int(accept.sum())
        result = scalar.unshard(agg_param, [agg0, agg1], num)
        if metrics_out is not None:
            metrics_out.append(self.round_metrics(agg_param, accept))
        return (result, accept, (leader_msg[nbytes:], helper_msg))

    def round_metrics(self, agg_param,
                      accept: np.ndarray) -> RoundMetrics:
        """Session-cumulative fault counters + this round's verdict
        and channel bytes (the process-separated collector cannot
        attribute rejections to a specific check — the leader only
        ships the final bitmap)."""
        (level, prefixes, _wc) = agg_param
        metrics = RoundMetrics(level=level,
                               frontier_width=len(prefixes),
                               padded_width=len(prefixes),
                               reports_total=self.num_reports)
        metrics.accepted = int(np.asarray(accept, bool).sum())
        metrics.timeouts = self.counters["timeouts"]
        metrics.retries = self.counters["retries"]
        metrics.respawns = self.counters["respawns"]
        metrics.quarantined = self.counters["quarantined"]
        rel = self.reliability_counters()
        metrics.reconnects = rel["reconnects"]
        metrics.replayed_frames = rel["replayed_frames"]
        count_round_bytes(metrics, self.m, agg_param,
                          self.num_reports)
        metrics.extra["process_separated"] = True
        metrics.extra["quarantine"] = {
            str(idx): REASON_NAMES.get(code, code)
            for (idx, code) in sorted(self.quarantine.items())}
        return metrics

    # -- teardown --------------------------------------------------

    def close(self) -> None:
        """Graceful shutdown hardened against hung parties: a party
        that ignores CMD_SHUTDOWN is terminated, then killed; the
        server socket closes in a finally so a wedged party can
        neither leak the port nor hang teardown."""
        try:
            for chan in (self.leader, self.helper):
                if chan is None:
                    continue
                try:
                    chan.send_msg(CMD_SHUTDOWN, "shutdown")
                except SessionError:
                    # A party that died earlier cannot ack shutdown;
                    # count it so teardown stays observable.
                    self.counters["shutdown_errors"] = \
                        self.counters.get("shutdown_errors", 0) + 1
            for proc in self.procs:
                try:
                    proc.wait(timeout=self.config.shutdown_timeout)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    try:
                        proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
        finally:
            for chan in (self.leader, self.helper):
                if chan is not None:
                    chan.close()
            if self.server is not None:
                self.server.close()
                self.server = None


def upload_body(blobs: list) -> bytes:
    """One party's upload body: u32 report count ‖ framed report
    blobs."""
    return np.uint32(len(blobs)).tobytes() \
        + b"".join(wire.frame(b) for b in blobs)


# -- supervised sessions: retry, respawn, snapshot, resume ------------

_SNAPSHOT_VERSION = 1


class AggregationSession:
    """A supervised collection session over a ProcessCollector.

    Adds the fault-tolerance policy on top of the mechanics: a failed
    round (timeout, crash, malformed exchange) respawns the party
    pair, replays the upload, and reruns the round — prep shares are
    pure functions of the replayed reports, so the rerun aggregate is
    bit-identical to an unfaulted run.  Completed rounds snapshot at
    round boundaries (`to_bytes`), and `from_bytes` resumes a session
    after a collector crash: it respawns parties, replays the stored
    upload bodies, and replays completed rounds from the snapshot
    instead of re-running them.  `device` is the spawned parties'.
    """

    def __init__(self, mastic: mastic_mod.Mastic, mastic_spec: dict,
                 ctx: bytes, verify_key: bytes,
                 config: Optional[SessionConfig] = None,
                 faults_spec: Optional[str] = None,
                 connect: Optional[dict] = None, tls=None,
                 device="cuda"):
        self.m = mastic
        self.spec = mastic_spec
        self.ctx = ctx
        self.verify_key = verify_key
        self.config = config or SessionConfig.from_env()
        self.coll = ProcessCollector(mastic, mastic_spec, ctx,
                                     verify_key, self.config,
                                     faults_spec, connect=connect,
                                     tls=tls, device=device)
        # [(encoded agg param, result, accept, (share0, share1))]
        self.completed: list = []
        self._replay_index = 0

    @property
    def counters(self) -> dict:
        return self.coll.counters

    def upload(self, reports: list) -> None:
        self.coll.upload(reports)

    def round(self, agg_param,
              metrics_out: Optional[list] = None) -> tuple:
        """One round with bounded retry: a retryable SessionError
        respawns the pair (replaying the upload) and reruns the
        round.  A snapshot-resumed session replays completed rounds
        from the snapshot (same agg params, in order) without
        touching the parties."""
        encoded = self.m.scalar().encode_agg_param(agg_param)
        if self._replay_index < len(self.completed):
            (saved_param, result, accept, shares) = \
                self.completed[self._replay_index]
            if saved_param != encoded:
                raise SessionError(
                    "collector", "agg_param",
                    session_mod.KIND_PROTOCOL,
                    "resumed session replayed a different agg param "
                    "than the snapshot recorded")
            self._replay_index += 1
            if metrics_out is not None:
                metrics_out.append(
                    self.coll.round_metrics(agg_param, accept))
            return (result, accept, shares)

        attempt = 0
        while True:
            try:
                (result, accept, shares) = self.coll.round(
                    agg_param, metrics_out=metrics_out)
                break
            except SessionError as err:
                if not err.retryable() \
                        or attempt >= self.config.retries:
                    raise
                self.coll.counters["retries"] += 1
                attempt += 1
                self.coll.respawn()
        self.completed.append((encoded, result, accept, shares))
        self._replay_index = len(self.completed)
        return (result, accept, shares)

    def close(self) -> None:
        self.coll.close()

    # -- snapshot / resume (length-prefixed JSON binding header +
    #    npz payload) ------------------------------------------------

    def to_bytes(self) -> bytes:
        import io

        header = json.dumps({
            "version": _SNAPSHOT_VERSION,
            "spec": self.spec,
            "ctx": self.ctx.hex(),
            "verify_key": self.verify_key.hex(),
        }, sort_keys=True).encode()
        data: dict = {
            "meta": np.array([_SNAPSHOT_VERSION,
                              self.coll.num_reports,
                              len(self.completed)], np.int64),
        }
        bodies = self.coll._upload_bodies or [b"", b""]
        for (i, body) in enumerate(bodies):
            data[f"upload_{i}"] = np.frombuffer(body, np.uint8)
        for (i, (param, result, accept, shares)) in \
                enumerate(self.completed):
            data[f"r{i}_param"] = np.frombuffer(param, np.uint8)
            data[f"r{i}_result"] = np.frombuffer(
                json.dumps(result).encode(), np.uint8)
            data[f"r{i}_accept"] = np.asarray(accept, bool)
            data[f"r{i}_share0"] = np.frombuffer(shares[0], np.uint8)
            data[f"r{i}_share1"] = np.frombuffer(shares[1], np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **data)
        return (len(header).to_bytes(4, "little") + header
                + buf.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes,
                   config: Optional[SessionConfig] = None,
                   faults_spec: Optional[str] = None,
                   device="cuda") -> "AggregationSession":
        import io

        hlen = int.from_bytes(data[:4], "little")
        try:
            header = json.loads(data[4:4 + hlen])
        except ValueError:
            raise ValueError(
                "session snapshot has no JSON binding header — not a "
                "snapshot written by AggregationSession.to_bytes")
        if header.get("version") != _SNAPSHOT_VERSION:
            raise ValueError(
                f"unknown session snapshot version "
                f"{header.get('version')}")
        arrays = np.load(io.BytesIO(data[4 + hlen:]),
                         allow_pickle=False)
        (_version, num_reports, num_rounds) = \
            [int(x) for x in arrays["meta"]]
        mastic = instantiate(header["spec"])
        sess = cls(mastic, header["spec"],
                   bytes.fromhex(header["ctx"]),
                   bytes.fromhex(header["verify_key"]),
                   config=config, faults_spec=faults_spec, device=device)
        bodies = [arrays["upload_0"].tobytes(),
                  arrays["upload_1"].tobytes()]
        if num_reports:
            sess.coll.upload_encoded(bodies, num_reports)
        for i in range(num_rounds):
            sess.completed.append((
                arrays[f"r{i}_param"].tobytes(),
                json.loads(arrays[f"r{i}_result"].tobytes()),
                np.asarray(arrays[f"r{i}_accept"], bool),
                (arrays[f"r{i}_share0"].tobytes(),
                 arrays[f"r{i}_share1"].tobytes()),
            ))
        sess._replay_index = 0
        return sess


def _repo_root() -> str:
    import pathlib
    return str(pathlib.Path(__file__).resolve().parents[2])


if __name__ == "__main__":
    party_main(sys.argv[1:])
