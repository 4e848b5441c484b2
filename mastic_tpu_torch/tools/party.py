"""Standalone network aggregator party (port of the JAX package's
`tools/party.py`): the deployment shape where leader and helper are
long-lived processes on their own hosts, reachable only over
authenticated TCP.

    python -m mastic_tpu_torch.tools.party serve --listen 127.0.0.1:0 \
        [--peer-listen 127.0.0.1:0] [--device cuda] \
        --tls-cert certs/leader.pem --tls-key certs/leader.key \
        --tls-ca certs/ca.pem [--port-file ports.json] [--once]

The process binds its listener(s), publishes the bound ports
(`--port-file`, atomic rename — how a caller finds `--listen host:0`),
and serves collector sessions forever (or one, with `--once`), each on
`--device` ("cuda" unless the CPU is asked for):

* every inbound connection is authenticated by the mutual-TLS gate
  (`net.transport.TcpListener`): CA pinning, client-cert requirement,
  peer-name check ("collector" on the main listener, "helper" on the
  leader's peer listener).  Plaintext, wrong-CA, expired or misnamed
  dialers are refused reason-coded before a single session byte;
* the session config — which binds the VERIFY KEY — arrives as the
  first framed message on the established mTLS channel (the network
  twin of the spawn path's private-stdin handoff; never argv, never
  the environment);
* channels are reliable (`drivers/session.ReliableChannel`): frames
  are sequence-numbered, acked and replay-buffered, so a dropped
  connection or healed partition redials and resumes exactly-once;
* a collector that abandons its session and opens a new one (respawn)
  hands over cleanly: the accept-side resume handshake surfaces the
  fresh session (`SessionRestart`) and the serve loop resets party
  state without dropping the new connection;
* a `--device` the machine does not have NAKs the collector's session
  and ends the process with exit code 1.

TLS flags fall back to the `MASTIC_NET_TLS_CERT` / `_KEY` / `_CA`
levers; with neither, the listener speaks plaintext (tests only — a
real deployment arms TLS).
"""

import argparse
import json
import os
import sys


def parse_hostport(text: str) -> tuple:
    (host, _, port) = text.rpartition(":")
    if not host or not port.lstrip("-").isdigit():
        raise ValueError(f"--listen wants host:port, got {text!r}")
    return (host, int(port))


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives a power cut
    (the tail of the tmp → fsync → replace → fsync(dir) atomic-write
    sequence)."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_port_file(path: str, ports: dict) -> None:
    # fsync-then-rename: a reader polling for this file must never
    # observe a torn JSON body under the final name.
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ports, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def serve(args) -> int:
    from ..drivers import faults as faults_mod
    from ..drivers import parties as parties_mod
    from ..drivers import session as session_mod
    from ..drivers.session import (SessionConfig, SessionError,
                                   reliable_accept, reliable_connect)
    from ..net.transport import (SessionRestart, TcpListener, TlsConfig,
                                 shape_from_env)
    from ..obs import trace as obs_trace

    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            print("party: --tls-cert/--tls-key/--tls-ca must all be "
                  "given (or none)", file=sys.stderr)
            return 2
        tls = TlsConfig(args.tls_cert, args.tls_key, args.tls_ca)
    else:
        tls = TlsConfig.from_env()

    config = SessionConfig.from_env()
    shaper = shape_from_env()
    (host, port) = parse_hostport(args.listen)
    listener = TcpListener(
        host, port,
        tls=tls.expecting("collector") if tls else None)
    peer_listener = None
    # The listeners live in a try/finally from the instant they are
    # bound: a failed peer-listener bind, a port-file write error or
    # a crash out of the serve loop must not strand the bound fds.
    try:
        if args.peer_listen:
            (ph, pp) = parse_hostport(args.peer_listen)
            peer_listener = TcpListener(
                ph, pp, tls=tls.expecting("helper") if tls else None)
        if args.port_file:
            _write_port_file(args.port_file, {
                "listen": listener.port,
                "peer_listen": (peer_listener.port
                                if peer_listener else None)})
        print(f"party: listening on {host}:{listener.port}"
              + (f" (peer {ph}:{peer_listener.port})"
                 if peer_listener else "")
              + (" [mTLS]" if tls else " [plaintext]")
              + f" on {args.device}", file=sys.stderr, flush=True)

        restart = None
        sessions = 0
        while True:
            peer = None
            coll = None
            try:
                coll = reliable_accept(listener, "collector", config,
                                       restart=restart)
                restart = None
                raw_cfg = coll.recv_msg(
                    "config", timeout=config.connect_timeout)
                cfg = json.loads(raw_cfg)
                agg_id = cfg["agg_id"]
                me = "leader" if agg_id == 0 else "helper"
                injector = (
                    faults_mod.FaultInjector(
                        faults_mod.parse_faults(cfg["faults"]), me)
                    if cfg.get("faults")
                    else faults_mod.injector_from_env(me))
                # Arm the already-built channel with this session's
                # injector (the config that names the faults rides
                # the very channel they apply to).
                coll.tp.injector = injector

                def trace(what: str, _me=me, **fields) -> None:
                    obs_trace.event("party_step", party=_me,
                                    step=what, **fields)

                def checkpoint(step: str, _inj=injector) -> None:
                    if _inj is not None:
                        _inj.checkpoint(step)

                checkpoint("spawn")
                try:
                    party = parties_mod.build_party(cfg, args.device)
                except SessionError as err:
                    # This party cannot serve on its device: say so on
                    # the channel, then end the process.
                    coll.send_msg(parties_mod.nak_payload(err), "nak")
                    print(f"party: {err}", file=sys.stderr, flush=True)
                    return 1
                coll.send_msg(bytes([agg_id]), "hello")
                trace("engine up (network session)")
                if agg_id == 0:
                    if peer_listener is None:
                        raise SessionError(
                            "collector", "config",
                            session_mod.KIND_PROTOCOL,
                            "leader config but no --peer-listen "
                            "listener to accept the helper on")
                    peer = reliable_accept(peer_listener, "helper",
                                           config,
                                           injector=injector,
                                           shaper=shaper)
                else:
                    (peer_host, peer_port) = cfg["peer"]
                    peer = reliable_connect(
                        peer_host, int(peer_port), "leader", config,
                        tls=tls, injector=injector, shaper=shaper)
                trace("peer channel up")
                parties_mod._command_loop(party, coll, peer, config,
                                          injector, trace,
                                          checkpoint)
                sessions += 1
                print(f"party: session {sessions} complete",
                      file=sys.stderr, flush=True)
            except SessionRestart as sr:
                restart = sr
                print("party: collector opened a new session; "
                      "resetting", file=sys.stderr, flush=True)
                continue
            except SessionError as err:
                # A dead collector or an exhausted redial budget
                # ends the session attributed; the server survives
                # to take the next one.
                print(f"party: session error: {err}",
                      file=sys.stderr, flush=True)
                if args.once:
                    return 1
            finally:
                for chan in (peer, coll):
                    if chan is not None:
                        chan.close()
            if args.once and restart is None:
                break
        return 0
    finally:
        listener.close()
        if peer_listener is not None:
            peer_listener.close()


def main() -> int:
    parser = argparse.ArgumentParser(
        description="standalone network aggregator party")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="bind the listeners and serve "
                                      "collector sessions")
    sp.add_argument("--listen", required=True,
                    help="host:port for collector sessions (port 0 "
                         "= ephemeral; see --port-file)")
    sp.add_argument("--peer-listen", default=None,
                    help="host:port for the helper's prep-exchange "
                         "link (leader role only)")
    sp.add_argument("--device", default="cuda",
                    help="the torch device the party runs on "
                         "(default cuda; cpu runs the kernels' plain "
                         "versions)")
    sp.add_argument("--tls-cert", default=None)
    sp.add_argument("--tls-key", default=None)
    sp.add_argument("--tls-ca", default=None,
                    help="pinned CA bundle; with cert/key, arms "
                         "mutual TLS (else MASTIC_NET_TLS_* env, "
                         "else plaintext)")
    sp.add_argument("--port-file", default=None,
                    help="write the bound ports as JSON (atomic "
                         "rename)")
    sp.add_argument("--once", action="store_true",
                    help="serve exactly one session then exit")
    args = parser.parse_args()
    if args.cmd == "serve":
        return serve(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
