"""Mint the mutual-TLS credential set for a party deployment (copy of
the JAX package's `tools/certs.py`).

One self-signed CA plus one leaf certificate per party (leader,
helper, collector), each with its party name as CN and DNS SAN — the
name `net.transport.TlsConfig` pins at handshake time on BOTH ends
(server verifies the dialing client's cert name, client verifies the
listener's), so a credential minted for one role cannot impersonate
another even inside the same CA.

Everything shells out to the `openssl` CLI (no `cryptography` wheel
is needed); private keys are written by openssl straight to disk with
0600 permissions and never pass through this process's memory.  EC
P-256 keys keep minting fast enough to run per-test.

CLI:

    python -m mastic_tpu_torch.tools.certs --out DIR [--days N]
        [--parties a,b,c] [--expired NAME] [--ca-name CN]

writes DIR/ca.pem, DIR/ca.key and DIR/<party>.pem/<party>.key per
party.  `--expired NAME` additionally mints <NAME>-expired.pem (same
key, validity already over) for the negative-path test matrix.
"""

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile

DEFAULT_PARTIES = ("leader", "helper", "collector")
CURVE = "prime256v1"


def _run(cmd: list) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"openssl failed ({' '.join(cmd[:3])}...): "
            f"{proc.stderr.strip()[-500:]}")


def _genkey(path: pathlib.Path) -> None:
    _run(["openssl", "ecparam", "-name", CURVE, "-genkey", "-noout",
          "-out", str(path)])
    os.chmod(path, 0o600)


def mint_ca(out: pathlib.Path, ca_name: str = "mastic-ca",
            days: int = 365) -> None:
    """Self-signed CA keypair at out/ca.{key,pem}."""
    out.mkdir(parents=True, exist_ok=True)
    _genkey(out / "ca.key")
    _run(["openssl", "req", "-x509", "-new", "-key",
          str(out / "ca.key"), "-subj", f"/CN={ca_name}", "-days",
          str(days), "-sha256", "-out", str(out / "ca.pem")])


def mint_party(out: pathlib.Path, name: str, days: int = 365,
               suffix: str = "") -> None:
    """One leaf cert for `name`, signed by out/ca.*, SAN DNS:name.
    `days` may be negative: the validity window is already over (the
    expired-cert refusal fixture).  `suffix` renames the output pair
    (<name><suffix>.pem) without changing the certified name."""
    stem = f"{name}{suffix}"
    key = out / f"{stem}.key"
    _genkey(key)
    with tempfile.TemporaryDirectory() as tmp:
        csr = pathlib.Path(tmp) / "leaf.csr"
        ext = pathlib.Path(tmp) / "leaf.ext"
        ext.write_text(f"subjectAltName=DNS:{name}\n")
        _run(["openssl", "req", "-new", "-key", str(key), "-subj",
              f"/CN={name}", "-out", str(csr)])
        _run(["openssl", "x509", "-req", "-in", str(csr), "-CA",
              str(out / "ca.pem"), "-CAkey", str(out / "ca.key"),
              "-CAcreateserial", "-days", str(days), "-sha256",
              "-extfile", str(ext), "-out", str(out / f"{stem}.pem")])


def mint_party_set(out, parties: tuple = DEFAULT_PARTIES,
                   days: int = 365) -> pathlib.Path:
    """CA + one leaf per party; returns the directory path.  The
    one-call form the test fixtures use."""
    out = pathlib.Path(out)
    mint_ca(out, days=days)
    for name in parties:
        mint_party(out, name, days=days)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(
        description="mint the mTLS CA + per-party certs")
    parser.add_argument("--out", required=True,
                        help="output directory for ca.* and the "
                             "per-party pairs")
    parser.add_argument("--days", type=int, default=365)
    parser.add_argument("--parties", type=str,
                        default=",".join(DEFAULT_PARTIES),
                        help="comma-separated party names "
                             "(default leader,helper,collector)")
    parser.add_argument("--expired", type=str, default=None,
                        help="additionally mint NAME-expired.pem "
                             "(validity already over) for refusal "
                             "testing")
    parser.add_argument("--ca-name", type=str, default="mastic-ca")
    args = parser.parse_args()

    out = pathlib.Path(args.out)
    parties = tuple(p.strip() for p in args.parties.split(",")
                    if p.strip())
    mint_ca(out, ca_name=args.ca_name, days=args.days)
    for name in parties:
        mint_party(out, name, days=args.days)
    if args.expired:
        mint_party(out, args.expired, days=-1, suffix="-expired")
    print(f"certs: CA + {len(parties)} part"
          f"{'ies' if len(parties) != 1 else 'y'}"
          + (f" + {args.expired}-expired" if args.expired else "")
          + f" -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
