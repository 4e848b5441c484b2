"""The HTTP floor under the WAL bench: how many PUTs a second one
process serves when the door does nothing, with the bench's shape (a
`ThreadingHTTPServer` on 127.0.0.1 answering keep-alive PUTs of a
402-byte body, the size of the bench's MasticCount(2) upload, and 32
client threads in the same process, 20 000 requests).

    python3 artifacts/torch_port_pr14/http_floor.py [--runs 3]

Each run is a fresh process (`--child bare|torch`: torch imported first
or not), alternating bare, torch, torch, bare, ...; prints the card's
name and power limit where `nvidia-smi` exists, then one line a run.
`loadgen --wal-bench`'s group-commit mode runs this path plus the door,
the WAL and the service, so its rate stays under this floor; its gate
asks for 5x the snapshot-before-ack rate.
"""

import argparse
import shutil
import subprocess
import sys
import threading
import time

REQUESTS = 20000
WORKERS = 32
BODY = 402


def serve_and_drive() -> float:
    from http.client import HTTPConnection
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_PUT(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(201)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    body = b"x" * BODY
    next_i = [0]
    mu = threading.Lock()

    def worker() -> None:
        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        while True:
            with mu:
                if next_i[0] >= REQUESTS:
                    break
                next_i[0] += 1
            conn.request("PUT", "/v1/tenants/count/reports", body=body)
            resp = conn.getresponse()
            resp.read()
        conn.close()

    threads = [threading.Thread(target=worker) for _ in range(WORKERS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rate = REQUESTS / (time.perf_counter() - t0)
    server.shutdown()
    return rate


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--child", choices=("bare", "torch"), default=None)
    args = parser.parse_args()
    if args.child is not None:
        if args.child == "torch":
            import torch  # noqa: F401  (its threads and libraries loaded)
        print(f"{serve_and_drive():.1f}")
        return 0
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    order = []
    for i in range(args.runs):
        order += ["bare", "torch"] if i % 2 == 0 else ["torch", "bare"]
    for kind in order:
        out = subprocess.run([sys.executable, __file__, "--child", kind],
                             capture_output=True, text=True, timeout=600,
                             check=True).stdout.strip()
        print(f"http floor ({kind}): {out} PUTs/s, {REQUESTS} requests, "
              f"{WORKERS} client threads in the server's process",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
