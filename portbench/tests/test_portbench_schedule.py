"""The open-loop schedule is drawn from the seed, and a request's latency
is timed from when it was due."""
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from portbench.lib import harness
from portbench.lib.schedule import arrivals


def test_arrivals_are_drawn_from_the_seed():
    a = arrivals(2 ** 31 + 11, 50.0, 10.0, 32)
    assert a == arrivals(2 ** 31 + 11, 50.0, 10.0, 32)
    b = arrivals(2 ** 31 + 12, 50.0, 10.0, 32)
    assert a != b
    assert len(a) == len(b) == 500
    assert all(0.0 <= t < 10.0 for t, _ in a)

    def gaps(x):
        return set(np.round(np.diff([t for t, _ in x]), 12))

    # the same gaps and bodies for every seed, in another order (the
    # differences of the send times hold all the gaps but one)
    assert len(gaps(a) ^ gaps(b)) <= 2
    assert sorted(k for _, k in a) == sorted(k for _, k in b)


class _Slow(BaseHTTPRequestHandler):
    """Answers one request at a time, each after 80 ms."""
    lock = threading.Lock()

    def log_message(self, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with self.lock:
            threading.Event().wait(0.08)
        body = json.dumps({"queue_ms": 0.0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_latency_is_timed_from_the_due_time(tmp_path):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    bodies = tmp_path / "bodies"
    bodies.mkdir()
    (bodies / "a.png").write_bytes(b"x" * 100)
    out = tmp_path / "out.json"
    try:
        p = subprocess.Popen(
            [sys.executable, os.path.join(harness.BENCH, "client.py"),
             "--port", str(server.server_address[1]), "--bodies",
             str(bodies), "--seed", "3", "--rate", "40", "--seconds", "0.5",
             "--wait", "20", "--out", str(out)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        assert p.stdout.readline().strip() == "ready"
        p.stdin.write("go\n")
        p.stdin.flush()
        assert p.stdout.readline().strip() == "done"
        assert p.wait(timeout=60) == 0
    finally:
        server.shutdown()
        server.server_close()
    recs = json.loads(out.read_text())["records"]
    assert len(recs) == 20 and all(r["status"] == 200 for r in recs)
    for r in recs:
        assert abs(r["latency_ms"] - (r["answered_s"] - r["due_s"]) * 1e3) \
            < 1e-6
        assert r["late_ms"] >= 0.0
    # 20 requests due within 0.5 s, answered one at a time in 80 ms each:
    # the last ones waited for the queue, and that wait is their latency
    last = max(recs, key=lambda r: r["answered_s"])
    assert last["answered_s"] >= 20 * 0.08 - 0.01
    assert last["latency_ms"] >= (20 * 0.08 - last["due_s"]) * 1e3 - 10
