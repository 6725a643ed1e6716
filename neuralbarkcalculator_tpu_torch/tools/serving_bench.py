"""Online-serving latency benchmark of the port's server (cli/serve.py).

    python -m neuralbarkcalculator_tpu_torch.tools.serving_bench \
        --model_path MODEL.pt [--device cuda|cpu] [--seq_n 20] [--conc 8] \
        [--conc_m 5] [--int8 | --only bf16|int8] [--cold_start]

Starts the HTTP server in-process on an ephemeral port (``make_server``
on port 0; a structured 1024x1024 request from bench_data), warms it up,
then measures the client's latency for ``POST /v1/predict?format=json``:

- sequential: ``seq_n`` single requests back to back (the latency floor);
- concurrent: ``conc`` client threads x ``conc_m`` requests each
  (micro-batching under load).

It runs the bf16 engine and, with ``--int8``, the int8 one (``--only``
runs one of them). ``--cold_start`` instead starts the server as a child
process (``cli/serve``, default warm-up) and times it from the child's
start to its first answer: ``build_s`` (imports, model load, BN fold) up
to the warm-up, ``warmup_s`` (every launch shape of the ladder) up to
listening, ``total_s`` up to the first answer. The kernel libraries are
built at first use into the repository's ``build/`` (utils/build.py),
which has no per-process override, so a cold start uses the libraries
found there; the JAX tool's ``--wipe_cache`` (its XLA compile cache) has
no counterpart here.

Prints one JSON line per phase, each with the device it ran on. The
client, the HTTP threads, the decode and the postprocess share the host's
cores with the server.
"""
from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np


def make_request_body(size: int = 1024) -> bytes:
    """A structured size x size image (bench_data, seed 7) as PNG bytes."""
    from PIL import Image

    from .bench_data import structured_dual_mask, structured_image

    rng = np.random.default_rng(7)
    img = structured_image(rng, structured_dual_mask(rng, size, size))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def one_request(port: int, body: bytes) -> tuple[float, bytes]:
    """One JSON predict request: its client-side seconds and its answer.
    Raises unless the server answers 200."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/predict?format=json", body=body,
                 headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    payload = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{resp.status}: {payload[:200]!r}")
    return time.perf_counter() - t0, payload


def pct(vals, q) -> float:
    """The q-th percentile of seconds `vals`, in ms."""
    return float(np.percentile(np.asarray(vals) * 1000.0, q))


def device_name(device) -> str:
    """The card's name for a CUDA device, else "cpu"."""
    import torch

    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def serve_argv(model_path: str, int8: bool, device: str) -> list[str]:
    """cli/serve's arguments for one engine: port 0, batch 8."""
    return ([model_path, "--port", "0", "--batch_size", "8", "--device",
             device] + (["--int8"] if int8 else []))


def sequential(port: int, bodies: list[bytes], n: int, label: str,
               device: str) -> tuple[dict, list[bytes]]:
    """`n` single requests back to back, cycling through `bodies`: the
    phase's JSON row and the answers in order."""
    lat, answers = [], []
    for i in range(n):
        t, answer = one_request(port, bodies[i % len(bodies)])
        lat.append(t)
        answers.append(answer)
    return ({"phase": f"{label}_sequential", "n": n, "p50_ms": pct(lat, 50),
             "p95_ms": pct(lat, 95), "device": device}, answers)


def concurrent(port: int, bodies: list[bytes], conc: int, conc_m: int,
               label: str, device: str) -> tuple[dict, list[bytes]]:
    """`conc` client threads x `conc_m` requests each, client c's k-th
    request sending ``bodies[(c * conc_m + k) % len(bodies)]``: the
    phase's JSON row and the answers."""
    lat, answers, errs = [], [], []
    lock = threading.Lock()

    def client(c: int):
        for k in range(conc_m):
            try:
                t, answer = one_request(
                    port, bodies[(c * conc_m + k) % len(bodies)])
            except Exception as e:  # reported after the join
                with lock:
                    errs.append(repr(e))
                return
            with lock:
                lat.append(t)
                answers.append(answer)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(conc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent phase failed: {errs[:1]}")
    return ({"phase": f"{label}_concurrent", "clients": conc,
             "total": conc * conc_m, "p50_ms": pct(lat, 50),
             "p95_ms": pct(lat, 95), "req_per_s": len(lat) / wall,
             "device": device}, answers)


def run_config(argv: list[str], seq_n: int, conc: int, conc_m: int,
               size: int = 1024, mesh=None) -> list[dict]:
    """The sequential and concurrent phases against an in-process server
    built from cli/serve arguments `argv`, with size x size requests.
    ``mesh``: grid rank 0's place in a mesh whose other ranks follow
    (cli/serve.make_server)."""
    from ..cli.serve import build_parser, make_server, serve_in_thread

    args = build_parser().parse_args(argv)
    server = make_server(args, mesh=mesh)
    state = server.state
    serve_in_thread(server)
    port = server.server_address[1]
    bodies = [make_request_body(size)]
    label = "int8" if args.int8 else "float32" if args.float32 else "bf16"
    device = device_name(args.device)
    try:
        state.predictor.warmup(height=size, width=size)
        one_request(port, bodies[0])  # the HTTP path, warm
        return [sequential(port, bodies, seq_n, label, device)[0],
                concurrent(port, bodies, conc, conc_m, label, device)[0]]
    finally:
        server.shutdown()
        server.server_close()
        state.predictor.close()


def run_cold_start(argv: list[str], size: int = 1024,
                   timeout: float = 600.0) -> dict:
    """Start ``cli/serve`` with `argv` (warm-up included) as a child
    process on an ephemeral port; time it from the start to the warm-up
    line, to listening and to its first answer; then stop it (SIGINT)."""
    from ..cli.serve import build_parser

    args = build_parser().parse_args(argv)
    body = make_request_body(size)
    lines: queue.Queue = queue.Queue()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "neuralbarkcalculator_tpu_torch.cli.serve",
         *argv], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    log: list[str] = []

    def reader():
        for line in child.stdout:
            lines.put((time.perf_counter(), line))
        lines.put((time.perf_counter(), None))

    threading.Thread(target=reader, daemon=True).start()
    t_warm = port = None
    try:
        deadline = t0 + timeout
        while port is None:
            t, line = lines.get(
                timeout=max(0.0, deadline - time.perf_counter()))
            if line is None:
                raise RuntimeError(f"the server exited before listening "
                                   f"({child.wait()}): {''.join(log)[-3000:]}")
            log.append(line)
            if line.startswith("warming up"):
                t_warm = t
            match = re.search(r"on http://[^:]+:(\d+)", line)
            if match:
                port, t_listen = int(match.group(1)), t
        one_request(port, body)
        t_answer = time.perf_counter()
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGINT)
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
    t_warm = t_listen if t_warm is None else t_warm
    return {"phase": "cold_start",
            "engine": "int8" if args.int8 else
            "float32" if args.float32 else "bf16",
            "model_path": os.path.basename(args.model_path),
            "build_s": t_warm - t0, "warmup_s": t_listen - t_warm,
            "total_s": t_answer - t0, "device": device_name(args.device)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", required=True,
                    help="a .pt checkpoint (torchvision-named state dict) "
                         "or an offline *.int8.pt")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve from the CUDA card (default; fails "
                         "without one) or from the CPU")
    ap.add_argument("--seq_n", type=int, default=20)
    ap.add_argument("--conc", type=int, default=8)
    ap.add_argument("--conc_m", type=int, default=5)
    ap.add_argument("--int8", action="store_true",
                    help="also run the int8 engine")
    ap.add_argument("--only", choices=["bf16", "int8"],
                    help="run a single engine")
    ap.add_argument("--cold_start", action="store_true",
                    help="time a child server from its start to its first "
                         "answer instead of the request latency")
    args = ap.parse_args()

    if args.only:
        engines = [args.only == "int8"]
    else:
        engines = [False, True] if args.int8 else [False]
    for int8 in engines:
        argv = serve_argv(args.model_path, int8, args.device)
        if args.cold_start:
            print(json.dumps(run_cold_start(argv)), flush=True)
            continue
        for row in run_config(argv, args.seq_n, args.conc, args.conc_m):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
