#!/usr/bin/env python3
"""The serving cells' client: an open loop of POST /v1/predict?format=json
requests in a process of its own.

    python3 portbench/client.py --port P --bodies DIR --seed S --rate R \
        --seconds T --wait W --mask_share M --out FILE

The requests that lib/schedule.masks picks ask for the class map
(``format=mask``, saved as FILE.masks/<request>.png), the others for the
numbers (``format=json``). It reads the request bodies (DIR/*.png, in
name order), prints ``ready``,
and waits for a line on standard input; that line starts the window. Each
request of lib/schedule.arrivals is sent at its time by one of a pool of
threads, whether or not earlier ones were answered, and is timed from the
time it was due (``latency_ms``); ``late_ms`` is how late it was sent.
A request unanswered ``W`` seconds after the window's end is given up.
The records go to FILE as JSON, then ``done`` is printed. The request
itself is a copy of neuralbarkcalculator_tpu_torch/tools/serving_bench.py's
``one_request``.
"""
import argparse
import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

if not __package__:  # run as a script: import portbench from the checkout
    HERE = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, os.path.dirname(HERE))

from portbench.lib.schedule import arrivals, masks  # noqa: E402

THREADS = 512


def one_request(port: int, body: bytes, timeout: float,
                fmt: str = "json") -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", f"/v1/predict?format={fmt}", body=body,
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--bodies", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--wait", type=float, required=True)
    p.add_argument("--mask_share", type=float, default=0.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    names = sorted(f for f in os.listdir(a.bodies) if f.endswith(".png"))
    bodies = []
    for n in names:
        with open(os.path.join(a.bodies, n), "rb") as f:
            bodies.append(f.read())
    plan = arrivals(a.seed, a.rate, a.seconds, len(bodies))
    as_mask = masks(a.seed, len(plan), a.mask_share)
    mask_dir = a.out + ".masks"
    os.makedirs(mask_dir, exist_ok=True)
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.perf_counter()
    deadline = t0 + a.seconds + a.wait
    records = [None] * len(plan)
    lock = threading.Lock()

    def send(i: int) -> None:
        due, body = plan[i]
        delay = t0 + due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sent = time.perf_counter()
        rec = {"body": body, "due_s": due, "late_ms": (sent - t0 - due) * 1e3}
        fmt = "mask" if as_mask[i] else "json"
        try:
            status, payload = one_request(a.port, bodies[body],
                                          max(1.0, deadline - sent), fmt)
            rec["status"] = status
            if status == 200 and fmt == "json":
                rec["answer"] = json.loads(payload)
            elif status == 200:
                rec["mask"] = os.path.join(mask_dir, f"{i}.png")
                with open(rec["mask"], "wb") as f:
                    f.write(payload)
            else:
                rec["error"] = payload[:200].decode(errors="replace")
        except (OSError, http.client.HTTPException) as e:
            rec["status"] = 0
            rec["error"] = repr(e)[:200]
        done = time.perf_counter()
        rec["latency_ms"] = (done - t0 - due) * 1e3
        rec["answered_s"] = done - t0
        with lock:
            records[i] = rec

    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        futures = [pool.submit(send, i) for i in range(len(plan))]
        for f in futures:
            f.result()
    with open(a.out, "w") as f:
        json.dump({"window_s": a.seconds, "records": records}, f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
