#!/usr/bin/env python3
"""The serving cell's rate sweep, run once when the cell's rate is set:
one server set up as the cell's run sets it up, then an open-loop window
at each rate.

    python3 portbench/sweep.py --workload fcn_resnet50.serve --seed 5 \
        --rates 40,60,80,100,120 --seconds 10

Prints one JSON line a rate (p50, p95, p99 of every request sent, each
timed from when it was due; the share answered by the window's end plus
the lowest rate's p95, so that the queue did not grow; the mean
micro-batch) and a last line with the knee: the highest rate at which
every request was answered by then and p95 stayed under twice its value
at the lowest rate, and 4/5 of it.
"""
import os
import sys
import time

T0 = time.perf_counter()

if not __package__:
    HERE = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

from portbench.lib import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    harness.cache_env()
    import torch
    cell = harness.find_cell(a.workload)
    driver = harness.driver_for(cell)
    workdir = tempfile.mkdtemp(prefix="portbench-sweep-")
    rows = []
    try:
        r = harness.Run(cell=cell, seed=a.seed, seconds=a.seconds,
                        trace=False, device=torch.device(a.device),
                        workdir=workdir, t0=T0)
        svc = driver.Service(r)
        horizon = (a.seconds + cell.traffic["wait_s"]) * 1e3
        grace = None
        try:
            for rate in (float(x) for x in a.rates.split(",")):
                w = svc.window(rate, a.seconds, a.seed, False,
                               tag=f"rate{rate:g}")
                recs = w["records"]
                lat = driver.latencies(recs, horizon)
                if grace is None:
                    grace = driver.percentile(lat, 95) / 1e3
                inside = sum(1 for x in recs if x.get("status") == 200
                             and x["answered_s"] <= a.seconds + grace)
                b0, b1 = w["stats_before"], w["stats_after"]
                batches = b1["batches"] - b0["batches"]
                row = {"rate": rate, "sent": len(recs),
                       "answered_inside": inside / max(len(recs), 1),
                       "p50_ms": driver.percentile(lat, 50),
                       "p95_ms": driver.percentile(lat, 95),
                       "p99_ms": driver.percentile(lat, 99),
                       "mean_batch": (b1["batch_size_sum"]
                                      - b0["batch_size_sum"]) / batches
                       if batches else 0.0,
                       "late_max_ms": max(x["late_ms"] for x in recs)}
                rows.append(row)
                print(json.dumps(row), flush=True)
        finally:
            svc.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    base = rows[0]["p95_ms"]
    ok = [x["rate"] for x in rows
          if x["answered_inside"] == 1.0 and x["p95_ms"] < 2 * base]
    knee = max(ok) if ok else None
    print(json.dumps({"knee": knee,
                      "cell_rate": round(0.8 * knee) if knee else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
