"""The serving cells: ``cli/serve.make_server`` in the run's process,
answering an open loop of single scans from the client process
(portbench/client.py) at the traffic's fixed rate.

Set-up: the request bodies (lib/inputs.make_scans: square scans, a drawing
between black bands), the run's weights as the checkpoint the server
loads, the server on an ephemeral localhost port with the configuration's
precision and batch and the traffic's ``max_wait_ms`` and
``fixed_height``, the batcher's warm-up (every launch batch size), and
each body sent once through HTTP, so every trimmed height's row operator
is built; then the client is started and reads the bodies.

Window: the client sends on its schedule (lib/schedule.arrivals) for the
window's seconds and waits for the answers. ``serve_p95_ms`` is the 95th
percentile over every request sent, each timed from when it was due; a
request that fails or is refused counts with the longest wait the run
allows.

A share of the requests, fixed by the traffic and placed by the seed, ask
for the class map (``format=mask``), the rest for the numbers.

Correctness, after the window. The reference trims each body's scan
(reference/postprocess.trim_rows) and runs the float32 model and clean-up
on it. ``mask_deficit``: over a sample of the map answers drawn from the
seed, the largest mean gap between the reference's logit of its own class
and of the answer's class, over the logits' spatial spread; ``mask_flip``,
``mask_tie_deficit``, ``mask_decisive``: the largest median of that gap
over the pixels where the maps differ, the deficit over the density of
near ties, and the share of pixels whose reference margin is decisive
and whose class differs (reference/postprocess.logit_gaps).
``answer_arith_pp``: over every numbers answer, the largest gap, in
percentage points of the image, between its percentages and areas and
those its own class counts give on the reference's trimmed size (an
answer of another height reads 100). ``answer_gap_pp``: over a sample of
them, the same against the reference's counts (printed; with random
weights the near-tie pixels move it as much as a lower precision does).
``never_answered``: requests with no answer at all. The cell's limits file
names the numbers that decide ``correct``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import reference
from portbench.lib import common, inputs
from portbench.lib.harness import BENCH, Outcome, Run
from portbench.lib.spans import Spans
from portbench.lib.trace import Trace
from portbench.reference import postprocess as ref


READINGS = ("mask_deficit", "mask_flip", "mask_tie_deficit",
            "mask_decisive", "answer_arith_pp", "answer_gap_pp",
            "never_answered")


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def _instrument(spans: Spans) -> None:
    from neuralbarkcalculator_tpu_torch.cli import serve as S
    from neuralbarkcalculator_tpu_torch.pipeline import serving as SV
    spans.wrap(S.BarkHandler, "do_POST", "harness/http/post")
    spans.wrap(SV.BatchingPredictor, "_serve_batch", "harness/batcher/batch")


def answer_gap_pp(answer: dict, want: dict, pixels: int, height: int
                  ) -> float:
    """The largest gap, in percentage points of the image, between an
    answer's class shares, percentages or areas and ``want``'s (an answer
    of another height reads 100)."""
    if answer.get("height") != height:
        return 100.0
    area_pp = 100.0 / (ref.MM2_PER_PIXEL * pixels)
    gaps = [abs(a - b) / pixels * 100.0
            for a, b in zip(answer["class_pixels"], want["counts"])]
    gaps += [abs(answer["bark_percent"] - want["bark_percent"]),
             abs(answer["node_percent"] - want["node_percent"]),
             abs(answer["bark_area_mm2"] - want["bark_area_mm2"]) * area_pp,
             abs(answer["node_area_mm2"] - want["node_area_mm2"]) * area_pp]
    return max(gaps)


def _mask_classes(path: str) -> np.ndarray:
    dual = common.read_gray(path)
    return ((dual == 127) * 1 + (dual == 255) * 2).astype(np.uint8)


class Reference:
    """The reference's trim, logits and map of each body, computed once."""

    def __init__(self, run: Run, bodies: list[str], ckpt: str):
        reference.exact_float32()
        self.run, self.bodies = run, bodies
        self.state = common.reference_state(ckpt, run.device)
        self.trims: dict[int, tuple[int, int]] = {}
        self.maps: dict[int, tuple] = {}

    def height(self, b: int) -> int:
        if b not in self.trims:
            self.trims[b] = ref.trim_rows(common.read_rgb(self.bodies[b]))
        first, last = self.trims[b]
        return last - first

    def logits_and_map(self, b: int):
        """The reference's (logits, map) of body b."""
        if b not in self.maps:
            self.height(b)
            first, last = self.trims[b]
            cfg = self.run.cell.config
            self.maps[b] = ref.logits_and_map(
                self.state, common.read_rgb(self.bodies[b])[first:last], cfg,
                self.run.device)
        return self.maps[b]


def check(run: Run, records: list[dict], bodies: list[str], ckpt: str
          ) -> tuple[list, list, dict]:
    """The program's answers against the reference (module docstring)."""
    tr, lim = run.cell.traffic, run.cell.limits
    R = Reference(run, bodies, ckpt)
    reads = dict.fromkeys(READINGS, 0.0)
    per = []
    for r in records:
        if "answer" in r:
            a = r["answer"]
            h = R.height(r["body"])
            n = h * a["width"]
            reads["answer_arith_pp"] = max(
                reads["answer_arith_pp"], answer_gap_pp(
                    a, ref.stats_of_counts(a["class_pixels"], n), n, h))
    rng = np.random.default_rng([run.seed, 5])
    for kind in ("answer", "mask"):
        have = [i for i, r in enumerate(records) if kind in r]
        k = min(tr["check_requests"], len(have))
        picks = (sorted(int(i) for i in rng.choice(have, size=k,
                                                   replace=False))
                 if k else [])
        name = "answer_gap_pp" if kind == "answer" else "mask_deficit"
        if not picks:
            reads[name] = float("inf")
            if kind == "mask":
                for k in ("flip", "tie_deficit", "decisive"):
                    reads["mask_" + k] = float("inf")
        for i in picks:
            b = records[i]["body"]
            logits, want = R.logits_and_map(b)
            if kind == "answer":
                v = answer_gap_pp(records[i]["answer"], ref.stats(want),
                                  want.size, want.shape[0])
            else:
                got = _mask_classes(records[i]["mask"])
                gaps = (ref.logit_gaps(logits, want, got)
                        if got.shape == want.shape else
                        dict.fromkeys(("deficit", "flip", "tie_deficit",
                                       "decisive"), float("inf")))
                for k in ("flip", "tie_deficit", "decisive"):
                    reads["mask_" + k] = max(reads["mask_" + k], gaps[k])
                v = gaps["deficit"]
            reads[name] = max(reads[name], v)
            per.append((i, b, kind, v))
    reads["never_answered"] = float(sum(1 for r in records
                                        if r.get("status") == 0))
    return ([(k, reads[k], lim[k]) for k in READINGS if k in lim], per,
            reads)


class Service:
    """The server of a run and its client's bodies, from set-up to
    shutdown (the driver's run, and portbench/sweep.py's several rates)."""

    def __init__(self, r: Run):
        from neuralbarkcalculator_tpu_torch.cli import serve as S

        cfg, tr = r.cell.config, r.cell.traffic
        pred = cfg["predict"]
        self.r = r
        self.body_dir = os.path.join(r.workdir, "bodies")
        self.bodies = inputs.make_scans(self.body_dir, r.seed, tr)
        self.ckpt = common.checkpoint(r, common.calibration_images(
            self.bodies))
        argv = [self.ckpt, "--device", r.device.type, "--host", "127.0.0.1",
                "--port", "0", "--model", cfg["model"],
                "--batch_size", str(pred["batch_size"]),
                "--max_wait_ms", str(tr["max_wait_ms"]),
                "--fixed_height", str(tr["fixed_height"])]
        if pred["dtype"] != "bfloat16":
            argv.append("--float32")
        if pred.get("int8"):
            argv.append("--int8")
        self.spans = Spans()
        _instrument(self.spans)
        self.server = S.make_server(S.build_parser().parse_args(argv))
        self.predictor = self.server.state.predictor
        self.port = self.server.server_address[1]
        S.serve_in_thread(self.server)
        self.predictor.warmup(tr["fixed_height"], tr["side"])
        from portbench.client import one_request
        payloads = []
        for path in self.bodies:
            with open(path, "rb") as f:
                payloads.append(f.read())
        with ThreadPoolExecutor(max_workers=pred["batch_size"]) as pool:
            for status, _ in pool.map(
                    lambda b: one_request(self.port, b, 600.0), payloads):
                if status != 200:
                    raise RuntimeError(f"warm-up request answered {status}")

    def window(self, rate: float, seconds: float, seed: int, trace: bool,
               tag: str = "client") -> dict:
        """One open-loop window at ``rate``; returns its records and
        readings."""
        from neuralbarkcalculator_tpu_torch.ops import upsample_argmax as UA
        from neuralbarkcalculator_tpu_torch.utils import profiling

        r, tr = self.r, self.r.cell.traffic
        out_path = os.path.join(r.workdir, f"{tag}.json")
        client = subprocess.Popen(
            [sys.executable, os.path.join(BENCH, "client.py"),
             "--port", str(self.port), "--bodies", self.body_dir,
             "--seed", str(seed), "--rate", str(rate),
             "--seconds", str(seconds), "--wait", str(tr["wait_s"]),
             "--mask_share", str(tr["mask_share"]), "--out", out_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            if client.stdout.readline().strip() != "ready":
                raise RuntimeError("the client did not start")
            self.spans.clear()
            profiling.report(reset=True)
            launches0 = UA.LAUNCHES.count
            stats_before = self.predictor.snapshot_stats()
            setup_peak = common.reset_peak(r.device)
            with Trace(trace) as tr_:
                t_start = time.perf_counter()
                with tr_.window():
                    client.stdin.write("go\n")
                    client.stdin.flush()
                    while time.perf_counter() - t_start < seconds:
                        time.sleep(0.05)
            stats_after = self.predictor.snapshot_stats()
            stages = profiling.report()
            if client.stdout.readline().strip() != "done":
                raise RuntimeError("the client did not finish")
            client.wait(timeout=60)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
        with open(out_path) as f:
            records = json.load(f)["records"]
        return {"records": records, "t_start": t_start,
                "setup_peak": setup_peak, "peak": common.peak(r.device),
                "launches": UA.LAUNCHES.count - launches0,
                "stats_before": stats_before, "stats_after": stats_after,
                "stages": stages, "trace": tr_ if trace else None}

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.predictor.close()
        self.spans.restore()
        del self.server, self.predictor
        common.free(self.r.device)


def latencies(records: list[dict], horizon_ms: float) -> list[float]:
    """Each request's latency; a failed one counts as ``horizon_ms``."""
    return [rec["latency_ms"] if rec.get("status") == 200 else horizon_ms
            for rec in records]


def run(r: Run) -> Outcome:
    if r.world is not None:
        raise ValueError("the serving driver runs in one process")
    tr = r.cell.traffic
    svc = Service(r)
    try:
        w = svc.window(tr["rate"], r.seconds, r.seed, r.trace)
    finally:
        svc.close()
    setup_s = w["t_start"] - r.t0
    records = w["records"]
    lat = latencies(records, (r.seconds + tr["wait_s"]) * 1e3)
    failed = sum(1 for rec in records if rec.get("status") != 200)
    late = [rec["late_ms"] for rec in records]
    ok = [rec for rec in records if "answer" in rec]
    r.log(f"serve: {len(records)} requests at {tr['rate']} requests/s, "
          f"{failed} failed, {w['launches']} upsample_argmax launches; "
          f"latency p50 {percentile(lat, 50):.3f} p95 "
          f"{percentile(lat, 95):.3f} p99 {percentile(lat, 99):.3f} max "
          f"{max(lat):.3f} ms; the client sent late by p50 "
          f"{percentile(late, 50):.3f}, max {max(late):.3f} ms; set-up "
          f"{setup_s:.3f} s")
    slices = {}
    for rec, ms in zip(records, lat):
        slices.setdefault(int(rec["due_s"] // 5) * 5, []).append(ms)
    r.log("serve: p95 by 5 s of due time: " + ", ".join(
        f"{k}-{k + 5} s {percentile(v, 95):.0f} ms"
        for k, v in sorted(slices.items())))
    done = [x["answered_s"] for x in records if x.get("status") == 200]
    if ok:
        r.log(f"serve: last answer {max(done):.3f} s after the window's "
              f"start; server compute_ms p50 "
              f"{percentile([x['answer']['compute_ms'] for x in ok], 50)}")
    for name, row in sorted(w["stages"].items()):
        r.log(f"stage {name}: {row['calls']} calls, {row['total_s']:.6f} s")
    checks, per, reads = check(r, records, svc.bodies, svc.ckpt)
    for i, b, kind, v in per:
        r.log(f"check request {i} (body {b}, {kind}): {v:.6g}")
    r.log("check readings: " + json.dumps(reads))
    readings = {"kind": "serve", "seconds": r.seconds,
                "answers": [x["answer"] for x in ok],
                "stats_before": w["stats_before"],
                "stats_after": w["stats_after"], "stages": w["stages"],
                "spans": svc.spans, "trace": w["trace"],
                "check_readings": reads}
    return Outcome(
        e2e={"serve_p95_ms": percentile(lat, 95), "setup_s": setup_s},
        attempted=len(records), failed=failed, checks=checks,
        memory_peak_bytes=max(w["setup_peak"], w["peak"]),
        readings=readings, trace=w["trace"])
