"""Serving soak: sustained mixed-size load against the port's
BatchingPredictor (pipeline/serving.py).

    python -m neuralbarkcalculator_tpu_torch.tools.serving_soak \
        --model_path MODEL.pt [--device cuda|cpu] [--minutes 10] \
        [--clients 8] [--batch 8] [--p99_ceiling_ms MS] [--out FILE]

A long-running serving process must hold a flat RSS across thousands of
micro-batches, a sane tail latency, and telemetry that adds up. Client
threads drive the predictor for the given time with a mixed workload
(several trimmed heights, so several launch shapes; a width mix; a
per-request exclude_nodes mix), then the soak checks:

- telemetry: served + errors + rejected == requests, no error, batches
  served, and a mean batch above 1 under more than two clients;
- RSS: the engine's ``bytes_h2d`` counter is sampled beside every RSS
  sample, from the moment the traffic has run a fifth of the soak (at
  most 10 s: the allocators' warm-up under concurrent clients is not a
  leak), and the RSS per uploaded MB, ``b``, is fitted by least squares
  over that series. The fit is clamped to [0, inf) before the residual
  ``rss - b * bytes_h2d`` is taken (a negative fit, which noise gives at
  low volumes, would make the residual grow with the uploads). The
  residual must stay flat (within ``rss_tolerance``): a leak not
  proportional to the uploads (queues, caches, rings);
- the slope, once the series has uploaded ``MIN_SLOPE_UPLOAD_MB`` (below
  that the fit is noise: a few MB of RSS jitter over a few MB or hundreds
  of MB uploaded): ``b`` at most 1.3 MB per uploaded MB (a transfer path
  holds no more than it stages), and on a clean platform at most 0.05,
  the raw flat-RSS invariant, the check that would catch a leak per
  request in the serving stack. A short calibration before the traffic
  says whether the platform is clean: it uploads fresh host buffers of at
  least 1024 x 1024 x 3 bytes, whatever the workload's shapes (16 puts,
  48 MB), with ``.to(device)`` and a synchronize, and measures the RSS
  they leave (clean below 0.05 MB per MB).

One time series cannot separate a leak per request from a retention per
uploaded byte (requests and bytes move together); the clean-platform
lane is the leak check. The report (JSON) goes to ``--out`` or to
stdout; a failed soak still writes it, then raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time

import numpy as np

# the calibration's smallest put and its number of puts: 16 x 3 MB, so
# sub-MB RSS jitter cannot make a clean platform look retentive
CALIBRATION_MIN_SHAPE = (1024, 1024, 3)
CALIBRATION_PUTS = 16
# below this many MB uploaded over the RSS series the fitted slope is
# noise, and the slope checks do not apply
MIN_SLOPE_UPLOAD_MB = 1024.0
# the RSS series starts once the traffic has run this share of the soak,
# at most SETTLE_MAX_S seconds
SETTLE_SHARE = 0.2
SETTLE_MAX_S = 10.0
CLEAN_MB_PER_MB = 0.05
MAX_MB_PER_MB = 1.3


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


def calibrate_platform_retention(device, shape=CALIBRATION_MIN_SHAPE,
                                 puts: int = CALIBRATION_PUTS) -> dict:
    """RSS growth per uploaded MB of this process's transfer path: `puts`
    fresh host buffers of `shape` (at least CALIBRATION_MIN_SHAPE a
    dimension), each moved with ``.to(device)`` and synchronized. Returns
    ``mb_per_mb`` (negative noise clamped to 0), ``put_bytes`` and
    ``puts``."""
    import torch

    device = torch.device(device)
    shape = tuple(max(a, b) for a, b in zip(shape, CALIBRATION_MIN_SHAPE))
    base = np.random.default_rng(7).integers(0, 256, shape, np.uint8)

    def put() -> None:
        t = torch.from_numpy(base.copy()).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        del t

    put()
    gc.collect()
    r0 = rss_mb()
    for _ in range(puts):
        put()
    gc.collect()
    grown = rss_mb() - r0
    return {"mb_per_mb": max(0.0, grown / (puts * base.nbytes / 2**20)),
            "put_bytes": int(base.nbytes), "puts": puts}


def fit_rss_per_upload(rss: np.ndarray, up: np.ndarray
                       ) -> tuple[float, float, np.ndarray]:
    """The least-squares RSS MB per uploaded MB over the series, raw and
    clamped to [0, inf), and the residual ``rss - clamped * up``."""
    du = up - up.mean()
    raw = (float(du @ (rss - rss.mean()) / (du @ du))
           if float(du @ du) > 1e-6 else 0.0)
    fit = max(0.0, raw)
    return raw, fit, rss - fit * up


def slope_violations(b_fit: float, retention: float,
                     uploaded_mb: float) -> list[str]:
    """The slope's checks once MIN_SLOPE_UPLOAD_MB were uploaded: the
    staging bound, and the raw flat-RSS bound on a clean platform."""
    out = []
    if uploaded_mb < MIN_SLOPE_UPLOAD_MB:
        return out
    if b_fit > MAX_MB_PER_MB:
        out.append(f"RSS slope {b_fit:.2f} MB per uploaded MB exceeds the "
                   f"staging bound {MAX_MB_PER_MB}: superlinear growth")
    if retention < CLEAN_MB_PER_MB and b_fit > CLEAN_MB_PER_MB:
        out.append(f"platform calibrates clean ({retention:.3f} MB/MB) but "
                   f"RSS grows {b_fit:.3f} MB per uploaded MB over "
                   f"{uploaded_mb:.0f} MB: a per-request leak in the "
                   f"serving or engine stack")
    return out


def run_soak(calc, seconds: float, clients: int = 6,
             heights=(896, 960, 1024), widths=(1024,),
             max_wait_ms: float = 25.0, rss_tolerance: float = 0.10,
             p99_ceiling_ms: float | None = None) -> dict:
    """Drive the soak against engine `calc`; returns the report, whose
    ``violations`` lists every failed check."""
    from ..pipeline.serving import BatchingPredictor
    from .serving_bench import device_name

    predictor = BatchingPredictor(calc, max_wait_ms=max_wait_ms)
    # every launch shape of every workload shape, so the soak measures
    # the steady state
    for w in widths:
        for h in heights:
            predictor.warmup(height=h, width=w)

    rng_global = np.random.default_rng(0)
    shapes = [(h, w) for w in widths for h in heights]
    images = {s: (rng_global.uniform(0.2, 0.9, (*s, 3)) * 255
                  ).astype(np.uint8) for s in shapes}

    stop = threading.Event()
    latencies: list[float] = []
    lat_lock = threading.Lock()
    client_errors: list[BaseException] = []

    def client(cid: int) -> None:
        rng = np.random.default_rng(100 + cid)
        while not stop.is_set():
            shape = shapes[int(rng.integers(len(shapes)))]
            t0 = time.perf_counter()
            try:
                res = predictor.submit(
                    images[shape],
                    exclude_nodes=bool(rng.integers(2))).result(timeout=600)
            except Exception as e:  # recorded, then raised by the caller
                client_errors.append(e)
                stop.set()
                return
            with lat_lock:
                latencies.append((time.perf_counter() - t0) * 1e3)
            if res.class_map.shape != shape or \
                    int(res.counts.sum()) != res.class_map.size:
                client_errors.append(AssertionError(
                    f"bad result: shape {res.class_map.shape} vs {shape}, "
                    f"counts sum {int(res.counts.sum())}"))
                stop.set()
                return

    calibration = calibrate_platform_retention(
        calc.device, shape=(max(heights), max(widths), 3))
    retention = calibration["mb_per_mb"]

    def bytes_h2d_mb() -> float:
        return calc.cache_stats()["bytes_h2d"] / 2**20

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    rss_samples: list[tuple[float, float, float]] = []
    t_start = time.monotonic()
    for t in threads:
        t.start()
    settle_s = min(SETTLE_MAX_S, SETTLE_SHARE * seconds)
    stop.wait(settle_s)
    while time.monotonic() - t_start < seconds:
        rss_samples.append((time.monotonic() - t_start, rss_mb(),
                            bytes_h2d_mb()))
        time.sleep(min(10.0, max(1.0, seconds / 30.0)))
    stop.set()
    for t in threads:
        t.join(timeout=600)
    stats = predictor.snapshot_stats()
    predictor.close()
    if client_errors:
        raise RuntimeError(f"client failure during soak: "
                           f"{client_errors[0]!r}")

    lat = np.asarray(latencies, np.float64)
    rss = np.asarray([m for _, m, _ in rss_samples], np.float64)
    up = np.asarray([b for _, _, b in rss_samples], np.float64)
    b_raw, b_fit, resid = fit_rss_per_upload(rss, up)
    third = max(1, len(rss) // 3)
    resid_first = float(resid[:third].mean())
    resid_last = float(resid[-third:].mean())
    uploaded_mb = float(up[-1] - up[0])
    report = {
        "tool": "neuralbarkcalculator_tpu_torch.tools.serving_soak",
        "device": device_name(calc.device),
        "seconds": seconds,
        "settle_seconds": settle_s,
        "clients": clients,
        "shapes": [list(s) for s in shapes],
        "requests": int(stats["requests"]),
        "served": int(stats["served"]),
        "errors": int(stats["errors"]),
        "rejected": int(stats["rejected"]),
        "batches": int(stats["batches"]),
        "mean_batch": float(stats["mean_batch"]),
        "throughput_rps": len(lat) / seconds,
        "latency_ms": {
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
            "max": float(lat.max()),
        } if lat.size else None,
        "rss_mb": {"first_third_mean": float(rss[:third].mean()),
                   "last_third_mean": float(rss[-third:].mean()),
                   "samples": [[t, m] for t, m, _ in rss_samples]},
        "platform_retention": {
            "calibrated_mb_per_mb": retention,
            "calibration_put_bytes": calibration["put_bytes"],
            "calibration_puts": calibration["puts"],
            "fitted_mb_per_mb": b_fit,
            "fitted_raw_mb_per_mb": b_raw,
            "uploaded_mb": uploaded_mb,
            "min_upload_mb_for_slope_check": MIN_SLOPE_UPLOAD_MB,
            "clean_platform": retention < CLEAN_MB_PER_MB,
            "slope_checked": uploaded_mb >= MIN_SLOPE_UPLOAD_MB,
            "note": ("calibrated = the pre-traffic put loop; fitted = the "
                     "least-squares RSS per uploaded MB over the series, "
                     "clamped at 0 (raw beside it); the slope checks apply "
                     "from min_upload_mb_for_slope_check uploaded"),
        },
        "rss_resid_mb": {
            "first_third_mean": resid_first,
            "last_third_mean": resid_last,
            "samples": [[t, float(m)]
                        for (t, _, _), m in zip(rss_samples, resid)],
        },
    }

    violations: list[str] = []
    if stats["served"] + stats["errors"] + stats["rejected"] \
            != stats["requests"]:
        violations.append(f"telemetry does not add up: {stats}")
    if stats["errors"]:
        violations.append(f"{stats['errors']} serve errors")
    if not lat.size or stats["batches"] == 0:
        violations.append("no traffic was served")
    if clients > 2 and stats["mean_batch"] <= 1.0:
        violations.append(
            f"no batching under {clients}-way load "
            f"(mean_batch={stats['mean_batch']})")
    if resid_last > resid_first * (1.0 + rss_tolerance):
        violations.append(
            f"upload-independent RSS grew {resid_first:.0f} -> "
            f"{resid_last:.0f} MB (> {rss_tolerance:.0%}): a leak not "
            f"proportional to transfers (queues, caches, rings)")
    violations += slope_violations(b_fit, retention, uploaded_mb)
    if p99_ceiling_ms is not None and lat.size and \
            float(np.percentile(lat, 99)) > p99_ceiling_ms:
        violations.append(
            f"p99 {np.percentile(lat, 99):.0f} ms exceeds the ceiling "
            f"{p99_ceiling_ms} ms")
    report["violations"] = violations
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", required=True,
                    help="a .pt checkpoint (torchvision-named state dict)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve from the CUDA card (default; fails "
                         "without one) or from the CPU")
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--p99_ceiling_ms", type=float, default=None)
    ap.add_argument("--out", default=None,
                    help="write the report here (default: stdout)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the soak from the command line; returns the report (raises
    AssertionError after writing it when a check failed)."""
    from ..config import PredictConfig
    from ..pipeline.predict import NeuralBarkCalculator

    args = build_parser().parse_args(argv)
    config = PredictConfig(model_path=args.model_path,
                           batch_size=args.batch, fixed_pad_height=1024)
    calc = NeuralBarkCalculator(args.model_path, config=config,
                                device=args.device)
    report = run_soak(calc, seconds=args.minutes * 60.0,
                      clients=args.clients,
                      p99_ceiling_ms=args.p99_ceiling_ms)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(json.dumps(report), flush=True)
    if report["violations"]:
        raise AssertionError("; ".join(report["violations"]))
    return report


if __name__ == "__main__":
    main()
