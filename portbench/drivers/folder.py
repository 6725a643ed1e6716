"""The folder cells: ``NeuralBarkCalculator.predict(root)`` over a folder
of processed images, pass after pass, for the window.

Set-up: the traffic's folder (lib/inputs.make_folder: drawings linked
under many names), the run's weights written as the checkpoint the engine
loads, the engine, and one pass over a small folder that holds every
height of the traffic in full launch batches of each height bucket, so
every launch shape, row operator and kernel build is done before the
window.

Window: ``predict(root)`` runs again until the window's seconds have
passed; the pass that is open then runs to its end. An image counts when
both of its artifacts (the combined figure and the dual PNG) were written
inside the window: ``folder_images_per_s`` is that count over the window's
seconds. With ``--trace 1`` the profiled window is the whole passes.

Correctness, after the window: a sample of the folder's files drawn from
the seed; for each, the reference (reference/postprocess.logits_and_map,
float32 at the image's own size) against the dual PNG the program wrote
(``map_mismatch``, the share of differing pixels, and the gaps of
reference/postprocess.logit_gaps: ``map_deficit``, ``map_flip``,
``map_tie_deficit``, ``map_decisive``), and against the program's
final_stats.csv row (``csv_gap_pp``: the largest gap of a percentage, or
of an area as a share of the image, in percentage points;
``csv_arith_pp``: the same against the statistics of the program's own
dual PNG, the CSV arithmetic alone). Each is the worst image's. The
cell's limits file names the numbers that decide ``correct``; every one
is printed.
"""
from __future__ import annotations

import csv
import json
import os
import threading
import time

import numpy as np

from portbench.lib import common, flops, inputs
from portbench.lib.harness import Outcome, Run
from portbench.lib.spans import Spans
from portbench.lib.trace import Trace
from portbench.reference import model as M
from portbench.reference import postprocess as ref


def _warm_records(records: list[dict], bucket: int, batch: int
                  ) -> list[dict]:
    """For each height bucket of the folder, ``batch`` of its files, every
    height of the bucket among them."""
    by_bucket: dict[int, list[dict]] = {}
    for r in records:
        by_bucket.setdefault(-(-r["height"] // bucket), []).append(r)
    out = []
    for group in by_bucket.values():
        heights = sorted({r["height"] for r in group})
        firsts = [next(r for r in group if r["height"] == h)
                  for h in heights]
        rest = [r for r in group if r not in firsts]
        out += (firsts + rest)[:batch]
    return out


class Artifacts:
    """When each image's figure and dual PNG were written."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.done: dict[tuple[str, str], list[float]] = {}

    def mark(self, path: str) -> None:
        key = (os.path.basename(os.path.dirname(path)),
               os.path.basename(path))
        now = time.perf_counter()
        with self.lock:
            self.done.setdefault(key, []).append(now)

    def clear(self) -> None:
        with self.lock:
            self.done.clear()

    def complete_by(self, t: float) -> int:
        """Images whose two artifacts were both written by ``t``: the
        figure and the dual of a pass are its first two marks, the next
        pass's the next two, and so on."""
        with self.lock:
            n = 0
            for marks in self.done.values():
                ends = sorted(marks)
                n += sum(1 for k in range(1, len(ends), 2) if ends[k] <= t)
            return n


def _instrument(spans: Spans, artifacts: Artifacts, calls: list) -> None:
    from neuralbarkcalculator_tpu_torch.pipeline import predict as P
    from neuralbarkcalculator_tpu_torch.pipeline import report as R

    kernel = P.upsample_argmax

    def upsample_argmax(feat, row_ops, colt, *rest, **kw):
        with spans.span("harness/upsample_argmax"):
            calls.append((feat.shape[0], feat.shape[1], feat.shape[2],
                          row_ops.shape[1], colt.shape[1]))
            return kernel(feat, row_ops, colt, *rest, **kw)

    spans.patch(P, "upsample_argmax", upsample_argmax)

    for attr, name, path_arg in (("render_combined_fast", "figure", 2),
                                 ("save_dual", "dual", 1)):
        original = getattr(R, attr)

        def written(*args, _f=original, _name=name, _at=path_arg, **kw):
            with spans.span(f"harness/report/{_name}"):
                out = _f(*args, **kw)
            artifacts.mark(args[_at])
            return out

        spans.patch(R, attr, written)
    spans.wrap(R.PredictReporter, "add", "harness/report/add")
    spans.wrap(P.NeuralBarkCalculator, "_launch_batch", "harness/engine/launch")
    spans.wrap(P.NeuralBarkCalculator, "predict", "harness/predict_pass")


def _read_csv(path: str) -> dict[tuple[str, str], list[float]]:
    with open(path) as f:
        rows = list(csv.reader(f, delimiter="\t"))[1:]
    return {(r[0], r[1]): [float(x) for x in r[2:6]] for r in rows}


def _dual_classes(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        dual = np.asarray(im.convert("L"))
    return ((dual == 127) * 1 + (dual == 255) * 2).astype(np.uint8)


def csv_gap_pp(row: list[float], want: dict, pixels: int) -> float:
    """The largest gap, in percentage points of the image, between a CSV
    row [bark %, bark mm^2, node %, node mm^2] and the reference's."""
    area_pp = 100.0 / (ref.MM2_PER_PIXEL * pixels)
    return max(abs(row[0] - want["bark_percent"]),
               abs(row[1] - want["bark_area_mm2"]) * area_pp,
               abs(row[2] - want["node_percent"]),
               abs(row[3] - want["node_area_mm2"]) * area_pp)


READINGS = ("map_mismatch", "map_deficit", "map_flip", "map_tie_deficit",
            "map_decisive", "csv_gap_pp", "csv_arith_pp")


def sample(run: Run, n_records: int) -> list[int]:
    """The files a run checks, drawn from its seed."""
    rng = np.random.default_rng([run.seed, 5])
    k = min(run.cell.traffic["check_images"], n_records)
    return sorted(int(i) for i in rng.choice(n_records, size=k,
                                             replace=False))


def compare(run: Run, records: list[dict], ckpt: str, got) -> tuple:
    """The sampled files: the reference's logits and map of each file (its
    drawing, computed once) against ``got(record, image)``, which gives
    (class map, [bark %, bark mm^2, node %, node mm^2]). Every number read
    is returned; those the cell's limits name are the checks."""
    cfg = run.cell.config
    M.exact_float32()
    state = common.reference_state(ckpt, run.device)
    refs: dict[int, tuple] = {}
    worst = dict.fromkeys(READINGS, 0.0)
    per = []
    for i in sample(run, len(records)):
        rec = records[i]
        if rec["drawing"] not in refs:
            img = common.read_rgb(rec["path"])
            logits, want = ref.logits_and_map(
                state, img, cfg["model"], cfg["mean"], cfg["std"],
                run.device)
            refs[rec["drawing"]] = (img, logits, want)
        img, logits, want = refs[rec["drawing"]]
        cmap, row = got(rec, img)
        same = cmap.shape == want.shape
        st = ref.stats(want)
        got_st = ref.stats(cmap)
        reads = {
            "map_mismatch": float((cmap != want).mean()) if same else 1.0,
            **({"map_" + k: v for k, v in
                ref.logit_gaps(logits, want, cmap).items()} if same else
               {"map_deficit": float("inf"), "map_flip": float("inf"),
                "map_tie_deficit": float("inf"),
                "map_decisive": float("inf")}),
            "csv_gap_pp": csv_gap_pp(row, st, want.size),
            "csv_arith_pp": csv_gap_pp(row, got_st, cmap.size)}
        for k, v in reads.items():
            worst[k] = max(worst[k], v)
        per.append((rec["name"], rec["height"], reads,
                    [round(c / want.size, 4) for c in st["counts"]]))
    lim = run.cell.limits
    return [(k, worst[k], lim[k]) for k in READINGS if k in lim], per, worst


def check(run: Run, records: list[dict], results: str, ckpt: str
          ) -> tuple[list, list, dict]:
    """The program's dual PNGs and final_stats.csv rows against the
    reference (module docstring)."""
    table = _read_csv(os.path.join(results, "final_stats.csv"))

    def got(rec, _img):
        return (_dual_classes(os.path.join(results, "outputs",
                                           rec["wood_type"], rec["name"])),
                table[(rec["name"], rec["wood_type"])])

    return compare(run, records, ckpt, got)


def run(r: Run) -> Outcome:
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.ops import upsample_argmax as UA
    from neuralbarkcalculator_tpu_torch.pipeline import predict as P
    from neuralbarkcalculator_tpu_torch.utils import profiling

    cfg, tr = r.cell.config, r.cell.traffic
    pred = cfg["predict"]
    root = os.path.join(r.workdir, "folder")
    marks = [("start", time.perf_counter())]
    records = inputs.make_folder(root, r.seed, tr)
    marks.append(("folder drawn", time.perf_counter()))
    warm = os.path.join(r.workdir, "warm")
    inputs.link_folder(warm, _warm_records(records, pred["height_bucket"],
                                           pred["batch_size"]))
    ckpt = common.checkpoint(r, common.calibration_images(
        inputs.drawing_files(root)))
    marks.append(("weights written", time.perf_counter()))
    config = PredictConfig(model_path=ckpt, batch_size=pred["batch_size"],
                           height_bucket=pred["height_bucket"],
                           figure_dpi=tr["figure_dpi"],
                           use_bfloat16=pred["dtype"] == "bfloat16",
                           quantize_int8=pred.get("int8", False))
    engine = P.NeuralBarkCalculator(ckpt, config=config,
                                    model_name=cfg["model"],
                                    device=r.device)
    marks.append(("engine loaded", time.perf_counter()))
    spans, artifacts, calls = Spans(), Artifacts(), []
    _instrument(spans, artifacts, calls)
    try:
        engine.predict(warm, progress=False)
        common.sync(r.device)
        marks.append(("warm pass", time.perf_counter()))
        spans.clear()
        artifacts.clear()
        calls.clear()
        profiling.report(reset=True)
        launches0 = UA.LAUNCHES.count
        setup_peak = common.reset_peak(r.device)
        passes = 0
        with Trace(r.trace) as trace:
            t_start = time.perf_counter()
            setup_s = t_start - r.t0
            with trace.window():
                pass_s = []
                while True:
                    t_pass = time.perf_counter()
                    engine.predict(root, progress=False)
                    pass_s.append(time.perf_counter() - t_pass)
                    passes += 1
                    if time.perf_counter() - t_start >= r.seconds:
                        break
                common.sync(r.device)
                t_all = time.perf_counter() - t_start
        in_window = artifacts.complete_by(t_start + r.seconds)
        stages = profiling.report()
        launches = UA.LAUNCHES.count - launches0
        memory_peak = max(setup_peak, common.peak(r.device))
    finally:
        spans.restore()
    del engine
    common.free(r.device)

    n_images = passes * len(records)
    results = os.path.join(root, "results")
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(results) for f in fs)
    r.log("set-up: imports " + f"{marks[0][1] - r.t0:.3f} s, " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
    r.log(f"folder: {passes} passes of {len(records)} images in "
          f"{t_all:.3f} s, {in_window} images complete inside the "
          f"{r.seconds:g} s window; set-up {setup_s:.3f} s; passes "
          f"{[round(x, 3) for x in pass_s]} s")
    r.log(f"folder: {written} bytes of artifacts for {len(records)} images "
          f"({written / len(records):.0f} bytes an image, rewritten each "
          f"pass); upsample_argmax launches {launches}")
    for name, row in sorted(stages.items()):
        r.log(f"stage {name}: {row['calls']} calls, {row['total_s']:.6f} s")
    checks, per, worst = check(r, records, results, ckpt)
    for name, h, reads, shares in per:
        r.log(f"check image {name} (height {h}): " + ", ".join(
            f"{k} {v:.6g}" for k, v in reads.items())
            + f", reference class shares {shares}")
    r.log("check readings (worst image): " + json.dumps(worst))
    if r.trace:
        r.log(f"trace: upsample_argmax kernels in the harness's spans "
              f"(seconds, events): {trace.span_device_s(
                  'harness/upsample_argmax', 'upsample_argmax_kernel')} for "
              f"{len(calls)} calls")
    heights = [rec["height"] for rec in records]
    image_flops = sum(flops.model_flops(cfg["model"], h, tr["width"])
                      for h in heights) / len(heights)
    readings = {
        "kind": "folder", "images": n_images, "seconds": t_all,
        "stages": stages, "spans": spans, "trace": trace if r.trace else None,
        "image_flops": image_flops, "upsample_argmax_calls": calls,
        "peaks": flops.PEAKS, "check_readings": worst}
    return Outcome(
        e2e={"folder_images_per_s": in_window / r.seconds,
             "setup_s": setup_s},
        attempted=n_images, failed=0, checks=checks,
        memory_peak_bytes=memory_peak, readings=readings,
        trace=trace if r.trace else None)
