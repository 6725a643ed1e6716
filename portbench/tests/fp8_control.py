#!/usr/bin/env python3
"""The e4m3 control of a bf16 folder cell, on the card at the cell's own
size: for each seed, the cell's folder and weights as a run draws them,
then the reference with every product's operands rounded to float8 e4m3
(reference/fp8.py) in the program's place, judged by the cell's own
comparison (drivers/folder.compare). It has to come out as not correct.
Also prints, at the seed's weights, the mean over each block's queries of
the largest attention probability on the first image of the folder
(reference/segformer.attention_peaks) beside 1 / the block's keys.

    python3 portbench/tests/fp8_control.py --workload segformer_b5.folder \
        --seeds 11,12,13

One JSON line a seed. ``--device cpu`` runs it on the CPU (small sizes).
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import reference  # noqa: E402
from portbench.lib import common, harness, inputs  # noqa: E402
from portbench.reference import postprocess as post  # noqa: E402
from portbench.reference.fp8 import E4M3  # noqa: E402


def control(cell: harness.Cell, seed: int, device) -> dict:
    folder = harness.driver_for(cell)
    workdir = tempfile.mkdtemp(prefix="portbench-fp8-")
    try:
        r = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                        device=device, workdir=workdir,
                        t0=time.perf_counter())
        root = os.path.join(workdir, "folder")
        records = inputs.make_folder(root, seed, cell.traffic)
        ckpt = common.checkpoint(r, common.calibration_images(
            inputs.drawing_files(root)))
        reference.exact_float32()
        state = common.reference_state(ckpt, device)
        ops = reference.Ops(**E4M3)
        cfg = cell.config

        def got(_rec, img):
            _, cmap = post.logits_and_map(state, img, cfg, device, ops)
            st = post.stats(cmap)
            return cmap, [st["bark_percent"], st["bark_area_mm2"],
                          st["node_percent"], st["node_area_mm2"]]

        checks, per, reads = folder.compare(r, records, ckpt, got)
        peaks = None
        module = reference.module_for(cfg)
        if hasattr(module, "attention_peaks"):
            img = common.read_rgb(records[0]["path"])
            x = reference.normalize(torch.from_numpy(img.copy())[None].to(
                device), cfg["mean"], cfg["std"])
            keys = [m for _n, m, _c in module.stage_sizes(
                cfg["model"], *img.shape[:2])]
            depths = module.spec(cfg["model"])["depths"]
            peaks = {"height": img.shape[0],
                     "mean_max_prob": module.attention_peaks(
                         state, x, cfg["model"]),
                     "uniform": [1.0 / m for m, d in zip(keys, depths)
                                 for _ in range(d)]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"workload": cell.name, "control": "e4m3", "seed": seed,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "correct": all(v <= lim for _, v, lim in checks),
            "readings": reads, "per": per, "attention_peaks": peaks}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    harness.cache_env()
    device = torch.device(a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(control(harness.find_cell(a.workload), seed,
                                 device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
