"""Small versions of the benchmark's cells, for the CPU tests: the same
files and code, with the sizes cut so that a run takes seconds."""
from __future__ import annotations

import tempfile
import time

import torch

from portbench.lib import harness


def small_cell(workload: str, manifest: str | None = None,
               float32: bool = True) -> harness.Cell:
    cell = harness.find_cell(workload, manifest)
    kind = cell.kind
    if kind == "folder":
        cell.traffic.update(width=64, copies=2, check_images=4,
                            sizes={"heights": [48, 56, 64],
                                   "counts": [2, 2, 1]})
    elif kind == "serve":
        cell.traffic.update(side=64, rate=4, fixed_height=64,
                            check_requests=4, wait_s=20,
                            sizes={"heights": [48, 56, 64],
                                   "counts": [2, 2, 1]})
    elif kind == "train":
        cell.traffic.update(side=48, drawings=2)
        cell.config["train"].update(batch_size=2, crop=32)
    if "predict" in cell.config:
        cell.config["predict"].update(batch_size=4, height_bucket=32)
        if float32:
            cell.config["predict"]["dtype"] = "float32"
    return cell


def run_small(cell: harness.Cell, seed: int = 2 ** 31 + 5,
              seconds: float = 2.0, trace: bool = False,
              workdir: str | None = None) -> harness.Outcome:
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"), workdir=workdir or tmp,
                        t0=time.perf_counter())
        return harness.driver_for(cell).run(r)
