#!/usr/bin/env python3
"""The controls of the benchmark's correctness check, on the card at a
cell's own size; each must come out as not correct.

- ``int8`` (the prediction cells, bf16): the program with its own int8
  path switched on (``PredictConfig.quantize_int8``, ``cli/serve --int8``),
  the precision below bf16, run as the cell's run with a short window
  (``--seconds``) and judged by the same comparison.
- ``tf32`` (the training cells, float32 with TF32 off): the reference with
  TF32-rounded convolutions (reference/control.py) in the program's place,
  on the run's inputs, weights and seeds, through the same comparison.

    python3 portbench/control.py --workload fcn_resnet50.folder \
        --control int8 --seeds 11,12,13 --seconds 5

Prints one JSON line a seed: every number read, the numbers compared with
their limits, and whether the control passed them. ``--device cpu`` runs
it on the CPU (tests, at small sizes).
"""
import os
import sys
import time

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


def control_run(cell, seed: int, name: str, device,
                seconds: float = 5.0) -> dict:
    driver = harness.driver_for(cell)
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        r = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                        device=device, workdir=workdir,
                        t0=time.perf_counter())
        if name == "tf32":
            from portbench.reference.control import tf32_conv
            checks, per, reads = driver.control(r, tf32_conv)
        else:
            cell.config["predict"]["int8"] = True
            out = driver.run(r)
            checks, per = out.checks, None
            reads = out.readings["check_readings"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"workload": cell.name, "control": name, "seed": seed,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "correct": all(v <= lim for _, v, lim in checks),
            "readings": reads, "per": per}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True, choices=("int8", "tf32"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    harness.cache_env()
    import torch
    device = torch.device(a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(control_run(harness.find_cell(a.workload), seed,
                                     a.control, device, a.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
