"""One run of one cell: ``python3 portbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.

The cell is found by name in ``BENCHMARK.json``; its configuration file,
``portbench/traffic/<traffic>.json``, ``portbench/limits/<workload>.json``
and the driver ``portbench/drivers/<kind>.py`` (``kind`` from the traffic
file) are found by the names in it, and so is the reader
``portbench/metrics/<metric>.py`` of every per-layer metric. A cell is
added by adding files and entries; no file here names one.

The driver returns the run's numbers; this module prints every number
compared beside its limit (standard error, the last lines) and, as the
last line of standard output, the JSON result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralbarkcalculator_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_module(path: str) -> ModuleType:
    """A module from a file under portbench/ (names may hold dots)."""
    name = "portbench_" + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """Everything the manifest and the cell's files say about one cell."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def find_cell(workload: str, manifest_path: str | None = None) -> Cell:
    manifest = read_json(manifest_path or os.path.join(ROOT,
                                                       "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"]: c["file"] for c in manifest["configs"]}
    if workload in cells:
        w = cells[workload]
    else:
        # a cell not in the manifest, named <config>.<traffic>, runs from
        # its files alone (a trial before its entry is added), with no
        # metric of the manifest's
        config_name, _, traffic = workload.rpartition(".")
        w = {"config": config_name, "traffic": traffic, "chips": 1}
        configs.setdefault(config_name,
                           f"portbench/configs/{config_name}.json")
        if not all(os.path.isfile(p) for p in (
                os.path.join(ROOT, configs[config_name]),
                os.path.join(BENCH, "traffic", f"{traffic}.json"))):
            raise SystemExit(f"no workload {workload!r} in the manifest "
                             f"(have {sorted(cells)}) nor in portbench/")
        manifest = {"end_to_end": [], "per_layer": []}
    config = read_json(os.path.join(ROOT, configs[w["config"]]))

    def mine(metrics: list[dict]) -> list[dict]:
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=read_json(os.path.join(BENCH, "traffic",
                                       f"{w['traffic']}.json")),
        limits=read_json(os.path.join(BENCH, "limits", f"{workload}.json")),
        end_to_end=mine(manifest["end_to_end"]),
        per_layer=mine(manifest["per_layer"]))


@dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, its scratch
    directory, where to log, and the set-up clock's start."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: str
    t0: float
    log: Callable = log


@dataclass
class Outcome:
    """What a driver returns."""
    e2e: dict[str, float]
    attempted: int
    failed: int
    checks: list[tuple[str, float, float]]
    memory_peak_bytes: int
    readings: dict = field(default_factory=dict)
    trace: object = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in
                                         self.checks)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def driver_for(cell: Cell) -> ModuleType:
    return load_module(os.path.join(BENCH, "drivers", f"{cell.kind}.py"))


def per_layer_values(cell: Cell, outcome: Outcome) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = load_module(os.path.join(BENCH, "metrics",
                                          f"{m['name']}.py"))
        value = reader.read(outcome.readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict
                ) -> dict:
    if trace:
        metrics = per_layer_values(cell, outcome)
    else:
        metrics = {m["name"]: {"value": float(outcome.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    tr = outcome.trace
    if trace and tr is not None:
        log(tr.describe())
    if trace and tr is not None and tr.window_s():
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in outcome.checks}
    return line


def card_lines() -> None:
    """The card's name, clocks and power limit, on standard error."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    log(f"card: {out}")


def cache_env() -> None:
    """The program's build and kernel caches at fixed paths inside the
    checkout (the port's own nvcc builds go to <checkout>/build)."""
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv: list[str], t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    cell = find_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 3
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, workdir=workdir,
                  t0=t0)
        outcome = driver_for(cell).run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark may not import JAX or "
            f"the JAX package; no result")
        return 4
    line = result_line(cell, outcome, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(outcome.memory_peak_bytes)})
    card_lines()
    for name, v, lim in outcome.checks:
        log(f"check {name}: {v!r} (limit {lim!r}) "
            f"{'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0
