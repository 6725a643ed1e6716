"""A copy of the benchmark in a temporary directory, to which a test adds
files and manifest entries, as a later change to the benchmark would; and
the runs of a cell there, in a process of their own."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.lib import harness


def digests(top: str) -> dict:
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


class BenchCopy:
    """``portbench/`` and ``BENCHMARK.json`` copied under ``top``; the
    program is found on ``PYTHONPATH``, from this repository."""

    def __init__(self, top: str):
        self.root = str(top)
        self.bench = os.path.join(self.root, "portbench")
        shutil.copytree(harness.BENCH, self.bench,
                        ignore=shutil.ignore_patterns("__pycache__"))
        self.manifest = harness.read_json(os.path.join(harness.ROOT,
                                                       "BENCHMARK.json"))
        self.before = digests(self.bench)

    def read(self, rel: str) -> dict:
        return harness.read_json(os.path.join(self.bench, rel))

    def write(self, rel: str, data) -> str:
        path = os.path.join(self.bench, rel)
        with open(path, "w") as f:
            if isinstance(data, str):
                f.write(data)
            else:
                json.dump(data, f)
        return path

    def add_config(self, name: str, config: dict) -> None:
        self.write(f"configs/{name}.json", dict(config, name=name))
        self.manifest["configs"].append({
            "name": name, "source": self.manifest["configs"][0]["source"],
            "file": f"portbench/configs/{name}.json",
            "reduced": config["reduced"], "why": "a test configuration"})

    def add_cell(self, config: str, traffic: str, chips: int,
                 moves: tuple[str, ...]) -> str:
        """A manifest entry of the cell, added to the metrics that name
        their cells and report ``moves`` (end-to-end metrics, and the
        per-layer ones moving them)."""
        name = f"{config}.{traffic}"
        self.manifest["workloads"].append({
            "name": name, "config": config, "traffic": traffic,
            "chips": chips, "why": "a test cell"})
        for m in self.manifest["end_to_end"] + self.manifest["per_layer"]:
            if "workloads" in m and (m["name"] in moves
                                     or m.get("moves") in moves):
                m["workloads"].append(name)
        return name

    def save_manifest(self) -> None:
        with open(os.path.join(self.root, "BENCHMARK.json"), "w") as f:
            json.dump(self.manifest, f)

    def unchanged(self) -> bool:
        """No file the benchmark had was changed."""
        after = digests(self.bench)
        return {k: v for k, v in after.items() if k in self.before} == \
            self.before

    def python(self, code: str, timeout: float = 600, **env
               ) -> subprocess.CompletedProcess:
        """``code`` in a fresh interpreter, the copy first on its path."""
        e = dict(os.environ, PYTHONPATH=harness.ROOT, OMP_NUM_THREADS="2",
                 **env)
        e.pop("JAX_PLATFORMS", None)
        prelude = f"import sys\nsys.path.insert(0, {self.root!r})\n"
        return subprocess.run([sys.executable, "-c", prelude + code],
                              capture_output=True, text=True,
                              timeout=timeout, env=e, cwd=self.root)

    def launch(self, workload: str, seed: int, seconds: float,
               entry: str | None = None, margin_s: float = 300.0,
               timeout: float = 600, trace: int = 0
               ) -> subprocess.CompletedProcess:
        """The cell through the harness's launcher on the CPU: its ranks
        are gloo processes (``entry``: the copy's run.py)."""
        argv = ["--workload", workload, "--seed", str(seed), "--seconds",
                str(seconds), "--trace", str(trace)]
        return self.python(
            "import time\nT0 = time.perf_counter()\n"
            "from portbench.lib import harness\n"
            f"cell = harness.find_cell({workload!r})\n"
            f"sys.exit(harness.launch({argv!r}, cell, {seconds!r}, T0, "
            f"'cpu', entry={entry!r}, margin_s={margin_s!r}))\n",
            timeout=timeout)

    def entry(self, name: str, patch: str) -> str:
        """A rank's entry: ``patch`` (Python run first, in the rank's
        process), then run.py's ``harness.main``."""
        return self.write(f"{name}.py", (
            "import sys, time\nT0 = time.perf_counter()\n"
            f"sys.path.insert(0, {self.root!r})\n"
            f"{patch}\n"
            "from portbench.lib import harness\n"
            "if __name__ == '__main__':\n"
            "    sys.exit(harness.main(sys.argv[1:], T0))\n"))


def tiny_train(copy: BenchCopy, config: dict, name: str,
               **traffic) -> dict:
    """A training configuration ``name`` at crop 32 and a tiny traffic
    mix's fields (side 48, 2 drawings, one checked step, and
    ``traffic``)."""
    config = json.loads(json.dumps(config))
    config["train"].update(batch_size=2, crop=32)
    copy.add_config(name, config)
    t = copy.read("traffic/train.json")
    t.update(side=48, drawings=2, checked_steps=1, **traffic)
    return t
