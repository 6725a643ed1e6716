"""A cell that exists only in a new manifest and new files (a
configuration, a traffic mix, its limits) runs without an edit to any
file the benchmark already has."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.lib import harness

RUN = r"""
import sys, json, time, tempfile, torch
sys.path[:0] = [{copy!r}, {root!r}]
from portbench.lib import harness
assert harness.ROOT == {copy!r}, harness.ROOT
cell = harness.find_cell("fcn_resnet50-f32.folder-tiny")
torch.set_num_threads(2)
with tempfile.TemporaryDirectory() as tmp:
    r = harness.Run(cell=cell, seed=2 ** 31 + 77, seconds=1.0, trace=False,
                    device=torch.device("cpu"), workdir=tmp,
                    t0=time.perf_counter())
    out = harness.driver_for(cell).run(r)
line = harness.result_line(cell, out, False, {{"platform": "cpu"}})
print(json.dumps(line))
"""


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


def test_new_cell_from_new_files_only(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(harness.BENCH, os.path.join(copy, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    before = digests(os.path.join(copy, "portbench"))

    # the new files
    bench = os.path.join(copy, "portbench")
    with open(os.path.join(bench, "configs", "fcn_resnet50.json")) as f:
        config = json.load(f)
    config["name"] = "fcn_resnet50-f32"
    config["predict"].update(dtype="float32", batch_size=4,
                             height_bucket=32)
    with open(os.path.join(bench, "configs", "fcn_resnet50-f32.json"),
              "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "folder.json")) as f:
        traffic = json.load(f)
    traffic.update(width=64, copies=2, check_images=3,
                   sizes={"heights": [48, 64], "counts": [2, 1]})
    with open(os.path.join(bench, "traffic", "folder-tiny.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits",
                           "fcn_resnet50-f32.folder-tiny.json"), "w") as f:
        json.dump({"map_mismatch": 1e-3, "csv_gap_pp": 1e-3}, f)
    # the new entries
    manifest["configs"].append({
        "name": "fcn_resnet50-f32", "source": manifest["configs"][0]["source"],
        "file": "portbench/configs/fcn_resnet50-f32.json", "reduced": [],
        "why": "a test configuration"})
    name = "fcn_resnet50-f32.folder-tiny"
    manifest["workloads"].append({
        "name": name, "config": "fcn_resnet50-f32",
        "traffic": "folder-tiny", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "folder_images_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(name)
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=copy, root=harness.ROOT)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"folder_images_per_s", "setup_s"}
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
