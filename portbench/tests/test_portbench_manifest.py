"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import os
import re

import pytest

from portbench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x cells runs
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_entries():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == configs
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["moves"] in e2e and UNIT.match(p["unit"])
        for w in p.get("workloads", []):
            assert w in e2e[p["moves"]].get("workloads", [w])
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest()["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.find_cell(workload)
    assert cell.kind in ("folder", "serve", "train")
    driver = harness.driver_for(cell)
    assert callable(driver.run)
    for m in cell.per_layer:
        reader = harness.load_module(os.path.join(
            harness.BENCH, "metrics", f"{m['name']}.py"))
        assert reader.read({}) is None  # nothing to read: no value
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
