"""A cell that exists only in a new manifest and new files (a
configuration, a traffic mix, its limits) runs without an edit to any
file the benchmark already has; so does a configuration that names a
reference module of its own, added as a new file."""
import json
import os

from copies import BenchCopy, tiny_train

RUN = r"""
import json, tempfile, time, torch
from portbench.lib import harness
assert harness.ROOT == {copy!r}, harness.ROOT
torch.set_num_threads(2)
for name in {cells!r}:
    cell = harness.find_cell(name)
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=cell, seed=2 ** 31 + 77, seconds=1.0,
                        trace=False, device=torch.device("cpu"), workdir=tmp,
                        t0=time.perf_counter())
        out = harness.driver_for(cell).run(r)
    print(json.dumps(harness.result_line(cell, out, False,
                                         {{"platform": "cpu"}})))
print(json.dumps({{"modules": sorted(
    m for m in sys.modules if m.startswith("portbench.reference"))}}))
{after}
"""


def run_cells(copy: BenchCopy, cells: list[str], after: str = "") -> list:
    out = copy.python(RUN.format(copy=copy.root, cells=cells, after=after))
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def tiny_folder(copy: BenchCopy) -> None:
    traffic = copy.read("traffic/folder.json")
    traffic.update(width=64, copies=2, check_images=3,
                   sizes={"heights": [48, 64], "counts": [2, 1]})
    copy.write("traffic/folder-tiny.json", traffic)


def test_new_cell_from_new_files_only(tmp_path):
    copy = BenchCopy(tmp_path)
    config = copy.read("configs/fcn_resnet50.json")
    config["predict"].update(dtype="float32", batch_size=4, height_bucket=32)
    copy.add_config("fcn_resnet50-f32", config)
    tiny_folder(copy)
    copy.write("limits/fcn_resnet50-f32.folder-tiny.json",
               {"map_mismatch": 1e-3, "csv_gap_pp": 1e-3})
    name = copy.add_cell("fcn_resnet50-f32", "folder-tiny", 1,
                         ("folder_images_per_s",))
    copy.save_manifest()

    line = run_cells(copy, [name])[0]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"folder_images_per_s", "setup_s"}
    assert copy.unchanged()


# the dilated ResNets' reference under another name, counting its forwards
COUNTER = """

CALLS = {"logits": 0, "param_shapes": 0}
_logits, _param_shapes = logits, param_shapes


def logits(*args, **kw):
    CALLS["logits"] += 1
    return _logits(*args, **kw)


def param_shapes(*args, **kw):
    CALLS["param_shapes"] += 1
    return _param_shapes(*args, **kw)
"""


def test_new_architecture_from_new_files_only(tmp_path):
    """A configuration names ``"reference": "resnet_counted"``, a module
    added under portbench/reference/; a tiny folder cell and a tiny
    training cell of it run correct, through that module alone."""
    copy = BenchCopy(tmp_path)
    with open(os.path.join(copy.bench, "reference", "model.py")) as f:
        copy.write("reference/resnet_counted.py", f.read() + COUNTER)
    config = copy.read("configs/deeplabv3_resnet101.json")
    config["reference"] = "resnet_counted"
    config["predict"].update(dtype="float32", batch_size=4, height_bucket=32)
    name = "deeplabv3_resnet101-counted"
    copy.write("traffic/train-tiny.json", tiny_train(copy, config, name))
    tiny_folder(copy)
    copy.write(f"limits/{name}.folder-tiny.json",
               {"map_mismatch": 1e-3, "csv_gap_pp": 1e-3})
    copy.write(f"limits/{name}.train-tiny.json",
               copy.read("limits/deeplabv3_resnet101.train.json"))
    cells = [copy.add_cell(name, "folder-tiny", 1, ("folder_images_per_s",)),
             copy.add_cell(name, "train-tiny", 1,
                           ("train_step_ms", "train_peak_gib"))]
    copy.save_manifest()

    *lines, modules, calls = run_cells(copy, cells, after=(
        "from portbench.reference import resnet_counted\n"
        "print(json.dumps(resnet_counted.CALLS))"))
    for line in lines:
        assert line["correct"] is True, line["checks"]
    assert set(lines[0]["metrics"]) == {"folder_images_per_s", "setup_s"}
    assert set(lines[1]["metrics"]) == {"train_step_ms", "train_peak_gib",
                                        "setup_s"}
    # the module named was the one used, and the default was never loaded
    assert "portbench.reference.resnet_counted" in modules["modules"]
    assert "portbench.reference.model" not in modules["modules"]
    # weights of each cell, calibration, the FLOP counts, the reference's
    # forwards: the folder's sampled drawings and the train steps
    assert calls["param_shapes"] >= 4 and calls["logits"] >= 4, calls
    assert copy.unchanged()
