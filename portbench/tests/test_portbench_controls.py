"""The controls (portbench/control.py: the program's int8 path for the
bf16 prediction cells; the reference with TF32 convolutions in the
program's place for the float32 training cell) come out as not correct
through each cell's own comparison: at a small size on the CPU here, and
at the cell's own size on the card (``cuda``)."""
import pytest
import torch

from portbench.control import control_run
from small import run_small, small_cell

CONTROL = {"folder": "int8", "serve": "int8", "train": "tf32"}


def small_sizes(workload: str):
    cell = small_cell(workload, float32=False)
    if cell.kind == "folder":
        cell.traffic.update(width=256, copies=1, check_images=3,
                            sizes={"heights": [224, 256], "counts": [1, 2]})
    elif cell.kind == "serve":
        cell.traffic.update(side=256, check_requests=4, fixed_height=256,
                            mask_share=0.5,
                            sizes={"heights": [224, 256], "counts": [1, 2]})
    else:
        cell.traffic.update(side=96, drawings=1, checked_steps=1)
        cell.config["train"].update(batch_size=2, crop=64)
    return cell


@pytest.mark.parametrize("workload", ["fcn_resnet50.folder",
                                      "fcn_resnet50.serve",
                                      "deeplabv3_resnet101.train"])
def test_control_separates_small(workload):
    """At a small size the numbers the cell compares read three times
    higher or more for the control than for the sound program, on the
    same seed (the cell's limits lie between the two at its own size)."""
    torch.set_num_threads(4)
    seed = 11
    cell = small_sizes(workload)
    sound = run_small(cell, seed=seed, seconds=0.5)
    control = control_run(small_sizes(workload), seed, CONTROL[cell.kind],
                          torch.device("cpu"), seconds=0.5)
    got = {k: v for k, v, _ in sound.checks}
    ratios = {k: control["readings"][k] / max(got[k], 1e-12) for k in got
              if control["readings"].get(k, 0) > 0}
    assert max(ratios.values()) >= 3.0, (ratios, got, control["readings"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fcn_resnet50.folder",
                                      "fcn_resnet50.serve",
                                      "deeplabv3_resnet101.train",
                                      "deeplabv3_resnet101.folder"])
def test_control_is_not_correct_on_the_card(workload, card):
    from portbench.lib import harness
    cell = harness.find_cell(workload)
    for seed in (11, 12, 13):
        out = control_run(cell, seed, CONTROL[cell.kind], card)
        assert out["correct"] is False, out["checks"]
