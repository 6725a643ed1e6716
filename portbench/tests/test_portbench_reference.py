"""The plain reference (portbench/reference/) against the program at small
sizes on the CPU, and the reference's own pieces against hand rules."""
import numpy as np
import pytest
import torch

from portbench.lib import weights
from portbench.reference import model as M
from portbench.reference import postprocess as ref


@pytest.mark.parametrize("name", ["fcn_resnet50", "deeplabv3_resnet101"])
def test_logits_match_the_program(name):
    from neuralbarkcalculator_tpu_torch.models.convert import \
        load_state_dict_into
    from neuralbarkcalculator_tpu_torch.models.segmentation import \
        MODEL_FACTORIES
    torch.manual_seed(0)
    state = weights.random_state_dict({"model": name}, 3,
                                      torch.device("cpu"))
    model = MODEL_FACTORIES[name]()
    load_state_dict_into(model, state)
    model.eval()
    x = torch.randn(1, 3, 40, 48)
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        want = M.logits(state, x, name)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.std())


def test_param_shapes_are_the_programs():
    from neuralbarkcalculator_tpu_torch.models.segmentation import \
        MODEL_FACTORIES
    for name in ("fcn_resnet50", "deeplabv3_resnet101"):
        sd = MODEL_FACTORIES[name]().state_dict()
        shapes = M.param_shapes(name)
        assert list(sd) == list(shapes)
        assert all(tuple(sd[k].shape) == shapes[k] for k in shapes)


def test_small_zones_match_the_program():
    from neuralbarkcalculator_tpu_torch.ops.ccl import remove_small_zones
    rng = np.random.default_rng(1)
    for p in (0.3, 0.6):
        cmap = rng.choice(3, size=(64, 96), p=[p, (1 - p) * 0.8,
                                               (1 - p) * 0.2]).astype(
            np.uint8)
        want = remove_small_zones(torch.from_numpy(cmap)).numpy()
        np.testing.assert_array_equal(ref.remove_small_zones(cmap), want)


def test_trim_matches_the_program():
    from neuralbarkcalculator_tpu_torch.ops.trim import trim_bounds
    img = np.full((64, 64, 3), 90, np.uint8)
    img[:7] = 0
    img[50:] = 0
    img[20, :20] = 0  # a row under the 85 % rule is still kept inside
    want = trim_bounds(torch.from_numpy(img).float() / 255.0)
    assert ref.trim_rows(img) == want == (7, 50)
    assert ref.trim_rows(img[:, :40]) == (0, 64)  # not square: no trim


def test_stats_are_the_csv_arithmetic():
    from neuralbarkcalculator_tpu_torch.pipeline.report import \
        class_stats_row
    cmap = np.zeros((10, 20), np.uint8)
    cmap[:4] = 1
    cmap[9, :5] = 2
    st = ref.stats(cmap)
    row, _ = class_stats_row("a.png", "sapin", np.array([80, 5]), 200)
    assert [float(v) for v in row[2:]] == pytest.approx(
        [st["bark_percent"], st["bark_area_mm2"], st["node_percent"],
         st["node_area_mm2"]], abs=1e-5)
