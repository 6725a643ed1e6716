"""PyTorch port: the matplotlib renderer (pipeline/report.py
``display_subsample`` / ``render_combined`` / ``PredictReporter(renderer=)``,
train/evaluate.py ``render_eval_image(renderer=)`` /
``evaluation_report(renderer=)``, the CLIs' ``--mpl``).

On the same arrays the port's figures are the JAX package's PNG files
byte for byte; ``--mpl`` through the port's predict CLI on the CPU writes
figures that the JAX package's renderer draws byte for byte from the
CLI's own maps; an unknown renderer raises ValueError, and without
matplotlib the 'mpl' renderer raises ImportError instead of falling back.
"""
import builtins
import csv
import os

import numpy as np
import pytest
import torch

from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)
from torch_port_common import tiny_torch_model, write_train_root

pytest.importorskip("matplotlib")


@pytest.fixture()
def sample():
    rng = np.random.default_rng(1)
    img = (rng.random((200, 256, 3)) * 120 + 90).astype(np.uint8)
    cmap = np.zeros((200, 256), np.uint8)
    cmap[40:160, 30:220] = 1
    cmap[80:120, 100:140] = 2
    pct = [float((cmap == 1).mean() * 100), float((cmap == 2).mean() * 100)]
    return img, cmap, pct


@pytest.mark.parametrize("shape,dpi", [((200, 256), 80), ((2048, 1024), 100),
                                       ((4096, 4096, 3), 200),
                                       ((1000, 900), 50)])
def test_display_subsample_equals_jax(shape, dpi):
    from neuralbarkcalculator_tpu.pipeline.report import (
        display_subsample as jax_subsample)
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        display_subsample)

    img = np.arange(np.prod(shape), dtype=np.int64).reshape(shape)
    np.testing.assert_array_equal(display_subsample(img, dpi),
                                  jax_subsample(img, dpi))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_render_combined_equals_jax(sample, tmp_path):
    from neuralbarkcalculator_tpu.pipeline.report import (
        render_combined as jax_render)
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        render_combined)

    img, cmap, pct = sample
    for dpi in (60, 100):
        render_combined(img, cmap, str(tmp_path / "port.png"), pct, dpi)
        jax_render(img, cmap, str(tmp_path / "jax.png"), pct, dpi)
        assert _read(tmp_path / "port.png") == _read(tmp_path / "jax.png")


def test_eval_figure_equals_jax(sample, tmp_path):
    from neuralbarkcalculator_tpu.train.evaluate import (
        render_eval_image as jax_render)
    from neuralbarkcalculator_tpu_torch.train.evaluate import (
        render_eval_image)

    img, cmap, _ = sample
    target = np.roll(cmap, 7, axis=0)
    ious = np.array([50.0, 60.0, 70.0])
    f1s = np.array([55.0, 65.0, 75.0])
    rows = {}
    for name, render in (("port", render_eval_image), ("jax", jax_render)):
        for sub in ("combined_images", "outputs"):
            os.makedirs(tmp_path / name / sub / "sapin" / "test")
        rows[name] = render(img, target, cmap, "a.png", "sapin", "test",
                            ious, f1s, str(tmp_path / name), dpi=80,
                            renderer="mpl")
    assert rows["port"] == rows["jax"]
    figure = os.path.join("combined_images", "sapin", "test", "a.png")
    assert _read(tmp_path / "port" / figure) == _read(tmp_path / "jax" /
                                                      figure)


def test_reporter_routes_to_the_renderer(sample, tmp_path):
    from neuralbarkcalculator_tpu.pipeline.report import (
        render_combined as jax_render)
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        PredictReporter)

    img, cmap, pct = sample
    figures = {}
    for renderer in ("fast", "mpl"):
        rdir = tmp_path / renderer
        for sub in ("combined_images", "outputs"):
            os.makedirs(rdir / sub / "sapin")
        rep = PredictReporter(str(rdir), dpi=60, renderer=renderer)
        rep.add(img, cmap, "x.png", "sapin")
        rep.finalize()
        figures[renderer] = _read(rdir / "combined_images" / "sapin" /
                                  "x.png")
    jax_render(img, cmap, str(tmp_path / "jax.png"), pct, 60)
    assert figures["mpl"] == _read(tmp_path / "jax.png")
    assert figures["fast"] != figures["mpl"]


def test_unknown_renderer_raises(sample, tmp_path):
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        PredictReporter)
    from neuralbarkcalculator_tpu_torch.train.evaluate import (
        evaluation_report)

    with pytest.raises(ValueError, match="unknown renderer"):
        PredictReporter(str(tmp_path), renderer="svg")
    with pytest.raises(ValueError, match="unknown renderer"):
        evaluation_report(None, str(tmp_path), renderer="svg")


def test_mpl_without_matplotlib_raises(tmp_path, monkeypatch):
    """Where matplotlib is missing (the card's machine), the 'mpl'
    renderer and --mpl raise ImportError before any work: no fallback."""
    from neuralbarkcalculator_tpu_torch.cli import predict, train
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        PredictReporter)

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="needs matplotlib"):
        PredictReporter(str(tmp_path), renderer="mpl")
    for cli in (predict, train):
        with pytest.raises(ImportError, match="needs matplotlib"):
            cli.main(cli.build_parser().parse_args(
                [str(tmp_path / "root"), "--device", "cpu", "--mpl"]))
    assert not os.path.exists(tmp_path / "root")  # nothing was written


def test_predict_cli_mpl_writes_the_figures(tmp_path):
    """--mpl through cli/predict on the CPU: every figure is the JAX
    package's render_combined of the CLI's own map (its dual PNG), its
    input (the processed PNG) and its CSV percentages."""
    from neuralbarkcalculator_tpu.pipeline.report import (
        render_combined as jax_render)
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main
    from neuralbarkcalculator_tpu_torch.data.dataset import (
        load_image_u8_pil, save_image_u8_pil)
    from neuralbarkcalculator_tpu_torch.models import segmentation

    torch.manual_seed(0)
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(tiny_torch_model().state_dict(), ckpt)
    rng = np.random.default_rng(0)
    root = tmp_path / "root"
    for wood, shape in (("sapin", (40, 64)), ("epinette_gelee", (64, 64))):
        d = root / "samples" / wood
        d.mkdir(parents=True)
        save_image_u8_pil(str(d / "a.bmp"),
                          (rng.random((*shape, 3)) * 200 + 40).astype(
                              np.uint8))
    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        main(build_parser().parse_args(
            [str(root), "--device", "cpu", "--model", "_tiny_test",
             "--model_path", ckpt, "--dpi", "40", "--mpl"]))
    finally:
        segmentation.MODEL_FACTORIES.pop("_tiny_test")
    with open(root / "results" / "final_stats.csv") as f:
        rows = list(csv.reader(f, delimiter="\t"))[1:]
    assert len(rows) == 2
    for fname, wood, *_ in rows:
        dual = load_image_u8_pil(str(root / "results" / "outputs" / wood /
                                     fname), grayscale=True)
        cmap = ((dual == 127) + 2 * (dual == 255)).astype(np.uint8)
        pct = [float((cmap == c).sum()) / cmap.size * 100.0 for c in (1, 2)]
        processed = load_image_u8_pil(str(root / "processed" / "samples" /
                                          wood / fname))
        want = str(tmp_path / f"{wood}.png")
        jax_render(processed, cmap, want, pct, 40)
        assert _read(root / "results" / "combined_images" / wood /
                     fname) == _read(want)


def test_evaluation_report_mpl(tmp_path):
    """evaluation_report(renderer='mpl') over a tiny experiment: the same
    CSV as the compositor's report, and every figure drawn by matplotlib
    (the PNG's Software tag)."""
    from neuralbarkcalculator_tpu_torch.config import TrainConfig
    from neuralbarkcalculator_tpu_torch.models import segmentation
    from neuralbarkcalculator_tpu_torch.train.evaluate import (
        evaluation_report)
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    data = write_train_root(tmp_path / "data")
    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        exp = Experiment(data, str(tmp_path / "moar"),
                         config=TrainConfig(pad_resize_size=64, crop_size=32,
                                            batch_size=4),
                         model_name="_tiny_test", device="cpu")
    finally:
        segmentation.MODEL_FACTORIES.pop("_tiny_test")
    tables = {}
    for renderer in ("fast", "mpl"):
        root = tmp_path / renderer
        with open(evaluation_report(exp, str(root), dpi=20,
                                    renderer=renderer)) as f:
            tables[renderer] = f.read()
        figures = root / "Images" / "results" / "moar" / "combined_images"
        pngs = [os.path.join(d, n) for d, _, names in os.walk(figures)
                for n in names]
        assert len(pngs) == 30
        tagged = sum(b"Matplotlib" in _read(p) for p in pngs)
        assert tagged == (30 if renderer == "mpl" else 0)
    assert tables["fast"] == tables["mpl"]
