"""PyTorch port: SegFormer (models/segformer.py) against the benchmark's
plain reference (portbench/reference/segformer.py), on the CPU.

A small preset keeps every kind of layer and every published ratio
(four stages, spatial-reduction ratios 8 / 4 / 2 / 1, patch sizes 7 / 3 /
3 / 3, MixFFN ratio 4) at head dim 8 and depths 1 / 1 / 2 / 1; its weights
are the benchmark's (portbench/lib/weights.py: peaked attention, the
decoder's BatchNorm calibrated on the images). The published widths are
checked on ``meta`` tensors. Tolerance: float32 logits within LOGIT_TOL
(the two sum in other orders and upsample the logits by matrices against
``F.interpolate``: measured ~3e-6 on logits of |x| <= ~3); each fault
case moves them by far more.
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.lib import flops, harness, inputs, weights
from portbench.reference import segformer as R
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

from neuralbarkcalculator_tpu_torch.models import segformer as S
from neuralbarkcalculator_tpu_torch.models.segmentation import (
    MODEL_FACTORIES, SegmentationModel)

TINY = {"hidden": (16, 32, 40, 64), "depths": (1, 1, 2, 1),
        "heads": (2, 4, 5, 8), "sr": (8, 4, 2, 1), "patch": (7, 3, 3, 3),
        "stride": (4, 2, 2, 2), "mlp_ratio": 4, "decoder": 32,
        "head_dim": 8}
TINY_SPEC = S.SegformerSpec(
    hidden_sizes=TINY["hidden"], depths=TINY["depths"], heads=TINY["heads"],
    sr_ratios=TINY["sr"], patch_sizes=TINY["patch"], strides=TINY["stride"],
    decoder_hidden=TINY["decoder"], head_dim=TINY["head_dim"])
CONFIG = {"model": "segformer_tiny", "reference": "segformer",
          "mean": [0.7399, 0.6139, 0.4401], "std": [0.1068, 0.1272, 0.1271]}
SEED = 2 ** 31 + 23
# |port - reference| of the float32 logits (module docstring)
LOGIT_TOL = 1e-4


def tiny_model() -> SegmentationModel:
    backbone = S.MixTransformer(TINY_SPEC)
    return SegmentationModel(backbone, S.SegformerDecodeHead(
        backbone.out_channels, TINY["decoder"]))


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setitem(R.SPECS, "segformer_tiny", TINY)
    monkeypatch.setitem(MODEL_FACTORIES, "segformer_tiny", tiny_model)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def state():
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 128, 128, 3), dtype=np.uint8))
    st = weights.random_state_dict(CONFIG, SEED, torch.device("cpu"))
    weights.calibrate_bn(CONFIG, st, images)
    return st


def images(h: int = 96, w: int = 128, n: int = 2) -> torch.Tensor:
    """Normalized NCHW images with smooth structure."""
    rng = np.random.default_rng(h * w + n)
    yy, xx = np.mgrid[:h, :w] / 16.0
    base = np.stack([np.sin(yy + k) * np.cos(xx * (k + 1)) for k in range(3)],
                    -1)
    u8 = np.clip(127 + 100 * base[None] + rng.normal(0, 20, (n, h, w, 3)), 0,
                 255).astype(np.uint8)
    return reference.normalize(torch.from_numpy(u8), CONFIG["mean"],
                               CONFIG["std"])


def port_logits(st, x, tamper=None) -> torch.Tensor:
    model = tiny_model()
    model.load_state_dict(st)
    if tamper is not None:
        tamper(model)
    with torch.no_grad():
        return model.eval()(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gap(st, x, tamper=None) -> float:
    with torch.no_grad():
        want = R.logits(st, x, "segformer_tiny")
    return float((port_logits(st, x, tamper) - want).abs().max())


def test_port_equals_reference(state):
    x = images()
    assert gap(state, x) < LOGIT_TOL
    # the weights make every block's attention peaked: a query's largest
    # probability far above 1 / (its keys), 12 here
    peaks = R.attention_peaks(state, x, "segformer_tiny")
    assert len(peaks) == sum(TINY["depths"])
    assert min(peaks) > 2.0 / 12


class _ReversedCat:
    """``torch`` with ``cat`` taking its tensors in reverse order."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def cat(tensors, dim=0):
        return torch.cat(list(tensors)[::-1], dim)


def _without_sr_norm(model) -> None:
    for m in model.modules():
        if isinstance(m, S.EfficientSelfAttention) and m.sr_ratio > 1:
            m.layer_norm = torch.nn.Identity()


# each fault: (a patch of the program, a change to the loaded model)
FAULTS = {
    "decoder concat reversed": (
        lambda mp: mp.setattr(S, "torch", _ReversedCat()), None),
    "spatial-reduction LayerNorm left out": (lambda mp: None,
                                             _without_sr_norm),
    "softmax scale wrong": (lambda mp: mp.setattr(
        S, "attention", lambda q, k, v: torch.nn.functional.
        scaled_dot_product_attention(q, k, v, scale=1.0 / q.shape[-1])),
        None),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_fail_the_check(state, monkeypatch, fault):
    x = images()
    patch, tamper = FAULTS[fault]
    patch(monkeypatch)
    assert gap(state, x, tamper) > 100 * LOGIT_TOL


def test_published_widths_on_meta():
    shapes = R.param_shapes("segformer_b5")
    with torch.device("meta"):
        model = MODEL_FACTORIES["segformer_b5"]()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert list(got) == list(shapes)
    assert got == {k: tuple(s) for k, s in shapes.items()}
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 84.5e6 < n < 84.7e6, n
    assert model.logit_stride == 4
    assert model.backbone.feature_stride == 32


def test_folded_decoder_equals_unfolded(state):
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model
    model = tiny_model()
    model.load_state_dict(state)
    model.eval()
    folded = fold_model(model)
    assert not any(k.startswith("classifier.batch_norm")
                   for k in folded.state_dict())
    x = images().permute(0, 2, 3, 1)
    with torch.no_grad():
        a, b = model.head_logits(x), folded.head_logits(x)
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_refusals(tmp_path):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.models.quantize import \
        check_quantizable
    from neuralbarkcalculator_tpu_torch.parallel.spatial import \
        check_width_split
    from neuralbarkcalculator_tpu_torch.pipeline.predict import \
        NeuralBarkCalculator
    from neuralbarkcalculator_tpu_torch.train.loop import build_model

    model = tiny_model().eval()
    with pytest.raises(ValueError, match="int8"):
        check_quantizable(model)
    ckpt = os.path.join(tmp_path, "m.pt")
    torch.save(model.state_dict(), ckpt)
    with pytest.raises(ValueError, match="int8"):
        NeuralBarkCalculator(ckpt, PredictConfig(
            model_path=ckpt, use_bfloat16=False, quantize_int8=True),
            model_name="segformer_tiny", device="cpu")
    # a split of the width
    with pytest.raises(ValueError, match="strips of the width"):
        check_width_split(model.backbone)
    # a JAX checkpoint
    jax_path = os.path.join(tmp_path, "m.msgpack")
    with open(jax_path, "wb") as f:
        f.write(b"\x00")
    with pytest.raises(ValueError, match="JAX package has no"):
        NeuralBarkCalculator(jax_path, PredictConfig(model_path=jax_path),
                             model_name="segformer_b5", device="cpu")
    # training
    with pytest.raises(ValueError, match="predicts only"):
        build_model("segformer_b5", 0.1, 0)
    assert R.trains("segformer_b5") is False


@pytest.mark.parametrize("model,h,w", [("segformer_tiny", 96, 128),
                                       ("segformer_b5", 1024, 1024)])
def test_flops_count_the_attention(model, h, w):
    """The FLOP counter sees q k^T and the probabilities times v of every
    block (the 3-D products, image by image): 4 N M C a block."""
    st = {k: torch.empty(s, device="meta")
          for k, s in R.param_shapes(model).items()}
    seen = []

    def on_matmul(a, b, y):
        if a.dim() == 3:
            seen.append(2 * y.numel() * a.shape[-1])

    R.logits(st, torch.empty((1, 3, h, w), device="meta"), model,
             reference.Ops(on_matmul=on_matmul))
    assert len(seen) == 2 * sum(R.spec(model)["depths"])
    assert sum(seen) == R.attention_flops(model, h, w)
    assert flops.model_flops({**CONFIG, "model": model}, h, w) > sum(seen)
    if model == "segformer_b5":
        # 4 N M C x depth: 65,536 / 16,384 / 4,096 / 1,024 queries, 1,024
        # keys in every stage
        assert R.attention_flops(model, h, w) == 4 * 1024 * (
            65536 * 64 * 3 + 16384 * 128 * 6 + 4096 * 320 * 40
            + 1024 * 512 * 3)


def test_engine_folder_against_reference():
    """NeuralBarkCalculator.predict on a folder of three heights (the
    exact-height path, float32 on the CPU), through the benchmark's folder
    driver: its class maps and final_stats.csv rows against the
    reference's."""
    cell = harness.Cell(
        name="segformer_tiny.folder", chips=1,
        config={**CONFIG, "predict": {"dtype": "float32", "batch_size": 4,
                                      "height_bucket": 32}},
        traffic={"kind": "folder", "width": 128, "copies": 2,
                 "png_level": 1, "figure_dpi": 30, "check_images": 4,
                 "sizes": {"heights": [64, 96, 128], "counts": [2, 1, 1]}},
        limits={"map_mismatch": 1e-3, "csv_gap_pp": 1e-3},
        end_to_end=[], per_layer=[])
    from neuralbarkcalculator_tpu_torch.ops import attention
    launches = attention.LAUNCHES.count
    with tempfile.TemporaryDirectory() as tmp:
        out = harness.driver_for(cell).run(harness.Run(
            cell=cell, seed=SEED, seconds=0.5, trace=False,
            device=torch.device("cpu"), workdir=tmp,
            t0=time.perf_counter()))
    assert out.correct, out.checks
    assert out.attempted >= 8
    # every launch of the window ran the 5 blocks' attention
    assert attention.LAUNCHES.count - launches >= 5 * 3
    stages = out.readings["stages"]
    assert stages["predict/attention"]["calls"] > 0
    assert stages["predict/decode_head"]["calls"] > 0


def test_streaming_and_serving_take_the_same_engine(state, tmp_path):
    """predict_streaming and BatchingPredictor run SegFormer through the
    engine's exact-height path: the same class maps as predict_images."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import \
        NeuralBarkCalculator
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import \
        ProcessedImage
    from neuralbarkcalculator_tpu_torch.pipeline.serving import \
        BatchingPredictor

    ckpt = os.path.join(tmp_path, "m.pt")
    torch.save(state, ckpt)
    engine = NeuralBarkCalculator(ckpt, PredictConfig(
        model_path=ckpt, use_bfloat16=False, batch_size=2),
        model_name="segformer_tiny", device="cpu")
    rng = np.random.default_rng(5)
    items = [ProcessedImage(rng.integers(0, 256, (h, 128, 3), np.uint8),
                            f"i{k}.png", "sapin")
             for k, h in enumerate((96, 64, 96))]
    want = {it.fname: m for it, m in engine.predict_images(items)}
    server = BatchingPredictor(engine, max_wait_ms=5.0)
    try:
        served = [server.submit(it.image).result(timeout=120) for it in items]
    finally:
        server.close()
    for it, got in zip(items, served):
        np.testing.assert_array_equal(got.class_map, want[it.fname])
    root = os.path.join(tmp_path, "stream")
    inputs.results_folders(root)  # as the predict CLI makes them
    engine.predict_streaming(root, iter(enumerate(items)), progress=False)
    from PIL import Image
    for it in items:
        with Image.open(os.path.join(root, "results", "outputs", "sapin",
                                     it.fname)) as im:
            dual = np.asarray(im.convert("L"))
        np.testing.assert_array_equal(
            (dual == 127) * 1 + (dual == 255) * 2, want[it.fname])
