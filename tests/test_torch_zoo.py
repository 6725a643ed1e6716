"""PyTorch port: the whole model zoo through folding, the CLIs, serving and
what training refuses.

- Folding: every factory's folded twin gives its unfolded logits within
  1e-5 of the largest |logit| (float64 fold, float32 forward), with
  EfficientNet's BN eps 1e-3 and the heads' 1e-5.
- ``cli/predict --model deeplabv3_resnet50`` and a served exact-height
  model run on the CPU; what ``cli/train`` and ``Experiment`` still refuse
  for the zoo's models, before touching the data.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import blob_image, normalized, zoo_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _zoo_names():
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    # the bare efficientnet factories take the variant n as an argument
    return sorted(n for n in MODEL_FACTORIES
                  if not n.endswith("_efficientnet"))


@pytest.mark.parametrize("name", _zoo_names())
def test_folded_equals_unfolded(name):
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model

    model = zoo_model(name, seed=3)
    folded = fold_model(model)
    assert not any(k.endswith("running_mean") for k in folded.state_dict())
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    x = torch.from_numpy(normalized([blob_image(np.random.default_rng(4),
                                                64, 48)]))
    with torch.inference_mode():
        want = model.head_logits(x)
        got = folded.head_logits(x)
    assert float(want.std()) > 0  # the logits are not all one value
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_fold_eps_is_per_scope():
    from neuralbarkcalculator_tpu_torch.models.fold import (_conv_of,
                                                            fold_state_dict)

    model = zoo_model("fcn_efficientnet_b0", seed=5)
    state = model.state_dict()
    bn = "backbone.model._blocks.2._bn1"
    assert _conv_of(bn) == "backbone.model._blocks.2._depthwise_conv"
    assert _conv_of("backbone.model._bn1") == "backbone.model._conv_head"
    assert _conv_of("backbone.model._bn0") == "backbone.model._conv_stem"
    assert _conv_of("classifier.0.convs.4.2") == "classifier.0.convs.4.1"
    for eps, other in ((1e-3, 1e-5), (1e-5, 1e-3)):
        folded = fold_state_dict(state, {"backbone": eps,
                                         "classifier": other})
        k = (state[f"{bn}.weight"].double()
             / torch.sqrt(state[f"{bn}.running_var"].double() + eps))
        torch.testing.assert_close(
            folded["backbone.model._blocks.2._depthwise_conv.bias"],
            (state[f"{bn}.bias"].double()
             - state[f"{bn}.running_mean"].double() * k).float(),
            rtol=0, atol=0)


def test_reference_checkpoint_with_fc_loads(tmp_path):
    """A reference EfficientNet checkpoint carries efficientnet_pytorch's
    unused ImageNet ``_fc``: loading drops it; any other stray key is an
    error."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, load_torch_checkpoint)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        deeplabv3_efficientnet)

    model = deeplabv3_efficientnet(0)
    state = dict(model.state_dict())
    state["backbone.model._fc.weight"] = torch.zeros(1000, 1280)
    state["backbone.model._fc.bias"] = torch.zeros(1000)
    path = tmp_path / "best_model.pt"
    torch.save({"state_dict": state}, path)
    load_state_dict_into(deeplabv3_efficientnet(0),
                         load_torch_checkpoint(str(path)))
    state["backbone.model._extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="_extra"):
        load_state_dict_into(deeplabv3_efficientnet(0), state)


def test_predict_cli_runs_deeplab_on_cpu(tmp_path):
    """``cli/predict --model deeplabv3_resnet50`` end to end on the CPU:
    BMP sources -> native preprocess -> full-width DeepLab -> artifacts."""
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        deeplabv3_resnet50)

    torch.manual_seed(0)
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(deeplabv3_resnet50().state_dict(), ckpt)
    rng = np.random.default_rng(0)
    root = tmp_path / "root"
    for wood, shape in (("sapin", (40, 64)), ("epinette_gelee", (64, 64))):
        d = root / "samples" / wood
        d.mkdir(parents=True)
        save_image_u8_pil(str(d / "a.bmp"),
                          (rng.random((*shape, 3)) * 200 + 40).astype(
                              np.uint8))
    proc = subprocess.run(
        [sys.executable, "-m", "neuralbarkcalculator_tpu_torch.cli.predict",
         str(root), "--device", "cpu", "--model_path", ckpt, "--model",
         "deeplabv3_resnet50", "--dpi", "40", "--batch_size", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for wood in ("sapin", "epinette_gelee"):
        for sub in ("combined_images", "outputs"):
            assert (root / "results" / sub / wood / "a.png").is_file()
    lines = (root / "results" / "final_stats.csv").read_text().splitlines()
    assert len(lines) == 3


def test_served_exact_height_model(tmp_path):
    """An exact-height model behind the batcher: the warm-up runs the
    ladder at its height, fixed_pad_height does not apply, a new height
    is one new launch shape, and the answer equals the engine's map."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    pt = str(tmp_path / "b0.pt")
    torch.save(zoo_model("fcn_efficientnet_b0", seed=6).state_dict(), pt)
    calc = NeuralBarkCalculator(pt, model_name="fcn_efficientnet_b0",
                                device="cpu", config=PredictConfig(
                                    model_path=pt, use_bfloat16=False,
                                    batch_size=2, fixed_pad_height=64))
    predictor = BatchingPredictor(calc, max_wait_ms=1)
    try:
        predictor.warmup(64, 64)
        assert calc._launch_shapes == {(64, 1, 64), (64, 2, 64)}
        img = blob_image(np.random.default_rng(7), 48, 64)
        res = predictor.submit(img).result(timeout=120)
    finally:
        predictor.close()
    assert calc._launch_shapes == {(64, 1, 64), (64, 2, 64), (48, 1, 64)}
    (_, want), = calc.predict_images([ProcessedImage(img, "a", "serving")])
    np.testing.assert_array_equal(res.class_map, want)
    assert int(res.counts.sum()) == 48 * 64


@pytest.mark.parametrize("name", ["deeplabv3_resnet50", "fcn_resnet101",
                                  "fcn_efficientnet_b0"])
def test_training_refuses_other_zoo_models(name, tmp_path):
    """Training takes every zoo model now (tests/test_torch_train_zoo.py
    trains each); what it still refuses for them: a bare EfficientNet name
    without its variant, an unknown sampler, and --mpl, before touching
    the data."""
    from neuralbarkcalculator_tpu_torch.cli.train import build_parser
    from neuralbarkcalculator_tpu_torch.train.loop import (Experiment,
                                                           build_model)

    model = build_model(name, 0.8, seed=0)
    assert model.classifier.__class__.__name__ == (
        "DeepLabHead" if name.startswith("deeplab") else "FCNHead")
    with pytest.raises(ValueError, match="sampler"):
        Experiment(str(tmp_path), str(tmp_path / "moar"), model_name=name,
                   sampler="uniform", device="cpu")
    bare = name.rsplit("_b", 1)[0] if "efficientnet" in name else None
    if bare:
        with pytest.raises(ValueError, match="variant"):
            Experiment(str(tmp_path), str(tmp_path / "moar"),
                       model_name=bare, device="cpu")
    with pytest.raises(SystemExit):
        build_parser().parse_args([str(tmp_path), "--device", "cpu",
                                   "--model", name, "--mpl"])
    assert not (tmp_path / "moar").exists()
