"""PyTorch port: ResNet-101 and the DeepLabV3 (ASPP) head against the JAX
package.

The tiny DeepLab model (one bottleneck per stage, full widths, the full
ASPP head) gets JAX-initialized weights with randomized BN, carried across
by ``variables_to_state_dict``; the full-depth factories get the port's
random weights (``torch_port_common.zoo_model``), carried to the JAX
package by its own converter. Tolerances: rtol = atol = 1e-4 between the
packages (the frameworks' convolutions sum in other orders), 1e-4 between
a padded ragged batch and per-image runs (the JAX package's bound,
tests/test_ragged.py; the pooled branch's masked mean sums in another
order), and folded vs unfolded weights bitwise equal between packages.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (tiny_deeplab_jax_model,
                               tiny_deeplab_torch_model, tiny_variables,
                               zoo_model)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """(JAX variables, port model) of the tiny DeepLab model."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)

    variables = tiny_variables(seed=2, model=tiny_deeplab_jax_model())
    model = tiny_deeplab_torch_model()
    load_state_dict_into(model, variables_to_state_dict(variables))
    return variables, model.eval()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


def test_deeplab_variables_map_to_the_port(tiny):
    """Every leaf maps to one key of the port's state dict, and the JAX
    package's converter takes the port's names back to the same tree."""
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    variables, model = tiny
    state = variables_to_state_dict(variables)
    assert set(state) == {k for k in model.state_dict()
                          if not k.endswith("num_batches_tracked")}
    for k in ("classifier.0.convs.0.0.weight", "classifier.0.convs.3.1.bias",
              "classifier.0.convs.4.1.weight",
              "classifier.0.convs.4.2.running_var",
              "classifier.0.project.0.weight", "classifier.1.weight",
              "classifier.2.running_mean", "classifier.4.bias"):
        assert k in state
    back = dict(_leaves(torch_state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()}, head="deeplab")))
    want = dict(_leaves(variables))
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_resnet101_names_equal_jax_exporter():
    """fcn_resnet101: the port's converter gives the JAX package's own
    exporter's keys and values (``variables_to_torch_state_dict``)."""
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables, variables_to_torch_state_dict)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet101)

    torch.manual_seed(0)
    state = fcn_resnet101().state_dict()
    variables = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()})
    want = variables_to_torch_state_dict(variables)
    got = variables_to_state_dict(variables)
    assert sorted(got) == sorted(want)
    assert len(got) == len([k for k in state
                            if not k.endswith("num_batches_tracked")])
    assert "backbone.layer3.22.conv3.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_tiny_deeplab_logits_match_jax(tiny, rng, h, w):
    import jax
    from neuralbarkcalculator_tpu.models.segmentation import (
        SegmentationModel)

    variables, model = tiny
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: tiny_deeplab_jax_model().apply(
        v, x, train=False, method=SegmentationModel.head_logits))(
            variables, x))
    with torch.inference_mode():
        got = model.head_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, h // 8, w // 8, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["fcn_resnet101", "deeplabv3_resnet50",
                                  "deeplabv3_resnet101"])
def test_full_depth_logits_match_jax(name, rng):
    import jax
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)
    from neuralbarkcalculator_tpu.models.segmentation import (
        MODEL_FACTORIES, SegmentationModel)

    model = zoo_model(name, seed=1)
    variables = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in model.state_dict().items()},
        head="deeplab" if name.startswith("deeplab") else "fcn")
    jax_model = MODEL_FACTORIES[name]()
    x = rng.normal(size=(1, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jax_model.apply(
        v, x, train=False, method=SegmentationModel.head_logits))(
            variables, x))
    with torch.inference_mode():
        got = model.head_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 8, 6, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fold_matches_jax_fold(tiny):
    """Both packages fold the ASPP's BNs in float64 and cast back."""
    from neuralbarkcalculator_tpu.models.fold import fold_inference_variables
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.fold import fold_state_dict

    variables, _ = tiny
    want = variables_to_state_dict(fold_inference_variables(variables))
    got = fold_state_dict(variables_to_state_dict(variables))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("fold", [False, True])
def test_ragged_deeplab_equals_per_image(tiny, rng, fold):
    """A zero-padded batch with row masks and embedded row operators gives
    each image what an unpadded forward at its own height gives, the
    masked pooled branch included."""
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        embedded_bicubic_rows)

    _, model = tiny
    if fold:
        model = fold_model(model)
    pad_h, w = 64, 48
    heights = [56, 64, 33]
    batch = np.zeros((len(heights), pad_h, w, 3), np.float32)
    refs, row_ops = [], []
    with torch.inference_mode():
        for i, h in enumerate(heights):
            img = rng.random((h, w, 3), dtype=np.float32)
            batch[i, :h] = img
            refs.append(model(torch.from_numpy(img[None]))[0].numpy())
            row_ops.append(embedded_bicubic_rows(
                model.backbone.valid_feature_height(h), h, pad_h // 8,
                pad_h))
        out = model(torch.from_numpy(batch),
                    valid_h=torch.tensor(heights, dtype=torch.int32),
                    row_upsample=torch.from_numpy(np.stack(row_ops))).numpy()
        # without the mask, the padded rows would move the pooled mean
        unmasked = model(torch.from_numpy(batch[2:]))[0, :heights[2]].numpy()
    for i, h in enumerate(heights):
        np.testing.assert_allclose(out[i, :h], refs[i], rtol=0, atol=1e-4)
        assert np.all(out[i, h:] == 0.0)
    assert np.abs(unmasked - refs[2]).max() > 1e-2


@pytest.mark.parametrize("rate,h,w", [(12, 16, 16), (24, 13, 20),
                                      (36, 16, 12), (2, 7, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_atrous_conv_equals_dilated_conv(rate, h, w, dtype, rng):
    """The space-to-batch ASPP conv computes torch's dilated conv: in
    float32 to rounding (the same products, summed in another order), in
    bf16 within a rounding of the output; channels_last or not."""
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.models.heads import AtrousConv2d

    conv = AtrousConv2d(24, 8, rate, bias=True).to(dtype)
    x = torch.from_numpy(rng.normal(size=(2, 24, h, w)).astype(
        np.float32)).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    with torch.inference_mode():
        want = F.conv2d(x.float(), conv.weight.float(), conv.bias.float(),
                        padding=rate, dilation=rate)
    for fmt in (torch.contiguous_format, torch.channels_last):
        with torch.inference_mode():
            got = conv(x.contiguous(memory_format=fmt))
        assert got.shape == want.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=tol * float(want.abs().max()))


def test_deeplab_has_torchvision_names():
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        deeplabv3_resnet101)

    with torch.device("meta"):
        model = deeplabv3_resnet101()
    keys = set(model.state_dict())
    for k in ("backbone.layer3.22.bn2.weight",
              "classifier.0.convs.0.0.weight", "classifier.0.convs.0.1.bias",
              "classifier.0.convs.2.0.weight",
              "classifier.0.convs.4.1.weight",
              "classifier.0.convs.4.2.running_mean",
              "classifier.0.project.0.weight",
              "classifier.0.project.1.running_var", "classifier.1.weight",
              "classifier.2.weight", "classifier.4.bias"):
        assert k in keys, k
    aspp = model.classifier[0]
    for i, rate in enumerate((12, 24, 36), start=1):
        assert aspp.convs[i][0].dilation == (rate, rate)
        assert aspp.convs[i][0].padding == (rate, rate)
    assert aspp.project[3].p == 0.5
    assert model.classifier[4].out_channels == 3


def test_deeplab_train_mode_raises(tiny):
    """Train mode runs with the step's seed (tests/test_torch_train_zoo.py
    holds it against JAX); it raises without the seed, and for a folded
    (inference-only) model, as JAX's folded heads do."""
    import copy

    from neuralbarkcalculator_tpu_torch.models.fold import fold_model

    model = copy.deepcopy(tiny[1]).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="dropout_seed"):
        model.head_logits(x)
    out = model.head_logits(x, dropout_seed=5)
    assert out.shape == (2, 4, 4, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="inference-only"):
        fold_model(copy.deepcopy(tiny[1])).train().head_logits(
            x, dropout_seed=5)
