"""PyTorch port: the dilated ResNet + FCN head against the JAX package.

The same weights (JAX variables with randomized batch statistics, carried
across by models/convert.py) go through both packages in float32 on the
CPU. Tolerances: rtol = atol = 1e-4 between the packages (the two
frameworks' convolutions sum in different orders), 1e-5 within the port.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (tiny_jax_model, tiny_torch_model,
                               tiny_variables, torch_model_with)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    variables = tiny_variables(seed=0)
    return variables, torch_model_with(variables)


def _images(rng, n, h, w):
    return rng.normal(size=(n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_head_logits_match_jax(weights, rng, h, w):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.segmentation import (
        SegmentationModel)

    variables, model = weights
    x = _images(rng, 2, h, w)
    want = np.asarray(tiny_jax_model().apply(
        variables, jnp.asarray(x), train=False,
        method=SegmentationModel.head_logits))
    with torch.inference_mode():
        got = model.head_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, h // 8, w // 8, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_full_forward_matches_jax(weights, rng):
    import jax.numpy as jnp

    variables, model = weights
    x = _images(rng, 1, 40, 64)
    want = np.asarray(tiny_jax_model().apply(variables, jnp.asarray(x),
                                             train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 40, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_folded_equals_unfolded(weights, rng):
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model

    _, model = weights
    folded = fold_model(model)
    assert not any(k.endswith("running_mean")
                   for k in folded.state_dict())
    assert folded.backbone.conv1.bias is not None
    x = torch.from_numpy(_images(rng, 2, 64, 64))
    with torch.inference_mode():
        np.testing.assert_allclose(folded.head_logits(x).numpy(),
                                   model.head_logits(x).numpy(),
                                   rtol=0, atol=1e-5)


def test_fold_matches_jax_fold():
    """Both packages fold in float64 and cast back: the folded weights are
    equal."""
    from neuralbarkcalculator_tpu.models.fold import fold_inference_variables
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.fold import fold_state_dict

    variables = tiny_variables(seed=1)
    want = variables_to_state_dict(fold_inference_variables(variables))
    got = fold_state_dict(variables_to_state_dict(variables))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("fold", [False, True])
def test_ragged_batch_equals_per_image(weights, rng, fold):
    """A zero-padded batch with row masks and embedded row operators gives
    each image what an unpadded forward at its own height gives."""
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        embedded_bicubic_rows)

    _, model = weights
    if fold:
        model = fold_model(model)
    pad_h, w = 64, 64
    heights = [56, 64, 41]
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
    for i, h in enumerate(heights):
        np.testing.assert_allclose(out[i, :h], refs[i], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out[i, :h].argmax(-1),
                                      refs[i].argmax(-1))
        assert np.all(out[i, h:] == 0.0)  # inert operator rows


def test_valid_feature_height_matches_jax():
    variables_free_jax = tiny_jax_model().backbone
    port = tiny_torch_model().backbone
    for h in (1, 7, 8, 33, 896, 960, 1000, 1024):
        assert port.valid_feature_height(h) == \
            variables_free_jax.valid_feature_height(h)
    assert port.feature_stride == 8


def test_resnet50_has_torchvision_names():
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)

    with torch.device("meta"):
        model = fcn_resnet50()
    keys = set(model.state_dict())
    for k in ("backbone.conv1.weight", "backbone.bn1.running_var",
              "backbone.layer1.0.downsample.0.weight",
              "backbone.layer3.5.conv3.weight",
              "backbone.layer4.2.bn3.bias", "classifier.0.weight",
              "classifier.1.running_mean", "classifier.4.bias"):
        assert k in keys
    assert model.backbone.layer4[1].conv2.dilation == (4, 4)
    assert model.backbone.layer3[0].conv2.stride == (1, 1)
