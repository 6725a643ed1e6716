"""PyTorch port: exact Lovász-Softmax (ops/losses.py) against the JAX
package's ``lovasz_softmax_loss``.

Same numpy logits and labels through both, value and gradient. Cases
include ties among the errors (logits on a coarse grid, so many pixels
share a probability; the stable sort on the same key orders them alike)
and padded ``pixel_weights``. Tolerances: the value within 1e-6, the
gradient within 1e-5 (the two softmaxes and sums round differently).
"""
import numpy as np
import pytest
import torch

from neuralbarkcalculator_tpu_torch.ops.losses import (lovasz_grad,
                                                       lovasz_softmax_loss)


def _case(name: str, rng):
    shape = (3, 12, 16)
    logits = rng.normal(size=(*shape, 3)).astype(np.float32)
    labels = rng.integers(0, 3, shape).astype(np.int32)
    weights = None
    if name == "ties":
        logits = np.round(logits * 2) / 2  # few distinct values
    elif name == "padded_batch":
        weights = np.array([1, 1, 0], np.float32)[:, None, None]
    elif name == "pixel_mask":
        weights = (rng.random(shape) < 0.7).astype(np.float32)
    elif name == "absent_class":
        labels = np.minimum(labels, 1)
    return logits, labels, weights


@pytest.mark.parametrize("name", ["random", "ties", "padded_batch",
                                  "pixel_mask", "absent_class"])
def test_lovasz_value_and_grad_match_jax(name):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import losses as jl

    logits, labels, weights = _case(name, np.random.default_rng(7))
    jw = None if weights is None else jnp.asarray(weights)
    want, want_g = jax.value_and_grad(
        lambda x: jl.lovasz_softmax_loss(x, jnp.asarray(labels),
                                         pixel_weights=jw))(
        jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    tw = None if weights is None else torch.from_numpy(weights)
    got = lovasz_softmax_loss(x, torch.from_numpy(labels).long(),
                              pixel_weights=tw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


def test_lovasz_grad_equals_jax():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import losses as jl

    gt = (np.random.default_rng(8).random(500) < 0.3).astype(np.float32)
    want = np.asarray(jl.lovasz_grad(jnp.asarray(gt)))
    np.testing.assert_array_equal(
        lovasz_grad(torch.from_numpy(gt)).numpy(), want)


def test_padded_samples_count_nothing():
    """A sample with pixel weight 0 changes neither the value nor the
    gradient of the others."""
    logits, labels, _ = _case("random", np.random.default_rng(9))
    x = torch.from_numpy(logits)
    lab = torch.from_numpy(labels).long()
    full = lovasz_softmax_loss(x[:2], lab[:2])
    pw = torch.tensor([1.0, 1.0, 0.0])[:, None, None]
    padded = lovasz_softmax_loss(x, lab, pixel_weights=pw)
    assert abs(float(full) - float(padded)) <= 1e-6
