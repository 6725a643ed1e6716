"""PyTorch port: the loss menu (ops/losses.py, train/step.make_loss_fn)
against the JAX package's, on the same seeded numpy inputs.

- Every multi-class loss of the menu (exact and histogram Lovász-Softmax,
  weighted cross-entropy, mixed, Jaccard), with and without
  ``pixel_weights``, and per image: the value and its gradient with
  respect to the logits within rtol 1e-5 (atol 1e-5 of the gradient's
  largest entry; the two frameworks sum in other orders).
- The histogram Lovász's prefix counts equal JAX's exactly (integers), and
  its loss is within 1/bins of the exact loss.
- The binary helpers: Lovász hinge (flat and per image, masked), StableBCE,
  binary xloss with ``ignore``, iou_binary, xloss with the reference's
  hard-coded 255, within rtol 1e-5.
"""
import numpy as np
import pytest
import torch

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed, shape=(2, 12, 16), masked=False):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((*shape, 3))).astype(np.float32)
    labels = rng.integers(0, 3, shape).astype(np.int32)
    weights = None
    if masked:
        weights = (rng.random(shape) > 0.3).astype(np.float32)
    return logits, labels, weights


def _jax_value_grad(fn, logits, labels, weights):
    import jax
    import jax.numpy as jnp

    kw = {} if weights is None else {"pixel_weights": jnp.asarray(weights)}
    value, grad = jax.value_and_grad(
        lambda lo: fn(lo, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    return float(value), np.asarray(grad)


def _port_value_grad(fn, logits, labels, weights):
    x = torch.from_numpy(logits).requires_grad_(True)
    kw = {} if weights is None else {"pixel_weights":
                                     torch.from_numpy(weights)}
    value = fn(x, torch.from_numpy(labels).long(), **kw)
    value.backward()
    return float(value.detach()), x.grad.numpy()


def _close(got, want):
    (gv, gg), (wv, wg) = got, want
    assert abs(gv - wv) <= RTOL * abs(wv) + 1e-7, (gv, wv)
    np.testing.assert_allclose(gg, wg, rtol=RTOL,
                               atol=1e-5 * np.abs(wg).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["lovasz", "lovasz_hist", "cwe", "mixed",
                                  "jaccard"])
def test_menu_loss_and_gradient_equal_jax(name, masked):
    from neuralbarkcalculator_tpu.train.step import make_loss_fn as jax_menu
    from neuralbarkcalculator_tpu_torch.train.step import make_loss_fn

    logits, labels, weights = _inputs(1, masked=masked)
    _close(_port_value_grad(make_loss_fn(name), logits, labels, weights),
           _jax_value_grad(jax_menu(name), logits, labels, weights))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bins", [0, 1024])
def test_lovasz_per_image_equal_jax(bins, masked):
    from neuralbarkcalculator_tpu.ops import losses as jl
    from neuralbarkcalculator_tpu_torch.ops import losses as tl

    logits, labels, weights = _inputs(2, masked=masked)
    if masked:
        weights[1] = 0.0  # an image with no valid pixel leaves the mean
    _close(_port_value_grad(
        lambda lo, la, **kw: tl.lovasz_softmax_loss(
            lo, la, per_image=True, bins=bins, **kw), logits, labels,
        weights),
        _jax_value_grad(
            lambda lo, la, **kw: jl.lovasz_softmax_loss(
                lo, la, per_image=True, bins=bins, **kw), logits, labels,
            weights))


@pytest.mark.parametrize("masked", [False, True])
def test_hist_counts_equal_jax_exactly(masked):
    """cum_all / cum_fg from per-class scatter_add_ histograms equal JAX's
    virtual [C, bins, P] compare-reduction on the same probabilities."""
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu_torch.ops.losses import (
        _fg_errors, lovasz_hist_counts)

    bins = 1024
    logits, labels, weights = _inputs(3, shape=(4, 24, 24), masked=masked)
    probas = torch.softmax(torch.from_numpy(logits), -1).reshape(-1, 3)
    w = None if weights is None else torch.from_numpy(weights).reshape(-1)
    fg, errors = _fg_errors(probas, torch.from_numpy(labels).reshape(-1), 3,
                            w)
    b, cum_all, cum_fg = lovasz_hist_counts(errors, fg, bins, w)

    # the JAX package's formulation (ops/losses.py:199-211), verbatim
    e = jnp.asarray(errors.numpy())
    jb = jnp.clip((e * bins).astype(jnp.int32), 0, bins - 1)
    if w is not None:
        jb = jnp.where(jnp.asarray(w.numpy()) > 0, jb, -1)
    ge = jb[:, None, :] >= jnp.arange(bins)[None, :, None]
    want_all = jnp.sum(ge, axis=-1, dtype=jnp.float32)
    want_fg = jnp.sum(jnp.where(ge, jnp.asarray(fg.numpy())[:, None, :],
                                0.0), axis=-1)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(cum_all.numpy(), np.asarray(want_all))
    np.testing.assert_array_equal(cum_fg.numpy(), np.asarray(want_fg))
    assert int(cum_all[:, 0].max()) == (
        errors.shape[1] if w is None else int(w.sum()))


@pytest.mark.parametrize("seed", [4, 5])
def test_hist_within_one_over_bins_of_exact(seed):
    from neuralbarkcalculator_tpu_torch.ops.losses import lovasz_softmax_loss

    bins = 1024
    logits, labels, weights = _inputs(seed, shape=(5, 64, 64), masked=True)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    pw = torch.from_numpy(weights)
    exact = float(lovasz_softmax_loss(x, y, pixel_weights=pw))
    hist = float(lovasz_softmax_loss(x, y, pixel_weights=pw, bins=bins))
    assert abs(hist - exact) <= 1.0 / bins, (hist, exact)


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lovasz_hinge_equal_jax(per_image, masked):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import losses as jl
    from neuralbarkcalculator_tpu_torch.ops import losses as tl

    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 10, 12)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 10, 12)).astype(np.int32)
    weights = ((rng.random((3, 10, 12)) > 0.25).astype(np.float32)
               if masked else None)
    kw_j = {} if weights is None else {"pixel_weights": jnp.asarray(weights)}
    want_v, want_g = jax.value_and_grad(lambda lo: jl.lovasz_hinge_loss(
        lo, jnp.asarray(labels), per_image=per_image, **kw_j))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    kw_t = {} if weights is None else {"pixel_weights":
                                       torch.from_numpy(weights)}
    got = tl.lovasz_hinge_loss(x, torch.from_numpy(labels),
                               per_image=per_image, **kw_t)
    got.backward()
    _close((float(got.detach()), x.grad.numpy()),
           (float(want_v), np.asarray(want_g)))


def test_binary_helpers_equal_jax():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import losses as jl
    from neuralbarkcalculator_tpu_torch.ops import losses as tl

    rng = np.random.default_rng(7)
    scores = (3 * rng.standard_normal((2, 9, 11))).astype(np.float32)
    labels = rng.integers(0, 2, (2, 9, 11)).astype(np.int64)
    labels[0, :2] = 255
    preds = rng.integers(0, 2, (2, 9, 11)).astype(np.int64)
    ts, tlab, tp = (torch.from_numpy(a) for a in (scores, labels, preds))
    js, jlab, jp = (jnp.asarray(a) for a in (scores, labels, preds))

    got_s, got_l = tl.flatten_binary_scores(ts, tlab, ignore=255)
    want_s, want_l = jl.flatten_binary_scores(js, jlab, ignore=255)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    binary = np.clip(labels, 0, 1)
    for got, want in (
            (tl.stable_bce_loss(ts, torch.from_numpy(binary)),
             jl.stable_bce_loss(js, jnp.asarray(binary))),
            (tl.binary_xloss(ts, tlab, ignore=255),
             jl.binary_xloss(js, jlab, ignore=255)),
            (tl.iou_binary(tp, tlab, ignore=255),
             jl.iou_binary(jp, jlab, ignore=255)),
            (tl.iou_binary(tp, tlab, per_image=False),
             jl.iou_binary(jp, jlab, per_image=False)),
            (tl.iou_binary(torch.zeros_like(tp), torch.zeros_like(tlab)),
             jl.iou_binary(jnp.zeros_like(jp), jnp.zeros_like(jlab)))):
        assert abs(float(got) - float(want)) <= RTOL * abs(float(want)) \
            + 1e-7, (float(got), float(want))

    logits, labels3, _ = _inputs(8)
    labels3[0, 0, :5] = 255
    got = tl.xloss(torch.from_numpy(logits), torch.from_numpy(labels3))
    want = jl.xloss(jnp.asarray(logits), jnp.asarray(labels3))
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want))
