"""PyTorch port: segmentation metrics (ops/metrics.py) against the JAX
package's ``ops/metrics.py``.

Confusion counts, IoU and F1 are equal, bit for bit: the counts are exact
integers and the scores take the same float32 operations in the same
order. The F1 postprocess runs through ops/ccl on the tensor's device in
the port (its plain version on the CPU) and through the JAX package's
scan-based labelling there; both are the reference's remove_small_zones,
so the class maps and the scores agree exactly too. Cases: blobby maps with islands under the 150-pixel
threshold, a class absent from target and output (the fixup), and a
padded batch (weights).
"""
import numpy as np
import pytest
import torch

from neuralbarkcalculator_tpu_torch.ops import metrics as tm


def _blobs(rng, n, h, w, classes=3):
    """Logits whose argmax has blobs of every size, down to single
    pixels, and labels drawn the same way."""
    coarse = rng.normal(size=(n, h // 8, w // 8, classes))
    logits = np.kron(coarse, np.ones((1, 8, 8, 1)))
    logits += 0.9 * rng.normal(size=logits.shape)
    labels = np.kron(rng.integers(0, classes, (n, h // 16, w // 16)),
                     np.ones((1, 16, 16), np.int64))
    return logits.astype(np.float32), labels.astype(np.int32)


@pytest.mark.parametrize("case", ["plain", "absent_class", "padded"])
def test_metrics_equal_jax(case):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import metrics as jm

    rng = np.random.default_rng({"plain": 0, "absent_class": 1,
                                 "padded": 2}[case])
    logits, labels = _blobs(rng, 3, 64, 64)
    weights = None
    if case == "absent_class":  # class 2 in neither target nor output
        logits[..., 2] = -10.0
        labels = np.minimum(labels, 1)
    if case == "padded":
        weights = np.array([1, 1, 0], np.float32)[:, None, None]
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.from_numpy(weights)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)

    want_cm = np.asarray(jm.confusion_matrix(jnp.argmax(jl, -1), jlab, 3,
                                             weights=jw))
    got_cm = tm.confusion_matrix(tl.argmax(-1), tlab, 3, weights=tw)
    np.testing.assert_array_equal(got_cm.numpy(), want_cm)
    np.testing.assert_array_equal(
        tm.iou_from_confusion(got_cm).numpy(),
        np.asarray(jm.iou_from_confusion(jnp.asarray(want_cm))))
    np.testing.assert_array_equal(
        tm.f1_from_confusion(got_cm).numpy(),
        np.asarray(jm.f1_from_confusion(jnp.asarray(want_cm))))
    for post in (True, False):
        want = np.asarray(jm.pixelwise_f1(jl, jlab, 3, post, weights=jw))
        got = tm.pixelwise_f1(tl, tlab, 3, post, weights=tw).numpy()
        np.testing.assert_array_equal(got, want)


def test_absent_class_fixup_equals_jax():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import metrics as jm

    scores = np.array([0.8, 0.25, 0.6], np.float32)
    for absent in ([0], [2], [0, 2], [1, 2]):
        cm = np.full((3, 3), 5, np.int64)
        cm[absent, :] = 0
        cm[:, absent] = 0
        want = np.asarray(jm._absent_class_fixup(jnp.asarray(scores),
                                                 jnp.asarray(cm)))
        got = tm._absent_class_fixup(torch.from_numpy(scores),
                                     torch.from_numpy(cm)).numpy()
        np.testing.assert_array_equal(got, want)


def test_remove_small_zones_equals_jax_ccl():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops.ccl import remove_small_zones

    logits, _ = _blobs(np.random.default_rng(3), 2, 96, 80)
    maps = logits.argmax(-1).astype(np.int32)
    want = np.asarray(remove_small_zones(jnp.asarray(maps)))
    got = tm.remove_small_zones(torch.from_numpy(maps)).numpy()
    assert (got != maps).any()  # the clean-up did work
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.remove_small_zones(torch.from_numpy(maps[0])).numpy(), want[0])
