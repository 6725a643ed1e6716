"""PyTorch port: the preprocess against the JAX package.

The B-spline operators must be array-equal to the JAX package's (both
built in float64 with scipy's banded solve); the port's ``spline_resize``
and trim bounds are held to the JAX functions on the same inputs. The
device backend (run here on the CPU: the same torch code the card runs)
is held to the JAX package's device backend and to the port's host
backend with the JAX package's own bound between its two backends
(tests/test_pipeline.py: identical trim decisions, max |diff| <= 1 and
under 1e-3 of pixels differing): float32 products summed in another order
than scipy's prefilter round spline-overshoot pixels to the other side.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

TARGET = 96
# (wood, name, h, w, dark top, dark bottom): resized and trimmed (a, c, f;
# a and f share a shape batch), resized non-square then trimmed (b), not
# resized but square so trimmed (d), neither (e)
SOURCES = (("sapin", "a.bmp", 192, 192, 32, 32),
           ("sapin", "b.bmp", 256, 160, 0, 0),
           ("epinette_gelee", "c.bmp", 192, 192, 16, 48),
           ("epinette_gelee", "d.bmp", 80, 80, 8, 4),
           ("sapin", "e.bmp", 90, 64, 0, 0),
           ("sapin", "f.bmp", 192, 192, 8, 40))


def _wood_image(h, w, dark_top=0, dark_bottom=0, seed=0):
    """Synthetic log: texture with dark bands (below the trim threshold)."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 120 + 90).astype(np.uint8)
    if dark_top:
        img[:dark_top] = 0
    if dark_bottom:
        img[-dark_bottom:] = 0
    return img


@pytest.fixture()
def root(tmp_path):
    root = tmp_path / "rootdir"
    for i, (wood, name, h, w, top, bottom) in enumerate(SOURCES):
        d = root / "samples" / wood
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(_wood_image(h, w, top, bottom, seed=i)).save(
            d / name)
    return str(root)


def _hold_close(got, want):
    """The JAX package's bound between its device and host backends."""
    assert [g.fname for g in got] == [w.fname for w in want]
    for g, w in zip(got, want):
        assert g.wood_type == w.wood_type
        assert g.image.shape == w.image.shape, g.fname  # same trim
        assert g.image.dtype == np.uint8
        diff = np.abs(g.image.astype(np.int16) - w.image.astype(np.int16))
        assert diff.max() <= 1, g.fname
        assert (diff > 0).mean() < 1e-3, g.fname


@pytest.mark.parametrize("in_size,out_size",
                         [(4096, 1024), (300, 96), (96, 96), (1, 8)])
def test_bspline_resize_matrix_equals_jax(in_size, out_size):
    from neuralbarkcalculator_tpu.ops.resize import (
        bspline_resize_matrix as jax_matrix)
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        bspline_resize_matrix)

    got = bspline_resize_matrix(in_size, out_size)
    assert got.dtype == np.float64 and got.shape == (out_size, in_size)
    np.testing.assert_array_equal(got, jax_matrix(in_size, out_size))


def test_spline_resize_equals_jax_with_per_image_clip():
    """Three images with different value ranges: each output lies in its
    own image's range (the JAX package vmaps its resize, so the clip is
    per image), within 2e-5 of JAX (its own tolerance against scipy,
    tests/test_resize.py)."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops.resize import (
        spline_resize as jax_resize)
    from neuralbarkcalculator_tpu_torch.ops.resize import spline_resize

    rng = np.random.default_rng(0)
    scale = np.array([1.0, 0.3, 0.05], np.float32).reshape(3, 1, 1, 1)
    offset = np.array([0.0, 0.5, 0.9], np.float32).reshape(3, 1, 1, 1)
    batch = rng.random((3, 50, 37, 3), dtype=np.float32) * scale + offset
    want = np.asarray(jax.vmap(lambda x: jax_resize(x, 20, 16))(
        jnp.asarray(batch)))
    got = spline_resize(torch.from_numpy(batch), 20, 16).numpy()
    assert got.shape == (3, 20, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    for i in range(3):
        assert got[i].min() >= batch[i].min()
        assert got[i].max() <= batch[i].max()
    # the spline overshoots on noise: the narrow images are clipped to
    # their own bounds, which a clip to the batch's range would not do
    assert got[2].max() == batch[2].max() and got[2].min() == batch[2].min()


def _trim_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if name == "dark_bands":  # tests/test_trim.py: (7, 52)
        img = rng.random((1, 64, 32, 3)).astype(np.float32) * 0.5 + 0.4
        img[0, :7] = 0.0
        img[0, -12:] = 0.0
    elif name == "exact_85_percent":  # strict >: (3, 9)
        img = np.zeros((1, 10, 100, 3), np.float32)
        img[0, 3:8] = 1.0
        img[0, 2, :85] = 1.0
        img[0, 8, :86] = 1.0
    elif name == "all_dark":  # no kept row: (0, H)
        img = np.zeros((1, 16, 16, 3), np.float32)
    else:  # a batch of four, one all dark
        img = rng.random((4, 32, 16, 3)).astype(np.float32) * 0.5 + 0.4
        img[0, :5] = 0
        img[1, -3:] = 0
        img[2] = 0
    return img


@pytest.mark.parametrize("case", ["dark_bands", "exact_85_percent",
                                  "all_dark", "batch"])
def test_trim_bounds_batch_equals_jax(case):
    from neuralbarkcalculator_tpu.ops.trim import (
        trim_bounds_batch as jax_trim)
    from neuralbarkcalculator_tpu_torch.ops.trim import (trim_bounds,
                                                         trim_bounds_batch)

    imgs = _trim_case(case)
    want_first, want_last = (np.asarray(v) for v in jax_trim(imgs))
    first, last = trim_bounds_batch(torch.from_numpy(imgs))
    np.testing.assert_array_equal(first.numpy(), want_first)
    np.testing.assert_array_equal(last.numpy(), want_last)
    assert trim_bounds(torch.from_numpy(imgs[0])) == (int(want_first[0]),
                                                      int(want_last[0]))
    expected = {"dark_bands": (7, 52), "exact_85_percent": (3, 9),
                "all_dark": (0, 16)}.get(case)
    if expected:
        assert (int(first[0]), int(last[0])) == expected


def test_device_backend_equals_jax_device_and_port_host(root):
    from neuralbarkcalculator_tpu.pipeline.preprocess import (
        Preprocessor as JaxPreprocessor)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    jax_dev = JaxPreprocessor(target_size=TARGET, backend="device")
    port_dev = Preprocessor(target_size=TARGET, backend="device",
                            device="cpu")
    port_host = Preprocessor(target_size=TARGET, backend="host",
                             device="cpu")
    want = jax_dev.preprocess_images(root, save=False, progress=False)
    got = port_dev.preprocess_images(root, save=False, progress=False)
    host = port_host.preprocess_images(root, save=False, progress=False)
    assert len(got) == len(SOURCES)
    _hold_close(got, want)
    _hold_close(got, host)
    shapes = {g.fname: g.image.shape for g in got}
    assert shapes["a.png"] == (TARGET - 32, TARGET, 3)  # 32/32 of 192 rows
    assert shapes["b.png"][1:] == (TARGET, 3)  # resized, then trimmed
    assert shapes["d.png"] == (80 - 12, 80, 3)  # trimmed, not resized
    assert shapes["e.png"] == (90, 64, 3)  # neither
    # uint8 uploads only: a, f (192^2), b, c, d, e as decoded
    assert port_dev.bytes_h2d == 3 * sum(h * w for *_, h, w, _, _ in SOURCES)


def test_device_stream_equals_list_and_pngs(root):
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.folders import (
        generate_folders)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    generate_folders(root, only_preprocess=True)
    pre = Preprocessor(target_size=TARGET, batch_size=2, backend="device",
                       device="cpu")
    listed = pre.preprocess_images(root, progress=False)
    streamed = dict(pre.preprocess_stream(root, save=False))
    assert sorted(streamed) == list(range(len(listed)))
    for i, item in enumerate(listed):
        assert streamed[i].fname == item.fname
        np.testing.assert_array_equal(streamed[i].image, item.image)
        on_disk = load_image_u8(os.path.join(
            root, "processed", "samples", item.wood_type, item.fname))
        np.testing.assert_array_equal(on_disk, item.image)
    # manifest order: epinette_gelee before sapin
    assert [it.fname for it in listed] == ["c.png", "d.png", "a.png",
                                           "b.png", "e.png", "f.png"]


def test_preprocess_resume_incremental(root):
    from neuralbarkcalculator_tpu_torch.pipeline.folders import (
        generate_folders)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    generate_folders(root, only_preprocess=True)
    pre = Preprocessor(target_size=TARGET, backend="device", device="cpu")
    assert len(pre.preprocess_images(root, progress=False)) == len(SOURCES)
    assert pre.preprocess_images(root, progress=False, resume=True) == []
    assert list(pre.preprocess_stream(root, resume=True)) == []
    Image.fromarray(_wood_image(192, 192, 8, 8, seed=9)).save(
        os.path.join(root, "samples", "sapin", "new.bmp"))
    second = pre.preprocess_images(root, progress=False, resume=True)
    assert [im.fname for im in second] == ["new.png"]
    assert second[0].image.shape == (TARGET - 8, TARGET, 3)
    assert os.path.isfile(os.path.join(root, "processed", "samples",
                                       "sapin", "new.png"))


def test_backend_choice(monkeypatch):
    """The environment override wins; 'auto' calibrates once per process
    and device; a card asked for and missing raises, never a move to the
    CPU."""
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    monkeypatch.setenv("NEURALBARK_PREPROCESS", "host")
    assert Preprocessor(backend="device")._resolve_backend() == "host"
    monkeypatch.setenv("NEURALBARK_PREPROCESS", "device")
    assert Preprocessor(backend="auto")._resolve_backend() == "device"
    monkeypatch.delenv("NEURALBARK_PREPROCESS")
    with pytest.raises(ValueError):
        Preprocessor(backend="tpu")

    monkeypatch.setattr(Preprocessor, "_auto_backend_cache", {})
    first = Preprocessor(backend="auto", device="cpu")
    choice = first._resolve_backend()
    assert choice in ("host", "device")
    assert first.calibration["choice"] == choice
    assert first.calibration["bandwidth_bytes_per_s"] > 0
    again = Preprocessor(backend="auto", device="cpu")
    assert again._resolve_backend() == choice
    assert again.calibration == {}  # the process-wide decision, no probe
    assert Preprocessor._auto_backend_cache == {"cpu": choice}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Preprocessor(backend="auto")._resolve_backend()
        with pytest.raises(RuntimeError, match="CUDA"):
            list(Preprocessor(backend="device")._stream_records(
                [], "unused", False, False))
