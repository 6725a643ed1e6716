"""PyTorch port without its native IO runtime (native/barkio.cc).

Each test makes the library's build fail (utils/build.build_native
replaced by a function that raises, the loader's cache reset) for its own
duration only. The port must then run as the JAX package runs without its
library: one RuntimeWarning, PIL codecs, the scipy resize on the host, the
CCL postprocess, and the same artifacts. Tolerances: decoded images,
class maps and CSV bytes exact; the scipy resize equal to the JAX
package's bit for bit (the same numpy and scipy operations in the same
order), and the scipy preprocess within the JAX package's bound of 1 LSB
of the native pass (tests/test_preprocess_native.py finds them equal).
"""
import os
import warnings

import numpy as np
import pytest
import torch

from torch_port_common import tiny_checkpoint, tiny_engines, write_processed
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

from neuralbarkcalculator_tpu_torch.io import native
from neuralbarkcalculator_tpu_torch.utils import build

_ERROR = "building libbarkio failed (g++ ...): g++: command not found"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _break_native(monkeypatch) -> None:
    """The native build fails for the rest of the test; the port's caches
    forget the library and the postprocess's once-a-process warning."""
    from neuralbarkcalculator_tpu_torch.pipeline import predict

    def fail():
        raise RuntimeError(_ERROR)

    monkeypatch.setattr(build, "build_native", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(predict, "_no_native_warned", False)


def test_one_warning_and_none(monkeypatch):
    _break_native(monkeypatch)
    with pytest.warns(RuntimeWarning) as record:
        assert native.get_lib() is None
        assert native.get_lib() is None  # no second build, no second warning
    assert len(record) == 1 and _ERROR in str(record[0].message)
    img = np.zeros((4, 4, 3), np.uint8)
    maps = np.zeros((1, 4, 4), np.uint8)
    assert native.image_info("missing.png") is None
    assert native.preprocess_image_native(img, 8, 1e-3, 0.85) is None
    assert native.remove_small_zones_batch(maps) is None
    assert native.remove_small_zones_host2(maps, 4) is None


@pytest.mark.parametrize("ext,mode", [(".bmp", "RGB"), (".png", "RGB"),
                                      (".png", "L")])
def test_pil_codecs_equal_barkio(tmp_path, ext, mode, monkeypatch):
    """RGB scans and single-channel duals (decoded grayscale). An RGB file
    decoded grayscale is left out: barkio's luma and PIL's convert('L')
    round 1 LSB apart at some pixels, in the JAX package too."""
    from PIL import Image

    rng = np.random.default_rng(1)
    shape = (37, 53, 3) if mode == "RGB" else (37, 53)
    img = (rng.random(shape) * 255).astype(np.uint8)
    path = str(tmp_path / f"a{ext}")
    Image.fromarray(img, mode=mode).save(path)
    gray = mode == "L"
    want = native.load_image_u8(path, grayscale=gray)  # barkio
    assert native.get_lib() is not None
    np.testing.assert_array_equal(want, img)
    _break_native(monkeypatch)
    with pytest.warns(RuntimeWarning):
        got = native.load_image_u8(path, grayscale=gray)  # PIL
    np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "b.png")
    native.save_image_u8(out, want)  # PIL's encoder
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (20, 17)),
                                       ((64, 64), (31, 40))])
def test_spline_resize_host_equals_jax(shape, out):
    from neuralbarkcalculator_tpu.ops.resize import spline_resize_host as ref
    from neuralbarkcalculator_tpu_torch.ops.resize import spline_resize_host

    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = spline_resize_host(x, *out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref(x, *out))
    assert got.min() >= x.min() and got.max() <= x.max()


@pytest.mark.parametrize("shape,dark", [((300, 300), (40, 30)),
                                        ((260, 200), (20, 0)),
                                        ((100, 100), (10, 12)),
                                        ((120, 90), (0, 0))])
def test_host_preprocess_scipy_path(shape, dark, monkeypatch):
    import neuralbarkcalculator_tpu.io.native as jax_native
    from neuralbarkcalculator_tpu.pipeline.preprocess import (
        Preprocessor as JaxPreprocessor)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    rng = np.random.default_rng(3)
    img = (rng.random((*shape, 3)) * 255).astype(np.uint8)
    img[:dark[0]] = 0
    if dark[1]:
        img[-dark[1]:] = 0
    port = Preprocessor(target_size=128, backend="host", device="cpu")
    native_out = port._preprocess_host_one(img)
    monkeypatch.setattr(jax_native, "preprocess_image_native",
                        lambda *a, **k: None)
    want = JaxPreprocessor(target_size=128,
                           backend="host")._preprocess_host_one(img)
    _break_native(monkeypatch)
    with pytest.warns(RuntimeWarning):
        got = port._preprocess_host_one(img)
    np.testing.assert_array_equal(got, want)
    assert got.shape == native_out.shape
    assert np.abs(got.astype(int) - native_out).max() <= 1


def _items():
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(12)
    items = []
    for i, (h, wood) in enumerate(((64, "sapin"), (40, "epinette_gelee"),
                                   (56, "sapin"), (30, "sapin"))):
        coarse = rng.random((h // 8 + 2, 10, 3))
        img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :64]
        img = img + 0.15 * rng.random(img.shape)
        items.append(ProcessedImage(
            np.clip(img * 230, 0, 255).astype(np.uint8), f"img{i}.png",
            wood))
    return items


def test_folder_predict_without_native_equals_native_and_jax(tmp_path,
                                                             monkeypatch):
    pt = tiny_checkpoint(str(tmp_path / "best_model.pt"), seed=5)
    jax_engine, port_engine = tiny_engines(pt, batch_size=4,
                                           height_bucket=32, figure_dpi=40)
    items = _items()
    roots = {name: str(tmp_path / name) for name in ("jax", "port", "bare")}
    for root in roots.values():
        write_processed(root, items)
    csv = {"jax": jax_engine.predict(roots["jax"], progress=False),
           "port": port_engine.predict(roots["port"], progress=False)}
    _break_native(monkeypatch)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        csv["bare"] = port_engine.predict(roots["bare"], progress=False)
    messages = [str(w.message) for w in record
                if issubclass(w.category, RuntimeWarning)]
    assert sum(_ERROR in m for m in messages) == 1
    assert sum("make -C native" in m for m in messages) == 1
    data = {}
    for name, path in csv.items():
        with open(path, "rb") as f:
            data[name] = f.read()
    assert data["bare"] == data["port"] == data["jax"]
    for it in items:
        rel = os.path.join("results", "outputs", it.wood_type, it.fname)
        maps = [native.load_image_u8(os.path.join(roots[n], rel),
                                     grayscale=True) for n in roots]
        np.testing.assert_array_equal(maps[2], maps[1])
        np.testing.assert_array_equal(maps[2], maps[0])
        assert os.path.isfile(os.path.join(
            roots["bare"], "results", "combined_images", it.wood_type,
            it.fname))
