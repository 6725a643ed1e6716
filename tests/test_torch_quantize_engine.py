"""PyTorch port: int8 inference through the engine, the CLIs and the
offline int8 checkpoint, against the JAX package.

The tiny model (tests/torch_port_common.py) on the CPU. What must hold:

- ``quantize_int8`` calibrates on the first chunk and swaps the engine to
  the int8 model, its host copy of the float weights freed; class maps
  valid; agreement with the float engine above JAX's own floor, 0.5 (a
  random network's logits are near ties everywhere, JAX
  tests/test_quantize.py); agreement with the JAX int8 engine on the same
  float weights >= 0.98 (the two calibrations see the same images, but
  each framework's float stem and normalization round on their own, so a
  few scales differ in the last bits and near-tie pixels flip);
- the first chunk's images are decoded once (calibration and the pump
  share them);
- the offline export reloaded gives bit-equal maps;
- a bf16 engine keeps every scale float32 and every int8 weight int8; only
  the stem conv takes bf16;
- ``--int8`` through ``cli/predict.main`` and ``cli/serve.make_server``;
  ``cli/quantize_checkpoint`` writes a file the engine and the CLI load;
- a JAX ``.int8.msgpack`` and EfficientNet are refused with messages.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, tiny_checkpoint,
                               tiny_deeplab_torch_model, tiny_engines,
                               tiny_torch_model, write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

# random weights overflow a downsample branch's clip range now and then
pytestmark = pytest.mark.filterwarnings("ignore:int8 calibration")

# agreement of the port's int8 maps with the JAX int8 engine's
JAX_INT8_FLOOR = 0.98
# agreement of int8 maps with float maps on random weights (JAX's floor)
FLOAT_FLOOR = 0.5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    directory = tmp_path_factory.mktemp("q")
    yield tiny_checkpoint(str(directory / "m.pt"), 0)
    shutil.rmtree(directory, ignore_errors=True)


def _items():
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(1)
    return [ProcessedImage(blob_image(rng, h, 64), f"i{k}.png", "sapin")
            for k, h in enumerate([64, 48, 64, 32])]


def _maps(engine, items):
    return {it.fname: m for it, m in engine.predict_images(items)}


def _agreement(a, b) -> float:
    return (sum(int((a[k] == b[k]).sum()) for k in a)
            / sum(m.size for m in a.values()))


@pytest.fixture(scope="module")
def int8_run(ckpt):
    """The port's and the JAX package's int8 engines and their maps."""
    jax_eng, eng = tiny_engines(ckpt, quantize_int8=True, batch_size=2,
                                height_bucket=32)
    items = _items()
    return eng, _maps(eng, items), _maps(jax_eng, items), items


def test_engine_int8_calibrates_and_agrees(int8_run, ckpt):
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        QuantizedSegmentationModel)

    eng, qmaps, jmaps, items = int8_run
    assert isinstance(eng.model, QuantizedSegmentationModel)
    assert not eng._quantize_pending
    assert not hasattr(eng, "_host_state")  # freed after calibration
    for it in items:
        m = qmaps[it.fname]
        assert m.shape == it.image.shape[:2] and m.dtype == np.uint8
        assert set(np.unique(m)) <= {0, 1, 2}
    _, f32 = tiny_engines(ckpt, jax_engine=False, batch_size=2,
                          height_bucket=32)
    assert _agreement(qmaps, _maps(f32, items)) > FLOAT_FLOOR
    assert _agreement(qmaps, jmaps) >= JAX_INT8_FLOOR
    with pytest.raises(RuntimeError, match="calibrat"):
        eng.quantize([items[:1]])


def test_offline_export_reloads_bit_equal(int8_run, ckpt, tmp_path):
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        is_quantized_checkpoint, load_quantized, save_quantized)

    eng, qmaps, _, items = int8_run
    path = str(tmp_path / "m.int8.pt")
    save_quantized(path, eng.model, "_tiny_test")
    assert is_quantized_checkpoint(path) and not is_quantized_checkpoint(ckpt)
    _, again = tiny_engines(path, jax_engine=False, batch_size=2,
                            height_bucket=32)
    assert not again._quantize_pending
    assert type(again.model) is type(eng.model)
    got = _maps(again, items)
    for k, m in qmaps.items():
        np.testing.assert_array_equal(got[k], m)
    with pytest.raises(ValueError, match="fcn_resnet50"):
        load_quantized(path, "fcn_resnet50")


def test_first_chunk_is_decoded_once(ckpt, tmp_path, monkeypatch):
    """predict() decodes images on the pump's workers; the calibration's
    decodes of the first chunk are handed to the pump, not read again."""
    from neuralbarkcalculator_tpu_torch.pipeline import predict as pmod

    root = str(tmp_path / "root")
    items = _items()
    write_processed(root, items)
    reads = []
    load = pmod.load_image_u8

    def counting(path, *a, **k):
        reads.append(os.path.basename(path))
        return load(path, *a, **k)

    monkeypatch.setattr(pmod, "load_image_u8", counting)
    _, eng = tiny_engines(ckpt, jax_engine=False, quantize_int8=True,
                          batch_size=4, height_bucket=32, figure_dpi=40)
    eng.predict(root, progress=False)
    assert sorted(reads) == sorted(it.fname for it in items)


def _tiny_deeplab_ckpt(path: str) -> str:
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from torch_port_common import tiny_deeplab_jax_model, tiny_variables

    torch.save(variables_to_state_dict(tiny_variables(
        seed=2, model=tiny_deeplab_jax_model())), path)
    return path


def test_bf16_engine_keeps_scales_float32(tmp_path, monkeypatch):
    """Lazy and offline: the int8 weights stay int8, every scale and the
    stem's float weights float32; the stem conv alone runs in bf16."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.models.quantize import save_quantized
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    monkeypatch.setitem(tseg.MODEL_FACTORIES, "_tiny_deeplab",
                        tiny_deeplab_torch_model)
    pt = _tiny_deeplab_ckpt(str(tmp_path / "d.pt"))
    items = _items()[:2]

    def engine(path, **config):
        return NeuralBarkCalculator(
            path, model_name="_tiny_deeplab", device="cpu",
            config=PredictConfig(model_path=path, batch_size=2,
                                 height_bucket=32, **config))

    lazy = engine(pt, quantize_int8=True)
    maps = _maps(lazy, items)
    qpath = str(tmp_path / "d.int8.pt")
    save_quantized(qpath, lazy.model, "_tiny_deeplab")
    offline = engine(qpath)
    for eng in (lazy, offline):
        assert eng.dtype == torch.bfloat16
        state = eng.model.state_dict()
        for key, v in state.items():
            want = torch.int8 if key.endswith(".q") else torch.float32
            assert v.dtype == want, key
        for key in ("backbone.inv_s_stem", "classifier.aspp.s_in",
                    "classifier.aspp.inv_s_cat",
                    "classifier.aspp.pool_kernel",
                    "backbone.layer1.0.conv1.m", "classifier.conv.b"):
            assert key in state, key
        # the float stem runs at the engine's dtype
        x = torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16)
        seen = []
        hook = torch.nn.functional.conv2d
        with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.nn.functional, "conv2d", lambda *a, **k: (
                seen.append(a[1].dtype), hook(*a, **k))[1])
            eng._logits(x.to(torch.uint8), None)
        assert seen == [torch.bfloat16]
    got = _maps(offline, items)
    for k, m in maps.items():
        np.testing.assert_array_equal(got[k], m)


def test_cli_predict_int8_and_quantize_checkpoint(ckpt, tmp_path,
                                                  monkeypatch):
    """cli/predict.main --int8 on a folder; cli/quantize_checkpoint on its
    processed images writes a .int8.pt that cli/predict.main runs as
    --model_path (no --int8), with the maps of an engine that loads the
    same file."""
    from neuralbarkcalculator_tpu_torch.cli import predict as cli_predict
    from neuralbarkcalculator_tpu_torch.cli import quantize_checkpoint
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        is_quantized_checkpoint)

    monkeypatch.setitem(tseg.MODEL_FACTORIES, "_tiny_test", tiny_torch_model)
    root = tmp_path / "root"
    (root / "samples" / "sapin").mkdir(parents=True)
    for it in _items():
        save_image_u8_pil(str(root / "samples" / "sapin" / it.fname),
                          it.image)
    base = [str(root), "--device", "cpu", "--model", "_tiny_test", "--dpi",
            "40", "--batch_size", "2", "--float32"]
    cli_predict.main(cli_predict.build_parser().parse_args(
        base + ["--model_path", ckpt, "--int8"]))
    csv = root / "results" / "final_stats.csv"
    assert len(csv.read_text().splitlines()) == 1 + 4

    out = quantize_checkpoint.main(quantize_checkpoint.build_parser(
        ).parse_args([str(root / "processed"), "--model_path", ckpt,
                      "--model", "_tiny_test", "--device", "cpu",
                      "--float32", "--n", "2",
                      "--out", str(tmp_path / "t.int8.pt")]))
    assert out.endswith(".int8.pt") and is_quantized_checkpoint(out)
    shutil.rmtree(root / "results")
    cli_predict.main(cli_predict.build_parser().parse_args(
        base + ["--model_path", out, "--resume"]))
    assert len(csv.read_text().splitlines()) == 1 + 4
    _, eng = tiny_engines(out, jax_engine=False, batch_size=2)
    for it, m in eng.predict_images(_items()):
        dual = load_image_u8(str(root / "results" / "outputs" / "sapin"
                                 / it.fname), grayscale=True)
        np.testing.assert_array_equal(
            dual, np.choose(m, [0, 127, 255]).astype(np.uint8))


def test_serve_int8(ckpt, monkeypatch):
    """cli/serve.make_server --int8: the warm-up calibrates, and a request
    through HTTP is answered by the int8 model."""
    import http.client
    import io

    from PIL import Image

    from neuralbarkcalculator_tpu_torch.cli.serve import (build_parser,
                                                          make_server,
                                                          serve_in_thread)
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        QuantizedSegmentationModel)

    monkeypatch.setitem(tseg.MODEL_FACTORIES, "_tiny_test", tiny_torch_model)
    srv = make_server(build_parser().parse_args(
        [ckpt, "--device", "cpu", "--model", "_tiny_test", "--port", "0",
         "--batch_size", "2", "--max_wait_ms", "10", "--fixed_height", "64",
         "--float32", "--int8"]))
    calc = srv.state.predictor.calc
    assert calc._quantize_pending
    srv.state.predictor.warmup(64, 64)
    assert isinstance(calc.model, QuantizedSegmentationModel)
    thread = serve_in_thread(srv)
    try:
        buf = io.BytesIO()
        Image.fromarray(_items()[1].image).save(buf, format="PNG")
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=60)
        c.request("POST", "/v1/predict", body=buf.getvalue())
        r = c.getresponse()
        payload = json.loads(r.read())
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.predictor.close()
        thread.join(timeout=10)
    assert r.status == 200
    assert sum(payload["class_pixels"]) == 48 * 64


def test_refusals(ckpt, tmp_path):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    jax_int8 = tmp_path / "m.int8.msgpack"
    jax_int8.write_bytes(b"NBCQINT8\x01" + b"\0" * 16)
    with pytest.raises(NotImplementedError, match="quantize_checkpoint"):
        NeuralBarkCalculator(str(jax_int8), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        NeuralBarkCalculator(
            ckpt, model_name="fcn_efficientnet_b0", device="cpu",
            config=PredictConfig(model_path=ckpt, quantize_int8=True))
    from neuralbarkcalculator_tpu_torch.cli import quantize_checkpoint
    with pytest.raises(ValueError, match="int8"):
        quantize_checkpoint.main(quantize_checkpoint.build_parser(
            ).parse_args([str(tmp_path), "--model_path", ckpt, "--model",
                          "deeplabv3_efficientnet_b0", "--device", "cpu"]))
