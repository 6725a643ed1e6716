"""PyTorch port: online serving, resumable and watched folder runs.

The batcher is a pure transport layer: a request's class map and numbers
must equal what the folder engine produces for the same image (and the
JAX engine's map, with no pixel under the near-tie margin), whatever the
batching, width grouping or per-request exclude_nodes remap. Mirrors
tests/test_serving.py on the tiny model that tests/torch_port_common.py
injects into MODEL_FACTORIES, in float32 on the CPU. A resumed folder run
must write a final_stats.csv byte-identical to the full run's and to the
JAX engine's resumed CSV; --watch must predict only the images that
arrive between scans.
"""
import http.client
import io
import json
import os
import queue
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_common import (near_ties, tiny_checkpoint, tiny_engines,
                               tiny_torch_model, write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

MM_PER_PIX = 3.6 * 3.6


def _img(h, w, seed=0):
    """Smooth colour blobs plus noise, so the maps hold several zones."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 8 + 2, w // 8 + 2, 3))
    img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    img = img + 0.15 * rng.random(img.shape)
    return np.clip(img * 230, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    directory = tmp_path_factory.mktemp("serve")
    yield tiny_checkpoint(str(directory / "best_model.pt"), seed=11)
    shutil.rmtree(directory, ignore_errors=True)


@pytest.fixture(scope="module")
def engines(ckpt):
    """(JAX engine, port engine): batch 4, height bucket 32, float32."""
    return tiny_engines(ckpt, batch_size=4, height_bucket=32, figure_dpi=50)


def _items(imgs, prefix="d"):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    return [ProcessedImage(im, f"{prefix}{i}", "t")
            for i, im in enumerate(imgs)]


def test_batcher_matches_direct_engine_and_jax(engines):
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    jax_engine, calc = engines
    imgs = [_img(h, 64, seed=i) for i, h in enumerate((56, 64, 64, 40, 64))]
    direct = {it.fname: cm for it, cm in calc.predict_images(_items(imgs))}
    want = {it.fname: cm
            for it, cm in jax_engine.predict_images(_items(imgs))}
    assert near_ties(calc, imgs) == 0
    pred = BatchingPredictor(calc, batch_size=4, max_wait_ms=150.0)
    try:
        futs = [pred.submit(im) for im in imgs]
        classes = set()
        for i, fut in enumerate(futs):
            res = fut.result(timeout=60)
            np.testing.assert_array_equal(res.class_map, direct[f"d{i}"])
            np.testing.assert_array_equal(res.class_map, want[f"d{i}"])
            # the numbers are the reporter's math over the same map
            counts = np.bincount(res.class_map.ravel(), minlength=3)
            assert res.counts.tolist() == counts.tolist()
            assert res.bark_percent == pytest.approx(
                counts[1] / res.class_map.size * 100.0)
            assert res.node_area_mm2 == pytest.approx(counts[2] * MM_PER_PIX)
            assert res.batch_images >= 1
            np.testing.assert_array_equal(res.image, imgs[i])
            classes |= set(np.unique(res.class_map).tolist())
        assert len(classes) >= 2
        stats = pred.snapshot_stats()
        assert stats["served"] == 5 and stats["requests"] == 5
        assert stats["errors"] == 0 and stats["rejected"] == 0
        assert stats["batches"] >= 2  # 5 images at batch 4
        assert stats["mean_batch"] == pytest.approx(5 / stats["batches"])
        assert stats["latency_ms_p50"] > 0
    finally:
        pred.close()


def test_pow2_ladder_bounds_launch_shapes(engines):
    """A 3-image micro-batch launches at ladder size 4 (an unseen batch
    size pays a one-off set-up), and the dummy row is dropped before the
    postprocess: results equal per-image runs."""
    _, calc = engines
    assert [calc._padded_batch(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert calc.launch_item_counts() == [1, 2, 3]
    items = _items([_img(64, 48, seed=10 + i) for i in range(3)], "p")
    batched = {it.fname: cm for it, cm in calc.predict_images(items)}
    assert sorted(batched) == ["p0", "p1", "p2"]
    for it in items:
        (single,) = [cm for _, cm in calc.predict_images([it])]
        np.testing.assert_array_equal(batched[it.fname], single)
    launched = {n for (pad_h, n, w) in calc._launch_shapes if w == 48}
    assert launched == {1, 4}


def test_fixed_pad_height_pins_launch_bucket(engines, ckpt):
    """PredictConfig.fixed_pad_height (serving's 1024, scaled down): every
    launch of an image at most that tall uses that one pad height, taller
    ones bucket as before, and the maps equal the bucketed engine's (the
    row masks make padding exact)."""
    _, calc = engines
    _, fixed = tiny_engines(ckpt, jax_engine=False, batch_size=4,
                            height_bucket=16, fixed_pad_height=64)
    assert fixed._bucket_of(30) == 64  # would bucket to 32
    assert fixed._bucket_of(64) == 64
    assert fixed._bucket_of(70) == 80  # taller: bucketed, never cut
    items = _items([_img(30, 64, seed=21), _img(64, 64, seed=22)], "f")
    got = {it.fname: cm for it, cm in fixed.predict_images(items)}
    assert {pad_h for (pad_h, _, _) in fixed._launch_shapes} == {64}
    for it, cm in calc.predict_images(items):  # pads 30 -> 32
        np.testing.assert_array_equal(got[it.fname], cm)


def test_batcher_exclude_nodes_per_request(engines):
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    _, calc = engines
    img = _img(64, 64, seed=7)
    pred = BatchingPredictor(calc, batch_size=2, max_wait_ms=150.0)
    try:
        f_keep = pred.submit(img, exclude_nodes=False)
        f_excl = pred.submit(img, exclude_nodes=True)
        keep, excl = f_keep.result(timeout=60), f_excl.result(timeout=60)
        # one batch, both flavours: the remap is node -> bark after
        # remove_small_zones (reference order, models.py:270-276)
        np.testing.assert_array_equal(
            excl.class_map, np.where(keep.class_map == 2, 1, keep.class_map))
        assert not (excl.class_map == 2).any()
        assert excl.counts.tolist() == [keep.counts[0],
                                        keep.counts[1] + keep.counts[2], 0]
        assert excl.node_percent == 0.0
    finally:
        pred.close()


def test_batcher_mixed_widths(engines):
    """Widths are launch-shape dimensions: a mixed micro-batch splits by
    (height bucket, width), so any arrival mix resolves correctly."""
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    _, calc = engines
    imgs = [_img(64, 64, seed=1), _img(64, 48, seed=2),
            _img(56, 64, seed=3), _img(48, 48, seed=4)]
    direct = {it.fname: cm for it, cm in calc.predict_images(_items(imgs))}
    pred = BatchingPredictor(calc, batch_size=4, max_wait_ms=100.0)
    try:
        futs = [pred.submit(im) for im in imgs]
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(fut.result(timeout=60).class_map,
                                          direct[f"d{i}"])
    finally:
        pred.close()


def test_batcher_rejects_bad_input_and_close(engines):
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    pred = BatchingPredictor(engines[1], batch_size=2, max_wait_ms=10.0)
    with pytest.raises(ValueError):
        pred.submit(np.zeros((8, 8), np.uint8))  # no channel dim
    with pytest.raises(ValueError):
        pred.submit(np.zeros((8, 8, 3), np.float32))  # wrong dtype
    pred.close()
    assert not pred._worker.is_alive()
    with pytest.raises(RuntimeError):
        pred.submit(np.zeros((8, 8, 3), np.uint8))
    pred.close()  # a second close is a no-op


def test_warmup_resets_stats(engines):
    """The warmup runs every ladder size and leaves the telemetry clean."""
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    _, calc = engines
    pred = BatchingPredictor(calc, batch_size=4, max_wait_ms=10.0)
    try:
        pred.warmup(height=32, width=40)
        assert {n for (pad_h, n, w) in calc._launch_shapes
                if (pad_h, w) == (32, 40)} == {1, 2, 4}
        stats = pred.snapshot_stats()
        assert stats["served"] == 0 and stats["requests"] == 0
        assert "latency_ms_p50" not in stats
        res = pred.submit(_img(32, 40)).result(timeout=60)
        assert res.class_map.shape == (32, 40)
        assert pred.snapshot_stats()["served"] == 1
    finally:
        pred.close()


class _GatedCalc:
    """A calc stub whose predict blocks on an event, to hold the batcher's
    worker mid-batch."""

    def __init__(self, gate):
        self.gate = gate
        self.config = types.SimpleNamespace(batch_size=1, mm_per_pix=12.96)

    def launch_item_counts(self):
        return [1]

    def predict_images(self, items, exclude_nodes=False, with_counts=False):
        self.gate.wait(timeout=30)
        for it in items:
            cmap = np.zeros(it.image.shape[:2], np.uint8)
            counts = np.array([cmap.size, 0, 0], np.int64)
            yield (it, cmap, counts) if with_counts else (it, cmap)


def test_backpressure_counts_rejected_requests():
    """queue.Full shows in the stats: requests and rejected both count."""
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    gate = threading.Event()
    pred = BatchingPredictor(_GatedCalc(gate), batch_size=1,
                             max_wait_ms=5.0, queue_limit=1)
    try:
        f1 = pred.submit(_img(8, 8))
        deadline = time.time() + 5
        while pred._queue.qsize() and time.time() < deadline:
            time.sleep(0.005)  # the worker takes r1 and blocks on the gate
        f2 = pred.submit(_img(8, 8))  # fills the bounded queue
        with pytest.raises(queue.Full):
            pred.submit(_img(8, 8))
        stats = pred.snapshot_stats()
        assert stats["requests"] == 3 and stats["rejected"] == 1
        gate.set()
        assert f1.result(timeout=10).class_map.shape == (8, 8)
        assert f2.result(timeout=10).class_map.shape == (8, 8)
        assert pred.snapshot_stats()["served"] == 2
    finally:
        gate.set()
        pred.close()


def test_close_serves_requests_queued_before_sentinel():
    """A request accepted before close() resolves: submit's put and
    close's sentinel are serialized by one lock, so accepted requests
    precede the sentinel."""
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    gate = threading.Event()
    pred = BatchingPredictor(_GatedCalc(gate), batch_size=1,
                             max_wait_ms=5.0, queue_limit=8)
    f1 = pred.submit(_img(8, 8))
    f2 = pred.submit(_img(8, 8))  # queued behind the batch in flight
    closer = threading.Thread(target=pred.close)
    closer.start()
    gate.set()
    closer.join(timeout=15)
    assert not closer.is_alive()
    assert f1.result(timeout=1).class_map.shape == (8, 8)
    assert f2.result(timeout=1).class_map.shape == (8, 8)
    with pytest.raises(RuntimeError):
        pred.submit(_img(8, 8))


# --------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def server(ckpt):
    """make_server on an ephemeral port: the tiny model on the CPU, batch
    2, pinned pad height 64, float32."""
    from neuralbarkcalculator_tpu_torch.cli.serve import (build_parser,
                                                          make_server,
                                                          serve_in_thread)
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg

    tseg.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        args = build_parser().parse_args(
            [ckpt, "--device", "cpu", "--model", "_tiny_test", "--port", "0",
             "--batch_size", "2", "--max_wait_ms", "10", "--fixed_height",
             "64", "--float32", "--timeout_s", "60"])
        srv = make_server(args)
    finally:
        tseg.MODEL_FACTORIES.pop("_tiny_test", None)
    thread = serve_in_thread(srv)
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.state.predictor.close()
    thread.join(timeout=10)


def _request(server, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                   timeout=60)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def _png_bytes(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_http_predict_json(server):
    calc = server.state.predictor.calc
    assert calc.config.fixed_pad_height == 64
    assert calc.config.batch_size == 2 and calc.dtype == torch.float32
    status, ctype, body = _request(server, "POST", "/v1/predict",
                                   _png_bytes(_img(64, 48, seed=11)))
    assert status == 200 and ctype == "application/json"
    payload = json.loads(body)
    assert (payload["height"], payload["width"]) == (64, 48)
    assert (payload["source_height"], payload["source_width"]) == (64, 48)
    pixels = payload["class_pixels"]
    assert sum(pixels) == 64 * 48
    assert payload["bark_percent"] == round(pixels[1] / (64 * 48) * 100, 5)
    assert payload["node_percent"] == round(pixels[2] / (64 * 48) * 100, 5)
    assert payload["bark_area_mm2"] == round(pixels[1] * MM_PER_PIX, 5)
    assert payload["batch_images"] >= 1


def test_http_predict_mask_and_exclude(server, engines):
    """The mask answer is the engine's map of the same image, and the
    per-request remap turns nodes into bark."""
    img = _img(64, 64, seed=12)
    body = _png_bytes(img)
    status, ctype, data = _request(server, "POST", "/v1/predict?format=mask",
                                   body)
    assert status == 200 and ctype == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(data)))
    assert mask.shape == (64, 64)
    assert set(np.unique(mask)) <= {0, 127, 255}
    (direct,) = [cm for _, cm in engines[1].predict_images(_items([img]))]
    np.testing.assert_array_equal(
        mask, np.select([direct == 1, direct == 2], [127, 255], 0))

    status, _, data = _request(
        server, "POST", "/v1/predict?format=mask&exclude_nodes=1", body)
    assert status == 200
    excl = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(excl, np.where(mask == 255, 127, mask))


def test_http_predict_combined_figure(server):
    status, ctype, data = _request(
        server, "POST", "/v1/predict?format=combined&dpi=50",
        _png_bytes(_img(64, 64, seed=13)))
    assert status == 200 and ctype == "image/png"
    fig = Image.open(io.BytesIO(data))
    assert fig.size[0] > fig.size[1]  # side-by-side landscape layout


def test_http_preprocess_applied(server):
    """A square image with dark bands is trimmed before the prediction
    (reference models.py:191-201), visible in the returned height."""
    img = _img(64, 64, seed=14)
    img[:8] = 0
    img[-4:] = 0
    status, _, body = _request(server, "POST", "/v1/predict",
                               _png_bytes(img))
    assert status == 200
    payload = json.loads(body)
    assert payload["height"] == 64 - 8 - 4
    assert payload["source_height"] == 64
    assert sum(payload["class_pixels"]) == (64 - 12) * 64


def test_http_health_stats_errors(server):
    status, _, body = _request(server, "GET", "/healthz")
    health = json.loads(body)
    assert status == 200 and health["ok"] is True
    assert health["model"] == "_tiny_test" and health["backend"] == "cpu"
    assert health["n_devices"] == torch.cuda.device_count()

    _request(server, "POST", "/v1/predict", _png_bytes(_img(32, 32)))
    status, _, body = _request(server, "GET", "/v1/stats")
    stats = json.loads(body)
    assert status == 200 and stats["served"] >= 1 and stats["errors"] == 0
    assert stats["served"] == stats["requests"]

    assert _request(server, "GET", "/nope")[0] == 404
    assert _request(server, "POST", "/v1/nope", b"x")[0] == 404
    status, _, body = _request(server, "POST", "/v1/predict",
                               b"not an image")
    assert status == 400 and "undecodable" in json.loads(body)["error"]
    assert _request(server, "POST", "/v1/predict?format=tiff", b"x")[0] == 400
    assert _request(server, "POST", "/v1/predict")[0] == 400  # no body


# ------------------------------------------------------ resume and watch


def _spy_launches(monkeypatch, engine, log: list):
    """Record the names of the images each device launch predicts."""
    launch = engine._launch_batch

    def spy(items, pad_h):
        log.extend(it.fname for it in items)
        return launch(items, pad_h)

    monkeypatch.setattr(engine, "_launch_batch", spy)


def test_predict_resume_csv_equals_full_run_and_jax(engines, tmp_path,
                                                    monkeypatch):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    jax_engine, calc = engines
    items = [ProcessedImage(_img(h, 64, seed=30 + i), f"r{i}.png", wood)
             for i, (h, wood) in enumerate(
                 [(64, "sapin"), (40, "epinette_gelee"), (56, "sapin"),
                  (64, "epinette_gelee"), (30, "sapin")])]
    gone = [("sapin", "r2.png"), ("epinette_gelee", "r3.png")]
    csvs = {}
    for name, engine in (("port", calc), ("jax", jax_engine)):
        root = str(tmp_path / name)
        write_processed(root, items)
        with open(engine.predict(root, progress=False), "rb") as f:
            csvs[name, "full"] = f.read()
        kept = os.path.join(root, "results", "outputs", "sapin", "r0.png")
        mtime = os.stat(kept).st_mtime_ns
        for wood, fname in gone:
            os.remove(os.path.join(root, "results", "outputs", wood, fname))
        # one figure gone alone: its image is predicted again too
        os.remove(os.path.join(root, "results", "combined_images", "sapin",
                               "r4.png"))
        predicted: list = []
        if name == "port":
            _spy_launches(monkeypatch, calc, predicted)
        with open(engine.predict(root, progress=False, resume=True),
                  "rb") as f:
            csvs[name, "resume"] = f.read()
        assert os.stat(kept).st_mtime_ns == mtime  # untouched artifact
        for wood, fname in gone:
            assert os.path.isfile(os.path.join(root, "results", "outputs",
                                               wood, fname))
        if name == "port":
            assert sorted(predicted) == ["r2.png", "r3.png", "r4.png"]
    assert csvs["port", "resume"] == csvs["port", "full"]
    assert csvs["port", "resume"] == csvs["jax", "resume"]
    assert csvs["jax", "resume"] == csvs["jax", "full"]
    lines = csvs["port", "resume"].decode().splitlines()
    # manifest order: epinette_gelee before sapin
    assert [ln.split("\t")[0] for ln in lines[1:]] == [
        "r1.png", "r3.png", "r0.png", "r2.png", "r4.png"]


def test_cli_watch_predicts_only_new_images(ckpt, tmp_path, monkeypatch):
    """--watch with the device preprocess backend (on the CPU), driven for
    two scans through the patched sleep: an image added between them is
    the only one the second scan preprocesses and predicts."""
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    root = tmp_path / "root"
    for wood, name, shape, seed in (("sapin", "a.bmp", (40, 64), 0),
                                    ("epinette_gelee", "b.bmp", (64, 64), 1)):
        (root / "samples" / wood).mkdir(parents=True)
        save_image_u8_pil(str(root / "samples" / wood / name),
                          _img(*shape, seed=seed))
    scans: list[list[str]] = [[]]
    launch = NeuralBarkCalculator._launch_batch

    def spy(self, items, pad_h):
        scans[-1].extend(it.fname for it in items)
        return launch(self, items, pad_h)

    real_sleep = time.sleep

    def fake_sleep(secs):
        if secs != 1234.0:  # anyone else's sleep
            return real_sleep(secs)
        if len(scans) == 2:
            raise KeyboardInterrupt
        save_image_u8_pil(str(root / "samples" / "sapin" / "c.bmp"),
                          _img(48, 64, seed=2))
        scans.append([])

    monkeypatch.setattr(NeuralBarkCalculator, "_launch_batch", spy)
    monkeypatch.setattr(time, "sleep", fake_sleep)
    monkeypatch.setitem(tseg.MODEL_FACTORIES, "_tiny_test", tiny_torch_model)
    main(build_parser().parse_args(
        [str(root), "--device", "cpu", "--model_path", ckpt, "--model",
         "_tiny_test", "--dpi", "40", "--batch_size", "2", "--float32",
         "--preprocess_backend", "device", "--watch", "1234"]))
    assert [sorted(s) for s in scans] == [["a.png", "b.png"], ["c.png"]]
    lines = (root / "results" / "final_stats.csv").read_text().splitlines()
    assert [ln.split("\t")[0] for ln in lines[1:]] == ["b.png", "a.png",
                                                       "c.png"]
    for wood, fname in (("sapin", "c.png"), ("epinette_gelee", "b.png")):
        for sub in ("combined_images", "outputs"):
            assert (root / "results" / sub / wood / fname).is_file()
