"""PyTorch port: ``predict_streaming`` and the server over a ``(data,
model)`` grid of processes (pipeline/predict.py, pipeline/serving.py), on
the CPU over gloo, with the tiny FCN of tests/torch_port_common.py in
float32.

One job of two spawned ranks (``_run_rank``, a ``file://`` rendezvous
under the module's tmp directory, a timeout of its own) runs once for the
module, under the meshes (2, 1) and (1, 2) in turn; the parent computes
the one-process references and JAX's batcher under ``make_mesh(n_data=2)``
while the ranks run. Grid rank 0 alone reads the stream and the requests
and broadcasts each chunk's or micro-batch's plan and pixels:

- streaming over a stream whose arrival order and delays differ by rank
  (only rank 0's is read, the others' are never touched), and through
  ``Preprocessor.preprocess_stream`` of a raw BMP folder (JAX
  tests/test_streaming.py:81): rank 0's final_stats.csv byte-equal to the
  one-process sequential path's and its dual masks bit-equal; the other
  rank returns None;
- a stream that raises on rank 0 makes both ranks raise, rank 0 its own
  error and rank 1 that rank 0's stream failed, within the job's
  deadline, and the mesh goes on working;
- the server: ``make_server(args, mesh=mesh)`` on rank 0 and
  ``BatchingPredictor.follow`` on rank 1; requests from four threads of
  mixed heights and widths with ``exclude_nodes`` per request: maps and
  counts equal to the one-process batcher's and to JAX's
  ``BatchingPredictor`` under ``make_mesh(n_data=2)`` (no pixel under the
  near-tie margin, as tests/test_torch_serving.py holds one process);
  rank 0's stats, one HTTP request, and ``close()`` ending the follower;
- a failed follower: rank 1 raises on the second micro-batch and leaves
  the process group; rank 0's pending futures end with an exception,
  ``close()`` raises and ``submit`` refuses.
"""
import argparse
import http.client
import io
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_common import (blob_image, near_ties, tiny_checkpoint,
                               tiny_jax_model, tiny_torch_model,
                               write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 19
# the streamed folder: 64-wide images in three height buckets (32)
WIDTH = 64
HEIGHTS = (64, 40, 56, 72, 96, 100, 128)
WOOD = ("sapin", "epinette_gelee", "sapin", "sapin", "epinette_gelee",
        "sapin", "epinette_gelee")
ENGINE_CONFIG = dict(batch_size=4, height_bucket=32, figure_dpi=50)
# the raw BMP folder (JAX tests/test_streaming.py's heights)
BMP_HEIGHTS = (90, 100, 110, 96, 120)
# the server's requests: (height, width, exclude_nodes), widths that a
# model group of 2 splits into strips of 8 columns or more
REQUESTS = ((56, 64, False), (64, 64, True), (40, 48, False),
            (64, 48, True), (48, 64, False), (64, 32, True),
            (33, 64, False), (64, 64, False))
CLIENTS = 4
SERVE_ARGS = ("--device", "cpu", "--model", "_tiny_test", "--port", "0",
              "--batch_size", "4", "--max_wait_ms", "50", "--float32",
              "--fixed_height", "64", "--timeout_s", "60")
MESHES = {"(2, 1)": (2, 1), "(1, 2)": (1, 2)}
TIMEOUT = 240

_RUN = r"""
import sys
import test_torch_mesh_serving as t
t._run_rank(*sys.argv[1:])
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _items():
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(SEED)
    return [ProcessedImage(blob_image(rng, h, WIDTH), f"img{i}.png", wood)
            for i, (h, wood) in enumerate(zip(HEIGHTS, WOOD))]


def _request_images():
    rng = np.random.default_rng(SEED + 1)
    return [blob_image(rng, h, w) for h, w, _ in REQUESTS]


def _write_bmp_root(root) -> None:
    """A raw folder of BMP scans, with the processed/ folder a saving
    preprocess writes into."""
    d = os.path.join(root, "samples", "sapin")
    os.makedirs(d)
    os.makedirs(os.path.join(root, "processed", "samples", "sapin"))
    rng = np.random.default_rng(SEED + 2)
    for i, h in enumerate(BMP_HEIGHTS):
        img = (rng.random((h, WIDTH, 3)) * 160 + 60).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"img{i}.bmp"))


def _fresh_results(root) -> None:
    results = os.path.join(root, "results")
    shutil.rmtree(results, ignore_errors=True)
    for sub in ("combined_images", "outputs"):
        os.makedirs(os.path.join(results, sub, "sapin"))


def _register():
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg

    tseg.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model


def _engine(pt, mesh=None):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    _register()
    return NeuralBarkCalculator(
        pt, model_name="_tiny_test", device="cpu", mesh=mesh,
        config=PredictConfig(model_path=pt, use_bfloat16=False,
                             **ENGINE_CONFIG))


def _serve_args(pt) -> argparse.Namespace:
    from neuralbarkcalculator_tpu_torch.cli.serve import build_parser

    _register()
    return build_parser().parse_args([pt, *SERVE_ARGS])


def _outputs(root, wood_types) -> dict:
    """{fname: dual mask bytes} under root/results/outputs."""
    out = {}
    for wood in sorted(set(wood_types)):
        d = os.path.join(root, "results", "outputs", wood)
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                out[f"{wood}/{name}"] = f.read()
    return out


def _csv(path):
    if path is None:
        return None
    with open(path, "rb") as f:
        return f.read()


def _serve(predictor, images) -> list:
    """Every request of REQUESTS through ``predictor`` from CLIENTS
    threads, each taking every CLIENTS-th request: (class map, counts)
    in request order."""
    results = [None] * len(images)

    def client(c: int):
        for i in range(c, len(images), CLIENTS):
            res = predictor.submit(images[i], REQUESTS[i][2]).result(
                timeout=60)
            results[i] = (res.class_map, res.counts)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and None not in results
    return results


# ------------------------------------------------------------ the ranks

def _run_rank(rank, size, init, out_dir) -> None:
    """A rank's body: join the group, run the job, save its result."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed)

    torch.set_num_threads(1)
    world = initialize_distributed(init_method=init, rank=int(rank),
                                   world_size=int(size), device="cpu")
    try:
        result = _job(world, out_dir)
        torch.save(result, os.path.join(out_dir, f"result-{rank}.pt"))
    finally:
        shutdown_distributed()


class _Stream:
    """``_items()`` as a (manifest index, item) stream in this rank's own
    order, with small delays of its own; ``taken`` counts what was read."""

    def __init__(self, rank: int):
        self.items = _items()
        rng = np.random.default_rng(SEED + 10 + rank)
        self.order = rng.permutation(len(self.items)).tolist()
        self.delays = rng.uniform(0, 0.01, len(self.items)).tolist()
        self.taken = 0

    def __iter__(self):
        for i, delay in zip(self.order, self.delays):
            time.sleep(delay)
            self.taken += 1
            yield i, self.items[i]


def _broken_stream():
    items = _items()
    for i in range(3):
        yield i, items[i]
    raise RuntimeError("decode exploded")


def _streaming(world, engine, out_dir, label) -> dict:
    """predict_streaming over ``_Stream`` and over a raw BMP folder's
    preprocess_stream (rank 0's), then over a stream that raises."""
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    items = _items()
    root = os.path.join(out_dir, f"stream-{label}-{world.rank}")
    write_processed(root, items)
    stream = _Stream(world.rank)
    csv = engine.predict_streaming(root, iter(stream), progress=False)
    out = {"csv": _csv(csv), "taken": stream.taken,
           "duals": _outputs(root, WOOD) if csv else None}
    bmp = os.path.join(out_dir, f"bmp-{label}-{world.rank}")
    shutil.copytree(os.path.join(out_dir, "bmp"), bmp)
    _fresh_results(bmp)
    pre = Preprocessor(backend="host", device="cpu")
    csv = engine.predict_streaming(
        bmp, pre.preprocess_stream(bmp) if world.is_main else None,
        total=len(BMP_HEIGHTS), progress=False)
    out.update(bmp_csv=_csv(csv),
               bmp_duals=_outputs(bmp, ["sapin"]) if csv else None)
    t0 = time.monotonic()
    try:
        engine.predict_streaming(
            root, _broken_stream() if world.is_main else None,
            progress=False)
        out["error"] = None
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    out["error_s"] = time.monotonic() - t0
    # the mesh still works after the failure
    out["after"] = _csv(engine.predict_streaming(
        root, iter(_Stream(world.rank)), progress=False))
    return out


def _server(world, mesh, out_dir) -> dict:
    """Rank 0 serves (make_server), rank 1 follows."""
    from neuralbarkcalculator_tpu_torch.cli.serve import (make_engine,
                                                          make_server,
                                                          serve_in_thread)
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    args = _serve_args(os.path.join(out_dir, "tiny.pt"))
    if not world.is_main:
        t0 = time.monotonic()
        BatchingPredictor.follow(make_engine(args, mesh))
        return {"followed_s": time.monotonic() - t0}
    srv = make_server(args, mesh=mesh)
    thread = serve_in_thread(srv)
    predictor = srv.state.predictor
    try:
        predictor.warmup(height=64, width=64)
        answers = _serve(predictor, _request_images())
        stats = predictor.snapshot_stats()
        buf = io.BytesIO()
        Image.fromarray(_request_images()[0]).save(buf, format="PNG")
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=60)
        c.request("POST", "/v1/predict?format=mask", body=buf.getvalue())
        r = c.getresponse()
        http_answer = (r.status, r.read())
        c.close()
        try:
            predictor.submit(np.zeros((64, 40, 3), np.uint8))
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        srv.shutdown()
        srv.server_close()
        predictor.close()
        thread.join(timeout=10)
    return {"answers": answers, "stats": stats, "http": http_answer,
            "refused": refused}


def _server_failure(world, mesh, out_dir) -> dict:
    """Rank 1's engine raises on its second micro-batch and rank 1 leaves
    the process group; rank 0's pending requests end with an exception.
    Last in the job: the group is gone afterwards."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        shutdown_distributed)
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    engine = _engine(os.path.join(out_dir, "tiny.pt"), mesh)
    images = _request_images()
    if not world.is_main:
        calls = []
        launch = engine.launch_images

        def failing(items):
            calls.append(len(items))
            if len(calls) == 2:
                raise RuntimeError("rank 1 failed")
            return launch(items)

        engine.launch_images = failing
        try:
            BatchingPredictor.follow(engine)
            error = None
        except RuntimeError as e:
            error = str(e)
        shutdown_distributed()
        return {"error": error}
    predictor = BatchingPredictor(engine, batch_size=2, max_wait_ms=10.0)
    first = predictor.submit(images[0]).result(timeout=60)
    t0 = time.monotonic()
    pending, errors = [], []
    for im in images[1:4]:
        try:
            pending.append(predictor.submit(im))
        except RuntimeError:  # the failure already reached rank 0
            errors.append("refused")
    for fut in pending:
        try:
            fut.result(timeout=60)
            errors.append(None)
        except Exception as e:
            errors.append(type(e).__name__)
    seconds = time.monotonic() - t0
    try:
        predictor.close()
        closed = None
    except RuntimeError as e:
        closed = str(e)
    try:
        predictor.submit(images[0])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return {"first": first.class_map, "errors": errors, "seconds": seconds,
            "closed": closed, "refused": refused}


def _job(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    out = {}
    for label, (n_data, n_model) in MESHES.items():
        mesh = make_mesh(n_data, n_model, world)
        engine = _engine(os.path.join(out_dir, "tiny.pt"), mesh)
        out[label] = {"stream": _streaming(world, engine, out_dir, label),
                      "server": _server(world, mesh, out_dir)}
    out["failure"] = _server_failure(world, make_mesh(1, 2, world), out_dir)
    return out


# ------------------------------------------------------- the references

def _jax_server_answers(pt, images) -> list:
    """JAX's BatchingPredictor under make_mesh(n_data=2) on the CPU
    devices, at the server's config: (class map, counts) a request."""
    from neuralbarkcalculator_tpu.config import PredictConfig as JaxConfig
    from neuralbarkcalculator_tpu.models import segmentation as jseg
    from neuralbarkcalculator_tpu.parallel.mesh import make_mesh
    from neuralbarkcalculator_tpu.pipeline.predict import (
        NeuralBarkCalculator as JaxEngine)
    from neuralbarkcalculator_tpu.pipeline.serving import (
        BatchingPredictor as JaxBatcher)

    jseg.MODEL_FACTORIES["_tiny_test"] = lambda dtype=None: tiny_jax_model(
        dtype)
    try:
        engine = JaxEngine(
            pt, mesh=make_mesh(n_data=2), model_name="_tiny_test",
            config=JaxConfig(model_path=pt, use_pallas=True,
                             pallas_interpret=True, use_bfloat16=False,
                             batch_size=4, fixed_pad_height=64))
    finally:
        jseg.MODEL_FACTORIES.pop("_tiny_test", None)
    predictor = JaxBatcher(engine, batch_size=4, max_wait_ms=50.0)
    try:
        return _serve(predictor, images)
    finally:
        predictor.close()


def _one_process(out, pt) -> dict:
    """The port's one-process references: the sequential folder path's
    CSV and masks, the raw BMP folder's, and the one-process batcher."""
    from neuralbarkcalculator_tpu_torch.cli.serve import make_engine
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    engine = _engine(pt)
    items = _items()
    root = str(out / "one-seq")
    write_processed(root, items)
    refs = {"csv": _csv(engine.predict(root, images=items, progress=False)),
            "duals": _outputs(root, WOOD)}
    bmp = str(out / "one-bmp")
    shutil.copytree(str(out / "bmp"), bmp)
    _fresh_results(bmp)
    images = Preprocessor(backend="host", device="cpu").preprocess_images(
        bmp, progress=False)
    refs["bmp_csv"] = _csv(engine.predict(bmp, images=images,
                                          progress=False))
    refs["bmp_duals"] = _outputs(bmp, ["sapin"])
    calc = make_engine(_serve_args(pt))
    requests = _request_images()
    refs["near_ties"] = near_ties(calc, requests)
    predictor = BatchingPredictor(calc, batch_size=4, max_wait_ms=50.0)
    try:
        refs["answers"] = _serve(predictor, requests)
    finally:
        predictor.close()
    return refs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both ranks' results, JAX's mesh batcher's answers and the port's
    one-process references, computed while the ranks run."""
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg

    out = tmp_path_factory.mktemp("mesh_serving")
    pt = tiny_checkpoint(str(out / "tiny.pt"), seed=SEED)
    _write_bmp_root(str(out / "bmp"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RUN, str(rank), "2",
         f"file://{out / 'rendezvous'}", str(out)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        jax_answers = _jax_server_answers(pt, _request_images())
        refs = _one_process(out, pt)
        deadline = time.monotonic() + TIMEOUT
        errs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())
                              )[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        tseg.MODEL_FACTORIES.pop("_tiny_test", None)
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {rank}: {err[-3000:]}"
    results = [torch.load(out / f"result-{rank}.pt", weights_only=False)
               for rank in range(2)]
    yield {"results": results, "jax": jax_answers, "refs": refs}
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("mesh", list(MESHES))
def test_streaming_writes_the_sequential_csv(job, mesh):
    """Rank 0's stream (its own arrival order and delays): the CSV byte
    for byte the one-process sequential path's, the dual masks bit for
    bit; rank 1 returns None and never reads its own stream."""
    r0, r1 = (r[mesh]["stream"] for r in job["results"])
    assert r0["csv"] == job["refs"]["csv"]
    assert r0["duals"] == job["refs"]["duals"]
    assert r0["taken"] == len(HEIGHTS)
    assert r1["csv"] is None and r1["taken"] == 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_streaming_a_preprocess_stream(job, mesh):
    """Rank 0's Preprocessor.preprocess_stream of a raw BMP folder: the
    CSV and dual masks of the one-process sequential path (preprocess,
    then predict)."""
    r0, r1 = (r[mesh]["stream"] for r in job["results"])
    assert r0["bmp_csv"] == job["refs"]["bmp_csv"]
    assert r0["bmp_duals"] == job["refs"]["bmp_duals"]
    assert r1["bmp_csv"] is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_streaming_error_reaches_every_rank(job, mesh):
    """A stream that raises on rank 0 after three images: rank 0 raises
    its error, rank 1 that rank 0's stream failed, both well within the
    job's deadline; a stream after it still writes the sequential CSV."""
    r0, r1 = (r[mesh]["stream"] for r in job["results"])
    assert r0["error"] == "RuntimeError: decode exploded"
    assert r1["error"] == ("RuntimeError: predict_streaming: grid rank "
                           "0's stream failed")
    assert r0["error_s"] < 60 and r1["error_s"] < 60
    assert r0["after"] == job["refs"]["csv"] and r1["after"] is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_server_answers_equal_one_process_and_jax(job, mesh):
    """Requests of mixed heights and widths from four threads, with
    exclude_nodes per request: every map and count equal to the
    one-process batcher's and to JAX's batcher under make_mesh(n_data=2),
    with no pixel under the near-tie margin."""
    assert job["refs"]["near_ties"] == 0
    got = job["results"][0][mesh]["server"]["answers"]
    classes = set()
    for i, ((cmap, counts), (want_map, want_counts),
            (jax_map, jax_counts)) in enumerate(zip(
                got, job["refs"]["answers"], job["jax"])):
        np.testing.assert_array_equal(cmap, want_map, err_msg=str(i))
        np.testing.assert_array_equal(counts, want_counts, err_msg=str(i))
        np.testing.assert_array_equal(cmap, jax_map, err_msg=str(i))
        np.testing.assert_array_equal(counts, jax_counts, err_msg=str(i))
        assert cmap.shape == REQUESTS[i][:2]
        if REQUESTS[i][2]:
            assert not (cmap == 2).any()
        classes |= set(np.unique(cmap).tolist())
    assert len(classes) >= 2


@pytest.mark.parametrize("mesh", list(MESHES))
def test_server_stats_http_and_close(job, mesh):
    """Rank 0's stats count the requests (the warm-up reset away), one
    HTTP request answers the first request's mask, a width the model
    group cannot split is refused in submit, and close() ends the
    follower."""
    from neuralbarkcalculator_tpu_torch.cli.serve import _dual_png_bytes

    r0, r1 = (r[mesh]["server"] for r in job["results"])
    stats = r0["stats"]
    assert stats["requests"] == stats["served"] == len(REQUESTS)
    assert stats["errors"] == 0 and stats["batches"] >= 2
    status, body = r0["http"]
    assert status == 200
    assert body == _dual_png_bytes(job["refs"]["answers"][0][0])
    if mesh == "(1, 2)":
        assert "multiple of 8" in r0["refused"]
    else:
        assert r0["refused"] is None
    assert r1["followed_s"] > 0


def test_server_failure_ends_pending_requests(job):
    """Rank 1 raises on the second micro-batch and leaves the group: rank
    0's first answer came back, its three pending futures end with an
    exception in well under their timeout, close() raises and submit
    refuses."""
    r0, r1 = (r["failure"] for r in job["results"])
    assert r1["error"] == "rank 1 failed"
    np.testing.assert_array_equal(r0["first"],
                                  job["refs"]["answers"][0][0])
    assert all(e is not None for e in r0["errors"]), r0["errors"]
    assert r0["seconds"] < 30
    assert "mesh server failed" in r0["closed"]
    assert "mesh server failed" in r0["refused"]
