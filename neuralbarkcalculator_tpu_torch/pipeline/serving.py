"""Online inference serving: a micro-batching front end over the folder
engine.

The reference is an offline folder tool (predict.py:51-58 walks a
directory once). This module accepts single images as they arrive,
coalesces them into device batches and answers with the numbers the
folder pipeline writes to final_stats.csv, through the same engine
(`NeuralBarkCalculator.predict_images`): ragged row masks, the native
remove_small_zones and the reference's write-back hold per request.

- A device step wants a full batch. The batcher holds the first request
  at most ``max_wait_ms`` while later arrivals fill the batch: the
  latency / throughput knob.
- The engine's chunk planner groups a batch by (height bucket, width), so
  any mix of request sizes is legal; a micro-batch splits into one launch
  per distinct shape. Launch batches round up the engine's power-of-two
  ladder, and with ``PredictConfig.fixed_pad_height`` every request up to
  that height shares one pad height, so ``warmup`` can run every launch
  shape before traffic: an unseen shape's first launch pays a one-off
  set-up (cuDNN plan selection) that would stall every request queued
  behind it.
- ``exclude_nodes`` is per request: a batch runs the device step and the
  native postprocess without the remap, and the node -> bark remap is
  applied to the one requested map afterwards. The reference remaps after
  remove_small_zones too (models.py:270-276), so one batch serves both.
- One worker thread owns every call into the engine, and so the card;
  callers (the HTTP handler threads of cli/serve.py) only decode,
  preprocess on the host and wait on their futures.

Under a mesh (the engine's ``mesh``, parallel/distributed.make_mesh;
JAX's server runs under its ``make_mesh(n_data=2)``) grid rank 0 serves:
it holds the queue, the batcher thread and the HTTP server, checks each
request in ``submit`` before anything is sent, resolves the futures and
counts the stats. Every rank launches every micro-batch: for each one
(the warm-up's too) rank 0 broadcasts a header, then the images' sizes
and pixels (pipeline/predict.broadcast_images), and every rank runs the
engine on them (``exclude_nodes`` is rank 0's remap after the batch, so
it is not sent); the other ranks call ``BatchingPredictor.follow(calc)``, which
returns when rank 0's ``close()`` sends the stop. A failed micro-batch
under a mesh is fatal, since the ranks' collectives no longer pair up:
rank 0 fails that batch's futures and every queued one, refuses new
requests, and ``close()`` raises. A rank that fails leaves the process
group (the caller's ``shutdown_distributed``), which makes the other
ranks' pending collectives raise (gloo) instead of waiting.

The HTTP layer lives in cli/serve.py; this module is transport-free so it
can be embedded (the tests drive it directly).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..parallel.spatial import is_split, strip_range
from .predict import broadcast_images
from .preprocess import ProcessedImage

# a mesh server's header: a micro-batch follows, or the stop
_BATCH = 1
_STOP = 0


@dataclasses.dataclass
class ServeResult:
    """One served prediction, carrying the folder pipeline's numbers."""

    class_map: np.ndarray  # uint8 [h, w], classes {0,1,2} ({0,1} remapped)
    image: np.ndarray  # the preprocessed uint8 [h, w, 3] that was predicted
    counts: np.ndarray  # int64 [3] pixel counts per class (post-remap)
    bark_percent: float
    bark_area_mm2: float
    node_percent: float
    node_area_mm2: float
    queue_ms: float  # submit -> batch launch
    compute_ms: float  # batch launch -> results ready (whole batch)
    batch_images: int  # how many requests shared the device batch


class BatchingPredictor:
    """Coalesces concurrent single-image requests into device batches.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to a :class:`ServeResult`. One worker thread drains the
    queue: it waits up to ``max_wait_ms`` after the first request for the
    batch to fill, runs the batch through the folder engine and resolves
    each future.
    """

    def __init__(self, calc, batch_size: int | None = None,
                 max_wait_ms: float = 25.0, queue_limit: int = 256,
                 mm_per_pix: float | None = None):
        mesh = getattr(calc, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.n_devices > 1 \
            else None
        if self._mesh is not None and not mesh.is_main:
            raise ValueError("under a mesh grid rank 0 serves; the other "
                             "ranks call BatchingPredictor.follow(calc)")
        self.calc = calc
        self.batch_size = batch_size or calc.config.batch_size
        self.max_wait_ms = max_wait_ms
        self.mm_per_pix = (calc.config.mm_per_pix if mm_per_pix is None
                           else mm_per_pix)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_limit)
        # serializes submit's closed-check + put against close's
        # closed-set + sentinel put: every accepted request is enqueued
        # strictly before the sentinel (FIFO), so the worker's drain after
        # the sentinel never leaves a future unresolved
        self._open_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "served": 0, "errors": 0, "batches": 0,
            "batch_size_sum": 0, "max_batch": 0, "rejected": 0,
        }
        self._latencies: list[float] = []  # ring of the last total ms
        # one micro-batch at a time reaches the engine (and, under a mesh,
        # the other ranks): the batcher's and the warm-up's
        self._launch_lock = threading.Lock()
        self._error: BaseException | None = None  # a mesh server's failure
        self._closed = False
        self._stopping = False  # worker side: the close() sentinel seen
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._worker.start()

    # ------------------------------------------------------------- public

    def submit(self, image_u8: np.ndarray,
               exclude_nodes: bool = False) -> Future:
        """Enqueue one preprocessed uint8 [h, w, 3] image.

        Raises ``queue.Full`` when the backlog exceeds ``queue_limit``:
        the HTTP layer answers 503 instead of letting memory grow.
        """
        if image_u8.dtype != np.uint8 or image_u8.ndim != 3 \
                or image_u8.shape[2] != 3:
            raise ValueError(
                f"expected uint8 [h, w, 3] image, got {image_u8.dtype} "
                f"{image_u8.shape}")
        if self._mesh is not None and is_split(self._mesh.model):
            # a width the model group cannot split is refused here, before
            # any rank sees it
            strip_range(image_u8.shape[1], self._mesh.model,
                        self.calc.model.backbone.strip_multiple)
        fut: Future = Future()
        with self._open_lock:
            if self._error is not None:
                raise RuntimeError("the mesh server failed") from self._error
            if self._closed:
                raise RuntimeError("predictor is closed")
            try:
                self._queue.put_nowait((image_u8, bool(exclude_nodes), fut,
                                        time.perf_counter()))
            except queue.Full:
                with self._stats_lock:
                    self.stats["requests"] += 1
                    self.stats["rejected"] += 1
                raise
        with self._stats_lock:
            self.stats["requests"] += 1
        return fut

    def warmup(self, height: int = 1024, width: int = 1024) -> None:
        """Run every launch batch size a micro-batch of canonical
        height x width requests can hit (the engine's power-of-two
        ladder, ``launch_item_counts``), so no request pays the one-off
        set-up of an unseen launch shape; then reset the stats, so the
        warmup does not count as traffic. Called before the server takes
        requests: it runs the engine on the caller's thread.

        The image is seeded uniform noise, not a constant, and the largest
        batch runs first: with lazy int8 quantization
        (``PredictConfig.quantize_int8`` and no offline int8 checkpoint)
        the engine's first chunk is its calibration set, and a constant
        image would give unrepresentative activation scales, fewer images
        a worse max|x| estimate. An offline int8 checkpoint
        (cli/quantize_checkpoint) skips calibration altogether."""
        img = np.random.default_rng(0).integers(
            0, 256, (height, width, 3), np.uint8)
        sizes = [n for n in self.calc.launch_item_counts()
                 if n <= self.batch_size] or [self.batch_size]
        for b in sorted(sizes, reverse=True):
            self._predict([img] * b)
        self.reset_stats()

    def reset_stats(self) -> None:
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0
            self._latencies.clear()

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop the worker after serving the requests already queued.

        Under ``_open_lock`` every accepted request precedes the sentinel
        in the FIFO queue, so the worker serves them all before it exits:
        a submit racing close either lands before the sentinel (served) or
        sees ``_closed`` and raises."""
        with self._open_lock:
            closed, self._closed = self._closed, True
        if not closed:
            self._queue.put(None)  # sentinel
        self._worker.join(timeout=timeout)
        if self._error is not None:
            raise RuntimeError("the mesh server failed") from self._error

    @staticmethod
    def follow(calc) -> None:
        """A mesh server's other ranks: launch every micro-batch grid rank
        0 sends (``calc.launch_images``; rank 0 postprocesses), until rank
        0's ``close()`` sends the stop. ``calc``: this rank's engine under
        the same mesh, model and config as rank 0's."""
        mesh = calc.mesh
        if mesh.n_devices == 1 or mesh.is_main:
            raise ValueError("follow: for the ranks of a mesh other than "
                             "grid rank 0, which serves")
        while mesh.world.broadcast_ints(None)[0] == _BATCH:
            calc.launch_images(_items(broadcast_images(mesh, None)))

    def snapshot_stats(self) -> dict:
        """Counters, the mean batch and latency percentiles (of the last
        requests) for /v1/stats."""
        with self._stats_lock:
            out = dict(self.stats)
            lat = np.asarray(self._latencies, np.float64)
        out["queue_depth"] = self._queue.qsize()
        out["mean_batch"] = (out["batch_size_sum"] / out["batches"]
                             if out["batches"] else 0.0)
        if lat.size:
            out["latency_ms_p50"] = float(np.percentile(lat, 50))
            out["latency_ms_p95"] = float(np.percentile(lat, 95))
            out["latency_ms_max"] = float(lat.max())
        return out

    # ------------------------------------------------------------- worker

    def _next_batch(self):
        """Block for the first request, then fill the batch until
        ``batch_size`` or ``max_wait_ms``. Returns (batch, stop): ``stop``
        means the close() sentinel arrived and nothing is left to drain
        (requests queued behind the sentinel are still served)."""
        batch: list = []
        deadline = None
        while len(batch) < self.batch_size:
            try:
                if batch:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        break
                    req = self._queue.get(timeout=timeout)
                elif self._stopping:
                    req = self._queue.get_nowait()  # drain, never block
                else:
                    req = self._queue.get()  # idle: block for traffic
            except queue.Empty:
                break
            if req is None:  # close() sentinel
                self._stopping = True
                break
            if deadline is None:
                deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            batch.append(req)
        stop = self._stopping and not batch and self._queue.empty()
        return batch, stop

    def _run(self) -> None:
        while True:
            batch, stop = self._next_batch()
            if batch:
                self._serve_batch(batch)
            if self._error is not None:
                return
            if stop:
                if self._mesh is not None:
                    with self._launch_lock:
                        self._mesh.world.broadcast_ints([_STOP])
                return

    def _predict(self, images: list[np.ndarray]) -> dict[str, tuple]:
        """One micro-batch through the engine, without the remap: {"req<i>":
        (class map, counts)}. Under a mesh every rank gets the batch first
        (the header, then ``broadcast_images``) and launches it too."""
        with self._launch_lock:
            if self._mesh is not None:
                self._mesh.world.broadcast_ints([_BATCH])
                broadcast_images(self._mesh, images)
            return {item.fname: (cmap, counts)
                    for item, cmap, counts in self.calc.predict_images(
                        _items(images), with_counts=True)}

    def _fail(self, error: BaseException) -> None:
        """A mesh server's failure: refuse new requests and fail every
        queued one; ``close()`` raises ``error``."""
        with self._open_lock:
            self._error = error
            self._closed = True
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None and not req[2].cancelled():
                req[2].set_exception(error)

    def _serve_batch(self, batch: list) -> None:
        t_launch = time.perf_counter()
        try:
            # the batch runs without the remap; each request's remap
            # follows (the reference remaps after remove_small_zones,
            # models.py:270-276)
            results = self._predict([img for img, _, _, _ in batch])
        except Exception as e:  # resolve every future, keep serving
            with self._stats_lock:
                self.stats["errors"] += len(batch)
            for _, _, fut, _ in batch:
                if not fut.cancelled():
                    fut.set_exception(e)
            if self._mesh is not None:  # the ranks' collectives are lost
                self._fail(e)
            return
        t_done = time.perf_counter()
        compute_ms = (t_done - t_launch) * 1000.0
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batch_size_sum"] += len(batch)
            self.stats["max_batch"] = max(self.stats["max_batch"],
                                          len(batch))
        for i, (img, exclude_nodes, fut, t_submit) in enumerate(batch):
            cmap, counts = results[f"req{i}"]
            counts = np.asarray(counts, np.int64)
            if exclude_nodes:
                cmap = np.where(cmap == 2, 1, cmap).astype(np.uint8)
                # the remap folds node pixels into bark: no new count
                counts = np.array(
                    [counts[0], counts[1] + counts[2], 0], np.int64)
            total = float(cmap.size)
            res = ServeResult(
                class_map=cmap, image=img, counts=counts,
                bark_percent=float(counts[1]) / total * 100.0,
                bark_area_mm2=float(counts[1]) * self.mm_per_pix,
                node_percent=float(counts[2]) / total * 100.0,
                node_area_mm2=float(counts[2]) * self.mm_per_pix,
                queue_ms=(t_launch - t_submit) * 1000.0,
                compute_ms=compute_ms, batch_images=len(batch))
            with self._stats_lock:
                self.stats["served"] += 1
                self._latencies.append((t_done - t_submit) * 1000.0)
                if len(self._latencies) > 512:
                    del self._latencies[:256]
            if not fut.cancelled():
                fut.set_result(res)


def _items(images: list[np.ndarray]) -> list[ProcessedImage]:
    """A micro-batch's images as the engine's items, named alike on
    every rank of a mesh (the plan's digest holds the names)."""
    return [ProcessedImage(img, f"req{i}", "serving")
            for i, img in enumerate(images)]


__all__ = ["BatchingPredictor", "ServeResult"]
