"""Folder preprocess: decode -> resize -> trim -> PNG.

Reference semantics (models.py:157-203): resize only when max(H, W) >
target_size, with skimage's prefiltered cubic B-spline (order 3, mirror
boundary, clip to the input range); trim the dark bands only when the
(possibly resized) image is square; quantize with rint(clip(x) * 255).

Two backends compute it:

- ``host``: the native pass (io/native.preprocess_image_native, bit-equal
  to scipy), one image per worker of a thread pool (it releases the GIL);
  without the native library the same steps in scipy and numpy
  (ops/resize.spline_resize_host), as the JAX package's host path;
- ``device``: sources decoded on host threads and batched by input shape,
  uploaded as uint8 (a quarter of float32's bytes), then on the device
  uint8 -> float / 255 -> the B-spline resize as two float32 matrix
  products (ops/resize.spline_resize) -> the trim bounds (ops/trim.py) ->
  uint8 quantization; the host crops rows [first:last] and encodes the
  PNGs on the pool, overlapping the next batch.

The two agree within 1 LSB at a small share of pixels (spline-overshoot
pixels, where float32 sums in another order round to the other side), with
identical trim decisions.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..config import (PREPROCESS_TARGET_SIZE, TRIM_PIXEL_THRESHOLD,
                      TRIM_ROW_FRACTION)
from ..data.dataset import make_dataset
from ..io.native import load_image_u8, preprocess_image_native, save_image_u8
from ..ops.resize import spline_resize, spline_resize_host
from ..ops.trim import trim_bounds_batch
from ..utils.device import resolve_device


@dataclasses.dataclass
class ProcessedImage:
    """One preprocessed (resized + trimmed) image, ready for prediction."""

    image: np.ndarray  # uint8 [h, w, 3]
    fname: str  # output name (bmp -> png)
    wood_type: str


def _preprocess_batch(batch_u8: torch.Tensor, target: int, do_resize: bool
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] uint8 -> (uint8 [B, target, target, 3] (or [B, H, W,
    3] without the resize), first [B], last [B]) where the batch lies."""
    img = batch_u8.float() / 255.0
    if do_resize:
        img = spline_resize(img, target, target)
    first, last = trim_bounds_batch(img)
    out_u8 = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return out_u8, first, last


def measure_transfer_bandwidth(device: str | torch.device = "cuda",
                               nbytes: int = 8 << 20) -> float:
    """Host -> ``device`` throughput in bytes/s, best of 2 synchronized
    uploads (the first warms the path). Used to pick the preprocess
    backend."""
    dev = resolve_device(device)
    a = torch.zeros(nbytes, dtype=torch.uint8)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        a.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return nbytes / max(best, 1e-9)


class Preprocessor:
    """Reference Preprocessor parity (models.py:169-203), folder-batched.

    ``backend``:
    - 'device': uint8 upload, the B-spline resize as matrix products and
      the trim bounds on ``device`` (``cuda``, the default, raises without
      a card; ``cpu`` runs the same torch code on the CPU);
    - 'host': the native resize + trim, one image per pool worker;
    - 'auto': calibrate once per process and device (the measured upload
      rate against a host-resize probe scaled by the cores the pool can
      use) and take the path predicted cheaper.
    The NEURALBARK_PREPROCESS environment variable ('host' or 'device')
    overrides all three.
    """

    # the upload rate and the host's speed do not change within a process:
    # watch mode builds a Preprocessor per scan and must not probe again.
    # Keyed by device.
    _auto_backend_cache: dict[str, str] = {}

    def __init__(self, target_size: int = PREPROCESS_TARGET_SIZE,
                 batch_size: int = 4, io_workers: int = 8,
                 backend: str = "auto", device: str | torch.device = "cuda"):
        if backend not in ("auto", "device", "host"):
            raise ValueError(f"unknown preprocess backend {backend!r}")
        self.target_size = target_size
        self.batch_size = batch_size
        self.io_workers = io_workers
        self.backend = backend
        self.device = device
        self._resolved_backend: str | None = None
        # what the last calibration measured (bandwidth, predicted s/image)
        self.calibration: dict[str, float | str] = {}
        # host -> device bytes of the device backend's uploads
        self.bytes_h2d = 0

    def _resolve_backend(self) -> str:
        if self._resolved_backend is None:
            env = os.environ.get("NEURALBARK_PREPROCESS")
            if env in ("host", "device"):
                self._resolved_backend = env
            elif self.backend != "auto":
                self._resolved_backend = self.backend
            else:
                key = str(resolve_device(self.device))
                cache = Preprocessor._auto_backend_cache
                if key not in cache:
                    cache[key] = self._calibrate_backend()
                self._resolved_backend = cache[key]
        return self._resolved_backend

    def _calibrate_backend(self, src: int = 4096) -> str:
        """Predict each path's cost for one src x src source and pick the
        cheaper. device: the uint8 upload over the measured link, plus 0.1
        s of dispatch and pull; host: the native pass (the scipy twin
        without the library) on a quarter-size probe, scaled by 16 and
        divided by the cores the pool can use."""
        bw = measure_transfer_bandwidth(self.device)
        device_s = (src * src * 3) / bw + 0.1
        probe_src = src // 4
        rng = np.random.default_rng(0)
        probe_u8 = (rng.random((probe_src, probe_src, 3))
                    * 255).astype(np.uint8)
        t0 = time.perf_counter()
        if preprocess_image_native(probe_u8, probe_src // 4,
                                   TRIM_PIXEL_THRESHOLD, TRIM_ROW_FRACTION,
                                   threads=1) is None:
            spline_resize_host(probe_u8.astype(np.float32), probe_src // 4,
                               probe_src // 4)
        probe_s = time.perf_counter() - t0
        cores = max(1, min(self.io_workers, os.cpu_count() or 1))
        host_s = probe_s * 16 / cores
        choice = "host" if host_s < device_s else "device"
        self.calibration = {"bandwidth_bytes_per_s": bw,
                            "device_s_per_image": device_s,
                            "host_s_per_image": host_s, "choice": choice}
        return choice

    def preprocess_images(self, root_path: str, save: bool = True,
                          progress: bool = True,
                          resume: bool = False) -> list[ProcessedImage]:
        """Process root/samples/** into root/processed/samples/**; returns
        the processed images in manifest order.

        ``resume`` skips records whose processed PNG already exists
        (incremental folders, watch mode); only the newly processed images
        are returned."""
        records = self._records(root_path, resume)
        if not records:
            return []
        results: list[ProcessedImage | None] = [None] * len(records)
        for idx, item in self._stream_records(
                records, os.path.join(root_path, "processed"), save,
                progress):
            results[idx] = item
        return results  # type: ignore[return-value]

    def preprocess_stream(self, root_path: str, save: bool = True,
                          progress: bool = False, resume: bool = False):
        """Streaming twin of preprocess_images: yields (manifest_idx,
        ProcessedImage) as each image finishes, without materializing the
        folder (NeuralBarkCalculator.predict_streaming consumes this).
        Completion order may differ from manifest order; the index carries
        the order."""
        records = self._records(root_path, resume)
        yield from self._stream_records(
            records, os.path.join(root_path, "processed"), save, progress)

    @staticmethod
    def _records(root_path: str, resume: bool) -> list:
        records = make_dataset(root_path)
        if resume:
            out_dir = os.path.join(root_path, "processed", "samples")
            records = [r for r in records if not os.path.isfile(
                os.path.join(out_dir, r.wood_type, r.fname))]
        return records

    def _stream_records(self, records, output_dir: str, save: bool,
                        progress: bool):
        """Backend dispatch: yields (index-into-records, ProcessedImage);
        PNG saves drain before the generator ends. A bounded look-ahead
        window keeps at most ~2x workers of decoded sources in memory."""
        window = max(2, 2 * min(self.io_workers, os.cpu_count() or 1))
        if self._resolve_backend() == "host":
            yield from self._stream_host(records, output_dir, save, progress,
                                         window)
        else:
            yield from self._stream_device(records, output_dir, save,
                                           progress, window)

    def _stream_host(self, records, output_dir, save, progress, window):
        """decode + resize + trim per image on the pool, in manifest
        order."""
        with ThreadPoolExecutor(max_workers=self.io_workers) as pool:
            def process(rec):
                return self._preprocess_host_one(
                    load_image_u8(rec.sample_path))

            futures: deque = deque(pool.submit(process, rec)
                                   for rec in records[:window])
            iterator = enumerate(records)
            if progress:
                iterator = _tqdm(iterator, total=len(records),
                                 desc="Preprocessing images")
            save_futures = []
            for idx, rec in iterator:
                processed = futures.popleft().result()
                if idx + window < len(records):
                    futures.append(pool.submit(process,
                                               records[idx + window]))
                if save:
                    path = os.path.join(output_dir, "samples",
                                        rec.wood_type, rec.fname)
                    save_futures.append(
                        pool.submit(save_image_u8, path, processed))
                yield idx, ProcessedImage(processed, rec.fname,
                                          rec.wood_type)
            for fut in save_futures:
                fut.result()

    def _stream_device(self, records, output_dir, save, progress, window):
        """Decodes and PNG saves share the IO pool, decodes with a bounded
        look-ahead (a bare pool.map would queue every decode at once, and
        later saves would starve behind them); the launch (stack, upload,
        device preprocess) runs on its own one-worker executor, so a
        batch's upload overlaps the previous batch's pull and PNG encodes.
        Two batches are in flight."""
        dev = resolve_device(self.device)
        with ThreadPoolExecutor(max_workers=self.io_workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as launch_pool:
            decode_futs: deque = deque(
                pool.submit(load_image_u8, rec.sample_path)
                for rec in records[:window])

            def decoded_stream():
                for idx, rec in enumerate(records):
                    img = decode_futs.popleft().result()
                    if idx + window < len(records):
                        decode_futs.append(pool.submit(
                            load_image_u8,
                            records[idx + window].sample_path))
                    yield (idx, rec), img

            iterator = decoded_stream()
            if progress:
                iterator = _tqdm(iterator, total=len(records),
                                 desc="Preprocessing images")
            save_futures = []
            pending: deque = deque()

            def finish(keyed, launched):
                done = []
                for (idx, rec), processed in zip(
                        keyed, self._finish_shape_batch(launched)):
                    if save:
                        path = os.path.join(output_dir, "samples",
                                            rec.wood_type, rec.fname)
                        save_futures.append(
                            pool.submit(save_image_u8, path, processed))
                    done.append((idx, ProcessedImage(processed, rec.fname,
                                                     rec.wood_type)))
                return done

            for group in _shape_batches(iterator, self.batch_size):
                keyed, imgs = zip(*group)
                pending.append((keyed, launch_pool.submit(
                    self._launch_shape_batch, imgs, dev)))
                if len(pending) >= 2:
                    keyed_done, fut = pending.popleft()
                    yield from finish(keyed_done, fut.result())
            while pending:
                keyed_done, fut = pending.popleft()
                yield from finish(keyed_done, fut.result())
            for fut in save_futures:
                fut.result()

    def preprocess_one(self, img: np.ndarray) -> np.ndarray:
        """Preprocess a single in-memory uint8 [h, w, 3] image on the host
        (the serving path: for one image the device round trip does not pay
        for itself), threaded within the image."""
        return self._preprocess_host_one(
            img, threads=min(self.io_workers, os.cpu_count() or 1))

    def _preprocess_host_one(self, img: np.ndarray,
                             threads: int = 1) -> np.ndarray:
        """Resize decision, spline resize, trim and uint8 quantization in
        the native pass, then the ragged crop; without the library the
        same steps in scipy and numpy (the JAX package's host path)."""
        res = preprocess_image_native(
            img, self.target_size, TRIM_PIXEL_THRESHOLD, TRIM_ROW_FRACTION,
            threads=threads)
        if res is not None:
            out, first, last = res
            return out[first:last] if first >= 0 else out
        h, w = img.shape[:2]
        do_resize = max(h, w) > self.target_size
        imgf = img.astype(np.float32) / 255.0
        if do_resize:
            imgf = spline_resize_host(imgf, self.target_size,
                                      self.target_size)
        if do_resize or h == w:  # "still square": trim (models.py:200)
            nonblack = imgf.sum(axis=-1) > TRIM_PIXEL_THRESHOLD
            keep = nonblack.mean(axis=-1) > TRIM_ROW_FRACTION
            first = int(np.argmax(keep))  # all-False -> 0: no trim
            last = len(keep) - int(np.argmax(keep[::-1]))
            imgf = imgf[first:last]
        return np.rint(np.clip(imgf, 0.0, 1.0) * 255.0).astype(np.uint8)

    def _launch_shape_batch(self, imgs: tuple[np.ndarray, ...],
                            dev: torch.device):
        """Upload same-shape uint8 images and run the device preprocess."""
        h, w = imgs[0].shape[:2]
        do_resize = max(h, w) > self.target_size
        square_after = do_resize or h == w
        host = torch.from_numpy(np.stack(imgs))
        self.bytes_h2d += host.numel()
        with torch.inference_mode():
            out, first, last = _preprocess_batch(
                host.to(dev), self.target_size, do_resize)
        return out, first, last, square_after

    @staticmethod
    def _finish_shape_batch(launched) -> Iterator[np.ndarray]:
        """Pull a launched batch; yields uint8 arrays, cropped to their
        trim bounds where the image was square after the resize
        decision."""
        out, first, last, square_after = launched
        out = out.cpu().numpy()
        first = first.cpu().numpy()
        last = last.cpu().numpy()
        for i in range(out.shape[0]):
            if square_after:
                yield out[i, int(first[i]):int(last[i])]
            else:
                yield out[i]


def _shape_batches(iterator, batch_size: int):
    """Group an ((index, record), image) stream into same-shape batches of
    at most batch_size, preserving order within each shape."""
    pending: dict[tuple, list] = {}
    for keyed, img in iterator:
        key = img.shape
        pending.setdefault(key, []).append((keyed, img))
        if len(pending[key]) == batch_size:
            yield pending.pop(key)
    yield from pending.values()


def _tqdm(iterable, **kwargs):
    try:
        from tqdm import tqdm
        return tqdm(iterable, ascii=True, **kwargs)
    except ImportError:  # pragma: no cover
        return iterable
