"""Folder preprocess on the host: decode -> resize -> trim -> PNG.

Reference semantics (models.py:157-203): resize only when max(H, W) >
target_size, with skimage's prefiltered cubic B-spline (order 3, mirror
boundary, clip to the input range); trim the dark bands only when the
(possibly resized) image is square; quantize with rint(clip(x) * 255).
The native pass (io/native.preprocess_image_native) computes exactly that,
bit-equal to scipy, one image per worker of a thread pool (it releases
the GIL).

A device backend (the B-spline resize as matmuls on the card) is not part
of this port yet.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config import (PREPROCESS_TARGET_SIZE, TRIM_PIXEL_THRESHOLD,
                      TRIM_ROW_FRACTION)
from ..data.dataset import make_dataset
from ..io.native import load_image_u8, preprocess_image_native, save_image_u8


@dataclasses.dataclass
class ProcessedImage:
    """One preprocessed (resized + trimmed) image, ready for prediction."""

    image: np.ndarray  # uint8 [h, w, 3]
    fname: str  # output name (bmp -> png)
    wood_type: str


class Preprocessor:
    """Reference Preprocessor parity (models.py:169-203), folder-batched
    on a host thread pool."""

    def __init__(self, target_size: int = PREPROCESS_TARGET_SIZE,
                 io_workers: int = 8):
        self.target_size = target_size
        self.io_workers = io_workers

    def preprocess_images(self, root_path: str, save: bool = True,
                          progress: bool = True) -> list[ProcessedImage]:
        """Process root/samples/** into root/processed/samples/**; returns
        the processed images in manifest order."""
        records = make_dataset(root_path)
        results: list[ProcessedImage | None] = [None] * len(records)
        for idx, item in self._stream_records(
                records, os.path.join(root_path, "processed"), save,
                progress):
            results[idx] = item
        return results  # type: ignore[return-value]

    def preprocess_stream(self, root_path: str, save: bool = True,
                          progress: bool = False):
        """Streaming twin of preprocess_images: yields (manifest_idx,
        ProcessedImage) as each image finishes, without materializing the
        folder (NeuralBarkCalculator.predict_streaming consumes this)."""
        records = make_dataset(root_path)
        yield from self._stream_records(
            records, os.path.join(root_path, "processed"), save, progress)

    def _stream_records(self, records, output_dir: str, save: bool,
                        progress: bool):
        """Yields (index-into-records, ProcessedImage) in manifest order;
        PNG saves drain before the generator ends. A bounded look-ahead
        window keeps at most ~2x workers of decoded sources in memory."""
        with ThreadPoolExecutor(max_workers=self.io_workers) as pool:
            def process(rec):
                return self._preprocess_host_one(
                    load_image_u8(rec.sample_path))

            window = max(2, 2 * min(self.io_workers, os.cpu_count() or 1))
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

    def preprocess_one(self, img: np.ndarray) -> np.ndarray:
        """Preprocess a single in-memory uint8 [h, w, 3] image, threaded
        within the image."""
        return self._preprocess_host_one(
            img, threads=min(self.io_workers, os.cpu_count() or 1))

    def _preprocess_host_one(self, img: np.ndarray,
                             threads: int = 1) -> np.ndarray:
        """Resize decision, spline resize, trim and uint8 quantization in
        the native pass, then the ragged crop."""
        out, first, last = preprocess_image_native(
            img, self.target_size, TRIM_PIXEL_THRESHOLD, TRIM_ROW_FRACTION,
            threads=threads)
        return out[first:last] if first >= 0 else out


def _tqdm(iterable, **kwargs):
    try:
        from tqdm import tqdm
        return tqdm(iterable, ascii=True, **kwargs)
    except ImportError:  # pragma: no cover
        return iterable
