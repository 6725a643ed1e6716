"""The inputs of a run, drawn from its seed: the folder of processed
images, the request bodies of the serving traffic and the training set.

Every drawing is ``bench_data``'s structured log (lib/bench_data.py) from
``numpy.random.default_rng([seed, stream, index])``. The sizes come from
the traffic file as a fixed multiset that the seed only permutes, so every
seed asks the program for the same work in another order. The drawings
are made by a pool of worker processes, which the pool's ``with`` block
waits for.
"""
from __future__ import annotations

import io
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import bench_data

FOLDER_STREAM, SERVE_STREAM, TRAIN_STREAM, ORDER_STREAM = 1, 2, 3, 4
WOOD_TYPES = ("epinette_gelee", "epinette_non_gelee", "sapin")


def drawing(seed: int, stream: int, index: int, h: int, w: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """(image uint8 [h, w, 3], class map uint8 [h, w]) of one drawing."""
    rng = np.random.default_rng([seed, stream, index])
    mask = bench_data.structured_dual_mask(rng, h, w)
    return bench_data.structured_image(rng, mask), mask


def png_bytes(img: np.ndarray, level: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", compress_level=level)
    return buf.getvalue()


def sizes(seed: int, spec: dict) -> list[int]:
    """The heights of ``spec`` ({"heights": [...], "counts": [...]}) as one
    list, permuted by the seed."""
    hs = np.repeat(spec["heights"], spec["counts"])
    return [int(h) for h in
            np.random.default_rng([seed, ORDER_STREAM]).permutation(hs)]


def _pool(n: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(
        max_workers=max(1, min(n, os.cpu_count() or 1, 8)),
        mp_context=multiprocessing.get_context("spawn"))


def _folder_job(args) -> None:
    seed, i, h, w, level, path = args
    img, _ = drawing(seed, FOLDER_STREAM, i, h, w)
    with open(path, "wb") as f:
        f.write(png_bytes(img, level))


def make_folder(root: str, seed: int, traffic: dict) -> list[dict]:
    """root/processed/samples/<wood type>/<name>.png: ``traffic["drawings"]``
    drawings of width ``traffic["width"]`` and the heights of
    ``traffic["sizes"]``, each linked ``traffic["copies"]`` times (hard
    links) under distinct names, spread over the wood types. Returns one
    record per file: name, wood type, drawing index, height, path."""
    heights = sizes(seed, traffic["sizes"])
    w, level = traffic["width"], traffic["png_level"]
    src = os.path.join(root, "drawings")
    os.makedirs(src, exist_ok=True)
    jobs = [(seed, i, h, w, level, os.path.join(src, f"d{i:03d}.png"))
            for i, h in enumerate(heights)]
    with _pool(len(jobs)) as pool:
        list(pool.map(_folder_job, jobs))
    n = len(heights) * traffic["copies"]
    order = np.random.default_rng([seed, ORDER_STREAM, 1]).permutation(n)
    records = []
    for j, k in enumerate(order):
        d = int(k) % len(heights)
        wood = WOOD_TYPES[j % len(WOOD_TYPES)]
        name = f"s{j:04d}.png"
        folder = os.path.join(root, "processed", "samples", wood)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, name)
        os.link(jobs[d][5], path)
        records.append({"name": name, "wood_type": wood, "drawing": d,
                        "height": heights[d], "path": path})
    results_folders(root)
    return records


def drawing_files(root: str) -> list[str]:
    """The drawings under ``make_folder``'s root, in order."""
    src = os.path.join(root, "drawings")
    return [os.path.join(src, f) for f in sorted(os.listdir(src))]


def link_folder(root: str, records: list[dict]) -> None:
    """A second folder under ``root`` that links the files of
    ``records``."""
    for r in records:
        folder = os.path.join(root, "processed", "samples", r["wood_type"])
        os.makedirs(folder, exist_ok=True)
        os.link(r["path"], os.path.join(folder, r["name"]))
    results_folders(root)


def results_folders(root: str) -> None:
    """root/results/{combined_images,outputs}/<wood type>, as the predict
    CLI makes them before a folder run."""
    for kind in ("combined_images", "outputs"):
        for wood in WOOD_TYPES:
            os.makedirs(os.path.join(root, "results", kind, wood),
                        exist_ok=True)


def _scan_job(args) -> tuple[int, int]:
    seed, i, h, side, level, path = args
    img, _ = drawing(seed, SERVE_STREAM, i, h, side)
    top = int(np.random.default_rng([seed, SERVE_STREAM, i, 1]).integers(
        0, side - h + 1))
    scan = np.zeros((side, side, 3), np.uint8)
    scan[top:top + h] = img
    with open(path, "wb") as f:
        f.write(png_bytes(scan, level))
    return top, h


def make_scans(folder: str, seed: int, traffic: dict) -> list[str]:
    """The serving traffic's request bodies: square ``traffic["side"]``
    scans whose drawing of a height from ``traffic["sizes"]`` lies between
    black bands (the dark-band trim's work), as PNG files in ``folder``."""
    side, level = traffic["side"], traffic["png_level"]
    os.makedirs(folder, exist_ok=True)
    jobs = [(seed, i, h, side, level, os.path.join(folder, f"r{i:03d}.png"))
            for i, h in enumerate(sizes(seed, traffic["sizes"]))]
    with _pool(len(jobs)) as pool:
        list(pool.map(_scan_job, jobs))
    return [j[5] for j in jobs]


def _train_job(args) -> tuple[np.ndarray, np.ndarray]:
    seed, i, side = args
    return drawing(seed, TRAIN_STREAM, i, side, side)


VARIANTS = (lambda a: a, lambda a: a[:, ::-1], lambda a: a[::-1],
            lambda a: a[::-1, ::-1], lambda a: a.swapaxes(0, 1))


def make_train_set(seed: int, traffic: dict
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N, S, S, 3], labels uint8 [N, S, S]):
    ``traffic["drawings"]`` square drawings, each under the five
    ``VARIANTS`` (identity, the two flips, the half turn, the transpose),
    so N = 5 x drawings rows, all different."""
    side, n = traffic["side"], traffic["drawings"]
    with _pool(n) as pool:
        pairs = list(pool.map(_train_job, [(seed, i, side)
                                           for i in range(n)]))
    images = np.stack([np.ascontiguousarray(v(img)) for img, _ in pairs
                       for v in VARIANTS])
    labels = np.stack([np.ascontiguousarray(v(m)) for _, m in pairs
                       for v in VARIANTS])
    return images, labels
