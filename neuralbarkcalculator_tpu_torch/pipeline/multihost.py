"""Sharded folder prediction: one folder split across processes, one per
card or host, and the per-shard CSVs merged (the JAX package's
pipeline/multihost.py; reference surface predict.py:51-58).

Folder prediction is per-image independent: no activation or gradient
crosses processes. So a sharded run is N fully independent processes,
each running the ordinary single-process engine on its own card
(``cuda:LOCAL_RANK``) over a round-robin slice of the manifest
(``i % n == k``, which keeps the height buckets balanced). No collective
is issued: the shared filesystem is the only coordination.

Each process writes its artifacts (dual PNGs and figures are per-image
files, so shards never collide) and an atomically renamed
``final_stats.shard-KKKK-of-NNNN.csv`` whose rows carry their manifest
order. Process 0 then waits for all n shard files and stitches them into
the ``final_stats.csv`` a single-process run writes. On the CPU the
merged file is byte-identical to one process's. On a card the same rows
come in the same order, and the masks agree at least 99.9 %: float32
maps are bit-exact across launch batches only where the convolution
algorithms are fixed (the CPU, equal launch batches on a card), and a
shard's launch batches differ from one process's.

A process's identity comes from explicit arguments, else from an
initialized process group, else from torchrun's ``RANK`` and
``WORLD_SIZE`` (one process when unset).
"""
from __future__ import annotations

import csv
import os
import time

import torch

from .report import CSV_HEADER, shard_stats_name


# how long a process waits for the others' files, and how often it looks
WAIT_TIMEOUT_S = 3600.0
POLL_INTERVAL_S = 0.5


def _wait_for_files(paths: list[str], what: str) -> None:
    """Block until every path exists; TimeoutError after WAIT_TIMEOUT_S."""
    deadline = time.monotonic() + WAIT_TIMEOUT_S
    missing = list(paths)
    while True:
        missing = [p for p in missing if not os.path.isfile(p)]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(missing)} {what} never appeared within "
                               f"{WAIT_TIMEOUT_S:.0f} s: {missing[:3]}")
        time.sleep(POLL_INTERVAL_S)


def merge_shard_stats(results_dir: str, num_shards: int) -> str:
    """Merge ``num_shards`` per-shard CSVs into final_stats.csv.

    Waits for every shard file: shard writers rename into place, so a
    file that exists is complete. Rows are put in the order of their
    manifest-order column, which is then dropped; the result is laid out
    byte for byte as a single-process run's CSV (each row as its shard
    wrote it) and is itself written through a temporary file and a
    rename. Two shards holding the same
    order (overlapping shard runs) raise ``ValueError``. The shard files
    are removed after the merge."""
    paths = [os.path.join(results_dir, shard_stats_name(k, num_shards))
             for k in range(num_shards)]
    _wait_for_files(paths, "shard file(s)")
    rows: list[tuple[int, list[str]]] = []
    for p in paths:
        with open(p, newline="") as f:
            rows += [(int(rec[0]), rec[1:])
                     for rec in csv.reader(f, delimiter="\t") if rec]
    orders = [o for o, _ in rows]
    if len(set(orders)) != len(orders):
        raise ValueError("merge_shard_stats: duplicate manifest orders "
                         "across shards (overlapping shard runs?)")
    out = os.path.join(results_dir, "final_stats.csv")
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(CSV_HEADER)
        writer.writerows(r for _, r in sorted(rows))
    os.replace(tmp, out)
    for p in paths:
        os.remove(p)
    return out


def wait_for_processed(root_path: str) -> None:
    """Block until every source record's processed PNG exists.

    Shards other than 0 call this instead of preprocessing: PNG writes
    are not atomic, so exactly one process, shard 0, owns the preprocess.
    It also makes every shard derive its indices from the same processed
    manifest."""
    from ..data.dataset import make_dataset

    want = [os.path.join(root_path, "processed", "samples", r.wood_type,
                         r.fname) for r in make_dataset(root_path)]
    _wait_for_files(want, "processed file(s) (is shard 0 running?)")


def _process_identity(process_id: int | None = None,
                     num_processes: int | None = None) -> tuple[int, int]:
    """(k, n) of this process: the arguments, else an initialized process
    group's rank and size, else ``RANK`` and ``WORLD_SIZE`` (0 and 1 when
    unset)."""
    if num_processes is None:
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            return (torch.distributed.get_rank(),
                    torch.distributed.get_world_size())
        return (int(os.environ.get("RANK", "0")),
                int(os.environ.get("WORLD_SIZE", "1")))
    if process_id is None:
        raise ValueError("process_id required when num_processes is set")
    return process_id, num_processes


def predict_folder_multihost(engine, root_path: str,
                             exclude_nodes: bool = False,
                             process_id: int | None = None,
                             num_processes: int | None = None,
                             resume: bool = False, progress: bool = True
                             ) -> str:
    """Run this process's shard of a folder prediction with ``engine``, the
    ordinary single-process ``NeuralBarkCalculator`` on this process's
    card (``parallel.distributed.local_device``: ``cuda:LOCAL_RANK``);
    process 0 merges. Returns the final_stats.csv path on process 0, this
    process's shard CSV path elsewhere. One process is the ordinary
    single-process predict."""
    k, n = _process_identity(process_id, num_processes)
    if n == 1:
        return engine.predict(root_path, exclude_nodes, resume=resume,
                              progress=progress)
    shard_csv = engine.predict(root_path, exclude_nodes, resume=resume,
                               progress=progress and k == 0, shard=(k, n))
    if k == 0:
        return merge_shard_stats(os.path.join(root_path, "results"), n)
    return shard_csv


__all__ = ["merge_shard_stats", "predict_folder_multihost",
           "wait_for_processed"]
