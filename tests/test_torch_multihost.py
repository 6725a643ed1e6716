"""PyTorch port: sharded folder prediction (pipeline/multihost.py,
``predict(shard=...)``, ``cli/predict --shard K/N``), as
tests/test_multihost_predict.py holds the JAX package's.

A processed folder of 5 images and the tiny model with weights carried
across from flax (tests/torch_port_common.py), both engines in float32 at
batch 1 on the CPU (so every image runs alone, whatever its shard):

- the port's shards 0/2 and 1/2 through ``predict_folder_multihost``
  in-process (shard 1 named by torchrun's RANK / WORLD_SIZE, shard 0 by
  its arguments, merging) give a final_stats.csv byte-identical to the
  port's single-process run and to the JAX package's, and every artifact
  lands exactly once;
- the partition is disjoint and complete and the rows keep manifest order;
- the merge times out on a missing shard and rejects overlapping shards;
- ``--shard`` rejects ``2/2`` and ``x/y``, ``predict(shard=(2, 2))``
  raises;
- a resumed shard rebuilds only its own rows and predicts nothing;
- ``cli/predict --shard 0/2`` and ``--shard 1/2`` as two concurrent
  subprocesses with ``--device cpu`` over raw samples (shard 0
  preprocesses, shard 1 waits for its PNGs): the merged CSV equals the
  single-process run's, byte for byte.
"""
import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import blob_image, tiny_checkpoint, tiny_engines
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHTS = (90, 100, 110, 96, 120)
WIDTH = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_images(d, ext: str) -> None:
    from neuralbarkcalculator_tpu_torch.io.native import save_image_u8

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    for i, h in enumerate(HEIGHTS):
        save_image_u8(os.path.join(d, f"img{i}.{ext}"),
                      blob_image(rng, h, WIDTH))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """(root with 5 processed images, checkpoint path, JAX engine, port
    engine)."""
    root = tmp_path_factory.mktemp("mh_root")
    _write_images(root / "processed" / "samples" / "sapin", "png")
    pt = tiny_checkpoint(str(root / "best_model.pt"), seed=5)
    jax_engine, port_engine = tiny_engines(pt, batch_size=1, figure_dpi=30)
    yield str(root), pt, jax_engine, port_engine
    shutil.rmtree(root, ignore_errors=True)


def _reset_results(root: str) -> str:
    results = os.path.join(root, "results")
    shutil.rmtree(results, ignore_errors=True)
    for sub in ("combined_images", "outputs"):
        os.makedirs(os.path.join(results, sub, "sapin"))
    return results


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _artifacts(results: str) -> dict[str, list[str]]:
    return {sub: sorted(os.listdir(os.path.join(results, sub, "sapin")))
            for sub in ("combined_images", "outputs")}


def test_sharded_predict_merges_byte_identical(tiny_root, monkeypatch):
    from neuralbarkcalculator_tpu_torch.pipeline.multihost import (
        predict_folder_multihost)

    root, _, jax_engine, engine = tiny_root
    _reset_results(root)
    want = _read(jax_engine.predict(root, progress=False))
    results = _reset_results(root)
    single = _read(engine.predict(root, progress=False))
    assert single == want
    want_artifacts = _artifacts(results)
    assert want_artifacts["outputs"] == [f"img{i}.png" for i in range(5)]

    results = _reset_results(root)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    out = predict_folder_multihost(engine, root, progress=False)
    assert os.path.basename(out) == "final_stats.shard-0001-of-0002.csv"
    merged = predict_folder_multihost(engine, root, process_id=0,
                                      num_processes=2, progress=False)
    assert merged == os.path.join(results, "final_stats.csv")
    assert _read(merged) == want
    assert _artifacts(results) == want_artifacts
    assert not [p for p in os.listdir(results) if ".shard-" in p]


def test_shard_partition_is_disjoint_and_complete(tiny_root):
    from neuralbarkcalculator_tpu_torch.pipeline.multihost import (
        merge_shard_stats)

    root, _, _, engine = tiny_root
    results = _reset_results(root)
    n = 3
    orders = []
    for k in range(n):
        with open(engine.predict(root, progress=False, shard=(k, n))) as f:
            got = [int(rec[0]) for rec in csv.reader(f, delimiter="\t")]
        assert got == list(range(k, len(HEIGHTS), n))
        orders += got
    assert sorted(orders) == list(range(len(HEIGHTS)))
    with open(merge_shard_stats(results, n)) as f:
        names = [line.split("\t")[0] for line in f.read().splitlines()[1:]]
    assert names == [f"img{i}.png" for i in range(len(HEIGHTS))]


def test_merge_times_out_on_missing_shard(tmp_path, monkeypatch):
    from neuralbarkcalculator_tpu_torch.pipeline import multihost
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        shard_stats_name)

    (tmp_path / shard_stats_name(0, 2)).write_text(
        "0\timg0.png\tsapin\t1\t2\t3\t4\n")
    monkeypatch.setattr(multihost, "WAIT_TIMEOUT_S", 0.3)
    monkeypatch.setattr(multihost, "POLL_INTERVAL_S", 0.05)
    with pytest.raises(TimeoutError, match="shard"):
        multihost.merge_shard_stats(str(tmp_path), 2)


def test_merge_rejects_overlapping_shards(tmp_path):
    from neuralbarkcalculator_tpu_torch.pipeline.multihost import (
        merge_shard_stats)
    from neuralbarkcalculator_tpu_torch.pipeline.report import (
        shard_stats_name)

    for k in range(2):  # both shards claim manifest order 0
        (tmp_path / shard_stats_name(k, 2)).write_text(
            "0\timg0.png\tsapin\t1\t2\t3\t4\n")
    with pytest.raises(ValueError, match="duplicate manifest orders"):
        merge_shard_stats(str(tmp_path), 2)
    assert not (tmp_path / "final_stats.csv").exists()


@pytest.mark.parametrize("text", ["2/2", "x/y", "1", "-1/2"])
def test_shard_validation(tiny_root, text):
    from neuralbarkcalculator_tpu_torch.cli.predict import (build_parser,
                                                            parse_shard)

    root, _, _, engine = tiny_root
    assert parse_shard("1/2") == (1, 2)
    args = build_parser().parse_args([root, f"--shard={text}"])
    with pytest.raises(SystemExit):
        parse_shard(args.shard)
    with pytest.raises(ValueError, match="shard"):
        engine.predict(root, progress=False, shard=(2, 2))


def test_resumed_shard_rebuilds_only_its_rows(tiny_root, monkeypatch):
    root, _, _, engine = tiny_root
    _reset_results(root)
    with open(engine.predict(root, progress=False)) as f:
        single = list(csv.reader(f, delimiter="\t"))[1:]
    launched = []
    real = engine._launch_batch
    monkeypatch.setattr(engine, "_launch_batch",
                        lambda *a: (launched.append(a), real(*a))[1])
    with open(engine.predict(root, progress=False, resume=True,
                             shard=(1, 2))) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert launched == []
    assert [int(r[0]) for r in rows] == [1, 3]
    assert [r[1:] for r in rows] == [single[1], single[3]]
    # a shard whose own images are gone predicts exactly those
    os.remove(os.path.join(root, "results", "outputs", "sapin", "img3.png"))
    with open(engine.predict(root, progress=False, resume=True,
                             shard=(1, 2))) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert len(launched) == 1
    assert [r[1:] for r in rows] == [single[1], single[3]]


_CLI = r"""
import sys
from torch_port_common import tiny_torch_model
from neuralbarkcalculator_tpu_torch.models import segmentation
segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main
main(build_parser().parse_args(sys.argv[1:]))
"""


def test_two_processes_merge_byte_identical(tiny_root, tmp_path):
    """Two concurrent CLI processes, shard 0 preprocessing raw samples and
    merging, shard 1 waiting for the PNGs."""
    _, pt, _, engine = tiny_root
    root = str(tmp_path / "root")
    _write_images(os.path.join(root, "samples", "sapin"), "png")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI, root, "--device", "cpu", "--shard",
         f"{k}/2", "--model", "_tiny_test", "--model_path", pt,
         "--float32", "--batch_size", "1", "--dpi", "30",
         "--preprocess_backend", "host"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in (1, 0)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    results = os.path.join(root, "results")
    merged = _read(os.path.join(results, "final_stats.csv"))
    artifacts = _artifacts(results)
    assert not [p for p in os.listdir(results) if ".shard-" in p]
    assert sorted(os.listdir(os.path.join(root, "processed", "samples",
                                          "sapin"))) == \
        [f"img{i}.png" for i in range(5)]

    _reset_results(root)
    assert merged == _read(engine.predict(root, progress=False))
    assert artifacts == _artifacts(results)
