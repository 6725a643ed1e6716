"""PyTorch port: the folder prediction engine against the JAX package.

Both engines run in float32 on the CPU with the same tiny model and
weights over images of mixed heights: the JAX engine with the Pallas
kernel in interpret mode, the port with the kernel's plain version (its
wrapper takes the plain version for CPU tensors). Class maps must be
equal; the only tolerated difference would be at pixels whose top-2 logit
margin is under 1e-5, and the test asserts there are none on its inputs.
The artifacts must match: final_stats.csv byte for byte, the dual PNGs
decoded, and the same set of combined figures. A pass's stage timers:
one plan and one finalize a pass, one decode, dispatch (upload, launch),
pull, wait and postprocess a launch batch, one figure and one dual an
image, each a profiler range in a session, a chunk's carrying its first
index.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (near_ties, tiny_checkpoint, tiny_engines,
                               write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 64
HEIGHTS = (64, 40, 56, 64, 30, 32, 24)  # buckets 64 (4) and 32 (3)
WOOD = ("sapin", "sapin", "epinette_gelee", "sapin", "epinette_gelee",
        "sapin", "epinette_gelee")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) loading the same best_model.pt, written
    by the JAX package's own exporter."""
    directory = tmp_path_factory.mktemp("engines")
    pt = tiny_checkpoint(str(directory / "best_model.pt"), seed=5)
    yield tiny_engines(pt, batch_size=4, height_bucket=32, figure_dpi=50)
    shutil.rmtree(directory, ignore_errors=True)


def _items(seed=7):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(seed)
    items = []
    for i, (h, wood) in enumerate(zip(HEIGHTS, WOOD)):
        # smooth blobs, so the maps have zones above the 150-px threshold
        coarse = rng.random((h // 8 + 2, WIDTH // 8 + 2, 3))
        img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :WIDTH]
        img = img + 0.15 * rng.random(img.shape)
        items.append(ProcessedImage(
            np.clip(img * 230, 0, 255).astype(np.uint8), f"img{i}.png",
            wood))
    return items


def test_predict_images_equal_jax(engines):
    jax_engine, port_engine = engines
    items = _items()
    want = {it.fname: m for it, m in jax_engine.predict_images(items)}
    got = {it.fname: (m, c) for it, m, c in
           port_engine.predict_images(items, with_counts=True)}
    assert near_ties(port_engine, [it.image for it in items]) == 0
    assert sorted(got) == sorted(want)
    classes = set()
    for it in items:
        m, counts = got[it.fname]
        assert m.shape == it.image.shape[:2] and m.dtype == np.uint8
        np.testing.assert_array_equal(m, want[it.fname])
        np.testing.assert_array_equal(counts, np.bincount(m.ravel(),
                                                          minlength=3))
        classes |= set(np.unique(m).tolist())
    assert len(classes) >= 2  # the maps are not trivially one class
    stats = port_engine.cache_stats()
    # launch shapes (64, 4) and (32, 4): the 3-image bucket pads one dummy
    # row up the pow2 ladder, and its bytes count too
    assert stats["launch_shapes"] == 2
    assert stats["bytes_h2d"] == WIDTH * 3 * (64 * 4 + 32 * 4)


def test_exclude_nodes_remaps_class_2(engines):
    _, port_engine = engines
    items = _items()
    for (_, plain), (_, excl) in zip(
            port_engine.predict_images(items),
            port_engine.predict_images(items, exclude_nodes=True)):
        assert not np.any(excl == 2)
        np.testing.assert_array_equal(excl, np.where(plain == 2, 1, plain))


def _files(root):
    out = set()
    for dirpath, _, fnames in os.walk(os.path.join(root, "results")):
        out |= {os.path.relpath(os.path.join(dirpath, f), root)
                for f in fnames}
    return out


def test_predict_folder_artifacts_equal_jax(engines, tmp_path):
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    jax_engine, port_engine = engines
    items = _items(seed=8)
    roots = {}
    for name, engine in (("jax", jax_engine), ("port", port_engine)):
        root = str(tmp_path / name)
        write_processed(root, items)
        csv = engine.predict(root, progress=False)
        assert csv == os.path.join(root, "results", "final_stats.csv")
        roots[name] = root
    with open(os.path.join(roots["jax"], "results", "final_stats.csv"),
              "rb") as f:
        want_csv = f.read()
    with open(os.path.join(roots["port"], "results", "final_stats.csv"),
              "rb") as f:
        got_csv = f.read()
    assert got_csv == want_csv
    lines = got_csv.decode().splitlines()
    assert len(lines) == 1 + len(items)
    assert len(lines[0].split("\t")) == 7 and len(lines[1].split("\t")) == 6
    assert _files(roots["port"]) == _files(roots["jax"])
    for it in items:
        rel = os.path.join("results", "outputs", it.wood_type, it.fname)
        np.testing.assert_array_equal(
            load_image_u8(os.path.join(roots["port"], rel), grayscale=True),
            load_image_u8(os.path.join(roots["jax"], rel), grayscale=True))


def test_streaming_equals_sequential(engines, tmp_path):
    _, port_engine = engines
    items = _items(seed=9)
    csvs = []
    for name in ("seq", "stream"):
        root = str(tmp_path / name)
        write_processed(root, items)
        if name == "seq":
            path = port_engine.predict(root, images=items, progress=False)
        else:
            path = port_engine.predict_streaming(
                root, iter(enumerate(items)), progress=False)
        with open(path, "rb") as f:
            csvs.append(f.read())
    assert csvs[0] == csvs[1]


def test_launch_ladder_and_unported_options(engines, tmp_path):
    _, port_engine = engines
    assert [port_engine._padded_batch(n) for n in range(1, 5)] == \
        [1, 2, 4, 4]
    assert port_engine.launch_item_counts() == [1, 2, 3]
    # resume is ported: a folder without artifacts is predicted whole
    root = str(tmp_path / "resume")
    items = _items(seed=10)[:2]
    write_processed(root, items)
    with open(port_engine.predict(root, progress=False, resume=True)) as f:
        assert len(f.read().splitlines()) == 1 + len(items)
    # shard is ported (tests/test_torch_multihost.py drives it): one out
    # of range is refused before the folder is read
    with pytest.raises(ValueError, match="shard"):
        port_engine.predict("unused", shard=(2, 2))


# the stage timers of a predict() pass: (name or prefix, calls per pass,
# per chunk (a launch batch) or per image)
STAGES = [("predict/plan", "pass"), ("predict/finalize", "pass"),
          ("predict/decode", "chunk"), ("predict/dispatch_h", "chunk"),
          ("predict/upload_h", "chunk"), ("predict/launch_h", "chunk"),
          ("predict/pull_h", "chunk"), ("predict/wait", "chunk"),
          ("predict/postprocess_h", "chunk"), ("report/figure", "image"),
          ("report/dual", "image")]


@pytest.fixture(scope="module")
def stage_run(engines, tmp_path_factory):
    """One predict() pass over a processed folder inside a CPU profiler
    session: (the stage report, the profiled spans' log, the profiler's
    events of the program's stages by name, the planned chunks' first
    indices and sizes, the number of images)."""
    from torch.profiler import ProfilerActivity, profile

    from neuralbarkcalculator_tpu_torch.data.dataset import make_dataset
    from neuralbarkcalculator_tpu_torch.utils import profiling

    _, port_engine = engines
    root = tmp_path_factory.mktemp("stages")
    items = _items(seed=11)
    write_processed(str(root), items)
    profiling.report(reset=True)
    with profile(activities=[ProfilerActivity.CPU],
                 **profiling._all_threads()) as prof:
        port_engine.predict(str(root), progress=False)
    log = profiling.spans()
    stages = profiling.report(reset=True)
    annotations: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("predict/", "report/")):
            annotations[e.name()] = annotations.get(e.name(), 0) + 1
    records = make_dataset(os.path.join(str(root), "processed"))
    height = {(it.fname, it.wood_type): it.image.shape[0] for it in items}
    chunks = port_engine._plan_chunks(
        [(i, height[(r.fname, r.wood_type)], WIDTH)
         for i, r in enumerate(records)])
    yield (stages, log, annotations,
           {idxs[0]: len(idxs) for _, idxs in chunks}, len(items))
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("stage, per", STAGES)
def test_predict_stage_counts(stage_run, stage, per):
    stages, log, annotations, chunks, n_images = stage_run
    want = {"pass": 1, "chunk": len(chunks), "image": n_images}[per]
    rows = {k: v for k, v in stages.items() if k.startswith(stage)}
    assert rows and sum(v["calls"] for v in rows.values()) == want
    # each call is a range of the profiler's and an entry of the log
    for name, row in rows.items():
        assert annotations[name] == row["calls"]
        assert sum(1 for n, *_ in log if n == name) == row["calls"]


def test_predict_stage_names_and_chunks(stage_run):
    import re

    stages, log, _, chunks, _ = stage_run
    assert len(chunks) == 2  # buckets 64 (4 images) and 32 (3)
    # the names dispatch_ms and postprocess_ms read: nothing else under
    # their prefixes
    for name in stages:
        if name.startswith(("predict/dispatch_h", "predict/postprocess_h")):
            assert re.fullmatch(r"predict/(dispatch|postprocess)_h\d+", name)
        assert name.startswith(("predict/", "report/"))
    # a chunk's spans carry its first manifest index, decode to artifacts
    by: dict[str, dict] = {}
    for name, _, _, chunk in log:
        stage = re.sub(r"_h\d+$", "", name)
        by.setdefault(stage, {}).setdefault(chunk, 0)
        by[stage][chunk] += 1
    for stage in ("predict/decode", "predict/dispatch", "predict/upload",
                  "predict/launch", "predict/pull", "predict/wait",
                  "predict/postprocess"):
        assert by[stage] == dict.fromkeys(chunks, 1), stage
    for stage in ("report/figure", "report/dual"):
        assert by[stage] == chunks, stage
    assert by["predict/plan"] == by["predict/finalize"] == {None: 1}


def test_cli_runs_on_cpu(tmp_path):
    """The port's CLI end to end on the CPU: BMP sources -> native
    preprocess -> full-width fcn_resnet50 -> artifacts."""
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)

    torch.manual_seed(0)
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(fcn_resnet50().state_dict(), ckpt)
    rng = np.random.default_rng(0)
    root = tmp_path / "root"
    names = []
    for wood, shape in (("sapin", (40, 64)), ("epinette_gelee", (64, 64))):
        d = root / "samples" / wood
        d.mkdir(parents=True)
        img = (rng.random((*shape, 3)) * 200 + 40).astype(np.uint8)
        save_image_u8_pil(str(d / "a.bmp"), img)
        names.append((wood, "a.png"))
    proc = subprocess.run(
        [sys.executable, "-m", "neuralbarkcalculator_tpu_torch.cli.predict",
         str(root), "--device", "cpu", "--model_path", ckpt, "--dpi", "40",
         "--batch_size", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for wood, fname in names:
        for sub in ("combined_images", "outputs"):
            assert (root / "results" / sub / wood / fname).is_file()
        assert (root / "processed" / "samples" / wood / fname).is_file()
    lines = (root / "results" / "final_stats.csv").read_text().splitlines()
    assert len(lines) == 3
