"""PyTorch port: width partitioning, the JAX mesh's ``model`` axis
(parallel/spatial.py, the split ResNet and FCN head, the engine under a
``(data, model)`` mesh), on the CPU over gloo.

Two jobs of spawned ranks (``_run_rank``, a ``file://`` rendezvous under
the module's tmp directory, a timeout of their own) run once for the
module, started together: two ranks (mesh (1, 2)) and four ranks (meshes
(1, 4) and (2, 2)). Each rank saves what it computed and the tests
compare in this process:

- the halo primitives at n_model 2 and 4: every op of the halo table
  (the stem from the input's halo, the strided 3x3, the 3x3 at dilation
  1 / 2 / 4, the FCN head's 3x3, the 1x1 convs on the strip as they are)
  and the max pool, each rank's output against its columns of the
  full-width ``F.conv2d`` / ``F.max_pool2d`` within rtol 1e-5 / atol 1e-6;
  the CPU gives them bit for bit, and the test says so;
- the model against JAX (tests/test_reference_parity.py:129-150):
  ``fcn_resnet50(dropout=0.0)`` JAX-initialised at PRNGKey(0), its
  weights carried across, batch 4 at 64x64 under a (2, 2) mesh, upsampled
  to 64x64, against JAX's unsharded apply and JAX's own (2, 2)-mesh apply
  on the 8 CPU devices of tests/conftest.py, rtol = atol = 1e-4;
- the engine (tests/test_pipeline.py:232-257): the tiny model of
  tests/torch_port_common.py in float32 at batch 4 over 64-wide images in
  three height buckets; the class maps bit-equal under ``mesh=None``, (1,
  1), (1, 2) and (2, 2) and equal to the JAX engine's; rank 0's
  final_stats.csv byte for byte the one-process CSV, the other ranks
  writing no file; the halo bytes each rank received equal to the count
  worked out from the shapes;
- lockstep: under (1, 2), a folder with three height buckets (more chunks
  than the pump's PREFETCH) and a resumed pass after deleting one output,
  both equal to the one process's CSV;
- a 1x1 mesh issues no collective, and the refusals raise ValueError
  (strips off the backbone's multiple, int8 EfficientNet, a split in
  train mode, a mesh server's unsplittable request; DeepLab and int8
  split since tests/test_torch_width_zoo.py, EfficientNet,
  predict_streaming and the server since tests/test_torch_width_effnet.py
  and tests/test_torch_mesh_serving.py).
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, tiny_checkpoint, tiny_engines,
                               tiny_torch_model, write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
# the engine's folder: 64-wide (a strip of 32 at n_model 2: 4 feature
# columns, layer4's dilation), height buckets 64, 96 and 128 at
# height_bucket 32, so batch 4 gives 3 chunks, more than PREFETCH
WIDTH = 64
HEIGHTS = (64, 40, 56, 72, 96, 100, 128)
WOOD = ("sapin", "epinette_gelee", "sapin", "sapin", "epinette_gelee",
        "sapin", "epinette_gelee")
ENGINE_CONFIG = dict(batch_size=4, height_bucket=32, figure_dpi=50)
# (n_pad, pad_h) of the folder's launches at batch 4 and bucket 32
LAUNCHES = ((4, 64), (2, 96), (2, 128))
# the halo table's convs, (kernel, stride, dilation, padding), and the 1x1
# convs, which take no halo
HALO_CONVS = {"stem 7x7/2": (7, 2, 1, 3), "3x3/2": (3, 2, 1, 1),
              "3x3 d1": (3, 1, 1, 1), "3x3 d2": (3, 1, 2, 2),
              "3x3 d4": (3, 1, 4, 4), "1x1": (1, 1, 1, 0),
              "1x1/2": (1, 2, 1, 0)}
HALO_STRIP = 8  # input columns a rank, the smallest strip allowed
TIMEOUT = 240

_RUN = r"""
import sys
import test_torch_width_partition as t
t._run_rank(*sys.argv[1:])
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _items():
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(SEED)
    return [ProcessedImage(blob_image(rng, h, WIDTH), f"img{i}.png", wood)
            for i, (h, wood) in enumerate(zip(HEIGHTS, WOOD))]


def _config(pt):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig

    return PredictConfig(model_path=pt, use_bfloat16=False, **ENGINE_CONFIG)


def _tiny_engine(pt, mesh=None):
    """The port engine on the tiny model, float32, on the CPU."""
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    tseg.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        return NeuralBarkCalculator(pt, config=_config(pt),
                                    model_name="_tiny_test", device="cpu",
                                    mesh=mesh)
    finally:
        tseg.MODEL_FACTORIES.pop("_tiny_test", None)


def _result_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(os.path.join(root, "results"))
                  for f in fs)


# ------------------------------------------------------------ the ranks

def _run_rank(job, rank, size, init, out_dir) -> None:
    """A rank's body: join the group, run the job, save its result."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed)

    torch.set_num_threads(1)
    world = initialize_distributed(init_method=init, rank=int(rank),
                                   world_size=int(size), device="cpu")
    try:
        result = _JOBS[job](world, out_dir)
        torch.save(result, os.path.join(out_dir, f"{job}-{rank}.pt"))
    finally:
        shutdown_distributed()


def _halo_case(n: int):
    """The input [2, 3, 10, n x HALO_STRIP] and one conv per HALO_CONVS
    entry, drawn from SEED."""
    import torch.nn as nn

    gen = torch.Generator().manual_seed(SEED + n)
    x = torch.randn(2, 3, 10, n * HALO_STRIP, generator=gen)
    convs = {}
    for name, (k, s, d, p) in HALO_CONVS.items():
        conv = nn.Conv2d(3, 4, k, s, p, d)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
        convs[name] = conv
    return x, convs


def _halo_outputs(mesh) -> dict:
    """Each op of the halo table on this rank's strip of ``_halo_case``."""
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        STEM_HALO, STRIP_MULTIPLE, conv2d_rows, conv2d_w, max_pool2d_w,
        stem_columns, stem_edge_pads, strip_range)

    model = mesh.model
    x, convs = _halo_case(model.size)
    start, stop = strip_range(x.shape[3], model, STRIP_MULTIPLE)
    strip = x[..., start:stop]
    out = {}
    with torch.inference_mode():
        for name, conv in convs.items():
            if name.startswith("stem"):
                # the stem's halo comes with the input
                wide = F.pad(x[..., stem_columns(x.shape[3], model,
                                                 STEM_HALO, STRIP_MULTIPLE)],
                             stem_edge_pads(model, STEM_HALO))
                out[name] = conv2d_rows(conv, wide)
            elif conv.kernel_size[1] == 1:
                out[name] = conv(strip)  # no halo: the strip as it is
            else:
                out[name] = conv2d_w(conv, strip, model)
        out["max pool 3x3/2"] = max_pool2d_w(F.relu(strip), model)
    return out


def _model_outputs(mesh, out_dir) -> np.ndarray:
    """fcn_resnet50's split forward of this rank's rows and strip."""
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        stem_columns, stem_edge_pads)

    model = fcn_resnet50(dropout=0.0)
    load_state_dict_into(model, torch.load(
        os.path.join(out_dir, "fcn_resnet50.pt")))
    model.eval()
    halo = model.backbone.stem_halo
    x = np.load(os.path.join(out_dir, "x.npy"))
    rows = mesh.data.rank_slice(x.shape[0])
    strip = torch.from_numpy(np.ascontiguousarray(
        x[rows][:, :, stem_columns(x.shape[2], mesh.model, halo,
                                   model.backbone.strip_multiple)]))
    strip = F.pad(strip, (0, 0, *stem_edge_pads(mesh.model, halo)))
    with torch.inference_mode():
        return model(strip, width=mesh.model).numpy()


def _engine_outputs(world, mesh, out_dir, tag) -> dict:
    """The engine under ``mesh``: predict_images' maps and the halo bytes
    they exchanged, then predict over a root of this rank's own (only
    rank 0 may write there)."""
    from neuralbarkcalculator_tpu_torch.parallel.spatial import EXCHANGES

    engine = _tiny_engine(os.path.join(out_dir, "tiny.pt"), mesh)
    items = _items()
    EXCHANGES.reset()
    maps = {it.fname: m for it, m in engine.predict_images(items)}
    exchanges = (EXCHANGES.count, EXCHANGES.bytes)
    root = os.path.join(out_dir, f"{tag}-root-{world.rank}")
    write_processed(root, items)
    csv = engine.predict(root, progress=False)
    return {"maps": maps, "exchanges": exchanges, "csv": csv,
            "csv_bytes": None if csv is None else open(csv, "rb").read(),
            "files": _result_files(root), "mesh": (
                mesh.data_rank, mesh.model_rank)}


def _lockstep(world, mesh, out_dir) -> dict:
    """Under ``mesh``, the folder predicted in one shared root, then one
    output deleted and the folder resumed."""
    engine = _tiny_engine(os.path.join(out_dir, "tiny.pt"), mesh)
    root = os.path.join(out_dir, "lockstep-root")
    if world.is_main:
        write_processed(root, _items())
    world.barrier()
    t0 = time.perf_counter()
    first = engine.predict(root, progress=False)
    first_bytes = None if first is None else open(first, "rb").read()
    world.barrier()  # rank 0 has written everything
    if world.is_main:
        os.remove(os.path.join(root, "results", "outputs", WOOD[3],
                               "img3.png"))
    world.barrier()
    resumed = engine.predict(root, progress=False, resume=True)
    return {"first": first_bytes, "resumed": None if resumed is None
            else open(resumed, "rb").read(),
            "seconds": time.perf_counter() - t0}


def _job_two(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    mesh = make_mesh(1, 2, world)
    return {"halo": _halo_outputs(mesh),
            "engine": _engine_outputs(world, mesh, out_dir, "m12"),
            "lockstep": _lockstep(world, mesh, out_dir)}


def _job_four(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    halo = _halo_outputs(make_mesh(1, 4, world))
    mesh = make_mesh(2, 2, world)
    return {"halo": halo, "model": _model_outputs(mesh, out_dir),
            "engine": _engine_outputs(world, mesh, out_dir, "m22"),
            "mesh": (mesh.data_rank, mesh.model_rank)}


_JOBS = {"two": _job_two, "four": _job_four}


# ------------------------------------------------------- the jobs' data

def _jax_fcn_resnet50():
    """fcn_resnet50(dropout=0.0) JAX-initialised at PRNGKey(0) on 64x64:
    (the model, its variables)."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.segmentation import fcn_resnet50

    model = fcn_resnet50(dropout=0.0)
    return model, jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))


def _jax_applies(model, variables, x):
    """JAX's unsharded apply of ``x`` and its apply under a (2, 2) mesh
    of the CPU devices (tests/test_reference_parity.py:129-150)."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.parallel.mesh import (ShardingRules,
                                                        make_mesh)

    def fwd(v, b):
        return model.apply(v, b, train=False)

    unsharded = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)))
    rules = ShardingRules(make_mesh(n_data=2, n_model=2))
    sharded = np.asarray(jax.jit(
        fwd, in_shardings=(rules.replicated, rules.image_batch))(
            jax.device_put(variables, rules.replicated),
            jax.device_put(x, rules.image_batch)))
    return unsharded, sharded


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both spawned jobs' results by rank, JAX's fcn_resnet50 applies of
    their input, and the one-process engines (JAX's and the port's). The
    parent computes the JAX results while the ranks run."""
    import jax

    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    out = tmp_path_factory.mktemp("width")
    model, variables = _jax_fcn_resnet50()
    x = np.random.default_rng(SEED).random((4, 64, 64, 3), dtype=np.float32)
    torch.save(variables_to_state_dict(jax.tree.map(np.asarray, variables)),
               out / "fcn_resnet50.pt")
    np.save(out / "x.npy", x)
    pt = tiny_checkpoint(str(out / "tiny.pt"), seed=SEED)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = {job: [subprocess.Popen(
        [sys.executable, "-c", _RUN, job, str(rank), str(size),
         f"file://{out / f'rendezvous-{job}'}", str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)] for job, size in (("two", 2), ("four", 4))}
    try:
        applies = _jax_applies(model, variables, x)
        jax_engine, port_engine = tiny_engines(pt, **ENGINE_CONFIG)
        deadline = time.monotonic() + TIMEOUT
        errs = {job: [p.communicate(
            timeout=max(1.0, deadline - time.monotonic()))[1] for p in ps]
            for job, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
    for job, ps in procs.items():
        for p, err in zip(ps, errs[job]):
            assert p.returncode == 0, f"{job}: {err[-3000:]}"
    results = {job: [torch.load(out / f"{job}-{rank}.pt", weights_only=False)
                     for rank in range(len(ps))]
               for job, ps in procs.items()}
    yield {"results": results, "pt": pt, "jax": applies,
           "jax_engine": jax_engine, "port_engine": port_engine}
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("job,n", [("two", 2), ("four", 4)])
def test_halo_primitives_equal_full_width(jobs, job, n):
    """Every op of the halo table, each rank's strip against its columns
    of the full-width op: within rtol 1e-5 / atol 1e-6, and on this CPU
    bit for bit (asserted too: a tolerance alone would hide a halo that
    is off by a column only where values are near). The reference runs on
    one thread, as the ranks do: the CPU's 1x1 conv sums in another order
    on two (4.8e-7 apart), whatever the width."""
    import torch.nn.functional as F

    ranks = jobs["results"][job]
    x, convs = _halo_case(n)
    torch.set_num_threads(1)
    try:
        with torch.inference_mode():
            want = {name: conv(x) for name, conv in convs.items()}
            want["max pool 3x3/2"] = F.max_pool2d(F.relu(x), 3, 2, 1)
    finally:
        torch.set_num_threads(2)
    for name, full in want.items():
        got = torch.cat([r["halo"][name] for r in ranks], dim=3)
        assert got.shape == full.shape, name
        torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-6,
                                   msg=name)
        assert torch.equal(got, full), f"{name}: not bit for bit"


def test_split_model_matches_jax(jobs):
    """fcn_resnet50 under a (2, 2) mesh against JAX's unsharded and (2,
    2)-mesh applies, rtol = atol = 1e-4; the two model ranks of a row
    hold the same full-width logits."""
    unsharded, sharded = jobs["jax"]
    ranks = jobs["results"]["four"]
    by_cell = {r["mesh"]: r["model"] for r in ranks}
    for d in range(2):
        np.testing.assert_array_equal(by_cell[(d, 0)], by_cell[(d, 1)])
    got = np.concatenate([by_cell[(0, 0)], by_cell[(1, 0)]])
    assert got.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got, unsharded, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, sharded, rtol=1e-4, atol=1e-4)


def test_engine_maps_equal_across_meshes(jobs):
    """Class maps bit-equal under mesh=None, (1, 1), (1, 2) and (2, 2) on
    every rank, and equal to the JAX engine's."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    items = _items()
    want = {it.fname: m for it, m in
            jobs["jax_engine"].predict_images(items)}
    meshes = {
        "None": {it.fname: m for it, m in
                 jobs["port_engine"].predict_images(items)},
        "(1, 1)": {it.fname: m for it, m in _tiny_engine(
            jobs["pt"], make_mesh()).predict_images(items)}}
    for job, label in (("two", "(1, 2)"), ("four", "(2, 2)")):
        for rank, r in enumerate(jobs["results"][job]):
            meshes[f"{label} rank {rank}"] = r["engine"]["maps"]
    classes = set()
    for label, maps in meshes.items():
        assert sorted(maps) == sorted(want), label
        for fname, m in want.items():
            np.testing.assert_array_equal(maps[fname], m,
                                          err_msg=f"{label} {fname}")
            classes |= set(np.unique(m).tolist())
    assert len(classes) >= 2  # the maps are not trivially one class


def test_rank0_writes_the_one_process_csv(jobs, tmp_path):
    """Grid rank 0's final_stats.csv byte for byte the one-process CSV
    (and its artifacts the same files); the other ranks write no file
    and return None."""
    root = str(tmp_path / "one")
    write_processed(root, _items())
    with open(jobs["port_engine"].predict(root, progress=False), "rb") as f:
        want = f.read()
    files = _result_files(root)
    for job in ("two", "four"):
        for rank, r in enumerate(jobs["results"][job]):
            e = r["engine"]
            if rank == 0:
                assert e["csv_bytes"] == want, job
                assert e["files"] == files, job
            else:
                assert e["csv"] is None and e["files"] == [], (job, rank)


def _expected_halo_bytes(model, rows: int, pad_h: int, n: int, rank: int
                         ) -> int:
    """The float32 halo bytes rank ``rank`` of ``n`` receives in one
    launch of ``rows`` images at ``pad_h``, from the model's shapes: the
    max pool's (1, 0) on the stem's 64 channels, each block's conv2, the
    FCN head's 3x3 (the stem's halo comes with the input)."""
    def received(conv_or_pool, channels, height):
        k, s, d, p = conv_or_pool
        left, right = p, d * (k - 1) - p - s + 1
        cols = (left if rank > 0 else 0) + (right if rank < n - 1 else 0)
        return 4 * rows * channels * height * cols

    total = received((3, 2, 1, 1), 64, pad_h // 2)
    height = pad_h // 4
    backbone = model.backbone
    for stage in range(4):
        for block in getattr(backbone, f"layer{stage + 1}"):
            c = block.conv2
            total += received((3, c.stride[1], c.dilation[1], c.padding[1]),
                              c.in_channels, height)
            height //= c.stride[0]
    head = model.classifier[0]
    return total + received((3, 1, 1, 1), head.in_channels, height)


@pytest.mark.parametrize("job,data,n", [("two", 1, 2), ("four", 2, 2)])
def test_halo_bytes_equal_the_shapes(jobs, job, data, n):
    """Each rank's exchanges and received halo bytes over the folder's
    launches equal what the model's shapes give: 6 exchanges a launch
    (the max pool, the 4 blocks' conv2, the head)."""
    model = tiny_torch_model()
    for r in jobs["results"][job]:
        d, m = r["engine"]["mesh"]
        want = sum(_expected_halo_bytes(model, n_pad // data, pad_h, n, m)
                   for n_pad, pad_h in LAUNCHES)
        assert r["engine"]["exchanges"] == (6 * len(LAUNCHES), want), (d, m)


def test_lockstep_and_resume_under_a_mesh(jobs, tmp_path):
    """Under (1, 2), a folder of three height buckets and its resumed pass
    after deleting one output both finish (within the job's timeout) and
    write the one process's CSV; the other rank returns None."""
    root = str(tmp_path / "one")
    write_processed(root, _items())
    with open(jobs["port_engine"].predict(root, progress=False), "rb") as f:
        want = f.read()
    ranks = [r["lockstep"] for r in jobs["results"]["two"]]
    assert ranks[0]["first"] == want and ranks[0]["resumed"] == want
    assert ranks[1]["first"] is None and ranks[1]["resumed"] is None


def test_a_1x1_mesh_issues_no_collective(jobs, tmp_path, monkeypatch):
    """With every torch.distributed collective made to raise, a 1x1
    mesh's engine gives mesh=None's maps and CSV bit for bit."""
    import torch.distributed as dist

    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran")

    for name in ("all_reduce", "all_gather", "barrier", "new_group",
                 "broadcast"):
        monkeypatch.setattr(dist, name, refuse)
    items = _items()
    engine = _tiny_engine(jobs["pt"], make_mesh(1, 1))
    for (_, got), (_, want) in zip(
            engine.predict_images(items),
            jobs["port_engine"].predict_images(items)):
        np.testing.assert_array_equal(got, want)
    csvs = []
    for name, eng in (("mesh", engine), ("none", jobs["port_engine"])):
        root = str(tmp_path / name)
        write_processed(root, items)
        with open(eng.predict(root, progress=False), "rb") as f:
            csvs.append(f.read())
    assert csvs[0] == csvs[1]


def _fake_mesh(n_model: int = 2):
    """A (1, n_model) mesh of rank 0 without a process group: enough for
    the checks that run before any collective."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        Mesh, World)

    cpu = torch.device("cpu")
    return Mesh(World(0, n_model, cpu), World(0, 1, cpu),
                World(0, n_model, cpu))


def _refuse_strip():
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        STRIP_MULTIPLE, strip_range)

    # strips of 30: no multiple of 8
    strip_range(60, _fake_mesh().model, STRIP_MULTIPLE)


def _refuse_mesh():
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        World, make_mesh)

    make_mesh(2, 2, World(0, 2, torch.device("cpu")))


def _refuse_effnet_strip(tmp_path):
    """The B0 engine under a model axis of 2 on 80-wide images: strips
    of 40 columns, a multiple of 8 but not of EfficientNet's 32."""
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_efficientnet)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    pt = str(tmp_path / "b0.pt")
    torch.save(fcn_efficientnet(0).state_dict(), pt)
    engine = NeuralBarkCalculator(pt, config=_config(pt),
                                  model_name="fcn_efficientnet_b0",
                                  device="cpu", mesh=_fake_mesh())
    list(engine.predict_images([ProcessedImage(
        np.zeros((64, 80, 3), np.uint8), "a.png", "sapin")]))


def _refuse_int8_efficientnet(pt):
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    config = _config(pt)
    config.quantize_int8 = True
    NeuralBarkCalculator(pt, config=config, model_name="fcn_efficientnet_b0",
                         device="cpu", mesh=_fake_mesh())


def _refuse_server_submit(pt):
    """A mesh server's submit of a 60-wide image (strips of 30), refused
    on grid rank 0 before anything is sent."""
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    predictor = BatchingPredictor(_tiny_engine(pt, _fake_mesh()))
    try:
        predictor.submit(np.zeros((64, 60, 3), np.uint8))
    finally:
        predictor.close()


def _refuse_head_logits():
    """EfficientNet's head_logits on a strip of 48 columns (with its stem
    halo of 0 + 1)."""
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_efficientnet)

    fcn_efficientnet(0).eval().head_logits(torch.zeros(1, 64, 49, 3),
                                           width=_fake_mesh().model)


def _refuse_effnet_train():
    """EfficientNet split in train mode."""
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_efficientnet)

    fcn_efficientnet(0).train().backbone(torch.zeros(1, 3, 64, 65),
                                         dropout_seed=1,
                                         width=_fake_mesh().model)


@pytest.mark.parametrize("case", [
    "strip", "mesh", "fcn_efficientnet_b0 strip", "int8 fcn_efficientnet_b0",
    "effnet train", "server submit", "head_logits"])
def test_refusals(jobs, case, tmp_path):
    """Each raises ValueError: a strip width that is no multiple of 8,
    n_data x n_model != the world's size, and under a model axis of 2
    EfficientNet on strips that are no multiple of 32 (in the engine and
    in head_logits), int8 EfficientNet, EfficientNet's backbone split in
    train mode, and a mesh server's request whose width does not split."""
    pt = jobs["pt"]
    run = {"strip": _refuse_strip, "mesh": _refuse_mesh,
           "fcn_efficientnet_b0 strip": lambda: _refuse_effnet_strip(
               tmp_path),
           "int8 fcn_efficientnet_b0": lambda: _refuse_int8_efficientnet(
               pt),
           "effnet train": _refuse_effnet_train,
           "server submit": lambda: _refuse_server_submit(pt),
           "head_logits": _refuse_head_logits}[case]
    with pytest.raises(ValueError):
        run()
