"""PyTorch port: EfficientNet under the JAX mesh's ``model`` axis
(models/efficientnet.py, parallel/spatial.py): TF-SAME convs on width
strips, the split-invariant squeeze-excite pool, the zoo's B0 models and
the exact-height engine under ``(data, model)`` meshes, on the CPU over
gloo.

Two jobs of spawned ranks (``_run_rank``, a ``file://`` rendezvous under
the module's tmp directory, a timeout of their own) run once for the
module, started together: two ranks (mesh (1, 2)) and four ranks (meshes
(1, 4) and (2, 2)). Each rank saves what it computed and the tests
compare in this process, which computes the JAX applies, JAX's engine
under ``make_mesh(n_data=1, n_model=2)`` and the port's one-process
references on one thread, as the ranks run:

- ``SameConv2d`` on strips: 3x3 and 5x5 at stride 1 and 2, depthwise and
  dense, NCHW and channels_last, at n 2 and 4: each rank's output
  bit-equal to its columns of the full-width conv;
- squeeze-excite's pool (``MBConvBlock._squeeze``) on a strip, the
  gathered column sums, within POOL_TOL = 1e-6 of the largest |pool| of
  the one process's float32 mean (measured 1.7e-7 at n 2, 8.4e-8 at n
  4), with one pooled reduction of [B, C, W] float32;
- fcn_efficientnet_b0 and deeplabv3_efficientnet_b0 with BN calibrated
  (``calibrate_bn``, as tests/test_torch_efficientnet.py) on blob images
  of the batch's own size (calibrated at 64 x 64, the network amplifies
  rounding ~10^2 more at 64 x 256, past JAX's own sharded-vs-unsharded
  spread), the FCN at 2 x 64 x 256 under (1, 2), (1, 4) and (2, 2), the
  DeepLab at 1 x 64 x 1024 under (1, 2) and (1, 4) (its 32-column
  feature map puts the ASPP's rates 12 and 24 on halos, multi-hop at n 4,
  and rate 36 on the centre tap): within LOGIT_TOL = 1e-4 of the largest
  |logit| of JAX's unsharded apply and of JAX's apply under its own (1,
  2) mesh (tests/test_torch_efficientnet.py's tolerance; measured up to
  9.8e-6), and within SPLIT_TOL = 1e-5 of the largest |logit| of the
  port's one process: measured 7.1e-6 for the FCN at (1, 2) and (1, 4),
  6.5e-6 at (2, 2), and 4.8e-6 for the DeepLab at (1, 2) and (1, 4).
  Two things differ from the one process in float32 rounding: every
  block's squeeze-excite pool (the split's column sums against the one
  process's mean, above), and on this CPU the channels_last 1x1 convs,
  GEMMs over B x H x W rows whose summation order oneDNN picks by that
  count (the FCN's stage-5 672 -> 192 projection on a 2 x 8 map and on a
  2 x 4 strip differ in the last bit);
- the engine with fcn_efficientnet_b0 (exact heights 64 and 48, width
  256, batch 4) under (1, 2) and (2, 2), and with
  ``effnet_bucket_heights`` under (1, 2): class maps equal to the one
  process's except at near ties (a top-2 margin under SPLIT_TOL of the
  largest |logit| of the per-image float32 forward; none flips here),
  rank 0's final_stats.csv byte for byte the one process's, the halo
  bytes and pooled-reduction bytes equal to the count from the shapes,
  and maps that agree with JAX's engine under make_mesh(n_data=1,
  n_model=2) away from its near ties (a margin under LOGIT_TOL).
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, calibrate_bn, normalized,
                               write_processed, zoo_model)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 23
# the SAME convs: (kernel, stride) x (groups: depthwise 8, dense 1)
SAME_CONVS = ((3, 1), (5, 1), (3, 2), (5, 2))
SAME_X = (2, 8, 13, 16)  # [B, C, H, w per rank]
# squeeze-excite's map, [B, C, H, w per rank]
SE_X = (2, 96, 9, 8)
FCN_X = (2, 64, 256, 3)
DEEPLAB_X = (1, 64, 1024, 3)
# the engine's folder: two exact heights, width 256
ENGINE_WIDTH = 256
ENGINE_HEIGHTS = (64, 48, 64, 48, 64)
ENGINE_CONFIG = dict(batch_size=4, figure_dpi=50)
BUCKET_CONFIG = dict(batch_size=4, figure_dpi=50, height_bucket=64,
                     effnet_bucket_heights=True)
BUCKET_HEIGHTS = (64, 48, 40, 64, 33)
# head logits of the two packages agree within this share of the largest
# |logit| (tests/test_torch_efficientnet.py)
LOGIT_TOL = 1e-4
# the split B0 models against the port's one process (measured 4.8e-6 to
# 7.1e-6: see the module docstring)
SPLIT_TOL = 1e-5
# squeeze-excite's pool on strips (the gathered column sums) against the
# one process's mean, a share of the largest |pool| (measured 1.7e-7 at n
# 2 and 8.4e-8 at n 4: float32 rounding of two summation orders)
POOL_TOL = 1e-6
TIMEOUT = 300

_RUN = r"""
import sys
import test_torch_width_effnet as t
t._run_rank(*sys.argv[1:])
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(name, out_dir):
    """The calibrated B0 of ``name``, its weights from out_dir."""
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    model = MODEL_FACTORIES[name]()
    model.load_state_dict(torch.load(os.path.join(out_dir, f"{name}.pt")))
    return model.eval()


def _items(heights, seed):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(seed)
    return [ProcessedImage(blob_image(rng, h, ENGINE_WIDTH), f"img{i}.png",
                           "sapin" if i % 2 else "epinette_gelee")
            for i, h in enumerate(heights)]


def _engine(out_dir, mesh=None, bucketed=False):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    pt = os.path.join(out_dir, "fcn_efficientnet_b0.pt")
    return NeuralBarkCalculator(
        pt, model_name="fcn_efficientnet_b0", device="cpu", mesh=mesh,
        config=PredictConfig(model_path=pt, use_bfloat16=False,
                             **(BUCKET_CONFIG if bucketed
                                else ENGINE_CONFIG)))


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


def _same_case(n: int, k: int, s: int, groups: int, fmt: str):
    """(conv, full-width input) of a SameConv2d case at n ranks."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        SameConv2d)

    gen = torch.Generator().manual_seed(SEED + 100 * k + 10 * s + groups)
    b, c, h, w = SAME_X
    conv = SameConv2d(c, c, k, stride=s, groups=groups)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(b, c, h, n * w, generator=gen)
    memory_format = (torch.channels_last if fmt == "channels_last"
                     else torch.contiguous_format)
    return (conv.to(memory_format=memory_format).eval(),
            x.contiguous(memory_format=memory_format))


def _same_outputs(model) -> dict:
    """Every SAME case on this rank's strip."""
    out = {}
    for k, s in SAME_CONVS:
        for groups in (1, SAME_X[1]):
            for fmt in ("nchw", "channels_last"):
                conv, x = _same_case(model.size, k, s, groups, fmt)
                w = x.shape[3] // model.size
                strip = x[..., model.rank * w:(model.rank + 1) * w]
                with torch.inference_mode():
                    out[(k, s, groups, fmt)] = conv(
                        strip.contiguous(memory_format=_fmt(x)), model)
    return out


def _fmt(x):
    return (torch.contiguous_format if x.is_contiguous()
            else torch.channels_last)


def _se_case(n: int):
    """(an MBConv block, its full-width squeeze input) at n ranks."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        MBConvBlock)

    gen = torch.Generator().manual_seed(SEED + n)
    b, c, h, w = SE_X
    block = MBConvBlock(16, 16, c // 16, 3, 1).eval()
    return block, torch.randn(b, c, h, n * w, generator=gen)


def _se_outputs(model):
    """(squeeze of this rank's strip, reductions, reduced bytes)."""
    from neuralbarkcalculator_tpu_torch.parallel.spatial import REDUCTIONS

    block, x = _se_case(model.size)
    w = x.shape[3] // model.size
    REDUCTIONS.reset()
    with torch.inference_mode():
        got = block._squeeze(x[..., model.rank * w:(model.rank + 1) * w],
                             model)
    return got, REDUCTIONS.count, REDUCTIONS.bytes


def _forward(mesh, out_dir, name, x_name) -> np.ndarray:
    """The split forward of ``name`` on this rank's rows and strip of the
    saved batch: the upsampled float32 logits, full width."""
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        stem_columns, stem_edge_pads)

    model = _model(name, out_dir)
    halo = model.backbone.stem_halo
    x = np.load(os.path.join(out_dir, f"{x_name}.npy"))
    rows = mesh.data.rank_slice(x.shape[0])
    strip = torch.from_numpy(np.ascontiguousarray(
        x[rows][:, :, stem_columns(x.shape[2], mesh.model, halo,
                                   model.backbone.strip_multiple)]))
    strip = F.pad(strip, (0, 0, *stem_edge_pads(mesh.model, halo)))
    with torch.inference_mode():
        return model(strip, width=mesh.model).numpy()


def _counted_run(world, mesh, out_dir, tag, bucketed=False) -> dict:
    """The engine under ``mesh``: predict_images' maps with the halo and
    reduction counters around them, then predict over a root of this
    rank's own (only rank 0 writes there)."""
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        EXCHANGES, REDUCTIONS)

    engine = _engine(out_dir, mesh, bucketed)
    items = _items(BUCKET_HEIGHTS if bucketed else ENGINE_HEIGHTS, SEED)
    EXCHANGES.reset()
    REDUCTIONS.reset()
    maps = {it.fname: m for it, m in engine.predict_images(items)}
    out = {"maps": maps, "exchanges": (EXCHANGES.count, EXCHANGES.bytes),
           "reductions": (REDUCTIONS.count, REDUCTIONS.bytes),
           "mesh": (mesh.data_rank, mesh.model_rank),
           "launches": sorted(engine._launch_shapes)}
    root = os.path.join(out_dir, f"{tag}-root-{world.rank}")
    write_processed(root, items)
    csv = engine.predict(root, progress=False)
    out.update(csv_bytes=None if csv is None else open(csv, "rb").read(),
               files=_result_files(root))
    return out


def _job_two(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    m12 = make_mesh(1, 2, world)
    return {"same": _same_outputs(m12.model), "se": _se_outputs(m12.model),
            "fcn (1, 2)": _forward(m12, out_dir, "fcn_efficientnet_b0",
                                   "fcn_x"),
            "deeplab (1, 2)": _forward(m12, out_dir,
                                       "deeplabv3_efficientnet_b0",
                                       "deeplab_x"),
            "engine": {"(1, 2)": _counted_run(world, m12, out_dir, "m12"),
                       "(1, 2) bucketed": _counted_run(
                           world, m12, out_dir, "m12b", bucketed=True)}}


def _job_four(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    m14, m22 = make_mesh(1, 4, world), make_mesh(2, 2, world)
    return {"same": _same_outputs(m14.model), "se": _se_outputs(m14.model),
            "fcn (1, 4)": _forward(m14, out_dir, "fcn_efficientnet_b0",
                                   "fcn_x"),
            "fcn (2, 2)": _forward(m22, out_dir, "fcn_efficientnet_b0",
                                   "fcn_x"),
            "mesh (2, 2)": (m22.data_rank, m22.model_rank),
            "deeplab (1, 4)": _forward(m14, out_dir,
                                       "deeplabv3_efficientnet_b0",
                                       "deeplab_x"),
            "engine": {"(2, 2)": _counted_run(world, m22, out_dir, "m22")}}


_JOBS = {"two": _job_two, "four": _job_four}


# ------------------------------------------------------- the references

def _jax_variables(model, name):
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)

    return torch_state_dict_to_variables(
        {k: v.numpy() for k, v in model.state_dict().items()},
        head="deeplab" if name.startswith("deeplab") else "fcn",
        efficientnet_variant=0)


def _jax_applies(name, variables, x):
    """JAX's unsharded apply of ``x`` and its apply under a (1, 2) mesh
    of the CPU devices."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.segmentation import (
        MODEL_FACTORIES as JAX_FACTORIES)
    from neuralbarkcalculator_tpu.parallel.mesh import (ShardingRules,
                                                        make_mesh)

    model = JAX_FACTORIES[name]()

    def fwd(v, b):
        return model.apply(v, b, train=False)

    unsharded = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)))
    rules = ShardingRules(make_mesh(n_data=1, n_model=2))
    sharded = np.asarray(jax.jit(
        fwd, in_shardings=(rules.replicated, rules.image_batch))(
            jax.device_put(variables, rules.replicated),
            jax.device_put(x, rules.image_batch)))
    return unsharded, sharded


def _jax_engine_maps(pt, items):
    """JAX's exact-height EfficientNet engine (float32, its Pallas kernel
    in interpret mode) under make_mesh(n_data=1, n_model=2)."""
    from neuralbarkcalculator_tpu.config import PredictConfig as JaxConfig
    from neuralbarkcalculator_tpu.parallel.mesh import make_mesh
    from neuralbarkcalculator_tpu.pipeline.predict import (
        NeuralBarkCalculator as JaxEngine)

    engine = JaxEngine(
        pt, mesh=make_mesh(n_data=1, n_model=2),
        model_name="fcn_efficientnet_b0",
        config=JaxConfig(model_path=pt, use_bfloat16=False,
                         use_pallas=True, pallas_interpret=True,
                         **ENGINE_CONFIG))
    return {it.fname: m for it, m in engine.predict_images(items)}


def _near_ties(engine, image, share: float) -> np.ndarray:
    """[h, w] bool: pixels whose top-2 margin in a float32 forward of the
    engine's folded model is under ``share`` of the largest |logit|."""
    with torch.inference_mode():
        logits = engine.model(torch.from_numpy(normalized(image[None])))[0]
    top2 = logits.topk(2).values
    return (top2[..., 0] - top2[..., 1] < share * logits.abs().max()
            ).numpy()


def _one_process(out) -> dict:
    """The port's one-process references, on one thread."""
    refs = {}
    for name, x_name in (("fcn_efficientnet_b0", "fcn_x"),
                         ("deeplabv3_efficientnet_b0", "deeplab_x")):
        with torch.inference_mode():
            refs[name] = _model(name, str(out))(torch.from_numpy(
                np.load(out / f"{x_name}.npy"))).numpy()
    for tag, bucketed in (("exact", False), ("bucketed", True)):
        engine = _engine(str(out), bucketed=bucketed)
        items = _items(BUCKET_HEIGHTS if bucketed else ENGINE_HEIGHTS, SEED)
        refs[f"{tag} maps"] = {it.fname: m
                               for it, m in engine.predict_images(items)}
        refs[f"{tag} ties"] = {it.fname: _near_ties(engine, it.image,
                                                    SPLIT_TOL)
                               for it in items}
        refs[f"{tag} jax ties"] = {it.fname: _near_ties(engine, it.image,
                                                        LOGIT_TOL)
                                   for it in items}
        root = str(out / f"one-{tag}")
        write_processed(root, items)
        with open(engine.predict(root, progress=False), "rb") as f:
            refs[f"{tag} csv"] = f.read()
        refs[f"{tag} files"] = _result_files(root)
        shutil.rmtree(root, ignore_errors=True)
    return refs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both spawned jobs' results by rank, the JAX results and the port's
    one-process references, computed while the ranks run."""
    out = tmp_path_factory.mktemp("width_effnet")
    models = {}
    for name, x in (("fcn_efficientnet_b0", FCN_X),
                    ("deeplabv3_efficientnet_b0", DEEPLAB_X)):
        models[name] = calibrate_bn(zoo_model(name, seed=0), seed=0,
                                    hw=x[1:3])
        torch.save(models[name].state_dict(), out / f"{name}.pt")
    rng = np.random.default_rng(SEED)
    xs = {"fcn_x": normalized([blob_image(rng, *FCN_X[1:3])
                               for _ in range(FCN_X[0])]),
          "deeplab_x": normalized([blob_image(rng, *DEEPLAB_X[1:3])
                                   for _ in range(DEEPLAB_X[0])])}
    for x_name, x in xs.items():
        np.save(out / f"{x_name}.npy", x)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = {job: [subprocess.Popen(
        [sys.executable, "-c", _RUN, job, str(rank), str(size),
         f"file://{out / f'rendezvous-{job}'}", str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)] for job, size in (("two", 2), ("four", 4))}
    try:
        applies = {
            name: _jax_applies(name, _jax_variables(models[name], name),
                               xs[x_name])
            for name, x_name in (("fcn_efficientnet_b0", "fcn_x"),
                                 ("deeplabv3_efficientnet_b0",
                                  "deeplab_x"))}
        jax_maps = _jax_engine_maps(str(out / "fcn_efficientnet_b0.pt"),
                                    _items(ENGINE_HEIGHTS, SEED))
        refs = _one_process(out)
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
    yield {"results": results, "jax": applies, "jax_maps": jax_maps,
           "refs": refs}
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("fmt", ["nchw", "channels_last"])
@pytest.mark.parametrize("job,n", [("two", 2), ("four", 4)])
def test_same_conv_strips_equal_the_full_conv(jobs, job, n, fmt):
    """3x3 / 5x5 at stride 1 / 2, depthwise and dense: rank m's output
    bit-equal to its columns of the full-width SAME conv."""
    ranks = [r["same"] for r in jobs["results"][job]]
    for k, s in SAME_CONVS:
        for groups in (1, SAME_X[1]):
            conv, x = _same_case(n, k, s, groups, fmt)
            with torch.inference_mode():
                full = conv(x)
            w = full.shape[3] // n
            for m, r in enumerate(ranks):
                got = r[(k, s, groups, fmt)]
                assert torch.equal(got, full[..., m * w:(m + 1) * w]), \
                    (k, s, groups, m)


@pytest.mark.parametrize("job,n", [("two", 2), ("four", 4)])
def test_squeeze_on_strips_matches_the_mean(jobs, job, n):
    """Squeeze-excite's pool of a strip, the same on every rank, within
    POOL_TOL of the largest |pool| of the one process's float32 mean,
    with one reduction of the [B, C, W] float32 column sums."""
    block, x = _se_case(n)
    with torch.inference_mode():
        want = block._squeeze(x, None)
    b, c, _, w = x.shape
    ranks = jobs["results"][job]
    for r in ranks:
        got, count, nbytes = r["se"]
        assert torch.equal(got, ranks[0]["se"][0])
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=POOL_TOL * want.abs().max().item())
        assert (count, nbytes) == (1, b * c * w * 4)


def _split_logits(jobs, key):
    """The full batch's logits of a split forward, the model ranks of a
    data row checked equal."""
    if key == "fcn (1, 2)" or key == "deeplab (1, 2)":
        ranks = [r[key] for r in jobs["results"]["two"]]
    elif key == "fcn (2, 2)":
        by_cell = {r["mesh (2, 2)"]: r[key] for r in jobs["results"]["four"]}
        for d in range(2):
            np.testing.assert_array_equal(by_cell[(d, 0)], by_cell[(d, 1)])
        return np.concatenate([by_cell[(0, 0)], by_cell[(1, 0)]])
    else:
        ranks = [r[key] for r in jobs["results"]["four"]]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r, ranks[0])
    return ranks[0]


@pytest.mark.parametrize("mesh", ["(1, 2)", "(1, 4)", "(2, 2)"])
def test_split_fcn_b0_matches_one_process_and_jax(jobs, mesh):
    """fcn_efficientnet_b0 at 2 x 64 x 256: within SPLIT_TOL of the
    largest |logit| of the port's one process (its squeeze-excite pools
    and the CPU's channels_last 1x1 GEMMs, module docstring), and within LOGIT_TOL of it of JAX's
    unsharded apply and of JAX's own (1, 2)-mesh apply."""
    got = _split_logits(jobs, f"fcn {mesh}")
    want = jobs["refs"]["fcn_efficientnet_b0"]
    assert got.shape == want.shape == FCN_X
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SPLIT_TOL * np.abs(want).max())
    for ref in jobs["jax"]["fcn_efficientnet_b0"]:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=LOGIT_TOL * np.abs(ref).max())


@pytest.mark.parametrize("mesh", ["(1, 2)", "(1, 4)"])
def test_split_deeplab_b0_matches_one_process_and_jax(jobs, mesh):
    """deeplabv3_efficientnet_b0 at 1 x 64 x 1024 (a 2 x 32 feature map:
    rates 12 and 24 exchange, multi-hop on the 8-column strips at n 4;
    36 takes the centre tap): within SPLIT_TOL of the largest |logit| of
    the port's one process (its squeeze-excite pools, module docstring),
    and within LOGIT_TOL of it of JAX's unsharded and (1, 2)-mesh
    applies."""
    got = _split_logits(jobs, f"deeplab {mesh}")
    want = jobs["refs"]["deeplabv3_efficientnet_b0"]
    assert got.shape == want.shape == DEEPLAB_X
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SPLIT_TOL * np.abs(want).max())
    for ref in jobs["jax"]["deeplabv3_efficientnet_b0"]:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=LOGIT_TOL * np.abs(ref).max())


ENGINE_RUNS = {"(1, 2)": ("two", "exact"), "(2, 2)": ("four", "exact"),
               "(1, 2) bucketed": ("two", "bucketed")}


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_engine_maps_and_csv_equal_one_process(jobs, run):
    """Every rank's class maps equal the one-process engine's away from
    near ties (none flips on these images), and grid rank 0's
    final_stats.csv and artifacts are the one process's byte for byte;
    the other ranks write nothing."""
    job, tag = ENGINE_RUNS[run]
    want = jobs["refs"][f"{tag} maps"]
    ties = jobs["refs"][f"{tag} ties"]
    classes = set()
    for rank, r in enumerate(jobs["results"][job]):
        got = r["engine"][run]
        assert sorted(got["maps"]) == sorted(want)
        for fname, m in want.items():
            away = ~ties[fname]
            np.testing.assert_array_equal(got["maps"][fname][away],
                                          m[away], err_msg=fname)
            classes |= set(np.unique(m).tolist())
        if rank == 0:
            assert got["csv_bytes"] == jobs["refs"][f"{tag} csv"]
            assert got["files"] == jobs["refs"][f"{tag} files"]
        else:
            assert got["csv_bytes"] is None and got["files"] == []
    assert len(classes) >= 2


def test_engine_agrees_with_the_jax_mesh_engine(jobs):
    """The split engine's maps under (1, 2) and (2, 2) against JAX's
    EfficientNet engine under make_mesh(n_data=1, n_model=2), equal away
    from near ties (a margin under LOGIT_TOL), with fewer than 1e-3 of
    the pixels near a tie."""
    jmaps = jobs["jax_maps"]
    ties = jobs["refs"]["exact jax ties"]
    assert sum(int(t.sum()) for t in ties.values()) < 1e-3 * sum(
        t.size for t in ties.values())
    for job, run in (("two", "(1, 2)"), ("four", "(2, 2)")):
        for r in jobs["results"][job]:
            for fname, m in jmaps.items():
                away = ~ties[fname]
                np.testing.assert_array_equal(
                    r["engine"][run]["maps"][fname][away], m[away],
                    err_msg=f"{run} {fname}")


def _received(left, right, rows, channels, height, w, n, m, elem=4):
    cols = min(left, m * w) + min(right, (n - 1 - m) * w)
    return elem * rows * channels * height * cols


def expected_counts(rows: int, height: int, width: int, n: int, m: int
                    ) -> tuple[int, int, int, int]:
    """(exchanges, halo bytes, reductions, reduced bytes) of rank m of n
    in one fcn_efficientnet_b0 launch of ``rows`` images ``height`` x
    ``width``, float32, from the shapes: each block's depthwise SAME conv
    takes ``same_halo`` on its expanded channels and its squeeze sums
    [rows, C, W] columns over the full width; the FCN head's 3x3 takes
    (1, 1) on the 1280 features."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        EFFICIENTNET_INPLANES)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_efficientnet)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import same_halo

    with torch.device("meta"):
        layout = fcn_efficientnet(0)
    h, w = -(-height // 2), width // 2  # after the 3x3/2 stem
    exchanges = halo_bytes = reduced = 0
    for block in layout.backbone.model._blocks:
        conv = block._depthwise_conv
        (k, _), (s, _) = conv.kernel_size, conv.stride
        halo_bytes += _received(*same_halo(k, s), rows, conv.in_channels, h,
                                w // n, n, m)
        exchanges += 1
        h, w = -(-h // s), w // s
        reduced += rows * conv.out_channels * w * 4
    halo_bytes += _received(1, 1, rows, EFFICIENTNET_INPLANES[0], h, w // n,
                            n, m)
    return exchanges + 1, halo_bytes, exchanges, reduced


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_halo_and_reduction_bytes_equal_the_shapes(jobs, run):
    """Each rank's exchanges and received halo bytes, squeeze-excite
    reductions and reduced bytes over the folder's launches equal what
    B0's shapes give."""
    job, tag = ENGINE_RUNS[run]
    n_data, n_model = (2, 2) if run == "(2, 2)" else (1, 2)
    heights = BUCKET_HEIGHTS if tag == "bucketed" else ENGINE_HEIGHTS
    for r in jobs["results"][job]:
        got = r["engine"][run]
        # each launch: (pad_h, n_pad, width) under predict_images
        launches = got["launches"]
        assert sum(n for _, n, _ in launches) >= len(heights)
        want = [expected_counts(n_pad // n_data, pad_h, w, n_model,
                                got["mesh"][1])
                for pad_h, n_pad, w in launches]
        assert got["exchanges"] == (sum(e for e, _, _, _ in want),
                                    sum(b for _, b, _, _ in want)), run
        assert got["reductions"] == (sum(c for _, _, c, _ in want),
                                     sum(b for _, _, _, b in want)), run
