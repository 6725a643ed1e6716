"""PyTorch port: the rest of the ResNet zoo under the JAX mesh's
``model`` axis (parallel/spatial.py): DeepLab's ASPP on width strips
(halos wider than a strip, the pooled sum over the whole width) and int8
under any ``(data, model)`` mesh, on the CPU over gloo.

Two jobs of spawned ranks (``_run_rank``, a ``file://`` rendezvous under
the module's tmp directory, a timeout of their own) run once for the
module, started together: two ranks (meshes (1, 2) and (2, 1)) and four
ranks (meshes (1, 4) and (2, 2)). Each rank saves what it computed and
the tests compare in this process, whose port references run on one
thread as the ranks do (the CPU's 1x1 conv sums in another order on
two):

- the multi-hop ``exchange_halo``: halos from 1 column to past the whole
  image, float32 and int8, NCHW and channels_last (and the NHWC
  exchange), each widened strip bit-equal to its columns of the
  zero-padded full tensor, and the bytes it counted those that came from
  another rank;
- the ASPP alone, float32, eval, folded and not, on two maps with
  ``valid_h``: 8 x 32 (rates 12 and 24 exchange, 36 takes the centre-tap
  shortcut; at n 4 a strip of 8 columns is narrower than every rate) and
  8 x 8 (every rate takes the shortcut): each rank's output bit-equal to
  its columns of the one-process ASPP;
- the tiny DeepLab (tests/torch_port_common.py, JAX-initialised, carried
  across) at batch 2 x 64 x 256 under (1, 4) and (2, 2): bit-equal to the
  port's one process, within rtol = atol = 1e-4 of JAX's unsharded apply
  and of JAX's own (2, 2)-mesh apply on the 8 CPU devices of
  tests/conftest.py (the tolerance of tests/test_torch_deeplab.py);
- the engine with the tiny DeepLab, float32: class maps bit-equal under
  ``mesh=None``, (1, 2), (1, 4) and (2, 2); rank 0's final_stats.csv byte
  for byte the one process's;
- int8 with the tiny FCN (``quantize_int8``) under (2, 1), (1, 2) and
  (2, 2): maps bit-equal to the one-process int8 engine, every rank's
  int8 state (weights and scales) bit-equal to the one process's, the
  first chunk decoded once on each rank, the calibrated model exported
  and loaded by a new engine under (1, 2) bit-equal, and agreement with
  the JAX int8 engine under a (2, 2) mesh >= 0.98 (the floor of
  tests/test_torch_quantize_engine.py); the int8 tiny DeepLab under
  (1, 2) bit-equal to one process;
- the halo bytes and the pooled-reduction bytes of each engine run equal
  the count from the shapes.
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, tiny_checkpoint,
                               tiny_deeplab_jax_model,
                               tiny_deeplab_torch_model, tiny_torch_model,
                               tiny_variables,
                               write_processed)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

# random weights overflow a downsample branch's clip range now and then
pytestmark = pytest.mark.filterwarnings("ignore:int8 calibration")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 17
# the engines' folder: 64-wide (a strip of 16 at n_model 4: 2 feature
# columns, narrower than layer4's dilation and every ASPP rate), height
# buckets 64, 96 and 128 at height_bucket 32
WIDTH = 64
HEIGHTS = (64, 40, 56, 72, 96, 100, 128)
WOOD = ("sapin", "epinette_gelee", "sapin", "sapin", "epinette_gelee",
        "sapin", "epinette_gelee")
ENGINE_CONFIG = dict(batch_size=4, height_bucket=32, figure_dpi=50)
# (n_pad, pad_h) of the folder's launches at batch 4 and bucket 32
LAUNCHES = ((4, 64), (2, 96), (2, 128))
# the exchange's (left, right) halos on strips of HALO_STRIP columns: up
# to a whole strip, past it, over several ranks, past the whole image
HALO_STRIP = 8
HALOS = ((1, 1), (3, 0), (0, 5), (8, 8), (9, 2), (2, 17), (25, 30),
         (40, 40))
# the int8 engines' checkpoints and image widths: 128 for the DeepLab, so
# that its features (16 columns) take the ASPP's exchange at rate 12
CKPTS = {"_tiny_test": "tiny.pt", "_tiny_deeplab": "deeplab.pt"}
INT8_WIDTHS = {"_tiny_test": WIDTH, "_tiny_deeplab": 128}
# the ASPP's maps, [B, C, H, W], with valid rows
ASPP_MAPS = {"8x32": (2, 64, 8, 32), "8x8": (2, 64, 8, 8)}
ASPP_VALID_H = (8, 5)
# the tiny DeepLab's batch against JAX
DEEPLAB_X = (2, 64, 256, 3)
# the port against the JAX package (tests/test_torch_deeplab.py)
JAX_TOL = 1e-4
# agreement of the port's int8 maps with the JAX int8 engine's
JAX_INT8_FLOOR = 0.98
TIMEOUT = 300

_RUN = r"""
import sys
import test_torch_width_zoo as t
t._run_rank(*sys.argv[1:])
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _items(width: int = WIDTH):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(SEED)
    return [ProcessedImage(blob_image(rng, h, width), f"img{i}.png", wood)
            for i, (h, wood) in enumerate(zip(HEIGHTS, WOOD))]


def _register():
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg

    tseg.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    tseg.MODEL_FACTORIES["_tiny_deeplab"] = tiny_deeplab_torch_model


def _unregister():
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg

    tseg.MODEL_FACTORIES.pop("_tiny_test", None)
    tseg.MODEL_FACTORIES.pop("_tiny_deeplab", None)


def _engine(pt, name, mesh=None, int8=False):
    """The port engine on a tiny model (``_tiny_test``, the FCN, or
    ``_tiny_deeplab``), float32, on the CPU; ``int8``: quantize_int8."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    _register()
    return NeuralBarkCalculator(
        pt, model_name=name, device="cpu", mesh=mesh,
        config=PredictConfig(model_path=pt, use_bfloat16=False,
                             quantize_int8=int8, **ENGINE_CONFIG))


def _maps(engine, items):
    return {it.fname: m for it, m in engine.predict_images(items)}


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


def _halo_case(n: int) -> dict:
    """The exchange's inputs at n ranks: [2, 3, 5, n x HALO_STRIP] in
    float32 and int8, drawn from SEED."""
    gen = torch.Generator().manual_seed(SEED + n)
    shape = (2, 3, 5, n * HALO_STRIP)
    return {"float32": torch.randn(shape, generator=gen),
            "int8": torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8)}


def _halo_outputs(model) -> dict:
    """Every HALOS exchange of this rank's strip of ``_halo_case``, in
    each dtype and layout: (widened strip, bytes counted)."""
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        EXCHANGES, STRIP_MULTIPLE, exchange_halo, exchange_halo_nhwc,
        strip_range)

    out = {}
    for dtype, x in _halo_case(model.size).items():
        start, stop = strip_range(x.shape[3], model, STRIP_MULTIPLE)
        strip = x[..., start:stop]
        for left, right in HALOS:
            for layout in ("nchw", "channels_last", "nhwc"):
                EXCHANGES.reset()
                if layout == "nhwc":
                    got = exchange_halo_nhwc(
                        strip.permute(0, 2, 3, 1).contiguous(), left, right,
                        model).permute(0, 3, 1, 2)
                else:
                    fmt = (torch.channels_last if layout == "channels_last"
                           else torch.contiguous_format)
                    got = exchange_halo(strip.contiguous(memory_format=fmt),
                                        left, right, model)
                    assert got.is_contiguous(memory_format=fmt)
                out[(dtype, layout, left, right)] = (
                    got.contiguous(), EXCHANGES.bytes)
    return out


def _aspp(folded: bool):
    """A float32 ASPP over 64 channels, eval, its weights (and BN
    statistics) drawn from SEED."""
    from neuralbarkcalculator_tpu_torch.models.heads import ASPP

    gen = torch.Generator().manual_seed(SEED + folded)
    aspp = ASPP(64, folded=folded).eval()
    with torch.no_grad():
        for name, t in [*aspp.named_parameters(), *aspp.named_buffers()]:
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return aspp


def _aspp_maps() -> dict:
    gen = torch.Generator().manual_seed(SEED)
    return {name: torch.randn(shape, generator=gen)
            for name, shape in ASPP_MAPS.items()}


def _aspp_run(aspp, x, valid_h, width=None):
    """(the concat of the ASPP's five branches, its output)."""
    seen = []
    hook = aspp.project[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    try:
        with torch.inference_mode():
            y = aspp(x, valid_h, width=width)
    finally:
        hook.remove()
    return seen[0], y


def _aspp_outputs(model) -> dict:
    """The ASPP, folded and not, on this rank's strip of each map:
    (branches, output, reductions, reduced bytes)."""
    from neuralbarkcalculator_tpu_torch.parallel.spatial import REDUCTIONS

    out = {}
    valid_h = torch.tensor(ASPP_VALID_H)
    for folded in (False, True):
        aspp = _aspp(folded)
        for name, x in _aspp_maps().items():
            w = x.shape[3] // model.size
            REDUCTIONS.reset()
            got = _aspp_run(aspp, x[..., model.rank * w:(model.rank + 1) * w],
                            valid_h, model)
            out[(folded, name)] = (*got, REDUCTIONS.count, REDUCTIONS.bytes)
    return out


def _deeplab_model(out_dir):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into)

    model = tiny_deeplab_torch_model()
    load_state_dict_into(model, torch.load(
        os.path.join(out_dir, "deeplab.pt")))
    return model.eval()


def _deeplab_outputs(mesh, out_dir) -> np.ndarray:
    """The tiny DeepLab's split forward of this rank's rows and strip."""
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        stem_columns, stem_edge_pads)

    model = _deeplab_model(out_dir)
    halo = model.backbone.stem_halo
    x = np.load(os.path.join(out_dir, "x.npy"))
    rows = mesh.data.rank_slice(x.shape[0])
    strip = torch.from_numpy(np.ascontiguousarray(
        x[rows][:, :, stem_columns(x.shape[2], mesh.model, halo,
                                   model.backbone.strip_multiple)]))
    strip = F.pad(strip, (0, 0, *stem_edge_pads(mesh.model, halo)))
    with torch.inference_mode():
        return model(strip, width=mesh.model).numpy()


def _counted_maps(engine, items) -> dict:
    """predict_images' maps and the halo and reduction counters around
    them."""
    from neuralbarkcalculator_tpu_torch.models.quantize import state_digest
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        QuantizedSegmentationModel)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        EXCHANGES, REDUCTIONS)

    EXCHANGES.reset()
    REDUCTIONS.reset()
    maps = _maps(engine, items)
    out = {"maps": maps, "exchanges": (EXCHANGES.count, EXCHANGES.bytes),
           "reductions": (REDUCTIONS.count, REDUCTIONS.bytes)}
    if isinstance(engine.model, QuantizedSegmentationModel):
        out["digest"] = state_digest(engine.model)
    return out


def _deeplab_engine(world, mesh, out_dir, tag) -> dict:
    """The float32 DeepLab engine under ``mesh``: predict_images' maps
    and counters, then predict over a root of this rank's own (only rank
    0 may write there)."""
    engine = _engine(os.path.join(out_dir, "deeplab.pt"), "_tiny_deeplab",
                     mesh)
    items = _items()
    out = _counted_maps(engine, items)
    root = os.path.join(out_dir, f"{tag}-root-{world.rank}")
    write_processed(root, items)
    csv = engine.predict(root, progress=False)
    out.update(csv=csv, csv_bytes=None if csv is None
               else open(csv, "rb").read(), files=_result_files(root),
               mesh=(mesh.data_rank, mesh.model_rank))
    return out


def _int8_engine(mesh, out_dir, name="_tiny_test") -> dict:
    """The int8 engine (quantize_int8) under ``mesh`` over INT8_WIDTHS[name]
    wide images: its maps, counters and int8 state digest."""
    engine = _engine(os.path.join(out_dir, CKPTS[name]), name, mesh,
                     int8=True)
    return _counted_maps(engine, _items(INT8_WIDTHS[name]))


def _int8_decode_and_export(world, mesh, out_dir) -> dict:
    """Under ``mesh``: predict over a root of this rank's own with every
    image read counted (the calibration's first chunk among them); rank 0
    exports the calibrated model and a new engine on the file predicts
    under the mesh."""
    from neuralbarkcalculator_tpu_torch.models.quantize import save_quantized
    from neuralbarkcalculator_tpu_torch.pipeline import predict as pmod

    engine = _engine(os.path.join(out_dir, "tiny.pt"), "_tiny_test", mesh,
                     int8=True)
    root = os.path.join(out_dir, f"decode-root-{world.rank}")
    write_processed(root, _items())
    reads = []
    load = pmod.load_image_u8

    def counting(path, *a, **k):
        reads.append(os.path.basename(path))
        return load(path, *a, **k)

    pmod.load_image_u8 = counting
    try:
        engine.predict(root, progress=False)
    finally:
        pmod.load_image_u8 = load
    path = os.path.join(out_dir, "tiny.int8.pt")
    if world.is_main:
        save_quantized(path, engine.model, "_tiny_test")
    world.barrier()
    return {"reads": reads, "export": _maps(
        _engine(path, "_tiny_test", mesh), _items())}


def _job_two(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    m12, m21 = make_mesh(1, 2, world), make_mesh(2, 1, world)
    return {"halo": _halo_outputs(m12.model),
            "aspp": _aspp_outputs(m12.model),
            "deeplab": {"(1, 2)": _deeplab_engine(world, m12, out_dir,
                                                  "m12")},
            "int8": {("_tiny_test", "(1, 2)"): _int8_engine(m12, out_dir),
                     ("_tiny_test", "(2, 1)"): _int8_engine(m21, out_dir),
                     ("_tiny_deeplab", "(1, 2)"): _int8_engine(
                         m12, out_dir, "_tiny_deeplab")},
            "decode": _int8_decode_and_export(world, m12, out_dir)}


def _job_four(world, out_dir) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.distributed import make_mesh

    m14, m22 = make_mesh(1, 4, world), make_mesh(2, 2, world)
    return {"halo": _halo_outputs(m14.model),
            "aspp": _aspp_outputs(m14.model),
            "model (1, 4)": _deeplab_outputs(m14, out_dir),
            "model (2, 2)": _deeplab_outputs(m22, out_dir),
            "mesh (2, 2)": (m22.data_rank, m22.model_rank),
            "deeplab": {"(1, 4)": _deeplab_engine(world, m14, out_dir,
                                                  "m14"),
                        "(2, 2)": _deeplab_engine(world, m22, out_dir,
                                                  "m22")},
            "int8": {("_tiny_test", "(2, 2)"): _int8_engine(m22, out_dir)}}


_JOBS = {"two": _job_two, "four": _job_four}


# ------------------------------------------------------- the jobs' data

def _jax_deeplab_applies(variables, x):
    """The JAX tiny DeepLab's unsharded apply of ``x`` and its apply
    under a (2, 2) mesh of the CPU devices."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.parallel.mesh import (ShardingRules,
                                                        make_mesh)

    model = tiny_deeplab_jax_model()

    def fwd(v, b):
        return model.apply(v, b, train=False)

    unsharded = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)))
    rules = ShardingRules(make_mesh(n_data=2, n_model=2))
    sharded = np.asarray(jax.jit(
        fwd, in_shardings=(rules.replicated, rules.image_batch))(
            jax.device_put(variables, rules.replicated),
            jax.device_put(x, rules.image_batch)))
    return unsharded, sharded


def _jax_int8_maps(pt, items):
    """The JAX int8 engine's maps (quantize_int8, float32, its Pallas
    kernel in interpret mode) under a (2, 2) mesh of the CPU devices."""
    from neuralbarkcalculator_tpu.config import PredictConfig as JaxConfig
    from neuralbarkcalculator_tpu.models import segmentation as jseg
    from neuralbarkcalculator_tpu.parallel.mesh import make_mesh
    from neuralbarkcalculator_tpu.pipeline.predict import (
        NeuralBarkCalculator as JaxEngine)
    from torch_port_common import tiny_jax_model

    jseg.MODEL_FACTORIES["_tiny_test"] = lambda dtype=None: tiny_jax_model(
        dtype)
    try:
        engine = JaxEngine(
            pt, mesh=make_mesh(n_data=2, n_model=2), model_name="_tiny_test",
            config=JaxConfig(model_path=pt, use_pallas=True,
                             pallas_interpret=True, use_bfloat16=False,
                             quantize_int8=True, **ENGINE_CONFIG))
        return _maps(engine, items)
    finally:
        jseg.MODEL_FACTORIES.pop("_tiny_test", None)


def _one_process(out, items) -> dict:
    """The port's one-process references, on one thread."""
    from neuralbarkcalculator_tpu_torch.models.quantize import state_digest

    x = torch.from_numpy(np.load(out / "x.npy"))
    with torch.inference_mode():
        deeplab = _deeplab_model(str(out))(x).numpy()
    refs = {"deeplab": deeplab}
    float_engine = _engine(str(out / "deeplab.pt"), "_tiny_deeplab")
    refs["deeplab_maps"] = _maps(float_engine, items)
    root = str(out / "one-root")
    write_processed(root, items)
    with open(float_engine.predict(root, progress=False), "rb") as f:
        refs["deeplab_csv"] = f.read()
    refs["deeplab_files"] = _result_files(root)
    shutil.rmtree(root, ignore_errors=True)
    for name, ckpt in CKPTS.items():
        engine = _engine(str(out / ckpt), name, int8=True)
        refs[f"int8 {name}"] = _maps(engine, _items(INT8_WIDTHS[name]))
        refs[f"int8 {name} digest"] = state_digest(engine.model)
    return refs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both spawned jobs' results by rank, the JAX results (the tiny
    DeepLab's applies, the int8 engine under a (2, 2) mesh) and the
    port's one-process references. The parent computes them while the
    ranks run."""
    import jax

    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    out = tmp_path_factory.mktemp("width_zoo")
    variables = tiny_variables(seed=SEED, model=tiny_deeplab_jax_model())
    torch.save(variables_to_state_dict(variables), out / "deeplab.pt")
    x = np.random.default_rng(SEED).random(DEEPLAB_X, dtype=np.float32)
    np.save(out / "x.npy", x)
    pt = tiny_checkpoint(str(out / "tiny.pt"), seed=SEED)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = {job: [subprocess.Popen(
        [sys.executable, "-c", _RUN, job, str(rank), str(size),
         f"file://{out / f'rendezvous-{job}'}", str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)] for job, size in (("two", 2), ("four", 4))}
    items = _items()
    try:
        applies = _jax_deeplab_applies(
            jax.tree.map(np.asarray, variables), x)
        jax_int8 = _jax_int8_maps(pt, items)
        refs = _one_process(out, items)
        deadline = time.monotonic() + TIMEOUT
        errs = {job: [p.communicate(
            timeout=max(1.0, deadline - time.monotonic()))[1] for p in ps]
            for job, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
        _unregister()
    for job, ps in procs.items():
        for p, err in zip(ps, errs[job]):
            assert p.returncode == 0, f"{job}: {err[-3000:]}"
    results = {job: [torch.load(out / f"{job}-{rank}.pt", weights_only=False)
                     for rank in range(len(ps))]
               for job, ps in procs.items()}
    yield {"results": results, "jax": applies, "jax_int8": jax_int8,
           "refs": refs}
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("job,n", [("two", 2), ("four", 4)])
def test_multi_hop_halo_equals_the_padded_tensor(jobs, job, n):
    """Each HALOS exchange, float32 and int8, NCHW, channels_last and
    NHWC: rank m's widened strip bit-equal to the columns [m w, m w +
    left + w + right) of the full tensor zero-padded by (left, right),
    and the bytes counted those of the columns that came from another
    rank (not the zeros)."""
    import torch.nn.functional as F

    ranks = [r["halo"] for r in jobs["results"][job]]
    w = HALO_STRIP
    for dtype, x in _halo_case(n).items():
        for left, right in HALOS:
            padded = F.pad(x, (left, right))
            for m, r in enumerate(ranks):
                want = padded[..., m * w:(m + 1) * w + left + right]
                cols = min(left, m * w) + min(right, (n - 1 - m) * w)
                for layout in ("nchw", "channels_last", "nhwc"):
                    got, nbytes = r[(dtype, layout, left, right)]
                    key = (dtype, layout, left, right, m)
                    assert got.dtype == x.dtype, key
                    assert torch.equal(got, want), key
                    assert nbytes == cols * x[..., :1].numel() * \
                        x.element_size(), key


@pytest.mark.parametrize("folded", [False, True], ids=["bn", "folded"])
@pytest.mark.parametrize("job,n", [("two", 2), ("four", 4)])
def test_split_aspp_equals_one_process(jobs, job, n, folded):
    """The ASPP on each rank's strip of an 8 x 32 map (rates 12 and 24
    take the exchange, 36 the centre-tap shortcut; at n 4 a strip of 8
    columns is narrower than every rate, and at rate 12 the strip alone
    would take the shortcut) and of an 8 x 8 map (every rate takes it),
    with valid rows. The strips' five branches, side by side, bit-equal
    to the one-process ASPP's (the 1x1 branch, the three atrous branches
    fed by the exchange, the pooled branch from the split-invariant sum);
    the output after the 1x1 projection over the 1280 concatenated
    channels within rtol 1e-5 / atol 1e-6, as the halo primitives of
    tests/test_torch_width_partition.py are held: on this CPU oneDNN's 1x1
    conv over that many channels sums in an order that depends on the
    map's width (a [2, 1280, 8, 32] map's two halves differ from its
    columns in the last bits, one thread; the same products through
    ``F.linear`` do not), so no split of it is bit-equal. One pooled
    reduction, of [B, C, W] float32."""
    ranks = [r["aspp"] for r in jobs["results"][job]]
    aspp = _aspp(folded)
    valid_h = torch.tensor(ASPP_VALID_H)
    for name, x in _aspp_maps().items():
        branches, want = _aspp_run(aspp, x, valid_h)
        got = torch.cat([r[(folded, name)][0] for r in ranks], dim=3)
        assert torch.equal(got, branches), name
        got = torch.cat([r[(folded, name)][1] for r in ranks], dim=3)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=name)
        b, c, _, w = x.shape
        for r in ranks:
            assert r[(folded, name)][2:] == (1, b * c * w * 4), name


@pytest.mark.parametrize("mesh", ["(1, 4)", "(2, 2)"])
def test_split_deeplab_matches_one_process_and_jax(jobs, mesh):
    """The tiny DeepLab at batch 2 x 64 x 256 under the mesh: the model
    ranks of a data row hold the same full-width logits, within rtol 1e-5
    / atol 1e-6 of the port's one process (its 1x1 convs over 1024 and
    more channels sum in a width-dependent order on this CPU, as the
    ASPP's projection), and within 1e-4 of JAX's unsharded and (2,
    2)-mesh applies."""
    ranks = jobs["results"]["four"]
    if mesh == "(1, 4)":
        got = ranks[0]["model (1, 4)"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["model (1, 4)"], got)
    else:
        by_cell = {r["mesh (2, 2)"]: r["model (2, 2)"] for r in ranks}
        for d in range(2):
            np.testing.assert_array_equal(by_cell[(d, 0)], by_cell[(d, 1)])
        got = np.concatenate([by_cell[(0, 0)], by_cell[(1, 0)]])
    assert got.shape == DEEPLAB_X
    np.testing.assert_allclose(got, jobs["refs"]["deeplab"], rtol=1e-5,
                               atol=1e-6)
    unsharded, sharded = jobs["jax"]
    np.testing.assert_allclose(got, unsharded, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got, sharded, rtol=JAX_TOL, atol=JAX_TOL)


MESHES = {"(1, 2)": (1, 2), "(2, 1)": (2, 1), "(1, 4)": (1, 4),
          "(2, 2)": (2, 2)}


def _deeplab_runs(jobs):
    """{(mesh, rank): the float32 DeepLab engine's result}."""
    return {(mesh, rank): r["deeplab"][mesh]
            for job in ("two", "four")
            for rank, r in enumerate(jobs["results"][job])
            for mesh in r["deeplab"]}


def _int8_runs(jobs, name="_tiny_test"):
    """{(mesh, rank): the int8 engine's result} of the model ``name``."""
    return {(mesh, rank): run
            for job in ("two", "four")
            for rank, r in enumerate(jobs["results"][job])
            for (n, mesh), run in r["int8"].items() if n == name}


def test_deeplab_engine_maps_equal_across_meshes(jobs):
    """The float32 DeepLab engine's class maps bit-equal under mesh=None,
    (1, 2), (1, 4) and (2, 2) on every rank."""
    want = jobs["refs"]["deeplab_maps"]
    classes = set()
    for label, r in _deeplab_runs(jobs).items():
        assert sorted(r["maps"]) == sorted(want), label
        for fname, m in want.items():
            np.testing.assert_array_equal(r["maps"][fname], m,
                                          err_msg=f"{label} {fname}")
            classes |= set(np.unique(m).tolist())
    assert len(classes) >= 2  # the maps are not trivially one class


def test_deeplab_rank0_writes_the_one_process_csv(jobs):
    """Grid rank 0's final_stats.csv byte for byte the one-process CSV,
    its artifacts the same files; the other ranks write no file."""
    for (label, rank), r in _deeplab_runs(jobs).items():
        if rank == 0:
            assert r["csv_bytes"] == jobs["refs"]["deeplab_csv"], label
            assert r["files"] == jobs["refs"]["deeplab_files"], label
        else:
            assert r["csv"] is None and r["files"] == [], (label, rank)


@pytest.mark.parametrize("mesh", ["(1, 2)", "(2, 1)", "(2, 2)"])
def test_int8_engine_equals_one_process(jobs, mesh):
    """The int8 FCN engine (quantize_int8) under the mesh: every rank's
    maps bit-equal to the one-process int8 engine's, and its int8 state
    (weights and scales) bit-equal to the one process's."""
    want = jobs["refs"]["int8 _tiny_test"]
    digest = jobs["refs"]["int8 _tiny_test digest"]
    runs = {k: r for k, r in _int8_runs(jobs).items() if k[0] == mesh}
    assert len(runs) == (4 if mesh == "(2, 2)" else 2)
    for key, r in runs.items():
        assert r["digest"] == digest, key
        for fname, m in want.items():
            np.testing.assert_array_equal(r["maps"][fname], m,
                                          err_msg=f"{key} {fname}")


def test_int8_deeplab_equals_one_process(jobs):
    """The int8 tiny DeepLab under (1, 2): maps and int8 state bit-equal
    to one process's."""
    want = jobs["refs"]["int8 _tiny_deeplab"]
    runs = _int8_runs(jobs, "_tiny_deeplab")
    assert len(runs) == 2
    for key, r in runs.items():
        assert r["digest"] == jobs["refs"]["int8 _tiny_deeplab digest"], key
        for fname, m in want.items():
            np.testing.assert_array_equal(r["maps"][fname], m,
                                          err_msg=f"{key} {fname}")


def test_int8_first_chunk_decoded_once_on_each_rank(jobs):
    """Under (1, 2), predict with quantize_int8 reads every image once on
    each rank: the calibration's first chunk is handed to the pump."""
    names = sorted(it.fname for it in _items())
    for rank, r in enumerate(jobs["results"]["two"]):
        assert sorted(r["decode"]["reads"]) == names, rank


def test_int8_export_loads_under_a_mesh(jobs):
    """The calibrated model exported by rank 0 (save_quantized) and
    loaded by a new engine under (1, 2): maps bit-equal to the one-process
    int8 engine's."""
    want = jobs["refs"]["int8 _tiny_test"]
    for rank, r in enumerate(jobs["results"]["two"]):
        for fname, m in want.items():
            np.testing.assert_array_equal(r["decode"]["export"][fname], m,
                                          err_msg=f"rank {rank} {fname}")


def test_int8_agrees_with_the_jax_mesh_engine(jobs):
    """The int8 maps under (2, 2) against the JAX int8 engine under a
    (2, 2) mesh: agreement >= 0.98 (each framework's float stem and
    normalization round on their own, so a few scales differ in the last
    bits and near-tie pixels flip)."""
    jmaps = jobs["jax_int8"]
    for key, r in _int8_runs(jobs).items():
        if key[0] != "(2, 2)":
            continue
        agree = (sum(int((r["maps"][k] == m).sum()) for k, m in jmaps.items())
                 / sum(m.size for m in jmaps.values()))
        assert agree >= JAX_INT8_FLOOR, (key, agree)


def _received_bytes(left: int, right: int, rows: int, channels: int,
                    height: int, w: int, n: int, m: int, elem: int) -> int:
    """The bytes rank m of n receives for a (left, right) halo of a strip
    of w columns: the columns that lie on other ranks."""
    cols = min(left, m * w) + min(right, (n - 1 - m) * w)
    return elem * rows * channels * height * cols


def _expected_bytes(head: str, int8: bool, width: int, rows: int,
                    pad_h: int, n: int, m: int) -> tuple[int, int, int]:
    """(exchanges, halo bytes, reduced bytes) of rank m of n in one
    launch of ``rows`` images at ``pad_h``, from the tiny model's shapes:
    the max pool's (1, 0) on the stem's 64 float32 channels, each block's
    conv2 (int8: 1-byte elements), then the FCN head's 3x3; or the ASPP's
    one exchange at the widest rate that reads past its centre tap (float:
    unless the rate reaches past the map's height and width; int8: past
    its width) and the DeepLab head's 3x3, with the pooled sum's [B, C,
    W] float32 or [B, C] int32."""
    elem = 1 if int8 else 4
    exchanges = 1
    total = _received_bytes(1, 0, rows, 64, pad_h // 2, width // 2 // n, n,
                            m, 4)
    height, w = pad_h // 4, width // 4 // n
    backbone = tiny_torch_model().backbone
    for stage in range(4):
        for block in getattr(backbone, f"layer{stage + 1}"):
            c = block.conv2
            s, d = c.stride[1], c.dilation[1]
            total += _received_bytes(d, 2 * d - d - s + 1, rows,
                                     c.in_channels, height, w, n, m, elem)
            exchanges += 1
            height //= s
            w //= s
    full_w = w * n
    reduced = 0
    if head == "fcn":
        total += _received_bytes(1, 1, rows, 2048, height, w, n, m, elem)
        return exchanges + 1, total, reduced
    rates = [d for d in (12, 24, 36)
             if d < full_w or (not int8 and d < height)]
    if rates:
        total += _received_bytes(max(rates), max(rates), rows, 2048, height,
                                 w, n, m, elem)
        exchanges += 1
    reduced = rows * 2048 * 4 * (1 if int8 else full_w)
    total += _received_bytes(1, 1, rows, 256, height, w, n, m, elem)
    return exchanges + 1, total, reduced


def _count_cases(jobs):
    """(label, result, head, int8, image width) of every engine run."""
    cases = [(label, r, "deeplab", False, WIDTH)
             for label, r in _deeplab_runs(jobs).items()]
    for name, head in (("_tiny_test", "fcn"), ("_tiny_deeplab", "deeplab")):
        cases += [(label, r, head, True, INT8_WIDTHS[name])
                  for label, r in _int8_runs(jobs, name).items()]
    return cases


@pytest.mark.parametrize("kind", ["deeplab float32", "fcn int8",
                                  "deeplab int8"])
def test_halo_and_reduction_bytes_equal_the_shapes(jobs, kind):
    """Each rank's exchanges, received halo bytes, pooled reductions and
    their bytes over the folder's launches equal what the tiny model's
    shapes give (the int8 runs' first chunk includes no calibration
    exchange: rank 0 calibrates at full width)."""
    head, dtype = kind.split()
    int8 = dtype == "int8"
    seen = 0
    for label, r, h, q, width in _count_cases(jobs):
        if (h, q) != (head, int8):
            continue
        seen += 1
        n_data, n_model = MESHES[label[0]]
        if n_model == 1:
            assert r["exchanges"] == (0, 0) and r["reductions"] == (0, 0)
            continue
        want = [_expected_bytes(head, int8, width, n_pad // n_data, pad_h,
                                n_model, label[1] % n_model)
                for n_pad, pad_h in LAUNCHES]
        assert r["exchanges"] == (sum(e for e, _, _ in want),
                                  sum(b for _, b, _ in want)), label
        n_red = len(LAUNCHES) if head == "deeplab" else 0
        assert r["reductions"] == (n_red, sum(x for _, _, x in want)), label
    assert seen
