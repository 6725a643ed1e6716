"""PyTorch port: the JAX package's checkpoints, read without jax, flax,
orbax, tensorstore or msgpack, against those packages.

- ``io/flax_msgpack``: its trees equal ``flax.serialization.
  msgpack_restore``'s leaf for leaf, dtype for dtype and bit for bit (the
  tiny FCN and DeepLab variables, EfficientNet-B0, the full-width
  fcn_resnet50 init, a JAX int8 tree, edge leaves, a chunked leaf), and
  ``to_bytes`` writes the bytes of ``flax.serialization.to_bytes``.
- ``io/orbax``: its trees equal the JAX package's ``restore_variables``
  (orbax) on directories the JAX package writes (``save_variables``,
  ``export_best_model``, a per-epoch ``save_epoch`` with ``opt_state`` and
  ``step``) and on edge trees; its OCDBT key listing and raw values equal
  tensorstore's ocdbt KvStore (with interior B+tree nodes and without
  compression too).
- The engines: float32 maps and final_stats.csv bytes of the port equal
  the JAX engine's on the same ``.msgpack`` and orbax directories; the
  JAX ``.int8.msgpack`` within the int8 parity floor of
  tests/test_torch_quantize_engine.py; the CLIs take every form.
- ``state_dict_to_variables`` equals JAX ``torch_state_dict_to_variables``;
  ``tools/export_torch_checkpoint`` writes the JAX tool's tensors.
- Errors: no libzstd, a wrong int8 version byte, a wrong model name.
"""
import functools
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, normalized, orbax_fixture_tree,
                               tiny_deeplab_jax_model, tiny_engines,
                               tiny_jax_model, tiny_torch_model,
                               tiny_variables, write_processed, zoo_model)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_tree")
# agreement of the port's int8 maps with the JAX int8 engine's
# (tests/test_torch_quantize_engine.py)
JAX_INT8_FLOOR = 0.98

pytestmark = pytest.mark.filterwarnings(
    "ignore:int8 calibration", "ignore:The given buffer is not writable")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ the trees

@functools.cache
def _variables(seed: int, deeplab: bool = False) -> dict:
    """``tiny_variables`` (its JAX init takes seconds), shared: no test
    mutates it."""
    return tiny_variables(seed=seed,
                          model=tiny_deeplab_jax_model() if deeplab else None)


def _jax_b0_variables():
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)

    return torch_state_dict_to_variables(
        zoo_model("fcn_efficientnet_b0", 4).state_dict(),
        efficientnet_variant=0)


@functools.cache
def _jax_int8_variables():
    """The JAX package's quantized {'params'} of the tiny model."""
    from neuralbarkcalculator_tpu.models.quantize import quantize_model

    rng = np.random.default_rng(6)
    batches = [normalized([blob_image(rng, 32, 32)]) for _ in range(2)]
    _, qvars = quantize_model(tiny_jax_model(), _variables(6),
                              batches)
    import jax
    return jax.tree.map(np.asarray, qvars)


def _edge_tree():
    import ml_dtypes

    rng = np.random.default_rng(9)
    return {
        "zero_d": np.asarray(np.float32(2.5)), "empty": np.zeros((0, 3)),
        "bool": np.array([True, False, True]),
        "int64": rng.integers(-2 ** 62, 2 ** 62, (5,)),
        "bf16": np.asarray(rng.standard_normal((3, 7)), ml_dtypes.bfloat16),
        "bf16_scalar": ml_dtypes.bfloat16(-3.25),
        "complex": np.asarray([1 + 2j, -3.5 - 4j], np.complex64),
        "np_scalar": np.float32(1.5), "py_complex": 1.5 - 2j, "none": None,
        "flag": True, "float": 0.1,
        "ints": [0, -1, 127, 128, -32, -33, 255, 256, -200, 70000, -70000,
                 2 ** 40, -2 ** 40, 2 ** 63 + 1],
        "text": "x" * 40, "nested": [np.arange(3), {"q": np.int8(-3)}],
        "large": rng.standard_normal(20000).astype(np.float32),
    }


_TREES = {
    "tiny_fcn": lambda: _variables(0),
    "tiny_deeplab": lambda: _variables(1, deeplab=True),
    "efficientnet_b0": _jax_b0_variables,
    "jax_int8": _jax_int8_variables,
    "edge_leaves": _edge_tree,
}


@pytest.fixture(scope="module")
def full_fcn_resnet50():
    """The JAX package's full-width fcn_resnet50 ``model.init`` at 64x64,
    as numpy."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.segmentation import MODEL_FACTORIES

    model = MODEL_FACTORIES["fcn_resnet50"]()
    variables = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables)


def _tree(name, request):
    if name == "full_fcn_resnet50":
        return request.getfixturevalue("full_fcn_resnet50")
    return _TREES[name]()


def assert_same_tree(want, got, path=""):
    """``got`` (the port's) equals ``want`` (flax's or orbax's): the same
    containers and keys, each array leaf of the same dtype, shape and
    bytes (a bfloat16 leaf as a torch.bfloat16 tensor of the same bits),
    each scalar of the same type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif getattr(want, "dtype", None) is not None and \
            want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -------------------------------------------------------------- msgpack

@pytest.mark.parametrize("name", [*_TREES, "full_fcn_resnet50"])
def test_msgpack_read_equals_flax(name, request):
    import flax.serialization

    from neuralbarkcalculator_tpu_torch.io import flax_msgpack

    data = flax.serialization.to_bytes(_tree(name, request))
    assert_same_tree(flax.serialization.msgpack_restore(data),
                     flax_msgpack.restore(bytearray(data)))


@pytest.mark.parametrize("name", [*_TREES, "full_fcn_resnet50"])
def test_msgpack_write_equals_flax(name, request):
    import flax.serialization

    from neuralbarkcalculator_tpu_torch.io import flax_msgpack

    tree = _tree(name, request)
    assert flax_msgpack.to_bytes(tree) == flax.serialization.to_bytes(tree)


def test_msgpack_chunked_leaves(monkeypatch):
    """flax splits leaves over MAX_CHUNK_SIZE bytes into chunk maps (made
    small here); the reader joins them, the writer splits them alike."""
    import flax.serialization

    from neuralbarkcalculator_tpu_torch.io import flax_msgpack

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(3)
    tree = {"a": {"k": rng.standard_normal((30, 17)).astype(np.float32)},
            "b": rng.integers(0, 9, 2001, dtype=np.int8),
            "c": np.ones(3, np.float32)}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert flax_msgpack.to_bytes(tree) == data
    got = flax_msgpack.restore(data)
    assert_same_tree(flax.serialization.msgpack_restore(data), got)
    assert_same_tree(tree, got)


def test_msgpack_leaves_are_views(tmp_path):
    """Every array leaf is a writable view of the one buffer read (no copy
    per leaf); ``load`` reads a file into such a buffer."""
    import flax.serialization

    from neuralbarkcalculator_tpu_torch.io import flax_msgpack

    variables = _variables(0)
    data = flax.serialization.to_bytes(variables)
    buf = bytearray(data)
    whole = np.frombuffer(buf, np.uint8)
    got = flax_msgpack.restore(buf)
    leaves = [got["params"]["classifier"]["conv1"]["kernel"],
              got["batch_stats"]["backbone"]["bn1"]["var"]]
    for leaf in leaves:
        assert leaf.flags.writeable and np.shares_memory(leaf, whole)
    path = tmp_path / "m.msgpack"
    path.write_bytes(data)
    assert_same_tree(variables, flax_msgpack.load(str(path)))


@pytest.mark.parametrize("damage", ["truncated", "trailing", "bad_byte",
                                    "ext_code"])
def test_msgpack_malformed_input(damage, tmp_path):
    import flax.serialization

    from neuralbarkcalculator_tpu_torch.io import flax_msgpack

    data = bytearray(flax.serialization.to_bytes(
        {"a": np.arange(4, dtype=np.float32), "b": 1}))
    if damage == "truncated":
        data = data[:-3]
    elif damage == "trailing":
        data += b"\x00"
    elif damage == "bad_byte":
        data[0] = 0xC1
    else:
        at = data.index(b"\xc7")  # ext 8 of the ndarray: its type byte
        data[at + 2] = 7
    path = tmp_path / "bad.msgpack"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"bad\.msgpack: .* at byte \d+"):
        flax_msgpack.load(str(path))


# ---------------------------------------------------------------- orbax

def _save_epoch_dir(directory: str) -> str:
    """A per-epoch checkpoint as the JAX trainer writes it: params,
    batch_stats, its Adam opt_state and the step."""
    from neuralbarkcalculator_tpu.train.checkpoint import (
        ExperimentCheckpoints)
    from neuralbarkcalculator_tpu.train.optim import adam

    variables = _variables(0)
    ckpts = ExperimentCheckpoints(directory)
    opt_state = adam(1e-3, 1e-4).init(variables["params"])
    ckpts.save_epoch(3, {**variables, "opt_state": opt_state, "step": 42},
                     {"val_miou": 0.5})
    return os.path.join(directory, "checkpoint_epoch_3")


def _orbax_dir(kind: str, directory: str) -> str:
    import orbax.checkpoint as ocp
    from neuralbarkcalculator_tpu.train.checkpoint import (
        ExperimentCheckpoints, save_variables)

    if kind == "save_variables":
        return save_variables(os.path.join(directory, "v"),
                              _variables(0))
    if kind == "best_model":
        return ExperimentCheckpoints(directory).export_best_model(
            _variables(1, deeplab=True))
    if kind == "per_epoch":
        return _save_epoch_dir(directory)
    path = os.path.join(directory, kind)
    if kind == "edge_leaves":  # scalars become 0-d arrays, as on save
        # orbax saves no empty array, bfloat16 scalar, complex or str
        tree = {k: v for k, v in _edge_tree().items()
                if k not in ("empty", "bf16_scalar", "py_complex", "text",
                             "ints")}
        tree.update(empty_dict={}, seq=[None, np.int32(4)], step=7)
        return save_variables(path, tree)
    assert kind == "several_chunks"  # edge chunks stored at full shape
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((37, 29, 3)).astype(np.float32),
            "q": rng.integers(-127, 128, (50, 33), dtype=np.int8)}
    args = {"w": ocp.SaveArgs(chunk_byte_size=2048),
            "q": ocp.SaveArgs(chunk_byte_size=256)}
    ocp.PyTreeCheckpointer().save(path, tree, save_args=args)
    return path


_ORBAX = ["save_variables", "best_model", "per_epoch", "edge_leaves",
          "several_chunks"]


@pytest.mark.parametrize("kind", _ORBAX)
def test_orbax_read_equals_orbax(kind, tmp_path):
    from neuralbarkcalculator_tpu.train.checkpoint import restore_variables
    from neuralbarkcalculator_tpu_torch.io import orbax

    path = _orbax_dir(kind, str(tmp_path))
    assert_same_tree(restore_variables(path), orbax.load(path))
    if kind == "several_chunks":
        meta = json.loads(bytes(_ocdbt(path).get("w/.zarray")))
        assert meta["chunks"] != meta["shape"]


def _ocdbt(path):
    from neuralbarkcalculator_tpu_torch.io import orbax

    return orbax._Ocdbt(path, orbax._Zstd(path))


def _tensorstore_db(path: str, config: dict) -> str:
    """An OCDBT database written by tensorstore itself, with keys sharing
    prefixes, inline and indirect values."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    with ts.Transaction() as txn:
        for i in range(80):
            kv.with_transaction(txn)[f"leaf{i:03d}/{i % 7}.0"] = (
                b"%d," % i) * (1 + i % 11)
    return path


_DBS = {
    "orbax_fixture": lambda tmp: FIXTURE,
    "per_epoch": lambda tmp: _save_epoch_dir(tmp),
    # a small node bound makes a B+tree of height > 0
    "interior_nodes": lambda tmp: _tensorstore_db(
        os.path.join(tmp, "db"), {"max_decoded_node_bytes": 300,
                                  "max_inline_value_bytes": 10,
                                  "compression": {"id": "zstd",
                                                  "level": 5}}),
    "uncompressed": lambda tmp: _tensorstore_db(
        os.path.join(tmp, "db"), {"max_inline_value_bytes": 16,
                                  "compression": None}),
}


@pytest.mark.parametrize("db", list(_DBS))
def test_ocdbt_equals_tensorstore(db, tmp_path):
    """The key listing and every raw value, against tensorstore's ocdbt
    KvStore (a test-time oracle only)."""
    import tensorstore as ts

    path = _DBS[db](str(tmp_path))
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    keys = kv.list().result()
    mine = _ocdbt(path)
    assert sorted(mine.keys) == sorted(keys)
    for key in keys:
        assert bytes(mine.get(key.decode())) == bytes(
            kv.read(key).result().value), key
    kinds = {type(v) for v in mine.keys.values()}
    assert kinds == {memoryview, tuple}  # inline and indirect values
    if db == "interior_nodes":
        manifest = ts.ocdbt.dump(ts.KvStore.open(
            f"file://{path}/").result()).result()
        assert manifest["versions"][-1]["root_height"] > 0


def test_orbax_fixture_matches_its_seed():
    """tests/fixtures/orbax_tree (written by the JAX package's
    save_variables) holds the tree its seed regenerates, every leaf's
    sha256 as its JSON says, an inline and an indirect value."""
    from neuralbarkcalculator_tpu.train.checkpoint import restore_variables
    from neuralbarkcalculator_tpu_torch.io import orbax
    from torch_port_common import leaf_digests

    tree = orbax_fixture_tree()
    with open(FIXTURE + ".json") as f:
        digests = json.load(f)["leaves"]
    got = orbax.load(FIXTURE)
    assert_same_tree(tree, got)
    assert_same_tree(restore_variables(FIXTURE), got)
    assert leaf_digests(got) == digests == leaf_digests(tree)
    values = _ocdbt(FIXTURE).keys
    assert isinstance(values["params.backbone.conv1.kernel/0.0.0.0".encode()],
                      tuple)
    assert isinstance(values[b"params.backbone.bn1.bias/0"], memoryview)
    assert sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs) < 1 << 20


# ------------------------------------------------------------ conversion

_STATES = {
    "tiny_fcn": (lambda: tiny_torch_model(), "fcn", None),
    "tiny_deeplab": (lambda: zoo_model("deeplabv3_resnet50", 2), "deeplab",
                     None),
    "efficientnet_b0": (lambda: zoo_model("fcn_efficientnet_b0", 3), "fcn",
                        0),
}


@pytest.mark.parametrize("name", list(_STATES))
def test_state_dict_to_variables_equals_jax(name):
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        state_dict_to_variables, variables_to_state_dict)

    make, head, variant = _STATES[name]
    state = make().state_dict()
    got = state_dict_to_variables(state, variant)
    assert_same_tree(torch_state_dict_to_variables(
        state, head=head, efficientnet_variant=variant), got)
    back = variables_to_state_dict(got, variant)
    want = {k: v for k, v in state.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


# --------------------------------------------------------------- engines

def _items(seed=11):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(seed)
    return [ProcessedImage(blob_image(rng, h, 64), f"i{k}.png", wood)
            for k, (h, wood) in enumerate([(64, "sapin"), (40, "sapin"),
                                           (64, "epinette_gelee"),
                                           (32, "epinette_gelee")])]


def _float_checkpoint(kind: str, directory: str) -> str:
    import flax.serialization
    from neuralbarkcalculator_tpu.train.checkpoint import save_variables

    if kind == "msgpack":
        path = os.path.join(directory, "best_model.msgpack")
        with open(path, "wb") as f:
            f.write(flax.serialization.to_bytes(_variables(5)))
        return path
    if kind == "orbax_best_model":
        return save_variables(os.path.join(directory, "best_model"),
                              _variables(5))
    return _save_epoch_dir(directory)


@pytest.mark.parametrize("kind", ["msgpack", "orbax_best_model",
                                  "per_epoch"])
def test_engines_float_equal_jax(kind, tmp_path):
    """The JAX engine and the port's, on the CPU in float32, on the same
    file: equal maps, equal final_stats.csv bytes and dual PNGs. The JAX
    engine folds BatchNorm (its default) and so loads a per-epoch
    checkpoint, taking params and batch_stats; the port does likewise."""
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    path = _float_checkpoint(kind, str(tmp_path))
    jax_eng, eng = tiny_engines(path, batch_size=2, height_bucket=32,
                                figure_dpi=40)
    assert jax_eng.config.fold_bn
    items = _items()
    want = {it.fname: m for it, m in jax_eng.predict_images(items)}
    got = {it.fname: m for it, m in eng.predict_images(items)}
    assert sorted(got) == sorted(want)
    for k, m in want.items():
        np.testing.assert_array_equal(got[k], m)
    csv = {}
    for name, engine in (("jax", jax_eng), ("port", eng)):
        root = str(tmp_path / name)
        write_processed(root, items)
        with open(engine.predict(root, progress=False), "rb") as f:
            csv[name] = f.read()
    assert csv["port"] == csv["jax"]
    assert len(csv["port"].splitlines()) == 1 + len(items)
    for it in items:
        rel = os.path.join("results", "outputs", it.wood_type, it.fname)
        np.testing.assert_array_equal(
            load_image_u8(str(tmp_path / "port" / rel), grayscale=True),
            load_image_u8(str(tmp_path / "jax" / rel), grayscale=True))


def _jax_int8_file(path: str) -> str:
    from neuralbarkcalculator_tpu.models.quantize import save_quantized

    save_quantized(path, _jax_int8_variables())
    return path


def test_engines_jax_int8_msgpack(tmp_path):
    """The JAX package's .int8.msgpack (its save_quantized) through both
    engines: the port starts quantized, with no calibration, and its maps
    agree with the JAX int8 engine's within the int8 parity floor; the
    port's int8 model holds the file's weights exactly."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        quantized_variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        QuantizedSegmentationModel)

    path = _jax_int8_file(str(tmp_path / "m.int8.msgpack"))
    jax_eng, eng = tiny_engines(path, batch_size=2, height_bucket=32)
    assert isinstance(eng.model, QuantizedSegmentationModel)
    assert not eng._quantize_pending
    want = quantized_variables_to_state_dict(_jax_int8_variables())
    state = eng.model.state_dict()
    assert sorted(state) == sorted(want)
    for k, v in want.items():  # the JAX package keeps some scales [1]
        assert torch.equal(state[k].reshape(v.shape), v), k
    items = _items()
    a = {it.fname: m for it, m in jax_eng.predict_images(items)}
    b = {it.fname: m for it, m in eng.predict_images(items)}
    agree = sum(int((a[k] == b[k]).sum()) for k in a) / sum(
        m.size for m in a.values())
    assert agree >= JAX_INT8_FLOOR


def test_cli_predict_serve_quantize_take_jax_forms(tmp_path, monkeypatch):
    """cli/predict.main runs a .msgpack and the .int8.msgpack;
    cli/quantize_checkpoint turns an orbax directory into the port's
    .int8.pt; cli/serve.make_server loads a .msgpack."""
    from neuralbarkcalculator_tpu_torch.cli import predict as cli_predict
    from neuralbarkcalculator_tpu_torch.cli import quantize_checkpoint
    from neuralbarkcalculator_tpu_torch.cli import serve
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        is_quantized_checkpoint)

    monkeypatch.setitem(tseg.MODEL_FACTORIES, "_tiny_test", tiny_torch_model)
    msgpack = _float_checkpoint("msgpack", str(tmp_path))
    best = _float_checkpoint("orbax_best_model", str(tmp_path))
    int8 = _jax_int8_file(str(tmp_path / "m.int8.msgpack"))
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil

    root = tmp_path / "root"
    (root / "samples" / "sapin").mkdir(parents=True)
    for it in _items():
        save_image_u8_pil(str(root / "samples" / "sapin" / it.fname),
                          it.image)
    base = [str(root), "--device", "cpu", "--model", "_tiny_test", "--dpi",
            "40", "--batch_size", "2", "--float32"]
    csv = root / "results" / "final_stats.csv"
    for path in (msgpack, int8):
        cli_predict.main(cli_predict.build_parser().parse_args(
            base + ["--model_path", path]))
        assert len(csv.read_text().splitlines()) == 1 + 4
        csv.unlink()
    out = quantize_checkpoint.main(quantize_checkpoint.build_parser(
        ).parse_args([str(root / "processed"), "--model_path", best,
                      "--model", "_tiny_test", "--device", "cpu",
                      "--float32", "--n", "2"]))
    assert out == best + ".int8.pt" and is_quantized_checkpoint(out)
    srv = serve.make_server(serve.build_parser().parse_args(
        [msgpack, "--device", "cpu", "--model", "_tiny_test", "--port", "0",
         "--float32", "--no_warmup"]))
    try:
        assert srv.state.predictor.calc.model.backbone.folded
    finally:
        srv.server_close()
        srv.state.predictor.close()


# ---------------------------------------------------------------- export

def _run_jax_export(ckpt: str, out: str, monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["export_torch_checkpoint.py", ckpt,
                                      out])
    runpy.run_path(os.path.join(REPO, "tools", "export_torch_checkpoint.py"),
                   run_name="__main__")


@pytest.mark.parametrize("kind", ["msgpack", "orbax"])
def test_export_tool_equals_jax_tool(kind, tmp_path, monkeypatch, request):
    """The port's tools/export_torch_checkpoint writes the tensors of the
    JAX package's tool, key for key and bit for bit (fcn_resnet50: the
    JAX tool's msgpack template is the full-width model's)."""
    import flax.serialization
    from neuralbarkcalculator_tpu.train.checkpoint import save_variables
    from neuralbarkcalculator_tpu_torch.tools import export_torch_checkpoint

    variables = request.getfixturevalue("full_fcn_resnet50")
    if kind == "msgpack":
        ckpt = str(tmp_path / "best_model.msgpack")
        with open(ckpt, "wb") as f:
            f.write(flax.serialization.to_bytes(variables))
    else:
        ckpt = save_variables(str(tmp_path / "best_model"), variables)
    _run_jax_export(ckpt, str(tmp_path / "jax.pt"), monkeypatch)
    export_torch_checkpoint.main([ckpt, str(tmp_path / "port.pt")])
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---------------------------------------------------------------- errors

def test_missing_libzstd_is_named(monkeypatch):
    from neuralbarkcalculator_tpu_torch.io import orbax

    monkeypatch.setattr(orbax.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libzstd") as err:
        orbax.load(FIXTURE)
    assert FIXTURE in str(err.value)


def test_int8_version_byte_as_jax(tmp_path):
    from neuralbarkcalculator_tpu.models.quantize import (
        load_quantized as jax_load_quantized)
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        load_jax_quantized)

    path = _jax_int8_file(str(tmp_path / "m.int8.msgpack"))
    with open(path, "r+b") as f:
        f.seek(8)
        f.write(b"\x00")
    with pytest.raises(ValueError) as jax_err:
        jax_load_quantized(path, "fcn_resnet50")
    with pytest.raises(ValueError) as port_err:
        load_jax_quantized(path, "fcn_resnet50")
    assert str(port_err.value) == str(jax_err.value)
    assert "version b'\\x00'" in str(port_err.value)


@pytest.mark.parametrize("kind", ["msgpack", "orbax_best_model", "int8"])
def test_wrong_model_name_raises(kind, tmp_path):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    path = (_jax_int8_file(str(tmp_path / "m.int8.msgpack")) if kind == "int8"
            else _float_checkpoint(kind, str(tmp_path)))
    for name in ("fcn_resnet101", "deeplabv3_resnet50"):
        with pytest.raises((KeyError, RuntimeError)):
            NeuralBarkCalculator(path, model_name=name, device="cpu",
                                 config=PredictConfig(model_path=path))


def test_unsupported_orbax_layouts(tmp_path):
    """What the JAX package never writes raises NotImplementedError naming
    what was found."""
    from neuralbarkcalculator_tpu_torch.io import orbax

    for change, match in (({"use_zarr3": True}, "zarr3"),
                          ({"use_ocdbt": False}, "not an OCDBT")):
        path = str(tmp_path / "c")
        shutil.copytree(FIXTURE, path)
        meta_path = os.path.join(path, "_METADATA")
        with open(meta_path) as f:
            meta = json.load(f)
        meta.update(change)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(NotImplementedError, match=match):
            orbax.load(path)
        shutil.rmtree(path)
    with pytest.raises(NotImplementedError, match="_METADATA"):
        orbax.load(str(tmp_path))
    path = str(tmp_path / "s")  # a Python scalar, which JAX's _to_host
    shutil.copytree(FIXTURE, path)  # turns into an array before saving
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        text = f.read()
    with open(meta_path, "w") as f:
        f.write(text.replace('"np.ndarray"', '"scalar"', 1))
    with pytest.raises(NotImplementedError, match="value type 'scalar'"):
        orbax.load(path)

    class Store:  # one array's keys, as the OCDBT map gives them
        directory = "ckpt"
        zarray = {"zarr_format": 2, "shape": [2], "chunks": [2],
                  "dtype": "<f4", "compressor": {"id": "blosc"},
                  "filters": None, "order": "C", "fill_value": None}

        def get(self, key):
            return json.dumps(self.zarray).encode()

    with pytest.raises(NotImplementedError, match="compressor 'blosc'"):
        orbax._zarr_array(Store(), "a")
