"""PyTorch port: import hygiene and device selection.

The port imports nothing of JAX, flax or the JAX package, and neither PIL
nor matplotlib when its modules (the tools subpackage included) are
imported; loading the JAX package's checkpoints (a flax ``.msgpack``
through the engine, the orbax fixture) imports none of jax, flax, orbax,
tensorstore or msgpack. This runs in a subprocess because the test process has already
imported jax (tests/conftest.py). Note that
``neuralbarkcalculator_tpu_torch`` starts with the string
``neuralbarkcalculator_tpu``, so the check looks for that exact key and
its ``neuralbarkcalculator_tpu.`` submodules.
"""
import os
import subprocess
import sys

import pytest
import torch
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import neuralbarkcalculator_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
pil = "PIL" in sys.modules
import os, tempfile
from neuralbarkcalculator_tpu_torch.io import flax_msgpack, orbax
from neuralbarkcalculator_tpu_torch.models.convert import (
    state_dict_to_variables)
from neuralbarkcalculator_tpu_torch.models.segmentation import (
    MODEL_FACTORIES)
from neuralbarkcalculator_tpu_torch.pipeline.predict import (
    NeuralBarkCalculator)
orbax.load(os.path.join("tests", "fixtures", "orbax_tree"))
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "best_model.msgpack")
    with open(path, "wb") as f:
        f.write(flax_msgpack.to_bytes(state_dict_to_variables(
            MODEL_FACTORIES["fcn_resnet50"]().state_dict())))
    NeuralBarkCalculator(path, device="cpu")
roots = ("jax", "flax", "orbax", "tensorstore", "msgpack",
         "neuralbarkcalculator_tpu")
bad = sorted(k for k in sys.modules
             if k in roots or k.startswith(tuple(r + "." for r in roots)))
print(json.dumps({"modules": names, "bad": bad,
                  "pil": pil,
                  "matplotlib": "matplotlib" in sys.modules}))
"""


def test_port_imports_no_jax():
    import json

    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert not out["pil"]  # PIL is imported only where images need it
    assert not out["matplotlib"]  # only by the 'mpl' renderer's functions
    for name in ("pipeline.predict", "ops.upsample_argmax", "cli.predict",
                 "models.convert", "io.native", "ops.kernels",
                 "ops.fused_dropout_matmul", "ops.losses", "ops.metrics",
                 "data.augment", "data.sampling", "train.step",
                 "train.optim", "train.checkpoint", "train.loop",
                 "train.evaluate", "cli.train", "ops.resize", "ops.trim",
                 "pipeline.preprocess", "pipeline.serving", "cli.serve",
                 "models.efficientnet", "models.heads", "models.resnet",
                 "models.fold", "models.segmentation", "models.seeding",
                 "models.qops", "models.quantize",
                 "cli.quantize_checkpoint", "parallel",
                 "parallel.distributed", "parallel.sync_bn",
                 "pipeline.multihost", "ops.ccl", "tools",
                 "tools.bench_data", "tools.serving_bench",
                 "tools.serving_soak", "tools.curation", "io.flax_msgpack",
                 "io.orbax", "tools.export_torch_checkpoint"):
        assert f"neuralbarkcalculator_tpu_torch.{name}" in out["modules"]


def test_constants_mirror_jax_config():
    """The port keeps its own copy of the reference constants; they must
    equal the JAX package's, and so must the shared PredictConfig
    defaults."""
    import dataclasses

    from neuralbarkcalculator_tpu import config as jc
    from neuralbarkcalculator_tpu_torch import config as tc

    for name in ("WOOD_TYPES", "CLASS_NAMES", "NUM_CLASSES", "DEFAULT_MEAN",
                 "DEFAULT_STD", "DEFAULT_MM_PER_PIXEL",
                 "SMALL_ZONE_THRESHOLD", "SMALL_ZONE_CONNECTIVITY",
                 "PREPROCESS_TARGET_SIZE", "TRIM_PIXEL_THRESHOLD",
                 "TRIM_ROW_FRACTION", "IMG_EXTENSIONS"):
        assert getattr(tc, name) == getattr(jc, name), name
    for cls in ("PredictConfig", "TrainConfig"):
        port = {f.name: f.default
                for f in dataclasses.fields(getattr(tc, cls))}
        jax_cfg = {f.name: f.default
                   for f in dataclasses.fields(getattr(jc, cls))}
        assert set(port) <= set(jax_cfg)
        for name, default in port.items():
            assert default == jax_cfg[name], (cls, name)
    assert tc.PredictConfig().effnet_bucket_heights is False
    assert "effnet_bucket_heights" in {
        f.name for f in dataclasses.fields(jc.PredictConfig)}
    # every training setting of the JAX package is ported
    dropped = {f.name for f in dataclasses.fields(jc.TrainConfig)} - {
        f.name for f in dataclasses.fields(tc.TrainConfig)}
    assert dropped == set()
    assert tc.CLASS_WEIGHTS == jc.CLASS_WEIGHTS


def test_engine_without_device_needs_a_card(tmp_path):
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.utils.device import resolve_device

    from neuralbarkcalculator_tpu_torch.cli.train import build_parser
    from neuralbarkcalculator_tpu_torch.cli.train import main as train_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        NeuralBarkCalculator(str(tmp_path / "unused.pt"))
    (tmp_path / "samples" / "sapin").mkdir(parents=True)
    (tmp_path / "samples" / "sapin" / "a.png").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(build_parser().parse_args(
            [str(tmp_path), "--data_dir", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_defaults_to_cuda_and_drops_unported_flags():
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser

    parser = build_parser()
    assert parser.parse_args(["root"]).device == "cuda"
    assert parser.parse_args(["root", "--device", "cpu"]).device == "cpu"
    # --int8 is ported (tests/test_torch_quantize_engine.py drives it)
    assert parser.parse_args(["root", "--int8"]).int8
    assert not parser.parse_args(["root"]).int8
    # --shard is ported (tests/test_torch_multihost.py drives it)
    assert parser.parse_args(["root", "--shard", "0/2"]).shard == "0/2"
    assert parser.parse_args(["root"]).shard is None
    # --mpl is ported (tests/test_torch_report_mpl.py drives it)
    assert parser.parse_args(["root", "--mpl"]).mpl
    assert not parser.parse_args(["root"]).mpl
    with pytest.raises(SystemExit):
        parser.parse_args(["root", "--preprocess_backend", "tpu"])


@pytest.mark.parametrize("argv,want", [
    ([], {"resume": False, "preprocess_backend": "auto", "watch": None}),
    (["--resume"], {"resume": True}),
    (["--preprocess_backend", "device"], {"preprocess_backend": "device"}),
    (["--preprocess_backend", "host"], {"preprocess_backend": "host"}),
    (["--watch", "2.5"], {"watch": 2.5}),
])
def test_cli_parses_ported_flags(argv, want):
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser

    args = build_parser().parse_args(["root", *argv])
    assert {k: getattr(args, k) for k in want} == want


def test_serve_cli_defaults_to_cuda_and_drops_int8():
    from neuralbarkcalculator_tpu_torch.cli.serve import build_parser

    parser = build_parser()
    args = parser.parse_args(["m.pt"])
    assert (args.device, args.model, args.fixed_height, args.port) == (
        "cuda", "fcn_resnet50", 1024, 8642)
    assert parser.parse_args(["m.pt", "--device", "cpu"]).device == "cpu"
    for model in ("fcn_resnet101", "deeplabv3_efficientnet_b7"):
        assert parser.parse_args(["m.pt", "--model", model]).model == model
    # --int8 is ported now (tests/test_torch_quantize_engine.py serves
    # through it); the other flags stay refused
    assert parser.parse_args(["m.pt", "--int8"]).int8
    assert not args.int8
    for flag in (["--model", "unet"], ["--device", "tpu"]):
        with pytest.raises(SystemExit):
            parser.parse_args(["m.pt", *flag])


def test_model_zoo_names_equal_jax():
    """The port's zoo has every name of the JAX package's, and each CLI's
    --model takes them."""
    from neuralbarkcalculator_tpu.models import segmentation as js
    from neuralbarkcalculator_tpu_torch.cli import predict, serve, train
    from neuralbarkcalculator_tpu_torch.models import segmentation as ts

    assert sorted(ts.MODEL_FACTORIES) == sorted(js.MODEL_FACTORIES)
    assert len(ts.MODEL_FACTORIES) == 22
    for cli in (predict, serve, train):
        action = next(a for a in cli.build_parser()._actions
                      if a.dest == "model")
        assert sorted(action.choices) == sorted(js.MODEL_FACTORIES)
    for name in js.MODEL_FACTORIES:
        assert ts.efficientnet_variant_of(name) == \
            js.efficientnet_variant_of(name)


def test_missing_or_unported_checkpoint(tmp_path):
    """A missing path raises; a 1-byte .msgpack (the msgpack of the int 0,
    not a variable tree) raises a ValueError naming the file."""
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    with pytest.raises(FileNotFoundError):
        NeuralBarkCalculator(str(tmp_path / "none.pt"), device="cpu")
    msgpack = tmp_path / "m.msgpack"
    msgpack.write_bytes(b"\0")
    with pytest.raises(ValueError, match=r"m\.msgpack"):
        NeuralBarkCalculator(str(msgpack), device="cpu")
    with pytest.raises(ValueError, match=r"m\.msgpack"):
        NeuralBarkCalculator(str(msgpack), device="cpu",
                             model_name="fcn_resnet101")
    with pytest.raises(ValueError, match="unknown model"):
        NeuralBarkCalculator(str(msgpack), device="cpu", model_name="unet")
