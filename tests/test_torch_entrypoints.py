"""PyTorch port: the console scripts (pyproject.toml ``[project.scripts]``,
``*-torch``) and the CLIs' ``entrypoint()``.

Every ``*-torch`` script names a callable of the port; ``entrypoint()``
of cli/predict and cli/train with ``--device cpu`` on a tiny folder
writes what ``main()`` writes on a copy of it (predict: every artifact
byte for byte; train: the best model's tensors and the report's CSV);
without ``--device`` the scripts ask for the card and raise here, before
writing anything.
"""
import importlib
import os
import shutil
import sys
import tomllib

import numpy as np
import pytest
import torch

from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)
from torch_port_common import tiny_torch_model, write_train_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def tiny_model():
    """The tiny model registered under ``_tiny_test`` (the CLIs' --model
    choices are read when their parser is built)."""
    from neuralbarkcalculator_tpu_torch.models import segmentation

    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    segmentation.MODEL_FACTORIES.pop("_tiny_test")


def test_console_scripts_name_callables():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {name: target for name, target in scripts.items()
            if name.endswith("-torch")}
    assert set(port) == {"bark-predict-torch", "bark-train-torch",
                         "bark-serve-torch", "bark-quantize-torch"}
    for name, target in port.items():
        module, attr = target.split(":")
        assert module.startswith("neuralbarkcalculator_tpu_torch.cli."), name
        assert callable(getattr(importlib.import_module(module), attr)), name


def _read_tree(root) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_predict_entrypoint_equals_main(tmp_path, tiny_model, monkeypatch):
    from neuralbarkcalculator_tpu_torch.cli import predict
    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil

    torch.manual_seed(0)
    ckpt = str(tmp_path / "best_model.pt")
    torch.save(tiny_torch_model().state_dict(), ckpt)
    rng = np.random.default_rng(0)
    for wood, shape in (("sapin", (40, 64)), ("epinette_gelee", (56, 64))):
        d = tmp_path / "a" / "samples" / wood
        d.mkdir(parents=True)
        save_image_u8_pil(str(d / "x.bmp"),
                          (rng.random((*shape, 3)) * 200 + 40).astype(
                              np.uint8))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    flags = ["--device", "cpu", "--model", "_tiny_test", "--model_path",
             ckpt, "--dpi", "30", "--batch_size", "2"]
    predict.main(predict.build_parser().parse_args(
        [str(tmp_path / "a"), *flags]))
    monkeypatch.setattr(sys, "argv", ["bark-predict-torch",
                                      str(tmp_path / "b"), *flags])
    predict.entrypoint()
    main_out, script_out = (_read_tree(tmp_path / r / "results")
                            for r in ("a", "b"))
    assert sorted(main_out) == sorted(script_out)
    assert len(main_out) == 5  # the CSV, two figures, two masks
    for name, data in main_out.items():
        assert script_out[name] == data, name


def test_train_entrypoint_equals_main(tmp_path, tiny_model, monkeypatch):
    from neuralbarkcalculator_tpu_torch.cli import train
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_torch_checkpoint)

    data = write_train_root(tmp_path / "data")
    flags = ["--device", "cpu", "--data_dir", data, "--model", "_tiny_test",
             "--epochs", "1", "--batch_size", "4", "--crop_size", "32",
             "--pad_size", "64", "--samples_factor", "1", "--report_dpi",
             "20"]
    train.main(train.build_parser().parse_args([str(tmp_path / "a"),
                                                *flags]))
    monkeypatch.setattr(sys, "argv", ["bark-train-torch",
                                      str(tmp_path / "b"), *flags])
    train.entrypoint()
    want, got = (load_torch_checkpoint(str(tmp_path / r / "moar" /
                                           "best_model.pt"))
                 for r in ("a", "b"))
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    csv_a, csv_b = (open(tmp_path / r / "Images" / "results" / "moar" /
                         "final_stats.csv").read() for r in ("a", "b"))
    assert csv_a == csv_b and len(csv_a.splitlines()) == 31


def test_scripts_default_to_the_card(tmp_path, monkeypatch):
    """Without --device the scripts run on the card; here, with none,
    they raise before writing anything."""
    from neuralbarkcalculator_tpu_torch.cli import predict, train

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    (tmp_path / "samples" / "sapin").mkdir(parents=True)
    for script, cli in (("bark-predict-torch", predict),
                        ("bark-train-torch", train)):
        monkeypatch.setattr(sys, "argv", [script, str(tmp_path),
                                          "--data_dir", str(tmp_path)]
                            if cli is train else [script, str(tmp_path)])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.entrypoint()
    assert sorted(os.listdir(tmp_path)) == ["samples"]
