"""PyTorch port: the curation tool (neuralbarkcalculator_tpu_torch/tools/
curation.py) against the JAX package's tools/curation.py.

On the same inputs ``make-duals``, ``adjust``, ``fix-image`` and
``fine-tune`` (the port's ops/ccl plain version on the CPU; JAX's CCL on
the CPU) write files byte-equal to the JAX tool's. ``preview-augment``
writes a PNG of the expected size (its draws come from a torch.Generator,
another stream than jax.random); ``--help`` lists every subcommand.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)
from torch_port_common import write_train_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("make-duals", "fine-tune", "adjust", "fix-image",
               "preview-augment")


@pytest.fixture(scope="module")
def jax_curation():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import curation
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return curation


def _tree(root) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_make_duals_equals_jax(tmp_path, jax_curation):
    from neuralbarkcalculator_tpu_torch.tools import curation

    rng = np.random.default_rng(0)
    for sub in ("bark", "nodes"):
        (tmp_path / sub).mkdir()
    for name in ("a.bmp", "b.bmp"):
        bark = (rng.random((32, 40)) > 0.5).astype(np.uint8) * 255
        node = (rng.random((32, 40)) > 0.8).astype(np.uint8) * 255
        Image.fromarray(bark, "L").save(tmp_path / "bark" / name)
        Image.fromarray(node, "L").save(tmp_path / "nodes" / name)
    curation.main(["make-duals", "--barks_dir", str(tmp_path / "bark"),
                   "--nodes_dir", str(tmp_path / "nodes"), "--duals_dir",
                   str(tmp_path / "port")])
    jax_curation.make_duals(str(tmp_path / "bark"), str(tmp_path / "nodes"),
                            str(tmp_path / "jax"))
    port = _tree(tmp_path / "port")
    assert sorted(port) == ["a.png", "b.png"]
    assert port == _tree(tmp_path / "jax")


def test_fine_tune_equals_jax(tmp_path, jax_curation):
    """Structured duals (bench_data: blobs, node islands, speckles under
    the 150-pixel threshold) of two wood types."""
    from neuralbarkcalculator_tpu_torch.tools import curation
    from neuralbarkcalculator_tpu_torch.tools.bench_data import (
        structured_dual_mask)

    rng = np.random.default_rng(3)
    for wood in ("sapin", "epinette_gelee"):
        d = tmp_path / "duals" / wood
        d.mkdir(parents=True)
        for i in range(2):
            mask = structured_dual_mask(rng, 96, 128)
            dual = np.select([mask == 1, mask == 2], [127, 255], 0)
            Image.fromarray(dual.astype(np.uint8), "L").save(d / f"{i}.png")
    curation.main(["fine-tune", "--duals_dir", str(tmp_path / "duals"),
                   "--output_dir", str(tmp_path / "port"), "--device",
                   "cpu"])
    jax_curation.fine_tune(str(tmp_path / "duals"), str(tmp_path / "jax"))
    port = _tree(tmp_path / "port")
    assert len(port) == 4
    assert port == _tree(tmp_path / "jax")
    assert port != _tree(tmp_path / "duals")  # the speckles went


def test_adjust_and_fix_image_equal_jax(tmp_path, jax_curation):
    from neuralbarkcalculator_tpu_torch.tools import curation

    rng = np.random.default_rng(1)
    for sub in ("duals", "samples"):
        (tmp_path / sub).mkdir()
    for name, (h, w) in (("y", (32, 24)), ("z", (20, 30))):
        dual = rng.choice([0, 127, 255], size=(16, 16)).astype(np.uint8)
        Image.fromarray(dual, "L").save(tmp_path / "duals" / f"{name}.png")
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
            tmp_path / "samples" / f"{name}.bmp")
    curation.main(["adjust", "--duals_folder", str(tmp_path / "duals"),
                   "--samples_folder", str(tmp_path / "samples"),
                   "--out_folder", str(tmp_path / "port")])
    jax_curation.adjust(str(tmp_path / "duals"), str(tmp_path / "samples"),
                        str(tmp_path / "jax"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert Image.open(tmp_path / "port" / "z.png").size == (30, 20)

    img = (rng.random((20, 10, 3)) * 255).astype(np.uint8)
    for side in ("port", "jax"):
        Image.fromarray(img).save(tmp_path / f"{side}_f.png")
    for n in (1, 2):
        curation.main(["fix-image", str(tmp_path / "port_f.png"),
                       "--n_pixels", str(n)])
        jax_curation.fix_image(str(tmp_path / "jax_f.png"), n)
        assert (tmp_path / "port_f.png").read_bytes() == \
            (tmp_path / "jax_f.png").read_bytes()
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port_f.png")), img[1:18])
    with pytest.raises(ValueError):
        curation.fix_image(str(tmp_path / "port_f.png"), 3)


def test_preview_augment_writes_the_grid(tmp_path):
    pytest.importorskip("matplotlib")
    from neuralbarkcalculator_tpu_torch.tools import curation

    root = write_train_root(tmp_path / "data")
    out = tmp_path / "preview.png"
    curation.main(["preview-augment", "--root_dir", root, "--out", str(out),
                   "--n", "3", "--crop", "32", "--device", "cpu"])
    assert Image.open(out).size == (3 * 3 * 120, 6 * 120)


def test_help_lists_every_subcommand():
    proc = subprocess.run(
        [sys.executable, "-m", "neuralbarkcalculator_tpu_torch.tools.curation",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for cmd in SUBCOMMANDS:
        assert cmd in proc.stdout
