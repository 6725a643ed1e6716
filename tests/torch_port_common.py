"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages build the same tiny model, a dilated ResNet with one
bottleneck per stage (full channel widths, output stride 8) and an FCN
head without dropout, and get the same weights: flax initializes the JAX
model, the batch statistics and BN affine parameters are then randomized
with numpy (so folding does real work), and the port receives them through
``models/convert.variables_to_state_dict``. The same carried weights serve
a model in train mode (``torch_train_model_with``), held against the JAX
model applied with ``train=True`` (``jax_train_loss_and_grads``).
"""
from __future__ import annotations

import shutil

import numpy as np
import pytest

TINY_STAGES = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def remove_tmp_path(tmp_path):
    """Checkpoints of full-width models take hundreds of MB a test: none
    outlives its test. A test module imports this fixture to apply it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_jax_model(dtype=None):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.heads import FCNHead
    from neuralbarkcalculator_tpu.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu.models.segmentation import SegmentationModel

    dtype = dtype or jnp.float32
    return SegmentationModel(
        backbone=DilatedResNet(stage_sizes=TINY_STAGES, dtype=dtype),
        classifier=FCNHead(3, dropout=0.0, dtype=dtype))


def tiny_torch_model(dropout: float = 0.0):
    from neuralbarkcalculator_tpu_torch.models.heads import FCNHead
    from neuralbarkcalculator_tpu_torch.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        SegmentationModel)

    backbone = DilatedResNet(stage_sizes=TINY_STAGES)
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, 3, dropout=dropout)).eval()


def tiny_deeplab_jax_model():
    """The tiny dilated ResNet with the DeepLabV3 head (JAX)."""
    from neuralbarkcalculator_tpu.models.heads import DeepLabHead
    from neuralbarkcalculator_tpu.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu.models.segmentation import SegmentationModel

    return SegmentationModel(backbone=DilatedResNet(stage_sizes=TINY_STAGES),
                             classifier=DeepLabHead(3))


def tiny_deeplab_torch_model():
    from neuralbarkcalculator_tpu_torch.models.heads import DeepLabHead
    from neuralbarkcalculator_tpu_torch.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        SegmentationModel)

    backbone = DilatedResNet(stage_sizes=TINY_STAGES)
    return SegmentationModel(backbone,
                             DeepLabHead(backbone.out_channels, 3)).eval()


def tiny_variables(seed: int = 0, model=None) -> dict:
    """JAX variables of the tiny model (or of ``model``) as numpy, with
    randomized BN."""
    import jax
    import jax.numpy as jnp

    model = model or tiny_jax_model()
    # jitted: the same values as the eager init, ~4x sooner on a CPU
    variables = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.PRNGKey(seed))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def randomize(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = randomize(v)
            elif k == "mean":
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias" and v.ndim == 1 and np.all(v == 0):
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"params": randomize(variables["params"]),
            "batch_stats": randomize(variables["batch_stats"])}


def calibrate_bn(model, seed: int, hw=(64, 64)):
    """``model`` with each BatchNorm's running statistics set to its
    input's batch statistics over four normalized blob images of ``hw``,
    in forward order, in one eval forward; returns it. The random
    EfficientNet's logits then depend on the image (uncalibrated, they
    depend almost on the position alone), at the price of a network that
    amplifies rounding with depth, which float32 comparisons absorb. A BN that sees one value per channel (the
    ASPP's pooled branch at batch 1) keeps its statistics."""
    import torch
    import torch.nn as nn

    def hook(bn, args):
        (inp,) = args
        if inp.numel() // inp.shape[1] > 1:
            bn.running_mean.copy_(inp.mean(dim=(0, 2, 3)))
            bn.running_var.copy_(inp.var(dim=(0, 2, 3), unbiased=False))

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(normalized([blob_image(rng, *hw) for _ in range(4)]))
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        with torch.no_grad():
            model.head_logits(x)
    finally:
        for h in handles:
            h.remove()
    return model


def blob_image(rng, h: int, w: int) -> np.ndarray:
    """A uint8 [h, w, 3] image of smooth 8-pixel blobs plus fine noise, so
    the maps have zones above the postprocess's 150-pixel threshold."""
    coarse = rng.random((h // 8 + 2, w // 8 + 2, 3))
    img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    img = img + 0.15 * rng.random(img.shape)
    return np.clip(img * 230, 0, 255).astype(np.uint8)


def normalized(images) -> np.ndarray:
    """uint8 NHWC images -> float32, normalized as the engine does."""
    from neuralbarkcalculator_tpu_torch.config import DEFAULT_MEAN, DEFAULT_STD

    x = np.asarray(images, np.float32) / 255.0
    return ((x - np.float32(DEFAULT_MEAN)) / np.float32(DEFAULT_STD)).astype(
        np.float32)


def zoo_model(name: str, seed: int):
    """A port zoo model in eval mode with weights drawn with numpy from
    ``seed``, as ``chip_smoke.random_state_dict`` draws them: He-normal
    convs (a depthwise conv's fan-in is its k x k window), BN statistics
    around 0 and 1, BN scales from [0.5, 1.5] except where a BN ends a
    residual branch (``bn3``, ``downsample.1``, MBConv's ``_bn2``: [0.1,
    0.3], as a trained network's tend to be; with unit-scale branches the
    random network amplifies float32 rounding by ~10^2 over its depth),
    small biases. Like flax's default init, they leave a random
    EfficientNet's logits independent of the image (``calibrate_bn``)."""
    import torch

    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    model = MODEL_FACTORIES[name]().eval()
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            state[k] = v
            continue
        if len(shape) == 4:
            arr = rng.standard_normal(shape) * np.sqrt(
                2.0 / (shape[1] * shape[2] * shape[3]))
        elif k.endswith(("running_mean", "bias")):
            arr = rng.normal(0.0, 0.1, shape)
        elif k.endswith("running_var"):
            arr = rng.uniform(0.5, 2.0, shape)
        elif k.endswith((".bn3.weight", "downsample.1.weight",
                         "._bn2.weight")):
            arr = rng.uniform(0.1, 0.3, shape)
        else:
            arr = rng.uniform(0.5, 1.5, shape)
        state[k] = torch.from_numpy(np.asarray(arr, np.float32))
    model.load_state_dict(state)
    return model


def torch_model_with(variables: dict):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)

    model = tiny_torch_model()
    load_state_dict_into(model, variables_to_state_dict(variables))
    return model.eval()


def torch_train_model_with(variables: dict, dropout: float = 0.0):
    """The tiny port model in train mode with the JAX variables' params and
    batch statistics (unfolded)."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)

    model = tiny_torch_model(dropout)
    load_state_dict_into(model, variables_to_state_dict(variables))
    return model.train()


def jax_train_loss_and_grads(variables: dict, x: np.ndarray,
                             labels: np.ndarray):
    """The tiny JAX model applied in train mode (dropout 0, batch
    statistics mutated), the Lovász loss and its gradient with respect to
    the params: (loss, new batch_stats, grads), as numpy."""
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops.losses import lovasz_softmax_loss

    model = tiny_jax_model()

    def loss_fn(params, batch_stats, x, labels):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        return lovasz_softmax_loss(logits, labels), mutated

    (loss, mutated), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], jnp.asarray(x),
                                jnp.asarray(labels))
    return (float(loss), jax.tree.map(np.asarray, mutated["batch_stats"]),
            jax.tree.map(np.asarray, grads))


# A port map may differ from the JAX engine's only at pixels whose top-2
# float32 logit margin is below this; the tests assert there are none.
NEAR_TIE = 1e-5


def tiny_checkpoint(path: str, seed: int) -> str:
    """The tiny model's weights as a ``best_model.pt``, written by the JAX
    package's own exporter."""
    import torch
    from neuralbarkcalculator_tpu.models.convert import (
        variables_to_torch_state_dict)

    torch.save({k: torch.tensor(v) for k, v in variables_to_torch_state_dict(
        tiny_variables(seed=seed)).items()}, path)
    return path


def tiny_engines(pt: str, jax_engine: bool = True, **config):
    """(JAX engine or None, port engine on the CPU) loading ``pt`` under
    the model name ``_tiny_test``, both in float32 with ``config``; the
    JAX engine runs its Pallas kernel in interpret mode."""
    from neuralbarkcalculator_tpu.config import PredictConfig as JaxConfig
    from neuralbarkcalculator_tpu.models import segmentation as jseg
    from neuralbarkcalculator_tpu.parallel.mesh import make_mesh
    from neuralbarkcalculator_tpu.pipeline.predict import (
        NeuralBarkCalculator as JaxEngine)
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.models import segmentation as tseg
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    config = dict(use_bfloat16=False, **config)
    jseg.MODEL_FACTORIES["_tiny_test"] = lambda dtype=None: tiny_jax_model(
        dtype)
    tseg.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        jax_eng = JaxEngine(
            pt, mesh=make_mesh(n_data=1), model_name="_tiny_test",
            config=JaxConfig(model_path=pt, use_pallas=True,
                             pallas_interpret=True, **config)
        ) if jax_engine else None
        port_engine = NeuralBarkCalculator(
            pt, model_name="_tiny_test", device="cpu",
            config=PredictConfig(model_path=pt, **config))
    finally:
        jseg.MODEL_FACTORIES.pop("_tiny_test", None)
        tseg.MODEL_FACTORIES.pop("_tiny_test", None)
    return jax_eng, port_engine


def near_ties(engine, images) -> int:
    """Pixels whose top-2 logit margin in a float32 per-image forward of
    the port engine's (folded) model is under NEAR_TIE; ``images`` are
    uint8 [h, w, 3] arrays."""
    import torch

    mean = engine.mean.numpy()
    std = engine.std.numpy()
    n = 0
    with torch.inference_mode():
        for img in images:
            x = (img.astype(np.float32) / 255.0 - mean) / std
            top2 = engine.model(torch.from_numpy(x[None]))[0].topk(2).values
            n += int((top2[..., 0] - top2[..., 1] < NEAR_TIE).sum())
    return n


def write_processed(root: str, items) -> None:
    """A predict root holding ``items`` (ProcessedImage) as processed PNGs,
    with the results/ folders of their wood types."""
    import os

    from neuralbarkcalculator_tpu_torch.io.native import save_image_u8

    for it in items:
        d = os.path.join(root, "processed", "samples", it.wood_type)
        os.makedirs(d, exist_ok=True)
        for sub in ("combined_images", "outputs"):
            os.makedirs(os.path.join(root, "results", sub, it.wood_type),
                        exist_ok=True)
        save_image_u8(os.path.join(d, it.fname), it.image)


def write_train_root(root) -> str:
    """A training dataset in the reference layout under ``root``: 10
    images per wood type, 64x64, with duals (0/127/255), so the 80/10/10
    split gives 24/3/3."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for wood_type in ("epinette_gelee", "epinette_non_gelee", "sapin"):
        for sub in ("samples", "duals"):
            (root / sub / wood_type).mkdir(parents=True)
        for i in range(10):
            img = (rng.random((64, 64, 3)) * 200 + 30).astype(np.uint8)
            Image.fromarray(img).save(root / "samples" / wood_type /
                                      f"img{i}.bmp")
            dual = rng.choice([0, 127, 255], size=(64, 64),
                              p=[0.6, 0.35, 0.05]).astype(np.uint8)
            Image.fromarray(dual, mode="L").save(root / "duals" / wood_type /
                                                 f"img{i}.png")
    return str(root)


def count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1


# tests/fixtures/orbax_tree: an orbax checkpoint written by the JAX
# package's save_variables from orbax_fixture_tree(), with each leaf's
# shape, dtype and sha256 in tests/fixtures/orbax_tree.json
ORBAX_FIXTURE_SEED = 13


def orbax_fixture_tree(seed: int = ORBAX_FIXTURE_SEED) -> dict:
    """Nested dicts of float32 and int8 leaves: the conv kernels are
    indirect values in the OCDBT data file (over 1024 bytes compressed),
    the small vectors inline in the B+tree leaf node."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "params": {
            "backbone": {"conv1": {"kernel": normal(3, 3, 8, 16)},
                         "bn1": {"scale": normal(16), "bias": normal(16)}},
            "head": {"conv_q": rng.integers(-127, 128, (3, 3, 16, 24),
                                            dtype=np.int8),
                     "conv_m": normal(24), "s_ratio": normal()}},
        "batch_stats": {"backbone": {"bn1": {"mean": normal(16),
                                             "var": normal(16) ** 2}}},
    }


def leaf_digests(tree, prefix: str = "") -> dict:
    """{'params/backbone/conv1/kernel': {'shape', 'dtype', 'sha256'}} of
    a tree of numpy leaves (sha256 of the C-order bytes)."""
    import hashlib

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(leaf_digests(v, path))
        else:
            arr = np.ascontiguousarray(v)
            out[path] = {"shape": list(arr.shape), "dtype": arr.dtype.name,
                         "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def write_orbax_fixture(directory: str) -> None:
    """Write tests/fixtures/orbax_tree (``directory``) and its JSON with the
    JAX package's ``save_variables``."""
    import json

    from neuralbarkcalculator_tpu.train.checkpoint import save_variables

    tree = orbax_fixture_tree()
    save_variables(directory, tree)
    with open(directory.rstrip("/") + ".json", "w") as f:
        json.dump({"seed": ORBAX_FIXTURE_SEED,
                   "leaves": leaf_digests(tree)}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
