"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages build the same tiny model, a dilated ResNet with one
bottleneck per stage (full channel widths, output stride 8) and an FCN
head without dropout, and get the same weights: flax initializes the JAX
model, the batch statistics and BN affine parameters are then randomized
with numpy (so folding does real work), and the port receives them through
``models/convert.variables_to_state_dict``.
"""
from __future__ import annotations

import numpy as np

TINY_STAGES = (1, 1, 1, 1)


def tiny_jax_model(dtype=None):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.heads import FCNHead
    from neuralbarkcalculator_tpu.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu.models.segmentation import SegmentationModel

    dtype = dtype or jnp.float32
    return SegmentationModel(
        backbone=DilatedResNet(stage_sizes=TINY_STAGES, dtype=dtype),
        classifier=FCNHead(3, dropout=0.0, dtype=dtype))


def tiny_torch_model():
    from neuralbarkcalculator_tpu_torch.models.heads import FCNHead
    from neuralbarkcalculator_tpu_torch.models.resnet import DilatedResNet
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        SegmentationModel)

    backbone = DilatedResNet(stage_sizes=TINY_STAGES)
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, 3, dropout=0.0)).eval()


def tiny_variables(seed: int = 0) -> dict:
    """JAX variables of the tiny model as numpy, with randomized BN."""
    import jax
    import jax.numpy as jnp

    variables = tiny_jax_model().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), train=False)
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


def torch_model_with(variables: dict):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)

    model = tiny_torch_model()
    load_state_dict_into(model, variables_to_state_dict(variables))
    return model.eval()


def count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1
