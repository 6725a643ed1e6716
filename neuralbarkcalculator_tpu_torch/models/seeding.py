"""The random layers of a training forward, keyed by the step's seed.

A train step draws one 64-bit ``dropout_seed``. The FCN head's dropout
takes it as its Philox key (ops/fused_dropout_matmul); every other random
layer draws from an explicit ``torch.Generator`` seeded from it and from
the layer's stream, never from torch's global generator, so a step is a
function of its seed (the JAX package folds one key per step in the same
way, train/step.py):

- ``BACKBONE_STREAM``: EfficientNet's stochastic depth (models/
  efficientnet.py), one per-sample draw per residual block, in block
  order;
- ``HEAD_STREAM``: the DeepLabV3 head's ASPP dropout (models/heads.py).

``fold_seed`` also seeds a resumed run's generators from (seed, first
epoch) (train/loop.py).

Data-parallel runs: a rank holds rows [rank * b, (rank + 1) * b) of a
global batch split evenly over ``size`` ranks. Each random layer draws
the global batch's values from its generator and keeps the rank's rows
(``batch_rand``), so its mask is exactly those rows of the single-process
mask, on the CPU and on a card alike (a CUDA generator's Philox offsets
depend on the launch shape, so drawing only the rank's part from a
shifted generator would not give the same numbers). The FCN head's
dropout passes the rank's element offset to its kernel instead. The
split, ``shard`` = (rank, size), comes down the forward with the step's
seed (train/step.py); (0, 1) is a single process.
"""
from __future__ import annotations

import numpy as np
import torch

BACKBONE_STREAM = 1
HEAD_STREAM = 2


def fold_seed(seed: int, value: int) -> int:
    """A 64-bit seed derived from (seed, value), as jax.random.fold_in
    derives a key: numpy's SeedSequence."""
    return int(np.random.SeedSequence([seed, value]).generate_state(
        1, np.uint64)[0])


def layer_generator(seed: int, stream: int, device: torch.device
                    ) -> torch.Generator:
    """A generator on ``device`` for one stream of a step, seeded from the
    step's seed and the stream."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, stream))


def batch_rand(shape, generator: torch.Generator, device: torch.device,
               shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Uniform [0, 1) values of ``shape`` for rank ``shard[0]``'s rows:
    the global batch's draw (``shape[0] * shard[1]`` rows) from
    ``generator``, then the rank's rows of it."""
    rank, size = shard
    if size == 1:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    u = torch.rand((b * size, *shape[1:]), generator=generator, device=device)
    return u[rank * b:(rank + 1) * b]


def inverted_dropout(x: torch.Tensor, rate: float,
                     generator: torch.Generator,
                     shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    (a uniform draw below it), scaled by 1 / keep; dropped elements are 0.
    ``shard``: (rank, size) of a data-parallel batch."""
    keep = 1.0 - rate
    kept = batch_rand(x.shape, generator, x.device, shard) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


def drop_path(h: torch.Tensor, rate: float, generator: torch.Generator,
              shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Stochastic depth: the whole residual branch of a sample kept with
    probability 1 - rate and rescaled by 1 / keep (JAX models/
    efficientnet.py's MBConv). ``shard``: (rank, size) of a data-parallel
    batch."""
    keep = 1.0 - rate
    mask = (batch_rand((h.shape[0], 1, 1, 1), generator, h.device, shard)
            < keep).to(h.dtype)
    return h * mask / keep
