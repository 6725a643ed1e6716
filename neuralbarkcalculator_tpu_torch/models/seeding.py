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


def inverted_dropout(x: torch.Tensor, rate: float,
                     generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    (a uniform draw below it), scaled by 1 / keep; dropped elements are 0."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


def drop_path(h: torch.Tensor, rate: float, generator: torch.Generator
              ) -> torch.Tensor:
    """Stochastic depth: the whole residual branch of a sample kept with
    probability 1 - rate and rescaled by 1 / keep (JAX models/
    efficientnet.py's MBConv)."""
    keep = 1.0 - rate
    mask = (torch.rand((h.shape[0], 1, 1, 1), generator=generator,
                       device=h.device) < keep).to(h.dtype)
    return h * mask / keep
