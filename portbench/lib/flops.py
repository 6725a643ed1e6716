"""Operation and byte counts, from shapes alone.

- ``model_flops(config, h, w)``: 2 x the multiply-adds of every product of
  the configuration's reference model (reference/__init__.py: every
  convolution, grouped ones included, through ``Ops.c``, every matrix
  product through ``Ops.mm``) for one image of h x w, the head's 1x1
  classifier included, the upsample of the class planes left out. It runs
  the reference forward on ``meta`` tensors, so nothing is computed. The
  count is the reference's, at the image's own size: it does not change
  with the program's padding or kernels.
- ``train_step_flops(config, batch, crop)``: a training step's forward,
  gradient of each operand of every product (3 x the forward), less the
  input gradient of the first product (the stem), whose input needs none.
- ``upsample_argmax_bytes``: the least bytes one call moves, each input
  read once and the class map written once: the logits [B, F, Wf, 3] and
  the operators [B, OH, F] and [Wf, OW] (float32), the column windows
  [2, OW] (int32), the map [B, OH, OW] (uint8): the bytes of the bound
  in ``chip_smoke.py``'s upsample_argmax phase, with the column windows.
- ``PEAKS``: the card's published peaks (peaks.json).
"""
from __future__ import annotations

import functools
import json
import os

import torch

from portbench import reference

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def _product_flops(name: str, model: str, b: int, h: int, w: int,
                   train: bool) -> list[int]:
    """The FLOPs of each product of reference module ``name``'s forward,
    in the order they run."""
    ref = reference.module_named(name)
    state = {k: torch.empty(s, device="meta")
             for k, s in ref.param_shapes(model).items()}
    counts: list[int] = []

    def on_conv(x, wt, y):
        counts.append(2 * y.numel() * wt.shape[1] * wt.shape[2] * wt.shape[3])

    def on_matmul(a, b, y):
        counts.append(2 * y.numel() * a.shape[-1])

    ops = reference.Ops(on_conv=on_conv, on_matmul=on_matmul, train=train,
                        dropout_keep=lambda y: torch.ones_like(
                            y, dtype=torch.bool))
    ref.logits(state, torch.empty((b, 3, h, w), device="meta"), model, ops)
    return counts


@functools.lru_cache(maxsize=64)
def _model_flops(name: str, model: str, h: int, w: int) -> int:
    return sum(_product_flops(name, model, 1, h, w, False))


@functools.lru_cache(maxsize=8)
def _train_step_flops(name: str, model: str, batch: int, crop: int) -> int:
    products = _product_flops(name, model, batch, crop, crop, True)
    return 3 * sum(products) - products[0]


def model_flops(config: dict, h: int, w: int) -> int:
    return _model_flops(reference.name_for(config), config["model"], h, w)


def train_step_flops(config: dict, batch: int, crop: int) -> int:
    return _train_step_flops(reference.name_for(config), config["model"],
                             batch, crop)


def upsample_argmax_bytes(b: int, f: int, wf: int, oh: int, ow: int) -> int:
    return (b * f * wf * 3 * 4 + b * oh * f * 4 + wf * ow * 4 + 2 * ow * 4
            + b * oh * ow)
