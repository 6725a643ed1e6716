"""Operation and byte counts, from shapes alone.

- ``model_flops(model, h, w)``: 2 x the multiply-adds of every convolution
  of the reference model (reference/model.py) for one image of h x w, the
  head's 1x1 classifier included, the bicubic upsample of the 3 class
  planes left out. It runs the reference forward on ``meta`` tensors, so
  nothing is computed. The count is the reference's, at the image's own
  size: it does not change with the program's padding or kernels.
- ``train_step_flops``: a training step's forward, weight gradient and
  input gradient of every conv (3 x the forward), less the input gradient
  of the stem, whose input needs none.
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

from portbench.reference import model as M

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def _conv_flops(model: str, b: int, h: int, w: int, train: bool
                ) -> list[int]:
    shapes = M.param_shapes(model)
    state = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    counts: list[int] = []

    def on_conv(x, wt, y):
        counts.append(2 * y.numel() * wt.shape[1] * wt.shape[2] * wt.shape[3])

    ops = M.Ops(on_conv=on_conv, train=train,
                dropout_keep=lambda y: torch.ones_like(y, dtype=torch.bool))
    x = torch.empty((b, 3, h, w), device="meta")
    head, backbone = M.split_name(model)
    M.head_forward(state, M.backbone_forward(state, x, backbone, ops), head,
                   ops)
    return counts


@functools.lru_cache(maxsize=64)
def model_flops(model: str, h: int, w: int) -> int:
    return sum(_conv_flops(model, 1, h, w, False))


@functools.lru_cache(maxsize=8)
def train_step_flops(model: str, batch: int, crop: int) -> int:
    convs = _conv_flops(model, batch, crop, crop, True)
    return 3 * sum(convs) - convs[0]


def upsample_argmax_bytes(b: int, f: int, wf: int, oh: int, ow: int) -> int:
    return (b * f * wf * 3 * 4 + b * oh * f * 4 + wf * ow * 4 + 2 * ow * 4
            + b * oh * ow)
