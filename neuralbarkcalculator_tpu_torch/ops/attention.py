"""Scaled dot-product attention of the port's transformer models
(models/segformer.py).

``attention(q, k, v)`` is one ``torch.nn.functional.scaled_dot_product_attention``
call over [B, heads, N, d] queries and [B, heads, M, d] keys and values,
scaled by 1 / sqrt(d): on a card in bf16, PyTorch's flash
attention (its memory-efficient kernel where flash refuses the shapes);
elsewhere PyTorch's own choice. On an H100 PyTorch would pick cuDNN's
attention first, whose host side took 2.1 ms a call in the SegFormer
folder cell (NVIDIA H100 80GB HBM3, 700 W; 52 calls a launch batch, on a
path bound by the host), against tens of microseconds for flash. Each
call runs inside the program span ``predict/attention``
(utils/profiling.stage_timer), so a profiled run can tie the device time
of the attention to it, and counts in ``LAUNCHES``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import stage_timer
from .kernels import LaunchCounter

LAUNCHES = LaunchCounter()
_FLASH = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v, [B, heads, N, d]."""
    with stage_timer("predict/attention"):
        if q.is_cuda and q.dtype == torch.bfloat16:
            with sdpa_kernel(_FLASH):
                out = F.scaled_dot_product_attention(q, k, v)
        else:
            out = F.scaled_dot_product_attention(q, k, v)
    LAUNCHES.add()
    return out
