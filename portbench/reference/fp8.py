"""The control of a bf16 prediction cell that has no int8 path of its own
(SegFormer's): the reference computed with every product's operands
rounded to float8 e4m3, the precision below bf16, put in the program's
place; it has to come out as not correct.

``E4M3``, the hooks of ``Ops`` (reference/__init__.py) that round both
operands of every convolution and matrix product to e4m3 (3 mantissa
bits, to nearest) on a per-tensor scale (the tensor's largest magnitude
at e4m3's largest finite value, 448) and compute in float32, forward only:
what an fp8 GEMM with per-tensor scales computes, the same on a CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 on its own per-tensor scale, as float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def e4m3_conv(x, w, b, stride, padding, dilation, groups):
    return F.conv2d(e4m3(x), e4m3(w), b, stride, padding, dilation, groups)


def e4m3_matmul(a, b):
    return torch.matmul(e4m3(a), e4m3(b))


E4M3 = {"conv": e4m3_conv, "matmul": e4m3_matmul}
