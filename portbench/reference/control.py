"""The training cells' control: the reference computed in the precision
just below the configuration's (float32 with TF32 off), put in the
program's place; it has to come out as not correct. (The prediction
cells' control is the program's own int8 path, portbench/control.py.)

``TF32``, the hooks of ``Ops`` (reference/__init__.py) that round every
product's operands to TF32 (10 mantissa bits, to nearest) and sum in
float32: what a card computes with TF32 on, the same on a CPU.
``tf32_conv`` rounds a convolution's input and weight and, in backward,
its output gradient; ``tf32_matmul`` rounds both factors and, in
backward, the gradient of the product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        xr, wr = tf32(x), tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, dilation, groups, b is not None)
        return F.conv2d(xr, wr, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, go):
        xr, wr = ctx.saved_tensors
        stride, padding, dilation, groups, has_b = ctx.conf
        gr = tf32(go)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride,
                                            padding, dilation, groups)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride,
                                             padding, dilation, groups)
        if has_b and ctx.needs_input_grad[2]:
            gb = go.sum((0, 2, 3))
        return gx, gw, gb, None, None, None, None


def tf32_conv(x, w, b, stride, padding, dilation, groups):
    return _Tf32Conv.apply(x, w, b, stride, padding, dilation, groups)


def _sum_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``t`` summed over the dimensions that broadcasting added to
    ``shape``."""
    t = t.sum(tuple(range(t.dim() - len(shape)))) if t.dim() > len(shape) \
        else t
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dims, keepdim=True) if dims else t


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = tf32(a), tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, go):
        ar, br = ctx.saved_tensors
        gr = tf32(go)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(torch.matmul(gr, br.transpose(-1, -2)), ar.shape)
        if ctx.needs_input_grad[1]:
            gb = _sum_to(torch.matmul(ar.transpose(-1, -2), gr), br.shape)
        return ga, gb


def tf32_matmul(a, b):
    """Both factors at least 2-D."""
    return _Tf32Matmul.apply(a, b)


TF32 = {"conv": tf32_conv, "matmul": tf32_matmul}
