"""The training cells' control: the reference computed in the precision
just below the configuration's (float32 with TF32 off), put in the
program's place; it has to come out as not correct. (The prediction
cells' control is the program's own int8 path, portbench/control.py.)

``tf32_conv``: every convolution's input, weight and, in backward, output
gradient rounded to TF32 (10 mantissa bits, to nearest), the products
summed in float32: what a card computes with TF32 on, the same on a CPU.
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
    def forward(ctx, x, w, b, stride, padding, dilation):
        xr, wr = tf32(x), tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, dilation, b is not None)
        return F.conv2d(xr, wr, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, go):
        xr, wr = ctx.saved_tensors
        stride, padding, dilation, has_b = ctx.conf
        gr = tf32(go)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride,
                                            padding, dilation)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride,
                                             padding, dilation)
        if has_b and ctx.needs_input_grad[2]:
            gb = go.sum((0, 2, 3))
        return gx, gw, gb, None, None, None


def tf32_conv(x, w, b, stride, padding, dilation):
    return _Tf32Conv.apply(x, w, b, stride, padding, dilation)


