"""Cross-rank BatchNorm: train-mode statistics over the global batch.

Under the JAX package's data-sharded train step, flax's BatchNorm takes
its batch statistics over the whole global batch (GSPMD inserts the
reductions). ``CrossRankBatchNorm2d`` does the same across the ranks of a
``World`` (parallel/distributed.py):

- the mean is the all-reduced per-channel sum over the all-reduced
  count; the variance the all-reduced sum of squared deviations from that
  mean: torch's two-pass variance, which the port keeps on purpose (flax
  takes E[x^2] - E[x]^2), now over the global batch;
- both all-reduces are differentiable, so the gradient flows back through
  the global statistics to every rank's inputs, as in the single-process
  BatchNorm on the concatenated batch; forward and backward, they run
  inside the program span ``train/collective/bn``;
- the running statistics take torch's update with the global count: the
  mean, and the unbiased variance, n / (n - 1) times the batch's.

It works over gloo and NCCL alike: ``torch.nn.SyncBatchNorm`` refuses
CPU tensors. In eval mode, and in a world of one rank, it is the plain
``nn.BatchNorm2d`` computation. It is an ``nn.BatchNorm2d``, with the
same parameters and buffers, so state dicts, BN folding and checkpoints
are unchanged.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .distributed import World


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics span the ranks of
    ``world``."""

    def __init__(self, num_features: int, world: World, eps: float = 1e-5,
                 momentum: float | None = 0.1, affine: bool = True,
                 track_running_stats: bool = True, device=None, dtype=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device, dtype)
        self.world = world

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.world.size == 1:
            return super().forward(x)
        xf = x.float()  # statistics in float32, also under autocast
        n = x.numel() // x.shape[1] * self.world.size
        mean = self.world.all_reduce_sum(xf.sum(dim=(0, 2, 3))) / n
        d = xf - mean.view(1, -1, 1, 1)
        var = self.world.all_reduce_sum((d * d).sum(dim=(0, 2, 3))) / n
        y = d * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        if self.affine:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / float(self.num_batches_tracked)
                          if self.momentum is None else self.momentum)
                self.running_mean.mul_(1.0 - factor).add_(mean * factor)
                self.running_var.mul_(1.0 - factor).add_(
                    var * (n / (n - 1)) * factor)
        return y.to(x.dtype)


def convert_batchnorm(model: nn.Module, world: World) -> nn.Module:
    """Swap every ``nn.BatchNorm2d`` of ``model`` (the zoo's: models/
    resnet.py, heads.py, efficientnet.py) for a ``CrossRankBatchNorm2d``
    over ``world`` with the same hyperparameters, parameters and running
    statistics; returns ``model``."""
    for name, child in model.named_children():
        if type(child) is nn.BatchNorm2d:
            bn = CrossRankBatchNorm2d(
                child.num_features, world, child.eps, child.momentum,
                child.affine, child.track_running_stats,
                device=child.running_mean.device
                if child.running_mean is not None else None)
            bn.load_state_dict(child.state_dict())
            bn.train(child.training)
            setattr(model, name, bn)
        else:
            convert_batchnorm(child, world)
    return model
