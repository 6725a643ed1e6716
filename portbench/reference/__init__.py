"""The plain references of the benchmark's models, one module a family of
architectures, and what they share.

A configuration file names its reference with ``"reference": "<module>"``,
the file ``portbench/reference/<module>.py``; a configuration without the
key takes ``model`` (reference/model.py: the dilated ResNets with the FCN
and DeepLabV3 heads). ``module_for(config)`` is the one place that
resolves it: a new architecture is a new module and a configuration file
that names it, and no other file changes.

The interface of a reference module (``model`` is the configuration's
``"model"``, so one module can serve several models of a family):

- ``param_shapes(model) -> {name: shape}``: every state-dict entry of the
  model, in the program's order and with the program's names (the weights
  file the program loads is written from it).
- ``logits(state, x, model, ops) -> logits``: normalized float32 NCHW
  images [B, 3, H, W] to float32 logits [B, classes, H, W] at the input's
  size. Every product of the forward goes through ``ops.c`` (a
  convolution, grouped ones included) or ``ops.mm`` (a matrix product: a
  linear layer as ``ops.mm(x, w.t()) + b``, attention), so that the FLOP
  counter (lib/flops.py) and the lower-precision control
  (reference/control.py) see each one. Every
  BatchNorm goes through ``batch_norm(ops, ...)``, which obeys ``ops``'
  flags (train mode, batch statistics, the calibration hook). Under
  ``ops.train`` the forward runs in train mode with ``ops.dropout_keep``
  as the dropout masks; under ``ops.recompute`` each block of the
  backbone runs through ``ops.block``, which recomputes it in backward.
  The forward also runs on ``meta`` tensors (lib/flops.py counts without
  computing), so nothing in it may depend on the values.
- ``init_rule(name, shape) -> Normal | Uniform | Zeros``: how
  lib/weights.py draws the entry. Normal entries take their share of one
  normal draw and uniform entries of one uniform draw, in the order of
  ``param_shapes``; zeros are drawn from nothing.
- ``CALIBRATE_PREFIX`` and ``CALIBRATE_EXCLUDE``: the BatchNorms whose
  running statistics lib/weights.calibrate_bn sets from the run's images
  (names that start with the prefix, less the excluded ones).
- ``trains(model) -> bool``: whether the training reference
  (reference/train.py) may run this model's forward in train mode; the
  training cells of a model it refuses cannot be checked.

Nothing here imports the program under test.
"""
from __future__ import annotations

import importlib
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DEFAULT = "model"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def name_for(config: dict) -> str:
    """The reference module's name that ``config`` gives."""
    name = config.get("reference", DEFAULT)
    if not _NAME.match(name):
        raise ValueError(f"no reference module named {name!r}")
    return name


def module_named(name: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{name}")


def module_for(config: dict) -> ModuleType:
    """The reference module of a configuration (module docstring)."""
    return module_named(name_for(config))


@dataclass(frozen=True)
class Normal:
    """Values N(0, std^2)."""
    std: float


@dataclass(frozen=True)
class Uniform:
    """Values U(lo, hi)."""
    lo: float
    hi: float


@dataclass(frozen=True)
class Zeros:
    """Zeros of ``dtype`` (a counter such as BatchNorm's
    ``num_batches_tracked`` is int64)."""
    dtype: torch.dtype = torch.float32


@dataclass
class Ops:
    """The operations a forward runs.

    - ``conv(x, w, b, stride, padding, dilation, groups)`` (``F.conv2d``
      when None) and ``matmul(a, b)`` (``torch.matmul`` when None): every
      product, through ``c`` and ``mm``; ``on_conv(x, w, y)`` and
      ``on_matmul(a, b, y)``, if given, see each one's operands and
      result.
    - ``train``: BatchNorm on batch statistics and dropout on
      ``dropout_keep(y)`` (a bool mask, drawn by the caller);
      ``batch_stats``: BatchNorm on batch statistics alone, for the
      BatchNorms named ``batch_stats_prefix...``; ``on_bn``, if given,
      sees every BatchNorm's (name, batch mean, biased batch variance) on
      batch statistics.
    - ``recompute``: ``block`` recomputes its function in backward instead
      of keeping its activations.
    """
    conv: Callable | None = None
    matmul: Callable | None = None
    train: bool = False
    batch_stats: bool = False
    batch_stats_prefix: str = ""
    dropout_keep: Callable | None = None
    recompute: bool = False
    on_conv: Callable | None = None
    on_matmul: Callable | None = None
    on_bn: Callable | None = None

    def c(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = (self.conv or F.conv2d)(x, w, b, stride, padding, dilation,
                                    groups)
        if self.on_conv is not None:
            self.on_conv(x, w, y)
        return y

    def mm(self, a, b):
        y = (self.matmul or torch.matmul)(a, b)
        if self.on_matmul is not None:
            self.on_matmul(a, b, y)
        return y

    def block(self, fn: Callable, *args):
        if self.recompute and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


def batch_norm(ops: Ops, st: dict, p: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The BatchNorm of state-dict prefix ``p`` over NCHW ``x``: on the
    batch's statistics in train mode (and for the batch-statistics prefix,
    where a channel has more than one value an image), else on the running
    statistics."""
    if ops.train or (ops.batch_stats and p.startswith(ops.batch_stats_prefix)
                     and x.shape[2] * x.shape[3] > 1):
        if ops.on_bn is not None:
            ops.on_bn(p, x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False))
        return F.batch_norm(x, None, None, st[f"{p}.weight"],
                            st[f"{p}.bias"], True, 0.0, eps)
    return F.batch_norm(x, st[f"{p}.running_mean"], st[f"{p}.running_var"],
                        st[f"{p}.weight"], st[f"{p}.bias"], False, 0.0, eps)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NCHW."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def exact_float32() -> None:
    """TF32 off for matmuls and cuDNN convolutions: the references compute
    in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
