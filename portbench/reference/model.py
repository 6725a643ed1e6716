"""The plain reference of the benchmark's models: torchvision's
segmentation models on a dilated ResNet, written as plain float32
functions over a state dict with torchvision's names.

- ``fcn_resnet50`` / ``fcn_resnet101``: ResNet-50 / -101 with
  ``replace_stride_with_dilation=[False, True, True]`` (output stride 8),
  then ``FCNHead`` (3x3 conv 2048 -> 512, BN, ReLU, dropout, 1x1 conv to
  the classes); Long et al. 2015, ``torchvision.models.segmentation.fcn``.
- ``deeplabv3_resnet50`` / ``deeplabv3_resnet101``: the same backbones,
  then ``DeepLabHead``: ASPP (a 1x1 branch, 3x3 branches at dilation and
  padding 12 / 24 / 36, a global-pool branch; 256 channels each),
  concatenated, projected to 256, ReLU, Dropout(0.5), then 3x3 conv, BN,
  ReLU, 1x1 conv; Chen et al. 2017 (arXiv:1706.05587),
  ``torchvision.models.segmentation.deeplabv3``.
- The logits are upsampled to the input's size with
  ``F.interpolate(mode="bicubic", align_corners=False)``, the reference
  application's upsample.

Every convolution goes through ``ops.conv`` (``F.conv2d`` by default), so
the FLOP counter (lib/flops.py) and the lower-precision controls
(reference/control.py) see the same graph. Nothing here imports the
program under test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

NUM_CLASSES = 3
BN_EPS = 1e-5
ASPP_RATES = (12, 24, 36)
ASPP_CHANNELS = 256
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def split_name(model: str) -> tuple[str, str]:
    """'deeplabv3_resnet101' -> ('deeplabv3', 'resnet101')."""
    head, backbone = model.split("_", 1)
    if head not in ("fcn", "deeplabv3") or backbone not in STAGES:
        raise ValueError(f"no reference for model {model!r}")
    return head, backbone


def _blocks(backbone: str):
    """(prefix, inplanes, planes, stride, dilation, downsample) of every
    bottleneck, torchvision's ``_make_layer`` with stride -> dilation in
    layer3 and layer4."""
    out = []
    inplanes, dilation = 64, 1
    for stage, n in enumerate(STAGES[backbone]):
        planes = 64 * 2 ** stage
        stride = 1 if stage == 0 else 2
        previous = dilation
        if stage >= 2:  # replace_stride_with_dilation = [False, True, True]
            dilation *= stride
            stride = 1
        for i in range(n):
            first = i == 0
            out.append((f"layer{stage + 1}.{i}", inplanes, planes,
                        stride if first else 1,
                        previous if first else dilation,
                        first and (stride != 1 or inplanes != planes * 4)))
            inplanes = planes * 4
    return out


def _bn_shapes(prefix: str, c: int) -> dict:
    return {f"{prefix}.weight": (c,), f"{prefix}.bias": (c,),
            f"{prefix}.running_mean": (c,), f"{prefix}.running_var": (c,),
            f"{prefix}.num_batches_tracked": ()}


def param_shapes(model: str) -> dict[str, tuple]:
    """Every state-dict entry of ``model`` and its shape, in torchvision's
    order and names."""
    head, backbone = split_name(model)
    s = {"backbone.conv1.weight": (64, 3, 7, 7)}
    s.update(_bn_shapes("backbone.bn1", 64))
    for prefix, cin, planes, _, _, down in _blocks(backbone):
        p = f"backbone.{prefix}"
        s[f"{p}.conv1.weight"] = (planes, cin, 1, 1)
        s.update(_bn_shapes(f"{p}.bn1", planes))
        s[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
        s.update(_bn_shapes(f"{p}.bn2", planes))
        s[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
        s.update(_bn_shapes(f"{p}.bn3", planes * 4))
        if down:
            s[f"{p}.downsample.0.weight"] = (planes * 4, cin, 1, 1)
            s.update(_bn_shapes(f"{p}.downsample.1", planes * 4))
    c_in = 2048
    if head == "fcn":
        s["classifier.0.weight"] = (c_in // 4, c_in, 3, 3)
        s.update(_bn_shapes("classifier.1", c_in // 4))
        s["classifier.4.weight"] = (NUM_CLASSES, c_in // 4, 1, 1)
        s["classifier.4.bias"] = (NUM_CLASSES,)
        return s
    c = ASPP_CHANNELS
    a = "classifier.0"
    s[f"{a}.convs.0.0.weight"] = (c, c_in, 1, 1)
    s.update(_bn_shapes(f"{a}.convs.0.1", c))
    for i in range(1, 4):
        s[f"{a}.convs.{i}.0.weight"] = (c, c_in, 3, 3)
        s.update(_bn_shapes(f"{a}.convs.{i}.1", c))
    s[f"{a}.convs.4.1.weight"] = (c, c_in, 1, 1)
    s.update(_bn_shapes(f"{a}.convs.4.2", c))
    s[f"{a}.project.0.weight"] = (c, 5 * c, 1, 1)
    s.update(_bn_shapes(f"{a}.project.1", c))
    s["classifier.1.weight"] = (c, c, 3, 3)
    s.update(_bn_shapes("classifier.2", c))
    s["classifier.4.weight"] = (NUM_CLASSES, c, 1, 1)
    s["classifier.4.bias"] = (NUM_CLASSES,)
    return s


@dataclass
class Ops:
    """The operations a forward runs. ``conv(x, w, b, stride, padding,
    dilation)``; ``train``: BatchNorm on batch statistics and the ASPP's
    dropout on ``dropout_keep`` (a bool mask, drawn by the caller);
    ``batch_stats``: BatchNorm on batch statistics alone (for the
    BatchNorms named ``batch_stats_prefix...``); ``on_conv``, if
    given, sees every conv's (input, weight, output), and ``on_bn`` every
    BatchNorm's (name, batch mean, biased batch variance) on batch
    statistics."""
    conv: Callable = None
    train: bool = False
    batch_stats: bool = False
    batch_stats_prefix: str = ""
    dropout_keep: Callable | None = None
    on_conv: Callable | None = None
    on_bn: Callable | None = None

    def c(self, x, w, b=None, stride=1, padding=0, dilation=1):
        fn = self.conv or (lambda x, w, b, s, p, d: F.conv2d(
            x, w, b, s, p, d))
        y = fn(x, w, b, stride, padding, dilation)
        if self.on_conv is not None:
            self.on_conv(x, w, y)
        return y


def _bn(ops: Ops, st: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    if ops.train or (ops.batch_stats and p.startswith(ops.batch_stats_prefix)
                     and x.shape[2] * x.shape[3] > 1):
        if ops.on_bn is not None:
            ops.on_bn(p, x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False))
        return F.batch_norm(x, None, None, st[f"{p}.weight"],
                            st[f"{p}.bias"], True, 0.0, BN_EPS)
    return F.batch_norm(x, st[f"{p}.running_mean"], st[f"{p}.running_var"],
                        st[f"{p}.weight"], st[f"{p}.bias"], False, 0.0,
                        BN_EPS)


def backbone_forward(st: dict, x: torch.Tensor, backbone: str,
                     ops: Ops) -> torch.Tensor:
    """NCHW normalized images -> layer4 features (stride 8)."""
    x = ops.c(x, st["backbone.conv1.weight"], None, 2, 3)
    x = F.relu(_bn(ops, st, "backbone.bn1", x))
    x = F.max_pool2d(x, 3, 2, 1)
    for prefix, _, _, stride, dil, down in _blocks(backbone):
        p = f"backbone.{prefix}"
        y = F.relu(_bn(ops, st, f"{p}.bn1",
                       ops.c(x, st[f"{p}.conv1.weight"])))
        y = F.relu(_bn(ops, st, f"{p}.bn2",
                       ops.c(y, st[f"{p}.conv2.weight"], None, stride,
                             dil, dil)))
        y = _bn(ops, st, f"{p}.bn3", ops.c(y, st[f"{p}.conv3.weight"]))
        if down:
            x = _bn(ops, st, f"{p}.downsample.1",
                    ops.c(x, st[f"{p}.downsample.0.weight"], None, stride))
        x = F.relu(y + x)
    return x


def head_forward(st: dict, x: torch.Tensor, head: str,
                 ops: Ops) -> torch.Tensor:
    """layer4 features -> class logits at the feature stride (NCHW)."""
    if head == "fcn":
        y = F.relu(_bn(ops, st, "classifier.1",
                       ops.c(x, st["classifier.0.weight"], None, 1, 1)))
        if ops.train:
            raise ValueError("the reference trains the DeepLab head only")
        return ops.c(y, st["classifier.4.weight"], st["classifier.4.bias"])
    a = "classifier.0"
    branches = [F.relu(_bn(ops, st, f"{a}.convs.0.1",
                           ops.c(x, st[f"{a}.convs.0.0.weight"])))]
    for i, rate in enumerate(ASPP_RATES, start=1):
        branches.append(F.relu(_bn(ops, st, f"{a}.convs.{i}.1", ops.c(
            x, st[f"{a}.convs.{i}.0.weight"], None, 1, rate, rate))))
    pooled = F.adaptive_avg_pool2d(x, 1)
    pooled = F.relu(_bn(ops, st, f"{a}.convs.4.2",
                        ops.c(pooled, st[f"{a}.convs.4.1.weight"])))
    branches.append(F.interpolate(pooled, size=x.shape[-2:],
                                  mode="bilinear", align_corners=False))
    y = F.relu(_bn(ops, st, f"{a}.project.1",
                   ops.c(torch.cat(branches, 1),
                         st[f"{a}.project.0.weight"])))
    if ops.train:
        keep = ops.dropout_keep(y)
        y = torch.where(keep, y / 0.5, torch.zeros_like(y))
    y = F.relu(_bn(ops, st, "classifier.2",
                   ops.c(y, st["classifier.1.weight"], None, 1, 1)))
    return ops.c(y, st["classifier.4.weight"], st["classifier.4.bias"])


def logits(st: dict, x: torch.Tensor, model: str,
           ops: Ops | None = None) -> torch.Tensor:
    """NCHW normalized images [B, 3, H, W] -> float32 logits [B, 3, H, W]
    at the input's resolution (bicubic, align_corners=False)."""
    ops = ops or Ops()
    head, backbone = split_name(model)
    feat = head_forward(st, backbone_forward(st, x, backbone, ops), head,
                        ops)
    return F.interpolate(feat, size=x.shape[-2:], mode="bicubic",
                         align_corners=False)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NCHW."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def exact_float32() -> None:
    """TF32 off for matmuls and cuDNN convolutions: the reference computes
    in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
