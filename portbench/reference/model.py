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

Every convolution goes through ``ops.c`` and every BatchNorm through
``batch_norm(ops, ...)`` (reference/__init__.py: the interface of a
reference module, which this one provides), so the FLOP counter
(lib/flops.py) and the lower-precision control (reference/control.py)
see the same graph. Nothing here imports the program under test.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from . import Normal, Ops, Uniform, Zeros, batch_norm

NUM_CLASSES = 3
ASPP_RATES = (12, 24, 36)
ASPP_CHANNELS = 256
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


# the drawn weights (lib/weights.py): He-normal convolutions, a nonzero
# BatchNorm state (running mean N(0, 0.1), running variance U(0.5, 2), scale
# U(0.5, 1.5), the scale of a BatchNorm that ends a residual branch U(0.1,
# 0.3) so that the random network stays in range), biases N(0, 0.1)
RESIDUAL_END_BN = (".bn3.weight", "downsample.1.weight")
# calibrated (lib/weights.calibrate_bn): the heads' BatchNorms, less
# DeepLab's pooled branch, whose batch statistics are over one value an
# image, a variance of a few samples
CALIBRATE_PREFIX = "classifier."
CALIBRATE_EXCLUDE = ("classifier.0.convs.4.2",)


def init_rule(name: str, shape: tuple) -> Normal | Uniform | Zeros:
    """How lib/weights.py draws the entry ``name`` of ``shape``."""
    if len(shape) == 4:
        return Normal((2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)
    if name.endswith(("running_mean", "bias")):
        return Normal(0.1)
    if name.endswith("num_batches_tracked"):
        return Zeros(torch.int64)
    if name.endswith("running_var"):
        return Uniform(0.5, 2.0)
    if name.endswith(RESIDUAL_END_BN):
        return Uniform(0.1, 0.3)
    return Uniform(0.5, 1.5)


def trains(model: str) -> bool:
    """The DeepLab head trains here; the FCN head's dropout is the
    program's fused kernel, whose mask this reference does not draw."""
    return split_name(model)[0] == "deeplabv3"


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


def backbone_forward(st: dict, x: torch.Tensor, backbone: str,
                     ops: Ops) -> torch.Tensor:
    """NCHW normalized images -> layer4 features (stride 8)."""
    x = ops.c(x, st["backbone.conv1.weight"], None, 2, 3)
    x = F.relu(batch_norm(ops, st, "backbone.bn1", x))
    x = F.max_pool2d(x, 3, 2, 1)
    for prefix, _, _, stride, dil, down in _blocks(backbone):
        x = ops.block(partial(_bottleneck, st, f"backbone.{prefix}", stride,
                              dil, down, ops), x)
    return x


def _bottleneck(st: dict, p: str, stride: int, dil: int, down: bool,
                ops: Ops, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(batch_norm(ops, st, f"{p}.bn1",
                          ops.c(x, st[f"{p}.conv1.weight"])))
    y = F.relu(batch_norm(ops, st, f"{p}.bn2",
                          ops.c(y, st[f"{p}.conv2.weight"], None, stride,
                                dil, dil)))
    y = batch_norm(ops, st, f"{p}.bn3", ops.c(y, st[f"{p}.conv3.weight"]))
    if down:
        x = batch_norm(ops, st, f"{p}.downsample.1",
                       ops.c(x, st[f"{p}.downsample.0.weight"], None,
                             stride))
    return F.relu(y + x)


def head_forward(st: dict, x: torch.Tensor, head: str,
                 ops: Ops) -> torch.Tensor:
    """layer4 features -> class logits at the feature stride (NCHW)."""
    if head == "fcn":
        y = F.relu(batch_norm(ops, st, "classifier.1", ops.c(
            x, st["classifier.0.weight"], None, 1, 1)))
        if ops.train:
            raise ValueError("the reference trains the DeepLab head only")
        return ops.c(y, st["classifier.4.weight"], st["classifier.4.bias"])
    a = "classifier.0"
    branches = [F.relu(batch_norm(ops, st, f"{a}.convs.0.1", ops.c(
        x, st[f"{a}.convs.0.0.weight"])))]
    for i, rate in enumerate(ASPP_RATES, start=1):
        branches.append(F.relu(batch_norm(ops, st, f"{a}.convs.{i}.1", ops.c(
            x, st[f"{a}.convs.{i}.0.weight"], None, 1, rate, rate))))
    pooled = F.adaptive_avg_pool2d(x, 1)
    pooled = F.relu(batch_norm(ops, st, f"{a}.convs.4.2", ops.c(
        pooled, st[f"{a}.convs.4.1.weight"])))
    branches.append(F.interpolate(pooled, size=x.shape[-2:],
                                  mode="bilinear", align_corners=False))
    y = F.relu(batch_norm(ops, st, f"{a}.project.1", ops.c(
        torch.cat(branches, 1), st[f"{a}.project.0.weight"])))
    if ops.train:
        keep = ops.dropout_keep(y)
        y = torch.where(keep, y / 0.5, torch.zeros_like(y))
    y = F.relu(batch_norm(ops, st, "classifier.2", ops.c(
        y, st["classifier.1.weight"], None, 1, 1)))
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
