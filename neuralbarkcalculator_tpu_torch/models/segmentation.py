"""Segmentation model assembly and the model zoo (reference
models.py:27-154).

``SegmentationModel`` = backbone -> head -> bicubic upsample to the input
resolution. Public tensors are NHWC: images in, float32 logits out, as in
the JAX package, so the two compare like with like. The factories mirror
the reference's zoo:

- fcn_resnet50 (models.py:127-139), the production model (models.py:221);
- fcn_resnet101 (models.py:142-154);
- deeplabv3_resnet50 / deeplabv3_resnet101 (models.py:46-71);
- fcn_efficientnet / deeplabv3_efficientnet (models.py:86-110), and the
  variant-bound names ``fcn_efficientnet_b0`` ...
  ``deeplabv3_efficientnet_b7``;
- ``segformer_b5`` (models/segformer.py), which the port alone holds
  (``PORT_ONLY``): a MiT-B5 encoder whose four maps go to an all-MLP
  decoder (``backbone(x)`` gives a tuple of maps, which the head takes
  whole), logits at stride 4 (``logit_stride``).

``QuantizedSegmentationModel`` is the int8 model of the ResNet factories
(models/quantize.py).

Width partitioning (``width``, the model group of a mesh; JAX's
``model`` axis): ``head_logits`` runs the backbone and head on this
rank's strip of the width (parallel/spatial.py) and gathers the logits
to the full width, as JAX's ``shard_map`` gathers them for
``upsample_argmax`` (JAX pipeline/predict.py:870-882). Inference only,
every factory: the dilated ResNets with the FCN or the DeepLab head, in
float and in int8, and EfficientNet (float only: int8 EfficientNet is
refused by models/quantize.check_quantizable, as in JAX) on strips of
its feature stride (models/efficientnet.py). The input strip carries the
backbone's ``stem_halo``.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..config import NUM_CLASSES
from ..ops.resize import bicubic_resize_matrix, bicubic_upsample_ragged
from ..parallel.distributed import World
from ..parallel.spatial import gather_width, is_split
from .efficientnet import SCALING, EfficientNetBackbone
from .heads import DeepLabHead, FCNHead
from .resnet import resnet101_dilated, resnet50_dilated
from .segformer import MIT_B5, MixTransformer, SegformerDecodeHead


class SegmentationModel(nn.Module):
    """backbone features -> head logits -> bicubic upsample to input H, W.

    Ragged-height batched inference (ResNet backbones): pass ``valid_h``
    ([B] true trimmed heights; inputs zero-padded to the static H) and
    ``row_upsample`` ([B, H, H//8] embedded row operators,
    ops/resize.embedded_bicubic_rows). Together these make the padded batch
    equal to running each image at its own height. Without them this is
    the plain reference forward. A backbone without ragged support
    (``supports_ragged`` False: EfficientNet) raises on ``valid_h``.
    """

    def __init__(self, backbone: nn.Module, classifier: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier

    @property
    def logit_stride(self) -> int:
        """The stride of ``head_logits``' rows and columns against the
        input's: a head's own (SegFormer's decoder: 4) or else the
        backbone's feature stride (8 for the dilated ResNets, 32 for
        EfficientNet)."""
        return (getattr(self.classifier, "logit_stride", None)
                or self.backbone.feature_stride)

    def head_logits(self, x: torch.Tensor,
                    valid_h: torch.Tensor | None = None,
                    dropout_seed: int | None = None,
                    shard: tuple[int, int] = (0, 1),
                    width: World | None = None) -> torch.Tensor:
        """NHWC images [B, H, W, 3] -> float32 head logits at the feature
        stride, NHWC [B, F, Wf, classes], without the upsample.
        ``dropout_seed`` keys every random layer in train mode: the head's
        dropout and a backbone's stochastic depth (models/seeding.py);
        ``shard``, (rank, size), places a data-parallel rank's rows in the
        global batch's draws. ``width``: the model group that splits the
        width; then ``x`` is this rank's strip with the backbone's
        ``stem_halo``, and the logits are the full width's."""
        split = is_split(width)
        if split:
            if self.training:
                raise ValueError("width partitioning is inference-only (the "
                                 "JAX package never splits a training "
                                 "step's width)")
        width_kw = {"width": width} if split else {}
        x = x.permute(0, 3, 1, 2)
        if self.training:
            if self.backbone.folded or self.classifier.folded:
                raise ValueError("a folded model is inference-only")
            # training runs contiguous NCHW, the reference's layout, so the
            # head's activations reach fused_dropout_matmul without a copy
            x = x.contiguous()
        if valid_h is None:
            feat = self.backbone(x, dropout_seed=dropout_seed, shard=shard,
                                 **width_kw)
            feat_h = None
        else:
            # raises for a backbone without ragged support
            feat_h = self.backbone.valid_feature_height(valid_h)
            feat = self.backbone(x, valid_h=valid_h, **width_kw)
        logits = self.classifier(feat, valid_h=feat_h,
                                 dropout_seed=dropout_seed,
                                 shard=shard, **width_kw).float()
        if split:
            logits = gather_width(logits, width)
        out = logits.permute(0, 2, 3, 1)
        if logits.is_contiguous(memory_format=torch.channels_last):
            # a channels_last [B, C, F, Wf] viewed as NHWC is contiguous
            assert out.is_contiguous()
            return out
        return out.contiguous()

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                row_upsample: torch.Tensor | None = None,
                dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """NHWC images -> NHWC float32 logits at the input resolution. The
        upsample runs in float32 also under autocast (the loss and the
        metrics take float32 logits). ``width``: as ``head_logits``; the
        logits are the full width's."""
        in_h, in_w = x.shape[1], x.shape[2]
        if is_split(width):
            in_w = (in_w - sum(self.backbone.stem_halo)) * width.size
        logits = self.head_logits(x, valid_h, dropout_seed, shard, width)
        if row_upsample is None:
            rows = torch.as_tensor(
                bicubic_resize_matrix(logits.shape[1], in_h).astype(
                    np.float32), device=x.device)
            row_upsample = rows.expand(x.shape[0], -1, -1)
        with torch.autocast(x.device.type, enabled=False):
            return bicubic_upsample_ragged(logits, row_upsample, in_w)


class QuantizedSegmentationModel(SegmentationModel):
    """The int8 inference model (models/quantize.py builds it): a
    ``QuantizedResNet`` and a ``QuantizedFCNHead`` or
    ``QuantizedDeepLabHead``. The path stays NHWC from the stem to the
    logits, with no permute; ``head_logits`` returns float32 NHWC
    [B, F, Wf, classes], contiguous, for ``upsample_argmax``, and the
    inherited ``forward`` upsamples them. Inference only. ``width``: as
    ``SegmentationModel.head_logits``'s; the backbone and head run on the
    rank's strip and the logits are gathered to the full width."""

    def head_logits(self, x: torch.Tensor,
                    valid_h: torch.Tensor | None = None,
                    dropout_seed: int | None = None,
                    shard: tuple[int, int] = (0, 1),
                    width: World | None = None) -> torch.Tensor:
        if self.training:
            raise ValueError("an int8 model is inference-only")
        feat_h = (None if valid_h is None
                  else self.backbone.valid_feature_height(valid_h))
        if not is_split(width):
            return self.classifier(self.backbone(x, valid_h), feat_h)
        logits = self.classifier(self.backbone(x, valid_h, width), feat_h,
                                 width)
        return gather_width(logits, width, dim=2)


def fcn_resnet50(dropout: float = 0.1, num_classes: int = NUM_CLASSES
                 ) -> SegmentationModel:
    """The reference production model (models.py:127-139, 221)."""
    backbone = resnet50_dilated()
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, num_classes,
                          dropout=dropout))


def fcn_resnet101(dropout: float = 0.1, num_classes: int = NUM_CLASSES
                  ) -> SegmentationModel:
    backbone = resnet101_dilated()
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, num_classes,
                          dropout=dropout))


def deeplabv3_resnet50(num_classes: int = NUM_CLASSES) -> SegmentationModel:
    backbone = resnet50_dilated()
    return SegmentationModel(
        backbone, DeepLabHead(backbone.out_channels, num_classes))


def deeplabv3_resnet101(num_classes: int = NUM_CLASSES) -> SegmentationModel:
    backbone = resnet101_dilated()
    return SegmentationModel(
        backbone, DeepLabHead(backbone.out_channels, num_classes))


def fcn_efficientnet(n: int, dropout: float = 0.1,
                     num_classes: int = NUM_CLASSES) -> SegmentationModel:
    backbone = EfficientNetBackbone(n)
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, num_classes,
                          dropout=dropout))


def deeplabv3_efficientnet(n: int, num_classes: int = NUM_CLASSES
                           ) -> SegmentationModel:
    backbone = EfficientNetBackbone(n)
    return SegmentationModel(
        backbone, DeepLabHead(backbone.out_channels, num_classes))


def segformer_b5(num_classes: int = NUM_CLASSES) -> SegmentationModel:
    """SegFormer-B5 (models/segformer.py), the published widths."""
    backbone = MixTransformer(MIT_B5)
    return SegmentationModel(backbone, SegformerDecodeHead(
        backbone.out_channels, MIT_B5.decoder_hidden, num_classes))


MODEL_FACTORIES: dict[str, Callable[..., SegmentationModel]] = {
    "fcn_resnet50": fcn_resnet50,
    "fcn_resnet101": fcn_resnet101,
    "deeplabv3_resnet50": deeplabv3_resnet50,
    "deeplabv3_resnet101": deeplabv3_resnet101,
    "fcn_efficientnet": fcn_efficientnet,
    "deeplabv3_efficientnet": deeplabv3_efficientnet,
    "segformer_b5": segformer_b5,
}
# the zoo's names that the JAX package does not have
PORT_ONLY = frozenset({"segformer_b5"})
# variant-bound names, so the CLIs and the engine select an EfficientNet
# without a separate n (reference callers pass n positionally,
# models.py:104)
for _n in range(len(SCALING)):
    MODEL_FACTORIES[f"fcn_efficientnet_b{_n}"] = functools.partial(
        fcn_efficientnet, _n)
    MODEL_FACTORIES[f"deeplabv3_efficientnet_b{_n}"] = functools.partial(
        deeplabv3_efficientnet, _n)


def efficientnet_variant_of(model_name: str) -> int | None:
    """'fcn_efficientnet_b3' -> 3; None for the other names."""
    if "_efficientnet_b" in model_name:
        return int(model_name.rsplit("_b", 1)[1])
    return None
