"""Segmentation model assembly (reference models.py:27-43, 127-139).

``SegmentationModel`` = backbone -> head -> bicubic upsample to the input
resolution. Public tensors are NHWC: images in, float32 logits out, as in
the JAX package, so the two compare like with like.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..config import NUM_CLASSES
from ..ops.resize import bicubic_resize_matrix, bicubic_upsample_ragged
from .heads import FCNHead
from .resnet import DilatedResNet, resnet50_dilated


class SegmentationModel(nn.Module):
    """backbone features -> head logits -> bicubic upsample to input H, W.

    Ragged-height batched inference: pass ``valid_h`` ([B] true trimmed
    heights; inputs zero-padded to the static H) and ``row_upsample``
    ([B, H, H//8] embedded row operators, ops/resize.embedded_bicubic_rows).
    Together these make the padded batch equal to running each image at
    its own height. Without them this is the plain reference forward.
    """

    def __init__(self, backbone: DilatedResNet, classifier: FCNHead):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier

    def head_logits(self, x: torch.Tensor,
                    valid_h: torch.Tensor | None = None,
                    dropout_seed: int | None = None) -> torch.Tensor:
        """NHWC images [B, H, W, 3] -> float32 head logits at the feature
        stride, NHWC [B, F, Wf, classes], without the upsample.
        ``dropout_seed`` keys the head's dropout mask in train mode."""
        feat_h = (None if valid_h is None
                  else self.backbone.valid_feature_height(valid_h))
        x = x.permute(0, 3, 1, 2)
        if self.training:
            # training runs contiguous NCHW, the reference's layout, so the
            # head's activations reach fused_dropout_matmul without a copy
            x = x.contiguous()
        feat = self.backbone(x, valid_h=valid_h)
        logits = self.classifier(feat, valid_h=feat_h,
                                 dropout_seed=dropout_seed).float()
        out = logits.permute(0, 2, 3, 1)
        if logits.is_contiguous(memory_format=torch.channels_last):
            # a channels_last [B, C, F, Wf] viewed as NHWC is contiguous
            assert out.is_contiguous()
            return out
        return out.contiguous()

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                row_upsample: torch.Tensor | None = None,
                dropout_seed: int | None = None) -> torch.Tensor:
        """NHWC images -> NHWC float32 logits at the input resolution."""
        in_h, in_w = x.shape[1], x.shape[2]
        logits = self.head_logits(x, valid_h, dropout_seed)
        if row_upsample is None:
            rows = torch.as_tensor(
                bicubic_resize_matrix(logits.shape[1], in_h).astype(
                    np.float32), device=x.device)
            row_upsample = rows.expand(x.shape[0], -1, -1)
        return bicubic_upsample_ragged(logits, row_upsample, in_w)


def fcn_resnet50(dropout: float = 0.1, num_classes: int = NUM_CLASSES,
                 folded: bool = False) -> SegmentationModel:
    """The reference production model (models.py:127-139, 221)."""
    backbone = resnet50_dilated(folded=folded)
    return SegmentationModel(
        backbone, FCNHead(backbone.out_channels, num_classes,
                          dropout=dropout, folded=folded))


MODEL_FACTORIES: dict[str, Callable[..., SegmentationModel]] = {
    "fcn_resnet50": fcn_resnet50,
}
