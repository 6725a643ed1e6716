"""Segmentation metrics (neuralbarkcalculator_tpu/ops/metrics.py), in
PyTorch.

- ``iou_from_confusion`` (reference lovasz_losses.py:54-73): per-class IoU
  x100 over the whole batch, EMPTY=1.0 when a class's union is zero.
- ``pixelwise_f1`` (reference PixelWiseF1, utils.py:201-235): argmax ->
  remove_small_zones -> per-class F1, plus the absent-class fixup: a class
  in neither target nor output takes the mean of the other scores, in
  class order on the running vector, as the reference's in-place loop does.

Counts are exact integers (scatter-add); the scores are float32 in the JAX
package's order of operations. The postprocess is ops/ccl.remove_small_zones
on the tensor's device (the union-find kernels on a card, the plain version
on the CPU), as the JAX package's metrics.py runs its ops/ccl: the class
maps never leave the device.
"""
from __future__ import annotations

import torch

from ..config import NUM_CLASSES
from .ccl import remove_small_zones


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int = NUM_CLASSES,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """[C, C] int64 counts: rows = true class, columns = predicted class.
    ``weights`` ({0, 1}, broadcastable to labels' shape): masked-out pixels
    count nothing."""
    idx = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    ones = torch.ones_like(idx)
    if weights is not None:
        ones = (torch.broadcast_to(weights, labels.shape).reshape(-1)
                > 0).long()
    # integer scatter-add: exact, and no host sync (bincount would read
    # the largest index back to size its output)
    cm = torch.zeros(num_classes ** 2, dtype=torch.int64, device=idx.device)
    return cm.scatter_add_(0, idx, ones).reshape(num_classes, num_classes)


def iou_from_confusion(cm: torch.Tensor, empty: float = 1.0) -> torch.Tensor:
    """Per-class IoU x100 with the reference's EMPTY convention."""
    cm = cm.to(torch.float32)
    tp = cm.diagonal()
    union = cm.sum(dim=0) + cm.sum(dim=1) - tp
    iou_c = torch.where(union > 0, tp / union.clamp_min(1.0),
                        torch.full_like(tp, empty))
    return 100.0 * iou_c


def f1_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Per-class F1; 0 where the denominator is 0 (sklearn's
    zero_division default)."""
    cm = cm.to(torch.float32)
    tp = cm.diagonal()
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp_min(1.0),
                       torch.zeros_like(tp))


def _absent_class_fixup(scores: torch.Tensor, cm: torch.Tensor
                        ) -> torch.Tensor:
    """Reference utils.py:221-226: a class absent from both target and
    output takes the mean of the other scores, sequentially in class
    order on the running (already fixed) vector."""
    scores = scores.clone()
    absent = (cm.sum(dim=1) == 0) & (cm.sum(dim=0) == 0)
    for i in range(scores.shape[0]):  # selects on the device: no host sync
        others = torch.cat([scores[:i], scores[i + 1:]])
        scores[i] = torch.where(absent[i], others.mean(), scores[i])
    return scores


def pixelwise_f1(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int = NUM_CLASSES, postprocess: bool = True,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """PixelWiseF1 (utils.py:211-226): the raw [C] float32 vector.

    logits: [..., H, W, C]; labels: [..., H, W] int; weights: optional
    {0, 1} validity mask that keeps padded pixels out of the counts.
    """
    preds = logits.argmax(dim=-1)
    if postprocess:
        preds = remove_small_zones(preds if preds.dim() >= 2
                                   else preds[None])
    cm = confusion_matrix(preds, labels, num_classes, weights=weights)
    return _absent_class_fixup(f1_from_confusion(cm), cm)
