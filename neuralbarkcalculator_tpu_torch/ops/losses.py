"""The training loss: exact Lovász-Softmax (reference lovasz_losses.py:
162-223, Berman 2018), as the JAX package formulates it
(neuralbarkcalculator_tpu/ops/losses.py:27-92).

The reference's ``classes='present'`` mean is taken with a presence mask:
every class term is computed and weighted by whether the class occurs.
The sort and the Lovász weights carry no gradient, so they are computed
under ``no_grad`` and scattered back to the unsorted pixels; the loss is
then ``sum(errors * weights)``, and its backward is one elementwise
product. The sort key is the JAX package's: ascending and stable on
``-errors``, with masked-out pixels keyed 1.0 so they sort after every
valid pixel. Ties therefore order the same way in both packages.

Layout: logits [..., H, W, C] (NHWC, as the model returns them), labels
[..., H, W] int. The histogram variant and the other losses of the JAX
package are not ported yet (ROADMAP Queue A10).
"""
from __future__ import annotations

import torch

from ..config import NUM_CLASSES


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to sorted errors,
    along the last axis (reference lovasz_losses.py:19-31)."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(dim=-1)
    union = gts + (1.0 - gt_sorted).cumsum(dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                         num_classes: int,
                         pixel_weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """probas [P, C], labels [P] -> scalar. ``pixel_weights`` ([P] in
    {0, 1}): masked-out pixels behave exactly as if absent."""
    fg = torch.nn.functional.one_hot(labels.long(), num_classes).t().to(
        probas.dtype)                                           # [C, P]
    errors = (fg - probas.t()).abs()
    if pixel_weights is not None:
        w = pixel_weights.to(probas.dtype)
        fg = fg * w
        errors = errors * w
    with torch.no_grad():
        key = -errors
        if pixel_weights is not None:
            key = torch.where(w > 0, key, torch.ones_like(key))
        order = torch.sort(key, dim=1, stable=True).indices
        grad = lovasz_grad(fg.gather(1, order))
        weights = torch.zeros_like(errors).scatter_(1, order, grad)
    losses = (errors * weights).sum(dim=1)
    present = (fg.sum(dim=1) > 0).to(probas.dtype)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        num_classes: int = NUM_CLASSES,
                        pixel_weights: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """LovaszSoftmax over the whole batch (the reference's default,
    per_image=False). ``pixel_weights``: optional {0, 1} validity mask
    broadcastable to labels' shape; masked pixels are excluded exactly."""
    probas = torch.softmax(logits, dim=-1)
    flat_w = None
    if pixel_weights is not None:
        flat_w = torch.broadcast_to(pixel_weights, labels.shape).reshape(-1)
    return _lovasz_softmax_flat(probas.reshape(-1, num_classes),
                                labels.reshape(-1), num_classes, flat_w)
