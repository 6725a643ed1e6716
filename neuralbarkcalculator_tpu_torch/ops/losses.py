"""The training losses, as the JAX package formulates them
(neuralbarkcalculator_tpu/ops/losses.py), in PyTorch.

- Lovász-Softmax (reference lovasz_losses.py:162-223, Berman 2018), the
  reference's loss (__main__.py:239), exact, and its sort-free histogram
  variant (``bins > 0``, the ``lovasz_hist`` menu entry);
- the binary Lovász hinge and its helpers (lovasz_losses.py:34-156,
  246-251): ``lovasz_hinge_loss``, ``flatten_binary_scores``,
  ``binary_xloss``, ``iou_binary``, ``xloss``, ``stable_bce_loss``;
- CustomWeightedCrossEntropy, JaccardLoss and MixedLoss (utils.py:151-192).

The reference's ``classes='present'`` mean is taken with a presence mask:
every class term is computed and weighted by whether the class occurs.
The sort and the Lovász weights carry no gradient, so they are computed
under ``no_grad`` and scattered back to the unsorted pixels; the loss is
then ``sum(errors * weights)``, and its backward is one elementwise
product. The sort key is the JAX package's: ascending and stable on
``-errors``, with masked-out pixels keyed 1.0 so they sort after every
valid pixel. Ties therefore order the same way in both packages.

``pixel_weights`` (a {0, 1} validity mask broadcastable to the labels) is
the static-shape form of the reference's ``ignore`` label: masked pixels
count exactly as if absent.

Layout: logits [..., H, W, C] (NHWC, as the model returns them), labels
[..., H, W] int.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

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


def _fg_errors(probas: torch.Tensor, labels: torch.Tensor, num_classes: int,
               pixel_weights: torch.Tensor | None):
    """(fg, errors), both [C, P], with masked-out pixels zeroed."""
    fg = F.one_hot(labels.long(), num_classes).t().to(probas.dtype)
    errors = (fg - probas.t()).abs()
    if pixel_weights is not None:
        w = pixel_weights.to(probas.dtype)
        fg = fg * w
        errors = errors * w
    return fg, errors


def _present_mean(losses: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    present = (fg.sum(dim=1) > 0).to(losses.dtype)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                         num_classes: int,
                         pixel_weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """probas [P, C], labels [P] -> scalar. ``pixel_weights`` ([P] in
    {0, 1}): masked-out pixels behave exactly as if absent."""
    fg, errors = _fg_errors(probas, labels, num_classes, pixel_weights)
    with torch.no_grad():
        key = -errors
        if pixel_weights is not None:
            key = torch.where(pixel_weights > 0, key, torch.ones_like(key))
        order = torch.sort(key, dim=1, stable=True).indices
        grad = lovasz_grad(fg.gather(1, order))
        weights = torch.zeros_like(errors).scatter_(1, order, grad)
    return _present_mean((errors * weights).sum(dim=1), fg)


def lovasz_hist_counts(errors: torch.Tensor, fg: torch.Tensor, bins: int,
                       pixel_weights: torch.Tensor | None = None):
    """The histogram Lovász's quantized keys and prefix counts: (bin [C, P]
    int64, -1 for masked pixels; cum_all [C, bins] and cum_fg [C, bins],
    the pixels, and the foreground pixels, whose bin is >= k), exact
    integer counts in int64. Per-class ``scatter_add_`` histograms and a
    reverse cumsum: never the [C, bins, P] compare."""
    c = errors.shape[0]
    b = (errors * bins).to(torch.int64).clamp(0, bins - 1)
    if pixel_weights is not None:
        b = torch.where(pixel_weights > 0, b, -1)
    # slot 0 of each class row takes the masked pixels; bins follow
    slots = (b + 1 + (bins + 1) * torch.arange(
        c, device=b.device).unsqueeze(1)).reshape(-1)
    hist_all = torch.zeros(c * (bins + 1), dtype=torch.int64,
                           device=b.device)
    hist_all.scatter_add_(0, slots, torch.ones_like(slots))
    hist_fg = torch.zeros_like(hist_all).scatter_add_(
        0, slots, fg.reshape(-1).to(torch.int64))

    def suffix_sums(hist):
        return hist.view(c, bins + 1)[:, 1:].flip(1).cumsum(1).flip(1)

    return b, suffix_sums(hist_all), suffix_sums(hist_fg)


def _lovasz_softmax_flat_hist(probas: torch.Tensor, labels: torch.Tensor,
                              num_classes: int, bins: int,
                              pixel_weights: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Sort-free Lovász-Softmax (JAX ``_lovasz_softmax_flat_hist``): the
    sort keys are quantized to ``bins`` levels (the errors keep float32 in
    the final product), and each pixel's Lovász weight is its bin's
    tie-averaged one, from the cumulative counts of pixels in that bin or
    above:

        J_end(k) = 1 - (gts - cum_fg(k)) / (gts + cum_all(k) - cum_fg(k))
        w(k)     = (J_end(k) - J_end(k+1)) / (count in bin k)
        loss     = sum_p errors_p * w(bin_p)

    Equal to the exact loss when the errors are distinct multiples of
    1/bins, within ~1/bins of it otherwise. The keys and the weights carry
    no gradient."""
    fg, errors = _fg_errors(probas, labels, num_classes, pixel_weights)
    with torch.no_grad():
        b, cum_all, cum_fg = lovasz_hist_counts(errors, fg, bins,
                                                pixel_weights)
        cum_all = cum_all.to(probas.dtype)
        cum_fg = cum_fg.to(probas.dtype)
        zero = torch.zeros_like(cum_all[:, :1])
        count = cum_all - torch.cat([cum_all[:, 1:], zero], 1)
        gts = fg.sum(dim=1, keepdim=True)
        intersection = gts - cum_fg
        union = gts + (cum_all - cum_fg)
        j_end = torch.where(union > 0, 1.0 - intersection / union, 0.0)
        j_next = torch.cat([j_end[:, 1:], zero], 1)
        w_bin = torch.where(count > 0, (j_end - j_next) / count.clamp_min(1.0),
                            0.0)
        weights = torch.where(b >= 0, w_bin.gather(1, b.clamp_min(0)), 0.0)
    return _present_mean((errors * weights).sum(dim=1), fg)


def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        num_classes: int = NUM_CLASSES,
                        per_image: bool = False,
                        pixel_weights: torch.Tensor | None = None,
                        bins: int = 0) -> torch.Tensor:
    """LovaszSoftmax over the whole batch (the reference's default,
    per_image=False) or averaged over the leading axis (per_image=True,
    lovasz_losses.py:180-184). ``pixel_weights``: optional {0, 1} validity
    mask broadcastable to labels' shape; masked pixels are excluded
    exactly. ``bins > 0`` takes the histogram formulation."""
    probas = torch.softmax(logits, dim=-1)
    if pixel_weights is not None:
        pixel_weights = torch.broadcast_to(pixel_weights, labels.shape)

    def flat(p, lab, w):
        p, lab = p.reshape(-1, num_classes), lab.reshape(-1)
        w = None if w is None else w.reshape(-1)
        if bins:
            return _lovasz_softmax_flat_hist(p, lab, num_classes, bins, w)
        return _lovasz_softmax_flat(p, lab, num_classes, w)

    if not per_image:
        return flat(probas, labels, pixel_weights)
    per = torch.stack([
        flat(probas[i], labels[i],
             None if pixel_weights is None else pixel_weights[i])
        for i in range(probas.shape[0])])
    if pixel_weights is None:
        return per.mean()
    valid = (pixel_weights.reshape(per.shape[0], -1).sum(dim=1) > 0).to(
        per.dtype)
    return (per * valid).sum() / valid.sum().clamp_min(1.0)


def _lovasz_hinge_flat(flat_logits: torch.Tensor, flat_labels: torch.Tensor,
                       pixel_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Flat binary Lovász hinge (lovasz_losses.py:102-119). Masked pixels
    get error 0 and no ground truth, and sort after every valid pixel."""
    flat_labels = flat_labels.to(flat_logits.dtype)
    errors = 1.0 - flat_logits * (2.0 * flat_labels - 1.0)
    if pixel_weights is not None:
        w = pixel_weights.to(flat_logits.dtype)
        errors = errors * w
        flat_labels = flat_labels * w
    with torch.no_grad():
        key = errors
        if pixel_weights is not None:
            # valid errors can be negative: masked pixels key -inf
            key = torch.where(pixel_weights > 0, errors, -torch.inf)
        perm = torch.sort(-key, stable=True).indices
        grad = lovasz_grad(flat_labels[perm])
    return torch.dot(F.relu(errors[perm]), grad)


def lovasz_hinge_loss(logits: torch.Tensor, labels: torch.Tensor,
                      per_image: bool = False,
                      pixel_weights: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Binary Lovász hinge (lovasz_losses.py:83-119): logits [..., H, W]
    real-valued, labels [..., H, W] in {0, 1}; per_image averages over the
    leading axis."""
    if pixel_weights is not None:
        pixel_weights = torch.broadcast_to(pixel_weights, labels.shape)
    if per_image:
        return torch.stack([
            _lovasz_hinge_flat(
                logits[i].reshape(-1), labels[i].reshape(-1),
                None if pixel_weights is None
                else pixel_weights[i].reshape(-1))
            for i in range(logits.shape[0])]).mean()
    return _lovasz_hinge_flat(
        logits.reshape(-1), labels.reshape(-1),
        None if pixel_weights is None else pixel_weights.reshape(-1))


def flatten_binary_scores(scores: torch.Tensor, labels: torch.Tensor,
                          ignore: int | None = None):
    """lovasz_losses.py:122-134: flatten, and drop the pixels labelled
    ``ignore``."""
    scores, labels = scores.reshape(-1), labels.reshape(-1)
    if ignore is None:
        return scores, labels
    valid = labels != ignore
    return scores[valid], labels[valid]


def stable_bce_loss(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """StableBCELoss (lovasz_losses.py:137-144)."""
    x = logits.reshape(-1)
    t = targets.reshape(-1).to(x.dtype)
    return (x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def binary_xloss(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int | None = None) -> torch.Tensor:
    """Binary cross-entropy through StableBCE (lovasz_losses.py:147-156)."""
    return stable_bce_loss(*flatten_binary_scores(logits, labels, ignore))


def iou_binary(preds: torch.Tensor, labels: torch.Tensor, EMPTY: float = 1.0,
               ignore: int | None = None, per_image: bool = True
               ) -> torch.Tensor:
    """Foreground IoU x100 (lovasz_losses.py:34-51); ``ignore`` pixels
    leave the union's prediction term only, as in the reference."""
    if not per_image:
        preds, labels = preds.reshape(1, -1), labels.reshape(1, -1)
    p = preds.reshape(preds.shape[0], -1)
    lab = labels.reshape(labels.shape[0], -1)
    not_ignored = (torch.ones_like(lab, dtype=torch.bool) if ignore is None
                   else lab != ignore)
    inter = ((lab == 1) & (p == 1)).sum(dim=1)
    union = ((lab == 1) | ((p == 1) & not_ignored)).sum(dim=1)
    iou = torch.where(union > 0, inter / union.clamp_min(1),
                      torch.full_like(inter, EMPTY, dtype=torch.float32))
    return 100.0 * iou.float().mean()


def xloss(logits: torch.Tensor, labels: torch.Tensor,
          ignore: int | None = None) -> torch.Tensor:
    """Cross-entropy (lovasz_losses.py:246-251). The reference ignores its
    ``ignore`` argument and hard-codes 255; so does this. NHWC logits."""
    del ignore
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels != 255
    safe = torch.where(valid, labels, 0).long()
    ce = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    vw = valid.to(ce.dtype)
    return (ce * vw).sum() / vw.sum().clamp_min(1.0)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor | Sequence[float],
                           pixel_weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """CustomWeightedCrossEntropy (utils.py:151-165): each pixel's CE
    weighted by ``weights[max(argmax(logits), label)]``."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(logp * F.one_hot(labels.long(), logits.shape[-1]).to(
        logp.dtype)).sum(dim=-1)
    weights = torch.as_tensor(weights, dtype=ce.dtype, device=ce.device)
    w = weights[torch.maximum(logits.argmax(dim=-1), labels.long())]
    if pixel_weights is not None:
        pw = torch.broadcast_to(pixel_weights, labels.shape).to(ce.dtype)
        return (ce * w * pw).sum() / pw.sum().clamp_min(1.0)
    return (ce * w).mean()


def jaccard_loss(logits: torch.Tensor, labels: torch.Tensor,
                 eps: float = 1e-7, num_classes: int = NUM_CLASSES,
                 pixel_weights: torch.Tensor | None = None) -> torch.Tensor:
    """JaccardLoss (utils.py:168-182): soft IoU over every axis but the
    class axis, averaged over the classes."""
    probas = torch.softmax(logits, dim=-1)
    one_hot = F.one_hot(labels.long(), num_classes).to(probas.dtype)
    if pixel_weights is not None:
        pw = torch.broadcast_to(pixel_weights, labels.shape).to(
            probas.dtype).unsqueeze(-1)
        probas, one_hot = probas * pw, one_hot * pw
    axes = tuple(range(probas.dim() - 1))
    intersection = (probas * one_hot).sum(dim=axes)
    union = (probas + one_hot).sum(dim=axes) - intersection
    return 1.0 - (intersection / (union + eps)).mean()


def mixed_loss(logits: torch.Tensor, labels: torch.Tensor,
               cwe_weights: torch.Tensor | Sequence[float],
               pixel_weights: torch.Tensor | None = None) -> torch.Tensor:
    """MixedLoss (utils.py:185-192): CWE / 4 + Lovász-Softmax."""
    return (weighted_cross_entropy(logits, labels, cwe_weights,
                                   pixel_weights=pixel_weights) / 4.0
            + lovasz_softmax_loss(logits, labels,
                                  pixel_weights=pixel_weights))
