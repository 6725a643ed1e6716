"""The train and eval steps (neuralbarkcalculator_tpu/train/step.py).

The reference's per-batch work (Poutyne internals + __main__.py:235-242):
forward -> loss -> backward -> Adam step -> metrics (miou, pixel F1). A
step takes the dataset and indices: gather + augment (data/augment.py) ->
forward in train mode (every random layer keyed by the step's seed:
the FCN head's dropout + 1x1 conv through ops/fused_dropout_matmul, the
DeepLab head's ASPP dropout, EfficientNet's stochastic depth;
models/seeding.py) -> loss -> backward -> Adam, with BatchNorm's running
statistics updated by the forward. Metrics stay on the device (no host
sync inside a step) unless the F1 postprocess is asked for.

``bf16`` runs the forward under ``torch.autocast(bfloat16)``, as the JAX
package's ``use_bfloat16`` runs its conv stack in bf16: parameters and
Adam state stay float32, and the model returns float32 logits, on which
the loss and the metrics are computed.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..config import CLASS_WEIGHTS, NUM_CLASSES
from ..data.augment import gather_augment_batch
from ..ops import losses as L
from ..ops.metrics import confusion_matrix, iou_from_confusion, pixelwise_f1

LossFn = Callable[..., torch.Tensor]
LOSS_NAMES = ("lovasz", "lovasz_hist", "cwe", "mixed", "jaccard")
HIST_BINS = 1024  # lovasz_hist's quantization (JAX train/step.py:437)


@functools.lru_cache(maxsize=None)
def _class_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor(CLASS_WEIGHTS, dtype=torch.float32, device=device)


def make_loss_fn(name: str) -> LossFn:
    """The loss menu (JAX train/step.py:34-62). Every loss takes
    ``pixel_weights=None`` ({0, 1} validity mask) for exact padded
    evaluation.

    - ``lovasz``: exact Lovász-Softmax, the reference's (__main__.py:239);
    - ``lovasz_hist``: its sort-free histogram form, 1024 bins, within
      ~1/bins of it;
    - ``cwe``: the weighted cross-entropy (CLASS_WEIGHTS);
    - ``mixed``: cwe / 4 + Lovász;
    - ``jaccard``: the soft Jaccard loss.
    """
    if name == "lovasz":
        return lambda logits, labels, pixel_weights=None: \
            L.lovasz_softmax_loss(logits, labels, pixel_weights=pixel_weights)
    if name == "lovasz_hist":
        return lambda logits, labels, pixel_weights=None: \
            L.lovasz_softmax_loss(logits, labels, pixel_weights=pixel_weights,
                                  bins=HIST_BINS)
    if name == "cwe":
        return lambda logits, labels, pixel_weights=None: \
            L.weighted_cross_entropy(logits, labels,
                                     _class_weights(logits.device),
                                     pixel_weights=pixel_weights)
    if name == "mixed":
        return lambda logits, labels, pixel_weights=None: \
            L.mixed_loss(logits, labels, _class_weights(logits.device),
                         pixel_weights=pixel_weights)
    if name == "jaccard":
        return lambda logits, labels, pixel_weights=None: \
            L.jaccard_loss(logits, labels, pixel_weights=pixel_weights)
    raise ValueError(f"unknown loss {name!r} (one of {', '.join(LOSS_NAMES)})")


def _autocast(device: torch.device, bf16: bool):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def step_on_batch(model: torch.nn.Module, opt: torch.optim.Optimizer,
                  imgs: torch.Tensor, labs: torch.Tensor, seed: int,
                  loss_fn: LossFn | None = None, bf16: bool = False,
                  f1_postprocess: bool = False) -> dict[str, torch.Tensor]:
    """One optimizer step on an augmented batch (imgs [B, H, W, 3]
    normalized, labs [B, H, W]); ``seed`` keys the model's random layers.
    Returns 0-d device tensors: loss, miou and the F1, without the
    connected-component postprocess unless ``f1_postprocess`` (the JAX
    step's default for train batches)."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.train()
    with _autocast(imgs.device, bf16):
        logits = model(imgs, dropout_seed=seed)
    loss = loss_fn(logits, labs)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    with torch.no_grad():
        cm = confusion_matrix(logits.argmax(dim=-1), labs, NUM_CLASSES)
        return {"loss": loss.detach(),
                "miou": iou_from_confusion(cm).mean(),
                "f1": pixelwise_f1(logits, labs,
                                   postprocess=f1_postprocess).mean()}


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels_u8: torch.Tensor,
               idx: torch.Tensor, generator: torch.Generator, seed: int,
               crop: int, mean: torch.Tensor, std: torch.Tensor,
               brightness: float = 0.1, saturation: float = 0.2,
               loss_fn: LossFn | None = None, bf16: bool = False,
               f1_postprocess: bool = False) -> dict[str, torch.Tensor]:
    """Gather + augment the dataset rows idx, then ``step_on_batch``."""
    imgs, labs = gather_augment_batch(images_u8, labels_u8, idx, crop, mean,
                                      std, generator, brightness, saturation)
    return step_on_batch(model, opt, imgs, labs, seed, loss_fn, bf16,
                         f1_postprocess)


def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
              labels_u8: torch.Tensor, idx: torch.Tensor,
              valid: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              loss_fn: LossFn | None = None, bf16: bool = False
              ) -> dict[str, torch.Tensor]:
    """Validation/test step over the dataset: gather by idx, normalize,
    forward in eval mode, loss and metrics. ``valid`` ([B] {0, 1}) marks
    real samples: padded entries still run through the forward but count
    in neither the loss nor the metrics."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.eval()
    with torch.no_grad():
        imgs = (images_u8[idx].float() / 255.0 - mean) / std
        labs = labels_u8[idx].long()
        pw = valid.float()[:, None, None]
        with _autocast(imgs.device, bf16):
            logits = model(imgs)
        cm = confusion_matrix(logits.argmax(dim=-1), labs, NUM_CLASSES,
                              weights=pw)
        iou = iou_from_confusion(cm)
        f1 = pixelwise_f1(logits, labs, weights=pw)
        return {"loss": loss_fn(logits, labs, pixel_weights=pw),
                "miou": iou.mean(), "iou_per_class": iou,
                "f1": f1.mean(), "f1_per_class": f1}
