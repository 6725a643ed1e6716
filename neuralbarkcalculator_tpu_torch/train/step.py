"""The train and eval steps (neuralbarkcalculator_tpu/train/step.py).

The reference's per-batch work (Poutyne internals + __main__.py:235-242):
forward -> Lovász-Softmax -> backward -> Adam step -> metrics (miou,
pixel F1). The whole training set lives on the device as uint8, so a step
takes only indices: gather + augment (data/augment.py) -> forward in train
mode (the head's dropout + 1x1 conv through ops/fused_dropout_matmul,
keyed by the step's seed) -> loss -> backward -> Adam, with BatchNorm's
running statistics updated by the forward. Metrics stay on the device
(no host sync inside a step).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config import NUM_CLASSES
from ..data.augment import gather_augment_batch
from ..ops.losses import lovasz_softmax_loss
from ..ops.metrics import confusion_matrix, iou_from_confusion, pixelwise_f1

LossFn = Callable[..., torch.Tensor]


def make_loss_fn(name: str) -> LossFn:
    """The loss menu. Every loss takes ``pixel_weights=None`` ({0, 1}
    validity mask) for exact padded evaluation. Only the exact Lovász loss
    (the reference's, __main__.py:239) is ported."""
    if name == "lovasz":
        return lambda logits, labels, pixel_weights=None: \
            lovasz_softmax_loss(logits, labels, pixel_weights=pixel_weights)
    if name in ("lovasz_hist", "cwe", "mixed", "jaccard"):
        raise NotImplementedError(f"loss {name!r} is not ported yet "
                                  f"(ROADMAP Queue A10)")
    raise ValueError(f"unknown loss {name!r}")


def step_on_batch(model: torch.nn.Module, opt: torch.optim.Optimizer,
                  imgs: torch.Tensor, labs: torch.Tensor, seed: int,
                  loss_fn: LossFn | None = None) -> dict[str, torch.Tensor]:
    """One optimizer step on an augmented batch (imgs [B, H, W, 3]
    normalized, labs [B, H, W]); ``seed`` keys the head's dropout mask.
    Returns 0-d device tensors: loss, miou and the F1 without the
    postprocess (the JAX step's default for train batches)."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.train()
    logits = model(imgs, dropout_seed=seed)
    loss = loss_fn(logits, labs)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    with torch.no_grad():
        cm = confusion_matrix(logits.argmax(dim=-1), labs, NUM_CLASSES)
        return {"loss": loss.detach(),
                "miou": iou_from_confusion(cm).mean(),
                "f1": pixelwise_f1(logits, labs, postprocess=False).mean()}


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels_u8: torch.Tensor,
               idx: torch.Tensor, generator: torch.Generator, seed: int,
               crop: int, mean: torch.Tensor, std: torch.Tensor,
               brightness: float = 0.1, saturation: float = 0.2,
               loss_fn: LossFn | None = None) -> dict[str, torch.Tensor]:
    """Gather + augment the dataset rows idx, then ``step_on_batch``."""
    imgs, labs = gather_augment_batch(images_u8, labels_u8, idx, crop, mean,
                                      std, generator, brightness, saturation)
    return step_on_batch(model, opt, imgs, labs, seed, loss_fn)


def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
              labels_u8: torch.Tensor, idx: torch.Tensor,
              valid: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              loss_fn: LossFn | None = None) -> dict[str, torch.Tensor]:
    """Validation/test step over the device-resident dataset: gather by
    idx, normalize, forward in eval mode, loss and metrics. ``valid`` ([B]
    {0, 1}) marks real samples: padded entries still run through the
    forward but count in neither the loss nor the metrics."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.eval()
    with torch.no_grad():
        imgs = (images_u8[idx].float() / 255.0 - mean) / std
        labs = labels_u8[idx].long()
        pw = valid.float()[:, None, None]
        logits = model(imgs)
        cm = confusion_matrix(logits.argmax(dim=-1), labs, NUM_CLASSES,
                              weights=pw)
        iou = iou_from_confusion(cm)
        f1 = pixelwise_f1(logits, labs, weights=pw)
        return {"loss": loss_fn(logits, labs, pixel_weights=pw),
                "miou": iou.mean(), "iou_per_class": iou,
                "f1": f1.mean(), "f1_per_class": f1}
