"""The train and eval steps (neuralbarkcalculator_tpu/train/step.py).

The reference's per-batch work (Poutyne internals + __main__.py:235-242):
forward -> loss -> backward -> Adam step -> metrics (miou, pixel F1). A
step takes the dataset and indices: gather + augment (data/augment.py) ->
forward in train mode (every random layer keyed by the step's seed:
the FCN head's dropout + 1x1 conv through ops/fused_dropout_matmul, the
DeepLab head's ASPP dropout, EfficientNet's stochastic depth;
models/seeding.py) -> loss -> backward -> Adam, with BatchNorm's running
statistics updated by the forward. Metrics stay on the device, the F1
postprocess included (ops/ccl's union-find kernels on a card): no host
sync inside a step.

``bf16`` runs the forward under ``torch.autocast(bfloat16)``, as the JAX
package's ``use_bfloat16`` runs its conv stack in bf16: parameters and
Adam state stay float32, and the model returns float32 logits, on which
the loss and the metrics are computed.

Data-parallel steps (``world``, parallel/distributed.py): each rank runs
the forward on its rows of the global batch (the model's BatchNorms take
global statistics, parallel/sync_bn.py; its random layers draw the global
batch's values, models/seeding.py). The logits, labels and pixel weights
are then gathered into the global batch, where every rank computes the
same loss and metrics: the Lovász-Softmax loss (``per_image=False``) sorts
the errors of the whole batch and does not split across ranks. The
gather's backward keeps each rank's own rows, so a rank's parameter
gradients are its rows' share of the global gradient; one all-reduce sums
them before the optimizer step (the JAX step's psum under GSPMD). The
step is then the single-process step on the global batch, on every rank.
Without a world, or with one of one rank and no process group, no
collective runs.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..config import CLASS_WEIGHTS, NUM_CLASSES
from ..data.augment import gather_augment_batch
from ..ops import losses as L
from ..parallel.distributed import World
from ..ops.metrics import confusion_matrix, iou_from_confusion, pixelwise_f1
from ..utils.profiling import stage_timer

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
                  f1_postprocess: bool = False, world: World | None = None
                  ) -> dict[str, torch.Tensor]:
    """One optimizer step on an augmented batch (imgs [B, H, W, 3]
    normalized, labs [B, H, W]: this rank's rows of the global batch under
    ``world``); ``seed`` keys the model's random layers. Returns 0-d
    device tensors of the global batch: loss, miou and the F1, without
    the connected-component postprocess unless ``f1_postprocess`` (the
    JAX step's default for train batches). Stage timers: ``train/forward``
    (the model and the loss), ``train/backward`` (clearing the gradients,
    the backward pass and, under ``world``, their all-reduce, itself in
    ``train/collective/grads``; the cross-rank BatchNorm's all-reduces are
    in ``train/collective/bn``),
    ``train/optimizer`` (the Adam step), ``train/metrics``."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.train()
    with stage_timer("train/forward"):
        with _autocast(imgs.device, bf16):
            logits = model(imgs, dropout_seed=seed,
                           shard=(0, 1) if world is None else (world.rank,
                                                               world.size))
        if world is not None:
            logits, labs = world.gather_rows(logits), world.gather_rows(labs)
        loss = loss_fn(logits, labs)
    with stage_timer("train/backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if world is not None:
            with stage_timer("train/collective/grads"):
                world.all_reduce_grads(model.parameters())
    with stage_timer("train/optimizer"):
        opt.step()
    with stage_timer("train/metrics"), torch.no_grad():
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
               f1_postprocess: bool = False, world: World | None = None
               ) -> dict[str, torch.Tensor]:
    """Gather + augment the dataset rows idx (under ``world``, this rank's
    rows of the global batch: the augmentation draws the global batch's
    parameters; stage timer ``train/augment``), then ``step_on_batch``."""
    b = idx.shape[0]
    rows = None if world is None else (world.rank * b, world.size * b)
    with stage_timer("train/augment"):
        imgs, labs = gather_augment_batch(images_u8, labels_u8, idx, crop,
                                          mean, std, generator, brightness,
                                          saturation, batch_rows=rows)
    return step_on_batch(model, opt, imgs, labs, seed, loss_fn, bf16,
                         f1_postprocess, world)


def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
              labels_u8: torch.Tensor, idx: torch.Tensor,
              valid: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              loss_fn: LossFn | None = None, bf16: bool = False,
              world: World | None = None) -> dict[str, torch.Tensor]:
    """Validation/test step over the dataset: gather by idx, normalize,
    forward in eval mode, loss and metrics. ``valid`` ([B] {0, 1}) marks
    real samples: padded entries still run through the forward but count
    in neither the loss nor the metrics. Under ``world`` idx and valid are
    this rank's rows, and the loss and metrics are the global batch's."""
    loss_fn = loss_fn or make_loss_fn("lovasz")
    model.eval()
    with torch.no_grad():
        imgs = (images_u8[idx].float() / 255.0 - mean) / std
        labs = labels_u8[idx].long()
        pw = valid.float()[:, None, None]
        with _autocast(imgs.device, bf16):
            logits = model(imgs)
        if world is not None:
            logits, labs = world.gather_rows(logits), world.gather_rows(labs)
            pw = world.gather_rows(pw)
        cm = confusion_matrix(logits.argmax(dim=-1), labs, NUM_CLASSES,
                              weights=pw)
        iou = iou_from_confusion(cm)
        f1 = pixelwise_f1(logits, labs, weights=pw)
        return {"loss": loss_fn(logits, labs, pixel_weights=pw),
                "miou": iou.mean(), "iou_per_class": iou,
                "f1": f1.mean(), "f1_per_class": f1}
