"""The plain reference of a training step: the augmentation, the forward of
the configuration's reference model (reference/__init__.py) in train mode
with its dropout, the Lovász-Softmax loss, backward and Adam, over the
whole global batch in one process: BatchNorm takes the statistics of all
of its rows, the semantics that the program's cross-rank BatchNorm
(parallel/sync_bn.py) claims for a data-parallel step, and each block of
the backbone can be recomputed in backward so that a large global batch
fits on one card.

Rules of the program that the reference needs to draw the same random
numbers, held here as frozen copies (the file each was copied from is
named):

- ``augment_params``: the order and form of a batch's draws from the
  augmentation generator (neuralbarkcalculator_tpu_torch/data/augment.py,
  ``draw_augment_params``): crop rows, crop columns, brightness, saturation,
  which of the two jitters runs first, the horizontal flip, the vertical
  flip.
- ``dropout_keep``: the ASPP dropout's mask, ``torch.rand`` of the
  activation's shape from a generator on the device seeded with
  ``fold_seed(step seed, 2)`` (neuralbarkcalculator_tpu_torch/models/
  seeding.py), kept below 0.5.

The rest is written from the published recipe: torchvision's
ColorJitter(brightness, saturation) (each step clamped to [0, 1], the
saturation blend with the ITU-R 601 luma), RandomCrop, the two
RandomFlips, Normalize; Lovász-Softmax over the batch with the classes
present (Berman et al. 2018, lovasz_losses.py); ``torch.optim.Adam`` with
L2 weight decay.
"""
from __future__ import annotations

import numpy as np
import torch

from . import Ops, module_for

HEAD_STREAM = 2


def fold_seed(seed: int, value: int) -> int:
    return int(np.random.SeedSequence([seed, value]).generate_state(
        1, np.uint64)[0])


def dropout_keep(step_seed: int):
    def keep(y: torch.Tensor) -> torch.Tensor:
        g = torch.Generator(device=y.device)
        g.manual_seed(fold_seed(step_seed, HEAD_STREAM))
        return torch.rand(y.shape, generator=g, device=y.device) < 0.5
    return keep


def augment_params(n: int, height: int, width: int, crop: int,
                   brightness: float, saturation: float,
                   g: torch.Generator) -> dict:
    dev = g.device

    def uniform(lo, hi):
        return torch.empty(n, device=dev).uniform_(lo, hi, generator=g)

    oy = torch.randint(0, height - crop + 1, (n,), device=dev, generator=g)
    ox = torch.randint(0, width - crop + 1, (n,), device=dev, generator=g)
    fb = uniform(max(0.0, 1 - brightness), 1 + brightness)
    fs = uniform(max(0.0, 1 - saturation), 1 + saturation)
    bright_first = torch.rand(n, device=dev, generator=g) < 0.5
    flip_h = torch.rand(n, device=dev, generator=g) < 0.5
    flip_v = torch.rand(n, device=dev, generator=g) < 0.5
    return {k: v.cpu() for k, v in dict(
        oy=oy, ox=ox, fb=fb, fs=fs, bright_first=bright_first,
        flip_h=flip_h, flip_v=flip_v).items()}


def augment(images_u8: torch.Tensor, labels_u8: torch.Tensor, idx,
            crop: int, mean, std, g: torch.Generator, brightness: float,
            saturation: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch, sample by sample: crop, flips, jitter, normalize.
    Returns (NCHW float32, int64 labels)."""
    p = augment_params(len(idx), images_u8.shape[1], images_u8.shape[2],
                       crop, brightness, saturation, g)
    imgs, labs = [], []
    for k, i in enumerate(idx):
        y, x = int(p["oy"][k]), int(p["ox"][k])
        img = images_u8[int(i), y:y + crop, x:x + crop].float() / 255.0
        lab = labels_u8[int(i), y:y + crop, x:x + crop]
        if p["flip_h"][k]:
            img, lab = img.flip(1), lab.flip(1)
        if p["flip_v"][k]:
            img, lab = img.flip(0), lab.flip(0)
        fb, fs = float(p["fb"][k]), float(p["fs"][k])

        def bright(t):
            return (t * fb).clamp(0.0, 1.0)

        def sat(t):
            gray = (0.299 * t[..., 0] + 0.587 * t[..., 1]
                    + 0.114 * t[..., 2])[..., None]
            return (gray + fs * (t - gray)).clamp(0.0, 1.0)

        img = sat(bright(img)) if p["bright_first"][k] else bright(sat(img))
        imgs.append(img)
        labs.append(lab.long())
    m = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    x = (torch.stack(imgs) - m) / s
    return x.permute(0, 3, 1, 2).contiguous(), torch.stack(labs)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union
    jaccard[1:] = jaccard[1:] - jaccard[:-1].clone()
    return jaccard


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """logits [B, C, H, W], labels [B, H, W] -> the batch's loss, averaged
    over the classes present."""
    c = logits.shape[1]
    probas = torch.softmax(logits, 1).permute(0, 2, 3, 1).reshape(-1, c)
    labels = labels.reshape(-1)
    losses = []
    for k in range(c):
        fg = (labels == k).float()
        if fg.sum() == 0:
            continue
        errors = (fg - probas[:, k]).abs()
        errors_sorted, perm = torch.sort(errors, descending=True)
        losses.append(torch.dot(errors_sorted, _lovasz_grad(fg[perm])))
    return torch.stack(losses).mean()


PARAM_SUFFIXES = ("weight", "bias")


def trainable(name: str) -> bool:
    return name.endswith(PARAM_SUFFIXES)


def run_steps(config: dict, state0: dict, images_u8, labels_u8, batches,
              step_seeds, aug_seed: int, device, hooks: dict | None = None,
              recompute: bool = False) -> dict:
    """The first len(batches) steps of the configuration's model and
    ``train`` recipe from ``state0``, each on the whole global batch of
    dataset rows ``batches[k]``. ``hooks``: ``Ops``' ``conv`` and
    ``matmul`` (reference/control.py); ``recompute``: each backbone block
    recomputed in backward. Returns each step's loss, each leaf's first
    gradient norm as Adam holds it after step 1 (its first moment over 1 -
    beta1), and each leaf's change after the last step."""
    ref, model, train = module_for(config), config["model"], config["train"]
    if not ref.trains(model):
        raise ValueError(f"the training reference does not train {model!r}")
    params = {k: v.detach().to(device).float().clone().requires_grad_(
        trainable(k)) for k, v in state0.items()}
    leaves = [params[k] for k in params if trainable(k)]
    opt = torch.optim.Adam(leaves, lr=train["lr"],
                           weight_decay=train["weight_decay"])
    beta1 = opt.param_groups[0]["betas"][0]
    g = torch.Generator(device=device)
    g.manual_seed(aug_seed)
    out = {"loss": [], "grad": {}, "change": {}}
    for step, (idx, seed) in enumerate(zip(batches, step_seeds)):
        x, y = augment(images_u8, labels_u8, idx, train["crop"],
                       config["mean"], config["std"], g, train["brightness"],
                       train["saturation"])
        ops = Ops(**(hooks or {}), train=True, recompute=recompute,
                  dropout_keep=dropout_keep(seed))
        loss = lovasz_softmax(ref.logits(params, x, model, ops), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = {k: float(opt.state[p]["exp_avg"].norm()) /
                           (1 - beta1) for k, p in params.items()
                           if trainable(k)}
    out["change"] = {k: float((params[k].detach()
                               - state0[k].to(device).float()).norm())
                     for k in params if trainable(k)}
    return out
