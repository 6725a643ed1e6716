"""The training experiment, a Poutyne-Experiment-like harness
(neuralbarkcalculator_tpu/train/loop.py), in PyTorch.

Reproduces the reference training recipe (__main__.py:199-311):

- dataset mean/std + class pos-weights computed once from the raw images
  (utils.py:23-69),
- stratified 80/10/10 splits + exp-weighted sampling (utils.py:76-132),
  with numpy's RandomState(seed), so split membership is the JAX
  package's and the reference's; or the prioritized sampler
  (utils.py:354-456, ``sampler="prioritized"``),
- the whole (pad_resized-to-1024, uint8) dataset resident on the device;
  each step takes only the sampled indices (train/step.py). With
  ``device_resident_data=False`` it stays on the host and each step
  uploads its gathered batch,
- any model of the zoo (fcn_resnet50(dropout=0.8) is the reference's),
  in float32 (TF32 off on a card) or with a bf16 forward
  (``use_bfloat16``), optionally from an ImageNet backbone
  (``backbone_ckpt``); torch.optim.Adam(5e-4, wd 2e-3), the loss menu
  (Lovász-Softmax by default), metrics miou + pixel F1,
  ReduceLROnPlateau(0.2/3/abs 1e-1), EarlyStopping(1e-1/8), monitor
  val_miou max (__main__.py:231-269),
- a checkpoint per epoch with best-model tracking and export
  (train/checkpoint.py), and ``train(resume=True)`` from the last one.

Randomness: a numpy RandomState(seed) draws the splits and the batches; a
``torch.Generator`` on the device draws the augmentation; a second one on
the host draws each step's 64-bit dropout seed, which keys every random
layer of the model (models/seeding.py). A resumed run seeds both
generators from (seed, first epoch), as the JAX package folds the first
epoch into its key. Weights start from a torchvision-style random init
drawn from the seed.

Data-parallel runs (``world``, one process per card, parallel/): every
rank builds the same model, splits and generators, draws the same global
batches from the same RandomState, the same augmentation parameters and
the same dropout seed, and takes its contiguous rows of each batch
(``World.rank_slice``); a global batch that does not divide across the
ranks raises ``ValueError``. The model's BatchNorms become cross-rank
(parallel/sync_bn.py) and its random layers draw for the global batch
(models/seeding.py), so a step is the single-process step on the global
batch (train/step.py). The prioritized sampler is updated with the
global batch's miou, so every rank's sampler, and so its RandomState,
stays in lockstep. ``evaluate`` pads each batch to a multiple of the
world size with repeats of the last sample, weighted 0 (JAX
train/loop.py:316-340), so its results do not depend on the world size.
Only rank 0 writes checkpoints, ``best_model.pt``, the log and the
console output; every rank waits for each write.
"""
from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch
import torch.nn as nn

from ..config import TrainConfig
from ..data.augment import pad_resize_pair
from ..data.dataset import BarkDataset
from ..data.sampling import (PrioritizedSampler, get_splits,
                             weighted_batch_iterator)
from ..models.convert import load_backbone_checkpoint, merge_backbone
from ..models.seeding import fold_seed
from ..models.segmentation import MODEL_FACTORIES, SegmentationModel
from ..parallel.distributed import World, single_process
from ..parallel.sync_bn import convert_batchnorm
from ..utils.device import resolve_device, set_float32_exact
from .checkpoint import ExperimentCheckpoints
from .optim import (EarlyStopping, ReduceLROnPlateau, adam,
                    get_learning_rate, set_learning_rate)
from .step import eval_step, make_loss_fn, train_step


@dataclasses.dataclass
class EpochLog:
    epoch: int
    lr: float
    time_s: float
    loss: float
    miou: float
    f1: float
    val_loss: float
    val_miou: float
    val_f1: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_model(model_name: str, dropout: float, seed: int
                ) -> SegmentationModel:
    """A randomly initialized zoo model, the same for the same seed: the
    backbone's convs He-normal (fan_out, as torchvision's ResNet), BN scale
    1 and shift 0, the head's convs torch's defaults. ``dropout`` goes to
    the factories that take it, the FCN heads (JAX train/loop.py:153-159).
    The global RNG is left as it was."""
    if model_name not in MODEL_FACTORIES:
        raise ValueError(f"unknown model {model_name!r}")
    factory = MODEL_FACTORIES[model_name]
    params = inspect.signature(factory).parameters
    required = [n for n, p in params.items() if p.default is p.empty]
    if required:
        raise ValueError(f"model {model_name!r} needs {required} as an "
                         f"argument: name a variant, {model_name}_b0 .. "
                         f"{model_name}_b7")
    kwargs = {"dropout": dropout} if "dropout" in params else {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = factory(**kwargs)
        if not getattr(model.backbone, "supports_training", True):
            raise ValueError(f"model {model_name!r} predicts only: the port "
                             f"does not train it")
        for m in model.backbone.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")
    return model


def _draw_seed(generator: torch.Generator) -> int:
    """A 64-bit dropout seed from a host generator."""
    hi, lo = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                           generator=generator).tolist()
    return (hi << 32) | lo


class Experiment:
    """Training harness over a reference-layout dataset directory
    (root/samples/<wood_type>/*.png|bmp + root/duals/...). ``world``: this
    process's rank of a data-parallel run (its device replaces
    ``device``); None for a single process."""

    def __init__(self, data_root: str, directory: str,
                 config: TrainConfig | None = None,
                 model_name: str = "fcn_resnet50",
                 loss_name: str = "lovasz", monitor: str | None = None,
                 sampler: str = "weighted",
                 device: str | torch.device = "cuda",
                 world: World | None = None):
        self.config = cfg = config or TrainConfig()
        self.device = resolve_device(world.device if world else device)
        self.world = world or single_process(self.device)
        if sampler not in ("weighted", "prioritized"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.sampler_kind = sampler
        set_float32_exact(self.device)
        self.model_name = model_name
        self.loss_fn = make_loss_fn(loss_name)
        self.monitor = monitor or cfg.monitor
        # the model before the data: a name that builds no model fails
        # before the images are read
        model = build_model(model_name, cfg.dropout, cfg.seed)
        if cfg.backbone_ckpt:
            # the reference fine-tunes an ImageNet backbone
            # (pretrained=True, models.py:127-130 via __main__.py:231)
            merge_backbone(model, load_backbone_checkpoint(cfg.backbone_ckpt))
        if self.world.group is not None:
            convert_batchnorm(model, self.world)
        self.ckpts = ExperimentCheckpoints(directory, monitor=self.monitor,
                                           mode=cfg.monitor_mode,
                                           writer=self.world.is_main)

        # ---- host data: statistics from the raw images (the reference's
        # compute_mean_std / compute_pos_weight run on the untransformed
        # dataset, __main__.py:200-207), then pad_resize to the static
        # training size
        size = cfg.pad_resize_size
        dataset = BarkDataset(data_root)
        n = len(dataset)
        self.fnames = [r.fname for r in dataset.records]
        self.wood_types = [r.wood_type for r in dataset.records]
        images = np.zeros((n, size, size, 3), np.uint8)
        labels = np.zeros((n, size, size), np.uint8)
        means, stds = [], []
        class_counts = np.zeros(3, np.int64)
        raw_nonzero = np.zeros(n, np.int64)
        for i in range(n):
            sample, target, _, _ = dataset[i]
            flat = sample.reshape(-1, 3).astype(np.float64)
            means.append(flat.mean(0))
            stds.append(flat.std(0, ddof=1))  # torch .std: unbiased
            class_counts += np.bincount(target.reshape(-1), minlength=3)
            raw_nonzero[i] = np.count_nonzero(target)
            sample, target = pad_resize_pair(sample, target, size)
            images[i] = np.rint(np.clip(sample, 0.0, 1.0) * 255.0)
            labels[i] = target

        # ---- statistics + splits (reference __main__.py:204-224)
        self.mean = np.mean(means, axis=0).tolist()
        self.std = np.mean(stds, axis=0).tolist()
        total = class_counts.sum()
        self.pos_weight = (total / (3.0 * class_counts)).tolist()
        self._print(self.mean)
        self._print(self.std)
        self._print(self.pos_weight)
        # RandomState(seed) is the MT19937 stream the reference's seeded
        # global np.random gives get_splits (utils.py:195-198)
        self._rng = np.random.RandomState(cfg.seed)
        self.train_split, self.valid_split, self.test_split, \
            self.train_weights = get_splits(
                raw_nonzero, self.wood_types, self._rng, cfg.train_percent,
                cfg.valid_percent)

        # ---- the dataset on the device (steps take indices), or on the
        # host (each step uploads its batch)
        self.device_resident = cfg.device_resident_data
        self.images = torch.from_numpy(images)
        self.labels = torch.from_numpy(labels)
        if self.device_resident:
            self.images = self.images.to(self.device)
            self.labels = self.labels.to(self.device)
        self._mean = torch.tensor(self.mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(self.std, dtype=torch.float32,
                                 device=self.device)

        # ---- model, optimizer, generators
        self.model = model.to(self.device)
        self.opt = adam(self.model.parameters(), cfg.lr, cfg.weight_decay)
        self.step_count = 0
        self.augment_gen = torch.Generator(device=self.device)
        self.augment_gen.manual_seed(cfg.seed)
        self.dropout_gen = torch.Generator()
        self.dropout_gen.manual_seed(cfg.seed + 1)
        self.history: list[EpochLog] = []
        self.step_losses: list[float] = []
        self.sampler_stats: dict | None = None  # the prioritized sampler's

    # -------------------------------------------------------------- train

    def train(self, epochs: int | None = None,
              resume: bool = False) -> list[EpochLog]:
        """Run the training loop (``epochs`` defaults to the config's).
        ``resume=True`` continues after the last epoch checkpoint (JAX
        train/loop.py:197-222): its weights, optimizer state (Adam moments
        and lr) and step count; the logged monitor replayed through the
        plateau and early-stop controllers; the augment and dropout
        generators seeded from (seed, first epoch)."""
        cfg = self.config
        epochs = epochs or cfg.epochs
        world = self.world
        world.rank_slice(cfg.batch_size)  # raises for an uneven split
        # the run's controllers, kept on the experiment for inspection
        self.plateau = plateau = ReduceLROnPlateau(
            mode=cfg.monitor_mode, factor=cfg.plateau_factor,
            patience=cfg.plateau_patience, threshold=cfg.plateau_threshold,
            threshold_mode="abs")
        self.early_stopping = early = EarlyStopping(
            mode=cfg.monitor_mode, min_delta=cfg.early_stop_min_delta,
            patience=cfg.early_stop_patience, verbose=world.is_main)
        start_epoch = 1
        if resume and self.ckpts.last_epoch > 0:
            start_epoch = self.ckpts.last_epoch + 1
            self.load_checkpoint(self.ckpts.last_epoch)
            # the controllers' state only: the lr stays the checkpoint's,
            # as in the JAX package
            lr = get_learning_rate(self.opt)
            for entry in self.ckpts.log["epochs"]:
                if self.monitor in entry:
                    lr = plateau.step(entry[self.monitor], lr)
                    early.step(entry[self.monitor], entry["epoch"])
            self.augment_gen.manual_seed(fold_seed(cfg.seed, start_epoch))
            self.dropout_gen.manual_seed(fold_seed(cfg.seed + 1,
                                                   start_epoch))
        prioritized = None
        if self.sampler_kind == "prioritized":
            prioritized = PrioritizedSampler(
                len(self.train_split), cfg.batch_size,
                len(self.train_split) * cfg.samples_per_epoch_factor,
                self._rng, metric_mode=cfg.monitor_mode)

        for epoch in range(start_epoch, epochs + 1):
            t0 = time.time()
            # per-batch metrics stay on the device until the epoch ends,
            # except the prioritized sampler's miou, which its weight
            # update reads after every step (utils.py:403-412)
            batch_metrics: list[dict] = []
            batches = (prioritized if prioritized is not None else
                       weighted_batch_iterator(
                           self.train_weights, cfg.batch_size, self._rng,
                           cfg.samples_per_epoch_factor))
            for batch_pos in batches:
                # every rank draws the same global batch and takes its rows
                images, labels, idx = self.batch_inputs(
                    self.train_split[batch_pos[world.rank_slice(
                        len(batch_pos))]])
                metrics = train_step(
                    self.model, self.opt, images, labels, idx,
                    self.augment_gen, _draw_seed(self.dropout_gen),
                    cfg.crop_size, self._mean, self._std,
                    cfg.jitter_brightness, cfg.jitter_saturation,
                    self.loss_fn, cfg.use_bfloat16, cfg.train_f1_postprocess,
                    world=world)
                self.step_count += 1
                if prioritized is not None:
                    prioritized.update(batch_pos,
                                       float(metrics["miou"]) / 100.0)
                batch_metrics.append(metrics)
            self.step_losses += [float(m["loss"]) for m in batch_metrics]
            train_metrics = {
                k: float(np.mean([float(m[k]) for m in batch_metrics]))
                for k in (batch_metrics[0] if batch_metrics else {})}
            for k in ("loss", "miou", "f1"):
                train_metrics.setdefault(k, 0.0)

            val = self.evaluate(self.valid_split)
            lr = get_learning_rate(self.opt)
            log = EpochLog(epoch=epoch, lr=lr, time_s=time.time() - t0,
                           loss=train_metrics["loss"],
                           miou=train_metrics["miou"],
                           f1=train_metrics["f1"], val_loss=val["loss"],
                           val_miou=val["miou"], val_f1=val["f1"])
            self.history.append(log)
            self._log_epoch(log, epochs)

            monitored = log.as_dict()[self.monitor]
            is_best = self.ckpts.save_epoch(
                epoch, {"model": self.model.state_dict(),
                        "optimizer": self.opt.state_dict(),
                        "step": self.step_count},
                log.as_dict())
            if is_best:
                self.ckpts.export_best_model(self.model)
            world.barrier()  # rank 0's files are complete for every rank
            new_lr = plateau.step(monitored, lr)
            if new_lr != lr:
                self._print(f"Epoch {epoch}: reducing learning rate to "
                            f"{new_lr:.2e}")
                set_learning_rate(self.opt, new_lr)
            if early.step(monitored, epoch):
                break
        if prioritized is not None:  # the train-end summary, utils.py:414-456
            self.sampler_stats = prioritized.stats()
            for k, v in self.sampler_stats.items():
                self._print(f"{k}: {v}")
        return self.history

    def batch_inputs(self, idx: np.ndarray):
        """(images, labels, idx) of a batch on the device: the resident
        dataset and the indices, or the batch gathered on the host and
        uploaded, with indices 0..B-1 (JAX train/loop.py:303-315)."""
        if self.device_resident:
            return (self.images, self.labels,
                    torch.as_tensor(idx, device=self.device))
        idx = torch.as_tensor(idx)
        return (self.images[idx].to(self.device),
                self.labels[idx].to(self.device),
                torch.arange(len(idx), device=self.device))

    # -------------------------------------------------------------- eval

    def evaluate(self, split: np.ndarray, batch_size: int = 8) -> dict:
        """Poutyne-style evaluation: per-batch metrics averaged, weighted by
        batch size. Each batch is padded to a multiple of the world size
        with repeats of its last sample, which the step weights 0, and
        each rank runs its rows of it: the results are the same for every
        world size."""
        world = self.world
        sums: dict[str, float] = {}
        count = 0
        for start in range(0, len(split), batch_size):
            rows = np.asarray(split[start:start + batch_size])
            b = len(rows)
            rows = world.pad_rows(rows)
            valid = (np.arange(len(rows)) < b).astype(np.float32)
            mine = world.rank_slice(len(rows))
            images, labels, idx = self.batch_inputs(rows[mine])
            out = eval_step(self.model, images, labels, idx,
                            torch.as_tensor(valid[mine], device=self.device),
                            self._mean, self._std, self.loss_fn,
                            self.config.use_bfloat16, world)
            for k, v in out.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v) * b
            count += b
        out = {k: v / max(count, 1) for k, v in sums.items()}
        for k in ("loss", "miou", "f1"):
            out.setdefault(k, 0.0)
        return out

    def test(self, use_best: bool = True) -> dict:
        """exp.test parity (__main__.py:291): restores the best checkpoint
        (when one was saved) before evaluating the test split;
        ``use_best=False`` tests the current weights."""
        if use_best and self.ckpts.best_epoch is not None:
            self.load_best()
        metrics = self.evaluate(self.test_split)
        self._print("Test:", ", ".join(f"{k}: {v:g}" for k, v in
                                       sorted(metrics.items())))
        return metrics

    def load_checkpoint(self, epoch: int) -> None:
        """Restore the weights, optimizer state and step count of an
        epoch's checkpoint."""
        self._restore(self.ckpts.load_checkpoint(epoch))

    def load_best(self) -> None:
        """The same, from the best epoch's checkpoint."""
        self._restore(self.ckpts.load_best())

    def _restore(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])

    # ------------------------------------------------------------- logging

    def _print(self, *args) -> None:
        """Console output, from rank 0 only."""
        if self.world.is_main:
            print(*args, flush=True)

    def _log_epoch(self, log: EpochLog, total_epochs: int) -> None:
        self._print(f"Epoch {log.epoch}/{total_epochs} {log.time_s:.2f}s "
                    f"lr: {log.lr:.2e} loss: {log.loss:.6g} "
                    f"miou: {log.miou:.6g} f1: {log.f1:.6g} "
                    f"val_loss: {log.val_loss:.6g} "
                    f"val_miou: {log.val_miou:.6g} "
                    f"val_f1: {log.val_f1:.6g}")
