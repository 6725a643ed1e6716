"""The training experiment, a Poutyne-Experiment-like harness
(neuralbarkcalculator_tpu/train/loop.py), in PyTorch.

Reproduces the reference training recipe (__main__.py:199-311):

- dataset mean/std + class pos-weights computed once from the raw images
  (utils.py:23-69),
- stratified 80/10/10 splits + exp-weighted sampling (utils.py:76-132),
  with numpy's RandomState(seed), so split membership is the JAX
  package's and the reference's,
- the whole (pad_resized-to-1024, uint8) dataset resident on the device;
  each step takes only the sampled indices (train/step.py),
- fcn_resnet50(dropout=0.8) trained in float32 (TF32 off on a card),
  torch.optim.Adam(5e-4, wd 2e-3), Lovász-Softmax, metrics miou + pixel
  F1, ReduceLROnPlateau(0.2/3/abs 1e-1), EarlyStopping(1e-1/8), monitor
  val_miou max (__main__.py:231-269),
- a checkpoint per epoch with best-model tracking and export
  (train/checkpoint.py).

Randomness: a numpy RandomState(seed) draws the splits and the batches; a
``torch.Generator`` on the device draws the augmentation; a second one on
the host draws each step's 64-bit dropout seed. Weights start from a
torchvision-style random init drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn as nn

from ..config import TrainConfig
from ..data.augment import pad_resize_pair
from ..data.dataset import BarkDataset
from ..data.sampling import get_splits, weighted_batch_iterator
from ..models.segmentation import MODEL_FACTORIES, SegmentationModel
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


# the zoo models training is ported for: the other factories take no
# dropout (DeepLab), and their heads and backbones have no train mode yet
TRAINABLE = ("fcn_resnet50",)


def check_trainable(model_name: str) -> None:
    if model_name not in TRAINABLE:
        raise NotImplementedError(
            f"training {model_name!r} is not ported yet (trainable: "
            f"{', '.join(TRAINABLE)}): ROADMAP Queue A item 6")


def build_model(model_name: str, dropout: float, seed: int
                ) -> SegmentationModel:
    """A randomly initialized model, the same for the same seed: the
    backbone's convs He-normal (fan_out, as torchvision's ResNet), BN scale
    1 and shift 0, the head's convs torch's defaults. The global RNG is
    left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MODEL_FACTORIES[model_name](dropout=dropout)
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


class _StepClock:
    """Marks taken after each train step, read at the end of an epoch:
    CUDA events on a card (no sync inside the loop; the intervals are the
    device's step-to-step times), host wall time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals(self) -> list[float]:
        """Seconds between consecutive marks; clears the marks."""
        marks, self.marks = self.marks, []
        if len(marks) < 2:
            return []
        if self.cuda:
            marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        return [b - a for a, b in zip(marks, marks[1:])]


class Experiment:
    """Training harness over a reference-layout dataset directory
    (root/samples/<wood_type>/*.png|bmp + root/duals/...)."""

    def __init__(self, data_root: str, directory: str,
                 config: TrainConfig | None = None,
                 model_name: str = "fcn_resnet50",
                 loss_name: str = "lovasz", monitor: str | None = None,
                 device: str | torch.device = "cuda"):
        check_trainable(model_name)
        self.config = cfg = config or TrainConfig()
        self.device = resolve_device(device)
        set_float32_exact(self.device)
        self.model_name = model_name
        self.monitor = monitor or cfg.monitor
        self.ckpts = ExperimentCheckpoints(directory, monitor=self.monitor,
                                           mode=cfg.monitor_mode)

        # ---- host data: statistics from the raw images (the reference's
        # compute_mean_std / compute_pos_weight run on the untransformed
        # dataset, __main__.py:200-207), then pad_resize to the static
        # training size for the device-resident arrays
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
        print(self.mean)
        print(self.std)
        print(self.pos_weight)
        # RandomState(seed) is the MT19937 stream the reference's seeded
        # global np.random gives get_splits (utils.py:195-198)
        self._rng = np.random.RandomState(cfg.seed)
        self.train_split, self.valid_split, self.test_split, \
            self.train_weights = get_splits(
                raw_nonzero, self.wood_types, self._rng, cfg.train_percent,
                cfg.valid_percent)

        # ---- the dataset on the device; steps take indices
        self.images = torch.from_numpy(images).to(self.device)
        self.labels = torch.from_numpy(labels).to(self.device)
        self._mean = torch.tensor(self.mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(self.std, dtype=torch.float32,
                                 device=self.device)

        # ---- model, optimizer, generators
        self.model = build_model(model_name, cfg.dropout, cfg.seed).to(
            self.device)
        self.opt = adam(self.model.parameters(), cfg.lr, cfg.weight_decay)
        self.step_count = 0
        self.augment_gen = torch.Generator(device=self.device)
        self.augment_gen.manual_seed(cfg.seed)
        self.dropout_gen = torch.Generator()
        self.dropout_gen.manual_seed(cfg.seed + 1)
        self.loss_fn = make_loss_fn(loss_name)
        self.history: list[EpochLog] = []
        self.step_seconds: list[float] = []  # every train step so far
        self.step_losses: list[float] = []

    # -------------------------------------------------------------- train

    def train(self, epochs: int | None = None,
              resume: bool = False) -> list[EpochLog]:
        """Run the training loop (``epochs`` defaults to the config's)."""
        if resume:
            raise NotImplementedError("resume is not ported yet (ROADMAP "
                                      "Queue A10)")
        cfg = self.config
        epochs = epochs or cfg.epochs
        plateau = ReduceLROnPlateau(
            mode=cfg.monitor_mode, factor=cfg.plateau_factor,
            patience=cfg.plateau_patience, threshold=cfg.plateau_threshold,
            threshold_mode="abs")
        early = EarlyStopping(mode=cfg.monitor_mode,
                              min_delta=cfg.early_stop_min_delta,
                              patience=cfg.early_stop_patience)
        clock = _StepClock(self.device)

        for epoch in range(1, epochs + 1):
            t0 = time.time()
            # per-batch metrics stay on the device until the epoch ends
            batch_metrics: list[dict] = []
            clock.mark()
            for batch_pos in weighted_batch_iterator(
                    self.train_weights, cfg.batch_size, self._rng,
                    cfg.samples_per_epoch_factor):
                idx = torch.as_tensor(self.train_split[batch_pos],
                                      device=self.device)
                metrics = train_step(
                    self.model, self.opt, self.images, self.labels, idx,
                    self.augment_gen, _draw_seed(self.dropout_gen),
                    cfg.crop_size, self._mean, self._std,
                    cfg.jitter_brightness, cfg.jitter_saturation,
                    self.loss_fn)
                clock.mark()
                self.step_count += 1
                batch_metrics.append(metrics)
            self.step_seconds += clock.intervals()
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
            new_lr = plateau.step(monitored, lr)
            if new_lr != lr:
                print(f"Epoch {epoch}: reducing learning rate to "
                      f"{new_lr:.2e}")
                set_learning_rate(self.opt, new_lr)
            if early.step(monitored, epoch):
                break
        return self.history

    # -------------------------------------------------------------- eval

    def evaluate(self, split: np.ndarray, batch_size: int = 8) -> dict:
        """Poutyne-style evaluation: per-batch metrics averaged, weighted by
        batch size."""
        sums: dict[str, float] = {}
        count = 0
        for start in range(0, len(split), batch_size):
            idx = torch.as_tensor(split[start:start + batch_size],
                                  device=self.device)
            b = idx.shape[0]
            valid = torch.ones(b, device=self.device)
            out = eval_step(self.model, self.images, self.labels, idx, valid,
                            self._mean, self._std, self.loss_fn)
            for k, v in out.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v) * b
            count += b
        out = {k: v / max(count, 1) for k, v in sums.items()}
        for k in ("loss", "miou", "f1"):
            out.setdefault(k, 0.0)
        return out

    def test(self) -> dict:
        """exp.test parity (__main__.py:291): restores the best checkpoint
        (when one was saved) before evaluating the test split."""
        if self.ckpts.best_epoch is not None:
            self.load_best()
        metrics = self.evaluate(self.test_split)
        print("Test:", ", ".join(f"{k}: {v:g}" for k, v in
                                 sorted(metrics.items())))
        return metrics

    def load_best(self) -> None:
        """Restore the weights, optimizer state and step count of the best
        epoch's checkpoint."""
        state = self.ckpts.load_best()
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])

    # ------------------------------------------------------------- logging

    def _log_epoch(self, log: EpochLog, total_epochs: int) -> None:
        print(f"Epoch {log.epoch}/{total_epochs} {log.time_s:.2f}s "
              f"lr: {log.lr:.2e} loss: {log.loss:.6g} "
              f"miou: {log.miou:.6g} f1: {log.f1:.6g} "
              f"val_loss: {log.val_loss:.6g} val_miou: {log.val_miou:.6g} "
              f"val_f1: {log.val_f1:.6g}", flush=True)
