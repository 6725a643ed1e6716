"""Optimizer and schedule controllers (reference __main__.py:234-258).

- The optimizer is ``torch.optim.Adam(lr, weight_decay)`` itself, the
  reference's (grad-coupled L2); ``adam`` builds it and
  ``set_learning_rate`` / ``get_learning_rate`` reach its lr through
  ``param_groups``.
- ``ReduceLROnPlateau``: torch scheduler semantics with mode='max',
  threshold_mode='abs' (reference __main__.py:244-250).
- ``EarlyStopping``: Poutyne/Keras semantics, min_delta, patience, mode
  (reference __main__.py:252-258).

Both controllers watch one scalar per epoch on the host; only the lr they
produce reaches the optimizer.
"""
from __future__ import annotations

import math
import random
from typing import Iterable

import numpy as np
import torch


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
         weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay), the reference optimizer."""
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau, host-side.

    Reference config (__main__.py:244-250): monitor val_miou, mode='max',
    factor=0.2, patience=3, threshold=1e-1, threshold_mode='abs'.
    """

    def __init__(self, mode: str = "max", factor: float = 0.2,
                 patience: int = 3, threshold: float = 1e-1,
                 threshold_mode: str = "abs", min_lr: float = 0.0,
                 cooldown: int = 0):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "abs":
            delta = self.threshold
        else:  # 'rel'
            delta = abs(self.best) * self.threshold
        if self.mode == "max":
            return metric > self.best + delta
        return metric < self.best - delta

    def step(self, metric: float, lr: float) -> float:
        """Observe the epoch metric; return the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return lr


class EarlyStopping:
    """Poutyne EarlyStopping (__main__.py:252-258): stop after ``patience``
    epochs without an improvement greater than ``min_delta``."""

    def __init__(self, mode: str = "max", min_delta: float = 1e-1,
                 patience: int = 8, verbose: bool = True):
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.verbose = verbose
        self.best = -math.inf if mode == "max" else math.inf
        self.wait = 0
        self.stopped_epoch = 0

    def step(self, metric: float, epoch: int) -> bool:
        """Observe the epoch metric; return True when training must stop."""
        improved = (metric > self.best + self.min_delta
                    if self.mode == "max"
                    else metric < self.best - self.min_delta)
        if improved:
            self.best = metric
            self.wait = 0
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            if self.verbose:
                print(f"Epoch {epoch}: early stopping")
            return True
        return False


def make_training_deterministic(seed: int) -> np.random.RandomState:
    """Reference make_training_deterministic (utils.py:195-198): seeds
    Python ``random``, numpy's global state and torch. Returns
    RandomState(seed), the MT19937 stream the reference's global
    np.random yields after seeding."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.RandomState(seed)
