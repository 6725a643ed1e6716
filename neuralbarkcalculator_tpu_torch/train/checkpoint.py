"""Checkpointing: per-epoch ``torch.save`` files + best-checkpoint tracking.

Replaces the Poutyne Experiment checkpoint machinery the reference
delegates to (__main__.py:235-242): a checkpoint per epoch
(``checkpoint_epoch_<n>.pt``: model and optimizer state dicts and the step
count), monitor-metric bookkeeping in ``experiment_log.json`` (val_miou,
mode max; every epoch's metrics and lr, which a resumed run replays
through its plateau and early-stop controllers), ``load_checkpoint(n)`` /
best restore, and ``best_model.pt``, a plain torchvision-named state dict
that the port's predict CLI loads.

In a data-parallel run every rank keeps the same bookkeeping in memory,
and only rank 0 (``writer``) writes files; the caller makes the other
ranks wait until they are written before any reads them.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any

import torch


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class ExperimentCheckpoints:
    """Per-epoch checkpoints under ``directory`` with monitor-metric
    bookkeeping (Poutyne Experiment parity). ``writer=False`` keeps the
    bookkeeping and writes nothing (a data-parallel rank other than 0)."""

    def __init__(self, directory: str, monitor: str = "val_miou",
                 mode: str = "max", writer: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.writer = writer
        self._log_path = os.path.join(self.directory, "experiment_log.json")
        self.log: dict[str, Any] = {"epochs": [], "best_epoch": None}
        if os.path.isfile(self._log_path):
            with open(self._log_path) as f:
                self.log = json.load(f)

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"checkpoint_epoch_{epoch}.pt")

    @property
    def best_model_path(self) -> str:
        return os.path.join(self.directory, "best_model.pt")

    def save_epoch(self, epoch: int, state: dict, metrics: dict) -> bool:
        """Save one epoch's checkpoint and its metrics; returns is_best."""
        if self.writer:
            torch.save(_to_cpu(state), self.epoch_path(epoch))
        entry = {**{k: float(v) for k, v in metrics.items()},
                 "epoch": int(epoch)}
        self.log["epochs"].append(entry)
        is_best = self._is_best(entry)
        if is_best:
            self.log["best_epoch"] = epoch
        if self.writer:
            with open(self._log_path, "w") as f:
                json.dump(self.log, f, indent=1)
        return is_best

    def _is_best(self, entry: dict) -> bool:
        value = entry.get(self.monitor)
        if value is None:
            return False
        best = self.log.get("best_epoch")
        if best is None:
            return True
        best_value = next((e[self.monitor] for e in self.log["epochs"]
                           if e["epoch"] == best and self.monitor in e),
                          -math.inf if self.mode == "max" else math.inf)
        return value > best_value if self.mode == "max" \
            else value < best_value

    def load_checkpoint(self, epoch: int) -> dict:
        """Poutyne exp.load_checkpoint(n) parity (__main__.py:298)."""
        return torch.load(self.epoch_path(epoch), map_location="cpu",
                          weights_only=True)

    def load_best(self) -> dict:
        best = self.log.get("best_epoch")
        if best is None:
            raise FileNotFoundError("no best checkpoint recorded yet")
        return self.load_checkpoint(best)

    @property
    def best_epoch(self) -> int | None:
        return self.log.get("best_epoch")

    @property
    def last_epoch(self) -> int:
        """The last epoch logged (0 for none): where a resumed run
        continues from."""
        return max((e["epoch"] for e in self.log["epochs"]), default=0)

    def export_best_model(self, model: torch.nn.Module) -> str:
        """Write ``best_model.pt``, the model's state dict on the CPU: the
        artifact the predict engine loads (reference ./best_model.pt)."""
        if self.writer:
            torch.save(_to_cpu(model.state_dict()), self.best_model_path)
        return self.best_model_path
