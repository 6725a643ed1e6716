"""Carrying weights into the port.

The port's modules use torchvision's names (``backbone.layer1.0.conv2
.weight``, ``classifier.0.weight``, ...), so a reference ``best_model.pt``
loads with ``load_state_dict``. Weights trained by the JAX package come
across as its variable tree ``{'params', 'batch_stats'}`` with numpy
leaves, which ``variables_to_state_dict`` renames and relayouts:

- conv kernels: flax [kh, kw, I, O] -> torch [O, I, kh, kw];
- BatchNorm: scale -> weight, bias -> bias, batch_stats mean/var ->
  running_mean/running_var;
- flax block scopes ``layer1_0`` -> ``layer1.0``; ``downsample_conv`` /
  ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``; FCN head
  ``conv1`` / ``bn1`` / ``conv2`` -> ``0`` / ``1`` / ``4``.

Loading flax ``.msgpack`` files or orbax directories is not part of this
port yet: the machine with the card has neither jax nor flax.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

_FCN_HEAD = {"conv1": "0", "bn1": "1", "conv2": "4"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()
             ) -> dict[tuple[str, ...], Any]:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _module_name(path: tuple[str, ...]) -> str:
    """flax scope path (without the leaf) -> torchvision module name."""
    root, *rest = path
    if root == "classifier":
        if len(rest) != 1 or rest[0] not in _FCN_HEAD:
            raise KeyError(f"unmapped head scope {'/'.join(path)}")
        return f"classifier.{_FCN_HEAD[rest[0]]}"
    if root != "backbone":
        raise KeyError(f"unmapped scope {'/'.join(path)}")
    if len(rest) == 1:  # stem conv1 / bn1
        return f"backbone.{rest[0]}"
    block, mod = rest
    stage, idx = block.split("_")
    mod = {"downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}.get(mod, mod)
    return f"backbone.{stage}.{idx}.{mod}"


def variables_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy or array leaves, folded or
    not) -> the port's state dict. Every leaf maps to exactly one key."""
    out: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})).items():
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] not in _LEAF:
                raise KeyError(f"unmapped leaf {col}/{'/'.join(path)}")
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            key = f"{_module_name(path[:-1])}.{_LEAF[path[-1]]}"
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_state_dict_into(model: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state)`` where the only keys allowed to be
    missing are BatchNorm ``num_batches_tracked`` counters (the JAX
    package has none, and eval-mode BN never reads them)."""
    result = model.load_state_dict(dict(state), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing}, unexpected {result.unexpected_keys}")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``best_model.pt`` (a torchvision-named state dict,
    possibly wrapped as ``{'state_dict': ...}``), on the CPU."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return {k: torch.as_tensor(v) for k, v in state.items()}
