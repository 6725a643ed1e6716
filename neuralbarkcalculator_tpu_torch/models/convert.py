"""Carrying weights into the port.

The port's modules use the reference's names (torchvision's
``backbone.layer1.0.conv2.weight``, ``classifier.0.convs.1.0.weight``, ...;
efficientnet_pytorch's ``backbone.model._blocks.3._se_reduce.bias``), so a
reference ``best_model.pt`` loads with ``load_state_dict``. Weights
trained by the JAX package come across as its variable tree
``{'params', 'batch_stats'}`` with numpy leaves, which
``variables_to_state_dict`` renames and relayouts (the inverse of the JAX
package's ``torch_state_dict_to_variables``):

- conv kernels: flax [kh, kw, I, O] -> torch [O, I, kh, kw] (a depthwise
  [k, k, 1, C] -> [C, 1, k, k]);
- BatchNorm: scale -> weight, bias -> bias, batch_stats mean/var ->
  running_mean/running_var;
- ResNet scopes ``layer1_0`` -> ``layer1.0``; ``downsample_conv`` /
  ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``;
- FCN head ``conv1`` / ``bn1`` / ``conv2`` -> ``0`` / ``1`` / ``4``;
  DeepLab head ``aspp`` -> ``0`` (its branches ``b0_*`` -> ``convs.0``,
  ``b{i}`` -> ``convs.{i}``, ``pool_*`` -> ``convs.4``, ``project_*`` ->
  ``project``), ``conv`` / ``bn`` / ``classifier`` -> ``1`` / ``2`` / ``4``;
- EfficientNet scopes ``stem_*`` / ``head_*`` -> ``model._conv_stem`` /
  ``_bn0`` / ``_conv_head`` / ``_bn1``, and ``block{stage}_{i}`` ->
  ``model._blocks.{j}``, j the flat index of the variant's block table.

Loading flax ``.msgpack`` files or orbax directories is not part of this
port yet: the machine with the card has neither jax nor flax.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from .efficientnet import block_table
from .segmentation import efficientnet_variant_of

_FCN_HEAD = {"conv1": "0", "bn1": "1", "conv2": "4"}
_DEEPLAB_HEAD = {"conv": "1", "bn": "2", "classifier": "4"}
_ASPP = {"b0_conv": "convs.0.0", "b0_bn": "convs.0.1",
         "pool_conv": "convs.4.1", "pool_bn": "convs.4.2",
         "project_conv": "project.0", "project_bn": "project.1"}
_ASPP_BRANCH = {"conv": "0", "bn": "1"}
_EFF_TOP = {"stem_conv": "_conv_stem", "stem_bn": "_bn0",
            "head_conv": "_conv_head", "head_bn": "_bn1"}
_EFF_BLOCK = {"expand_conv": "_expand_conv", "bn0": "_bn0",
              "depthwise_conv": "_depthwise_conv", "bn1": "_bn1",
              "project_conv": "_project_conv", "bn2": "_bn2"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
# the ImageNet classifier of a reference EfficientNet checkpoint, which
# extract_features never reads (reference models.py:100)
_UNUSED_PREFIX = "backbone.model._fc."


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


def _head_name(rest: list[str]) -> str | None:
    if len(rest) == 1:
        return _FCN_HEAD.get(rest[0]) or _DEEPLAB_HEAD.get(rest[0])
    if rest[0] != "aspp":
        return None
    if len(rest) == 2:
        return f"0.{_ASPP[rest[1]]}" if rest[1] in _ASPP else None
    branch, mod = rest[1], rest[2]
    if len(rest) == 3 and branch in ("b1", "b2", "b3") \
            and mod in _ASPP_BRANCH:
        return f"0.convs.{branch[1]}.{_ASPP_BRANCH[mod]}"
    return None


def _efficientnet_name(rest: list[str], blocks: dict[str, int] | None
                       ) -> str | None:
    if len(rest) == 1:
        return f"model.{_EFF_TOP[rest[0]]}" if rest[0] in _EFF_TOP else None
    if blocks is None:
        raise KeyError("EfficientNet scopes need the variant (or the model "
                       "name) to lay out the block table")
    j = blocks.get(rest[0])
    if j is None:
        return None
    if rest[1:] in (["se", "reduce"], ["se", "expand"]):
        return f"model._blocks.{j}._se_{rest[2]}"
    if len(rest) == 2 and rest[1] in _EFF_BLOCK:
        return f"model._blocks.{j}.{_EFF_BLOCK[rest[1]]}"
    return None


def _module_name(path: tuple[str, ...], blocks: dict[str, int] | None
                 ) -> str:
    """flax scope path (without the leaf) -> the port's module name."""
    root, *rest = path
    name = None
    if root == "classifier" and rest:
        name = _head_name(rest)
    elif root == "backbone" and rest:
        if rest[0] in _EFF_TOP or rest[0].startswith("block"):
            name = _efficientnet_name(rest, blocks)
        elif len(rest) == 1:  # stem conv1 / bn1
            name = rest[0]
        elif len(rest) == 2 and rest[0].startswith("layer"):
            stage, idx = rest[0].split("_")
            mod = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(rest[1], rest[1])
            name = f"{stage}.{idx}.{mod}"
    if name is None:
        raise KeyError(f"unmapped scope {'/'.join(path)}")
    return f"{root}.{name}"


def variables_to_state_dict(variables: Mapping,
                            variant: int | str | None = None
                            ) -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy or array leaves, folded or
    not) of any zoo model -> the port's state dict. Every leaf maps to
    exactly one key. An EfficientNet backbone needs ``variant``: its n, or
    the model name (``fcn_efficientnet_b3``)."""
    if isinstance(variant, str):
        variant = efficientnet_variant_of(variant)
    blocks = (None if variant is None else
              {f"block{s}_{i}": j
               for j, (s, i) in enumerate(block_table(variant))})
    out: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})).items():
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] not in _LEAF:
                raise KeyError(f"unmapped leaf {col}/{'/'.join(path)}")
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            key = f"{_module_name(path[:-1], blocks)}.{_LEAF[path[-1]]}"
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_state_dict_into(model: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state)`` where the only keys allowed to be
    missing are BatchNorm ``num_batches_tracked`` counters (the JAX
    package has none, and eval-mode BN never reads them), and the only
    keys dropped are a reference EfficientNet's unused ``_fc``."""
    state = {k: v for k, v in state.items()
             if not k.startswith(_UNUSED_PREFIX)}
    result = model.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing}, unexpected {result.unexpected_keys}")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``best_model.pt`` (a reference-named state dict,
    possibly wrapped as ``{'state_dict': ...}``), on the CPU."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return {k: torch.as_tensor(v) for k, v in state.items()}
