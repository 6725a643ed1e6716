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

An ImageNet backbone to start training from (``TrainConfig.backbone_ckpt``,
the reference's pretrained=True) comes through ``load_backbone_checkpoint``
(a local torchvision ResNet-50/101 or efficientnet_pytorch state dict, bare
or inside a segmentation checkpoint, in ``.pt`` / ``.pth`` / ``.npz``) and
``merge_backbone``, which checks every tensor's name and shape against the
model's backbone before loading it.

An int8 model quantized by the JAX package (``quantize_variables``'
``{'params'}``) comes across through ``quantized_variables_to_state_dict``
into the port's int8 state dict (models/quantize.py).

``load_jax_checkpoint`` reads the JAX package's float checkpoints, a flax
``.msgpack`` file (io/flax_msgpack.py) or an orbax directory
(io/orbax.py: the trainer's ``best_model`` export, or a per-epoch
checkpoint, whose ``opt_state`` and ``step`` are left out as the JAX
engine's BatchNorm fold leaves them out), without jax, flax or orbax.
"""
from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..io import flax_msgpack, orbax
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


def module_name(path: tuple[str, ...], blocks: dict[str, int] | None = None
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
    the model name (``fcn_efficientnet_b3``). float32 leaves are shared,
    not copied: a conv kernel comes back as a permuted view of its leaf,
    which ``load_state_dict`` copies in one strided pass."""
    if isinstance(variant, str):
        variant = efficientnet_variant_of(variant)
    blocks = (None if variant is None else
              {f"block{s}_{i}": j
               for j, (s, i) in enumerate(block_table(variant))})
    out: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})).items():
            arr = (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf, dtype=np.float32))
            if path[-1] not in _LEAF:
                raise KeyError(f"unmapped leaf {col}/{'/'.join(path)}")
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            key = f"{module_name(path[:-1], blocks)}.{_LEAF[path[-1]]}"
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(arr)
    return out


def _invert(table: Mapping[str, str]) -> dict[str, str]:
    return {v: k for k, v in table.items()}


_FCN_HEAD_INV, _DEEPLAB_HEAD_INV, _ASPP_INV, _ASPP_BRANCH_INV = map(
    _invert, (_FCN_HEAD, _DEEPLAB_HEAD, _ASPP, _ASPP_BRANCH))
_EFF_TOP_INV, _EFF_BLOCK_INV = _invert(_EFF_TOP), _invert(_EFF_BLOCK)


def _scope_path(module: str, deeplab: bool, blocks: list[str] | None
                ) -> tuple[str, ...]:
    """The port's module name -> the flax scope path (the inverse of
    ``module_name``)."""
    root, *rest = module.split(".")
    name: tuple[str, ...] | None = None
    if root == "backbone" and rest[:1] == ["model"]:  # EfficientNet
        if len(rest) == 2 and rest[1] in _EFF_TOP_INV:
            name = (_EFF_TOP_INV[rest[1]],)
        elif len(rest) == 4 and rest[1] == "_blocks":
            if blocks is None:
                raise KeyError("EfficientNet keys need the variant (or the "
                               "model name) to lay out the block table")
            block = blocks[int(rest[2])]
            if rest[3] in ("_se_reduce", "_se_expand"):
                name = (block, "se", rest[3][4:])
            elif rest[3] in _EFF_BLOCK_INV:
                name = (block, _EFF_BLOCK_INV[rest[3]])
    elif root == "backbone" and len(rest) == 1:  # stem conv1 / bn1
        name = (rest[0],)
    elif root == "backbone" and len(rest) >= 3 and \
            rest[0].startswith("layer"):
        mod = {"downsample.0": "downsample_conv",
               "downsample.1": "downsample_bn"}.get(".".join(rest[2:]),
                                                     rest[2])
        name = (f"{rest[0]}_{rest[1]}", mod)
    elif root == "classifier" and deeplab:
        aspp = ".".join(rest[1:])
        if rest[0] != "0":
            name = (_DEEPLAB_HEAD_INV.get(rest[0]),)
        elif aspp in _ASPP_INV:
            name = ("aspp", _ASPP_INV[aspp])
        elif len(rest) == 4 and rest[1] == "convs" and \
                rest[2] in ("1", "2", "3"):
            name = ("aspp", f"b{rest[2]}", _ASPP_BRANCH_INV.get(rest[3]))
    elif root == "classifier" and len(rest) == 1:
        name = (_FCN_HEAD_INV.get(rest[0]),)
    if name is None or None in name:
        raise KeyError(f"unmapped module {module}")
    return (root, *name)


def state_dict_to_variables(state: Mapping[str, Any],
                            variant: int | str | None = None) -> dict:
    """The port's state dict of any zoo model -> the JAX ``{'params',
    'batch_stats'}`` tree of numpy arrays (the JAX package's
    ``torch_state_dict_to_variables``; the inverse of
    ``variables_to_state_dict``). ``num_batches_tracked`` and a reference
    EfficientNet's unused ``_fc`` are dropped; an EfficientNet backbone
    needs ``variant``."""
    if isinstance(variant, str):
        variant = efficientnet_variant_of(variant)
    blocks = (None if variant is None else
              [f"block{s}_{i}" for s, i in block_table(variant)])
    deeplab = any(k.startswith("classifier.0.convs.") for k in state)
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        if key.endswith("num_batches_tracked") or \
                key.startswith(_UNUSED_PREFIX):
            continue
        module, leaf = key.rsplit(".", 1)
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        if leaf == "weight" and arr.ndim == 4:
            col, name, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf in ("weight", "bias"):
            col, name = "params", {"weight": "scale"}.get(leaf, leaf)
        elif leaf in ("running_mean", "running_var"):
            col, name = "batch_stats", leaf[len("running_"):]
        else:
            raise KeyError(f"unmapped key {key}")
        node = out[col]
        for scope in _scope_path(module, deeplab, blocks):
            node = node.setdefault(scope, {})
        node[name] = arr
    return out


# int8 conv scopes whose port module has another name
_QCONV = {"downsample_conv": "downsample", "b0_conv": "b0",
          "project_conv": "project"}
_QLEAF = {"pool_conv_kernel": "pool_kernel", "pool_conv_bias": "pool_bias"}


def _quantized_key(path: tuple[str, ...]) -> str:
    """A JAX quantized param path -> the port's int8 state-dict key:
    ``(..., 'layer1_0', 'conv1_q')`` -> ``...layer1.0.conv1.q`` (``_m``,
    ``_b`` alike), ``downsample_conv`` / ``b0_conv`` / ``project_conv`` ->
    ``downsample`` / ``b0`` / ``project``, an atrous branch's ``b1/conv_q``
    -> ``b1.q``, the stem's ``kernel`` -> ``weight``."""
    *scope, leaf = path
    mods = [p.replace("_", ".") if p.startswith("layer") else p
            for p in scope]
    if leaf[-2:] in ("_q", "_m", "_b"):
        conv = leaf[:-2]
        if not (conv == "conv" and mods and mods[-1] in ("b1", "b2", "b3")):
            mods.append(_QCONV.get(conv, conv))
        leaf = leaf[-1]
    else:
        leaf = {"kernel": "weight"}.get(leaf, _QLEAF.get(leaf, leaf))
    return ".".join([*mods, leaf])


def quantized_variables_to_state_dict(qvariables: Mapping
                                      ) -> dict[str, torch.Tensor]:
    """A JAX quantized ``{'params'}`` tree (models/quantize.py's
    ``quantize_variables``, numpy or array leaves) -> the port's int8
    state dict (``QuantizedSegmentationModel``): each int8 HWIO kernel
    flattened to [kh * kw * cin, cout] and transposed to [cout, K], cout
    padded to a multiple of 8 with zero rows (models/qops.py); the float
    stem kernel to OIHW; every other leaf as it is."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(qvariables["params"]).items():
        arr = np.asarray(leaf)
        key = _quantized_key(path)
        if path[-1].endswith("_q"):
            w = arr.reshape(-1, arr.shape[-1]).T
            arr = np.zeros((-(-w.shape[0] // 8) * 8, w.shape[1]), np.int8)
            arr[:w.shape[0]] = w
        elif path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
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


def load_jax_checkpoint(path: str, model_name: str
                        ) -> dict[str, torch.Tensor]:
    """A float checkpoint of the JAX package -> the port's state dict of
    ``model_name``, on the CPU: an orbax directory (``best_model``, or a
    per-epoch checkpoint, of which ``params`` and ``batch_stats`` are
    taken), else a flax ``.msgpack`` file, which must hold exactly the two
    collections (JAX ``from_bytes`` against the model's template)."""
    if os.path.isdir(path):
        tree = orbax.load(path)
    else:
        tree = flax_msgpack.load(path)
        if not (isinstance(tree, dict)
                and set(tree) == {"params", "batch_stats"}):
            found = sorted(tree) if isinstance(tree, dict) else \
                type(tree).__name__
            raise ValueError(f"{path}: a flax msgpack of {found}, not a "
                             f"model's {{'params', 'batch_stats'}}")
    if not (isinstance(tree, dict) and "params" in tree):
        raise ValueError(f"{path}: no 'params' in the checkpoint")
    return variables_to_state_dict(
        {"params": tree["params"],
         "batch_stats": tree.get("batch_stats", {})},
        variant=efficientnet_variant_of(model_name))


# the ImageNet classifiers of a bare backbone checkpoint: torchvision's
# ResNet ``fc``, efficientnet_pytorch's ``_fc`` (under the backbone's model)
_IMAGENET_HEADS = ("fc.", "model._fc.")


def load_backbone_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A backbone state dict named as the port's ``model.backbone`` from a
    local file (JAX ``load_backbone_checkpoint``): a torchvision ResNet
    (``conv1.weight``, ``layer1.0.conv1.weight``, ...) or an
    efficientnet_pytorch net (``_conv_stem.weight``, ``_blocks.0...``),
    bare or as a full segmentation checkpoint (``backbone.*``, whose
    classifier is left out), in ``.pt`` / ``.pth`` (possibly wrapped as
    ``{'state_dict': ...}``) or ``.npz``. The ImageNet classifier is
    dropped. On the CPU."""
    if path.endswith(".npz"):
        with np.load(path) as arrays:
            state = {k: torch.from_numpy(arrays[k]) for k in arrays.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, Mapping) and "state_dict" in state:
            state = state["state_dict"]
        state = {k: torch.as_tensor(v) for k, v in state.items()}
    if any(k.startswith("backbone.") for k in state):
        state = {k[len("backbone."):]: v for k, v in state.items()
                 if k.startswith("backbone.")}
    if any(k.startswith("_conv_stem.") for k in state):
        # bare efficientnet_pytorch: the port wraps the net as .model
        state = {f"model.{k}": v for k, v in state.items()}
    return {k: v for k, v in state.items()
            if not k.startswith(_IMAGENET_HEADS)}


def merge_backbone(model: nn.Module, state: Mapping[str, torch.Tensor]
                   ) -> None:
    """Load ``state`` (``load_backbone_checkpoint``) into ``model.backbone``
    in place, after checking that it holds every tensor of the backbone
    and nothing else, each of the backbone's shape, as JAX
    ``merge_backbone`` does: a ResNet-50 / -101 mix-up fails before
    training. BatchNorm ``num_batches_tracked`` counters are neither
    required nor checked."""
    own = {k: v for k, v in model.backbone.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    given = {k: v for k, v in state.items()
             if not k.endswith("num_batches_tracked")}
    missing, unexpected = sorted(set(own) - set(given)), sorted(
        set(given) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"backbone checkpoint does not match the model's backbone: "
            f"{len(missing)} tensors missing ({missing[:3]}...), "
            f"{len(unexpected)} unexpected ({unexpected[:3]}...)")
    for k, v in own.items():
        if tuple(given[k].shape) != tuple(v.shape):
            raise ValueError(
                f"backbone checkpoint shape mismatch at {k}: model "
                f"{tuple(v.shape)} vs checkpoint {tuple(given[k].shape)}")
    model.backbone.load_state_dict(
        {k: v.to(own[k].dtype) for k, v in given.items()}, strict=False)
