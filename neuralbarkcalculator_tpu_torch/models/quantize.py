"""Post-training int8 quantization: calibrate -> convert -> int8 model
(the JAX package's ``models/quantize.py``).

A folded model (models/fold.py) of the ResNet zoo becomes a
``QuantizedSegmentationModel`` (models/segmentation.py; primitives in
models/qops.py): symmetric per-output-channel weight scales, static
per-tensor activation scales calibrated as max|x| / 127 over a few
batches of representative images, and requantization epilogues computed
offline (m[c] = s_in * s_w[c] / s_next, b[c] = bias[c] / s_next), so the
runtime graph is int8 GEMM -> multiply, add -> round, clip, cast.

- ``calibrate`` records max|x| where the JAX package sows it: ``q_in``,
  ``q_stem`` (after the stem's ReLU), each block's ``q_t1``, ``q_t2``,
  ``q_ds`` (the downsample branch) and ``q_out``, the FCN head's
  ``q_t1``, the ASPP's ``q_cat`` (the concat of its branches) and
  ``q_proj``, and the DeepLab head's ``q_h``. It runs the folded model at
  its own dtype with forward hooks, so the plain forward carries no cost
  for it. Stats are keyed by the JAX scope paths.
- ``quantize_variables`` turns the folded float32 weights and the stats
  into the JAX package's quantized ``{'params'}`` tree, in float64 numpy,
  as the JAX function computes it, line for line; ``quantize_model`` loads
  that into the int8 model (models/convert.quantized_variables_to_state_dict).
- The offline int8 checkpoint is a ``torch.save`` dict ``{"format":
  "NBCQINT8", "version": 1, "model": name, "state_dict": ...}``, by
  convention ``*.int8.pt``. It loads with no BN folding and no
  calibration. The JAX package's ``.int8.msgpack`` (the 8-byte
  ``NBCQINT8`` tag, the version byte ``\x01``, then the flax msgpack of
  its quantized ``{'params'}``) loads through ``load_jax_quantized`` into
  the same int8 model (io/flax_msgpack.py,
  models/convert.quantized_variables_to_state_dict).

Scope: the dilated ResNets with the FCN or DeepLabV3 head
(``supports_quantize``). EfficientNet raises, as in JAX: its SE / swish
graph has no int8 mode.
"""
from __future__ import annotations

import hashlib
import os
import warnings
import zipfile
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from ..io import flax_msgpack
from .convert import module_name, quantized_variables_to_state_dict
from .fold import fold_model
from .heads import DeepLabHead, QuantizedDeepLabHead
from .segmentation import (MODEL_FACTORIES, QuantizedSegmentationModel,
                           SegmentationModel)

_EPS = 1e-6  # floor for calibrated scales (dead tensors / channels)

QCKPT_FORMAT = "NBCQINT8"
QCKPT_VERSION = 1
# the JAX package's int8 checkpoint: this tag, a version byte, a msgpack
JAX_QCKPT_TAG = b"NBCQINT8"
JAX_QCKPT_MAGIC = JAX_QCKPT_TAG + b"\x01"


def check_quantizable(model: SegmentationModel) -> None:
    """Raise ``ValueError`` for a backbone or head without an int8 mode
    (EfficientNet, SegFormer)."""
    for part, label in ((model.backbone, "backbone"),
                        (model.classifier, "head")):
        if not getattr(part, "supports_quantize", False):
            raise ValueError(
                f"{label} {type(part).__name__} has no int8 inference "
                f"mode (supported: DilatedResNet backbones + "
                f"FCNHead/DeepLabHead)")


def quantized_twin(model: SegmentationModel) -> QuantizedSegmentationModel:
    """The int8 model of ``model``'s layout, its buffers zero; raises
    ``ValueError`` for a backbone or head without an int8 mode."""
    check_quantizable(model)
    return QuantizedSegmentationModel(model.backbone.quantized_twin(),
                                      model.classifier.quantized_twin())


def _sow_points(model: SegmentationModel):
    """(module, hook kind, JAX stats path) of every calibration point of a
    folded model: "in" reads the module's input, "out" its output, "relu"
    the ReLU of its output."""
    backbone, head = model.backbone, model.classifier
    points = [(backbone, "in", ("backbone", "q_in")),
              (backbone.bn1, "relu", ("backbone", "q_stem"))]
    for stage in range(len(backbone.stage_sizes)):
        for i, block in enumerate(getattr(backbone, f"layer{stage + 1}")):
            scope = ("backbone", f"layer{stage + 1}_{i}")
            points += [(block.bn1, "relu", scope + ("q_t1",)),
                       (block.bn2, "relu", scope + ("q_t2",)),
                       (block, "out", scope + ("q_out",))]
            if block.downsample is not None:
                points.append((block.downsample, "out", scope + ("q_ds",)))
    if isinstance(head, DeepLabHead):
        aspp = head[0]
        points += [(aspp.project[0], "in", ("classifier", "aspp", "q_cat")),
                   (aspp.project[2], "out",
                    ("classifier", "aspp", "q_proj")),
                   (head[3], "out", ("classifier", "q_h"))]
    else:
        points.append((head[2], "out", ("classifier", "q_t1")))
    return points


def stat_paths(model: SegmentationModel) -> list[tuple[str, ...]]:
    """The JAX scope paths ``calibrate`` records for ``model``'s layout,
    sorted: the order in which a mesh's rank 0 hands its stats to the
    other ranks (pipeline/predict.py)."""
    return sorted(path for _, _, path in _sow_points(model))


def calibrate(model: SegmentationModel, batches: Iterable[torch.Tensor]
              ) -> dict[tuple[str, ...], float]:
    """Run the folded model over calibration batches (normalized NHWC, at
    the model's device and dtype; no row masks), collecting per-tensor
    max|x| at the JAX package's calibration points. Returns {JAX scope
    path: max|x|}, the max over the batches."""
    if not (model.backbone.folded and model.classifier.folded):
        raise ValueError("calibrate needs a folded model (models/fold.py)")
    agg: dict[tuple[str, ...], torch.Tensor] = {}

    def record(path, t):
        v = t.detach().abs().amax()
        agg[path] = v if path not in agg else torch.maximum(agg[path], v)

    handles = []
    for module, kind, path in _sow_points(model):
        if kind == "in":
            hook = (lambda p: lambda mod, args: record(p, args[0]))(path)
            handles.append(module.register_forward_pre_hook(hook))
        else:
            relu = kind == "relu"
            hook = (lambda p, r: lambda mod, args, out: record(
                p, out.clamp_min(0) if r else out))(path, relu)
            handles.append(module.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            for x in batches:
                model.head_logits(x)
    finally:
        for h in handles:
            h.remove()
    return {path: float(v) for path, v in agg.items()}


def _quantize_conv(out: dict, scope: tuple, kernel: np.ndarray,
                   bias: np.ndarray, s_in: float,
                   s_next: float | None) -> None:
    """Emit {scope}_q / {scope}_m / {scope}_b for one conv. ``s_next``
    None means the consumer wants real units (residual adds, logits)."""
    k = np.asarray(kernel, np.float64)
    b = np.asarray(bias, np.float64)
    w_scale = np.maximum(np.max(np.abs(k), axis=(0, 1, 2)) / 127.0, _EPS)
    out[scope[:-1] + (scope[-1] + "_q",)] = np.clip(
        np.rint(k / w_scale), -127, 127).astype(np.int8)
    if s_next is None:
        m, bq = s_in * w_scale, b
    else:
        m, bq = s_in * w_scale / s_next, b / s_next
    out[scope[:-1] + (scope[-1] + "_m",)] = m.astype(np.float32)
    out[scope[:-1] + (scope[-1] + "_b",)] = bq.astype(np.float32)


def _unflatten(flat: Mapping[tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def quantize_variables(folded_state: Mapping[str, torch.Tensor],
                       stats: Mapping[tuple[str, ...], float],
                       stage_sizes: Sequence[int],
                       head: str = "fcn") -> dict:
    """Folded float32 state dict + calibration stats -> the JAX package's
    quantized ``{'params'}`` tree (numpy), computed as JAX's
    ``quantize_variables`` computes it. Walks the backbone blocks in
    dataflow order so each block's input scale is its producer's output
    scale. ``head``: 'fcn' or 'deeplab'."""
    def hwio(scope: tuple) -> np.ndarray:
        w = folded_state[f"{module_name(scope)}.weight"]
        return w.detach().cpu().numpy().transpose(2, 3, 1, 0)

    def bias(scope: tuple) -> np.ndarray:
        return folded_state[f"{module_name(scope)}.bias"].detach().cpu(
            ).numpy()

    out: dict[tuple, np.ndarray] = {}

    def scale(*path: str) -> float:
        if path not in stats:
            raise ValueError(f"calibration stats missing {path} — was the "
                             "calibration run on the folded model?")
        return max(stats[path] / 127.0, _EPS)

    def conv(scope: tuple, s_in: float, s_next: float | None) -> None:
        _quantize_conv(out, scope, hwio(scope), bias(scope), s_in, s_next)

    # the stem stays float (models/resnet.py QuantizedResNet): the folded
    # conv copied verbatim, quantized after the pool
    s_prev = scale("backbone", "q_stem")
    out[("backbone", "conv1", "kernel")] = np.asarray(
        hwio(("backbone", "conv1")), np.float32)
    out[("backbone", "conv1", "bias")] = np.asarray(
        bias(("backbone", "conv1")), np.float32)
    out[("backbone", "inv_s_stem")] = np.float32(1.0 / s_prev)

    inplanes = 64
    for stage, num_blocks in enumerate(stage_sizes):
        planes = 64 * (2 ** stage)
        stride = 1 if stage == 0 else 2
        for block in range(num_blocks):
            name = f"layer{stage + 1}_{block}"
            bscope = ("backbone", name)
            s_t1 = scale(*bscope, "q_t1")
            s_t2 = scale(*bscope, "q_t2")
            s_out = scale(*bscope, "q_out")
            conv(bscope + ("conv1",), s_prev, s_t1)
            conv(bscope + ("conv2",), s_t1, s_t2)
            # conv3 + downsample requantize to s_out units so the whole
            # residual add runs there
            conv(bscope + ("conv3",), s_t2, s_out)
            if block == 0 and (stride != 1 or inplanes != planes * 4):
                conv(bscope + ("downsample_conv",), s_prev, s_out)
                # requant_signed clips this branch to +-127*s_out; the
                # clip is only sound if the calibrated branch magnitude
                # fits (the branch CAN exceed the post-ReLU block output
                # it shares a scale with): warn on overflow risk
                ds_key = bscope + ("q_ds",)
                if ds_key in stats and stats[ds_key] > 127.0 * s_out:
                    warnings.warn(
                        f"int8 calibration: {name} downsample branch "
                        f"max-abs {stats[ds_key]:.3g} exceeds its "
                        f"residual clip range {127.0 * s_out:.3g} "
                        f"({stats[ds_key] / (127.0 * s_out):.2f}x) — "
                        "expect saturation error in this block; "
                        "calibrate on more representative data",
                        stacklevel=2)
            else:
                out[bscope + ("s_ratio",)] = np.float32(s_prev / s_out)
            s_prev = s_out
            inplanes = planes * 4

    if head == "fcn":
        s_h1 = scale("classifier", "q_t1")
        conv(("classifier", "conv1"), s_prev, s_h1)
        conv(("classifier", "conv2"), s_h1, None)
    elif head == "deeplab":
        aspp = ("classifier", "aspp")
        s_cat = scale(*aspp, "q_cat")
        conv(aspp + ("b0_conv",), s_prev, s_cat)
        for i in range(3):  # the atrous branches, all requant to s_cat
            conv(aspp + (f"b{i + 1}", "conv"), s_prev, s_cat)
        # the pooled branch stays float32 (QuantizedASPP)
        out[aspp + ("pool_conv_kernel",)] = np.asarray(
            hwio(aspp + ("pool_conv",)), np.float32)[0, 0]
        out[aspp + ("pool_conv_bias",)] = np.asarray(
            bias(aspp + ("pool_conv",)), np.float32)
        out[aspp + ("s_in",)] = np.float32(s_prev)
        out[aspp + ("inv_s_cat",)] = np.float32(1.0 / s_cat)
        s_proj = scale(*aspp, "q_proj")
        conv(aspp + ("project_conv",), s_cat, s_proj)
        s_h = scale("classifier", "q_h")
        conv(("classifier", "conv"), s_proj, s_h)
        conv(("classifier", "classifier"), s_h, None)
    else:
        raise ValueError(f"unknown head kind {head!r}")
    return {"params": _unflatten(out)}


def quantize_model(model: SegmentationModel,
                   calib_batches: Iterable[torch.Tensor] | None = None,
                   folded_state: Mapping[str, torch.Tensor] | None = None,
                   stats: Mapping[tuple[str, ...], float] | None = None
                   ) -> QuantizedSegmentationModel:
    """(model, calibration batches) -> the int8 model, on the CPU.

    ``model`` is folded or not (folded here if not), on any device and
    dtype: calibration runs it as it is on ``calib_batches`` (normalized
    NHWC batches on its device, at its dtype), unless ``stats`` gives
    ``calibrate``'s result already (a mesh's rank 0 calibrates for every
    rank). ``folded_state``: the folded float32 weights to quantize, when
    ``model`` itself holds them in another dtype (the engine's bf16
    copy); default its own."""
    twin = quantized_twin(model)
    if not model.backbone.folded:
        model = fold_model(model)
    if stats is None:
        stats = calibrate(model, calib_batches)
    if folded_state is None:
        folded_state = {k: v.detach().float().cpu()
                        for k, v in model.state_dict().items()}
    head = ("deeplab" if isinstance(twin.classifier, QuantizedDeepLabHead)
            else "fcn")
    qvars = quantize_variables(folded_state, stats,
                               model.backbone.stage_sizes, head)
    twin.load_state_dict(quantized_variables_to_state_dict(qvars))
    return twin.eval()


def state_digest(qmodel: QuantizedSegmentationModel) -> bytes:
    """sha256 of an int8 model's state dict (names, dtypes, shapes and
    bytes, in name order): equal on two processes exactly when their
    weights and scales are equal bit for bit."""
    h = hashlib.sha256()
    for key, v in sorted(qmodel.state_dict().items()):
        v = v.detach().cpu().contiguous()
        h.update(repr((key, str(v.dtype), tuple(v.shape))).encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.digest()


def save_quantized(path: str, qmodel: QuantizedSegmentationModel,
                   model_name: str) -> None:
    """Write an offline int8 checkpoint of ``qmodel`` (from
    ``quantize_model`` or a calibrated engine), which deployments load
    with no folding and no calibration."""
    torch.save({"format": QCKPT_FORMAT, "version": QCKPT_VERSION,
                "model": model_name,
                "state_dict": {k: v.detach().cpu()
                               for k, v in qmodel.state_dict().items()}},
               path)


def is_jax_quantized_checkpoint(path: str) -> bool:
    """True when ``path`` starts with the JAX package's int8 tag (its
    ``.int8.msgpack``; the version byte is checked on loading)."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(len(JAX_QCKPT_TAG)) == JAX_QCKPT_TAG


def _read(path: str, mmap: bool = False):
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)


def is_quantized_checkpoint(path: str) -> bool:
    """True when ``path`` is the port's offline int8 checkpoint (a
    ``torch.save`` zip whose dict says ``format: NBCQINT8``); the tensors
    are memory-mapped, not read."""
    if not (os.path.isfile(path) and zipfile.is_zipfile(path)):
        return False
    obj = _read(path, mmap=True)
    return isinstance(obj, Mapping) and obj.get("format") == QCKPT_FORMAT


def load_quantized(path: str, model_name: str = "fcn_resnet50"
                   ) -> QuantizedSegmentationModel:
    """The port's offline int8 checkpoint -> the int8 model, on the CPU,
    float32, eval mode. ``model_name`` must be the factory the checkpoint
    was quantized from."""
    obj = _read(path)
    if not (isinstance(obj, Mapping) and obj.get("format") == QCKPT_FORMAT):
        raise ValueError(f"{path!r} is not an int8 checkpoint of the port")
    if obj.get("version") != QCKPT_VERSION:
        raise ValueError(f"{path!r} is int8 checkpoint version "
                         f"{obj.get('version')!r}, this runtime reads "
                         f"{QCKPT_VERSION}: quantize the float checkpoint "
                         f"again with cli/quantize_checkpoint")
    if obj.get("model") != model_name:
        raise ValueError(f"{path!r} holds an int8 {obj.get('model')!r}, "
                         f"not {model_name!r} (pass --model "
                         f"{obj.get('model')})")
    with torch.device("meta"):  # the layout only: no float weights made
        layout = MODEL_FACTORIES[model_name]()
    qmodel = quantized_twin(layout)
    qmodel.load_state_dict(obj["state_dict"])
    return qmodel.eval()


def load_jax_quantized(path: str, model_name: str = "fcn_resnet50"
                       ) -> QuantizedSegmentationModel:
    """The JAX package's offline int8 checkpoint (``save_quantized``'s
    ``.int8.msgpack``) -> the int8 model, on the CPU, float32, eval mode,
    as ``load_quantized`` gives it; raises for another version byte as
    the JAX package's loader does, and for a checkpoint of another
    ``model_name``."""
    with open(path, "rb") as f:
        prefix = f.read(len(JAX_QCKPT_MAGIC))
    if prefix[:len(JAX_QCKPT_TAG)] != JAX_QCKPT_TAG:
        raise ValueError(f"{path!r} is not an int8 checkpoint (missing "
                         f"NBCQINT8 prefix)")
    if prefix != JAX_QCKPT_MAGIC:
        raise ValueError(
            f"{path!r} is int8 checkpoint version "
            f"{prefix[len(JAX_QCKPT_TAG):]!r}, this runtime reads "
            f"{JAX_QCKPT_MAGIC[len(JAX_QCKPT_TAG):]!r} — re-export it with "
            f"tools/quantize_checkpoint.py from the original f32 checkpoint")
    tree = flax_msgpack.load(path, offset=len(JAX_QCKPT_MAGIC))
    if not (isinstance(tree, dict) and set(tree) == {"params"}):
        found = sorted(tree) if isinstance(tree, dict) else \
            type(tree).__name__
        raise ValueError(f"{path}: a flax msgpack of {found}, not a "
                         f"quantized model's {{'params'}}")
    with torch.device("meta"):  # the layout only: no float weights made
        layout = MODEL_FACTORIES[model_name]()
    qmodel = quantized_twin(layout)
    qmodel.load_state_dict(quantized_variables_to_state_dict(tree))
    return qmodel.eval()


__all__ = ["QCKPT_FORMAT", "QCKPT_VERSION", "calibrate", "check_quantizable",
           "is_jax_quantized_checkpoint", "is_quantized_checkpoint",
           "load_jax_quantized", "load_quantized", "quantize_model",
           "quantize_variables", "quantized_twin", "save_quantized",
           "stat_paths", "state_digest"]
