"""The plain reference of SegFormer (Xie et al. 2021, arXiv:2105.15203):
the Mix Transformer encoder and the all-MLP decoder, as plain float32
functions over a state dict with the program's names, in the order of
operations of transformers' ``modeling_segformer.py``
(``SegformerForSemanticSegmentation``).

- Each of the four stages: an overlapping patch embedding (a k x k
  convolution at stride s, padding k // 2, then LayerNorm); blocks of
  x + attention(LayerNorm(x)) and x + MixFFN(LayerNorm(x)); a LayerNorm.
- Attention: queries from every token; keys and values from the tokens
  reduced by a sr x sr convolution at stride sr and a LayerNorm where the
  stage's ratio sr > 1; heads of ``head_dim`` channels; the scores q k^T x
  head_dim^-1/2 and their softmax written out, image by image; an output
  linear layer.
- MixFFN: a linear layer to ``mlp_ratio`` x the width, a 3 x 3 depthwise
  convolution, exact GELU, a linear layer back.
- The decoder: each stage's map through a linear layer to ``decoder``
  channels, resized bilinearly (align_corners False) to the first stage's
  size, concatenated as stages 4, 3, 2, 1, a bias-free 1 x 1 convolution,
  BatchNorm, ReLU, a 1 x 1 classifier to the 3 classes.
- The logits (stride 4) are upsampled to the input's size with
  ``F.interpolate(mode="bicubic", align_corners=False)``, the pipeline's
  upsample for every configuration (the published model resizes
  bilinearly).

Every LayerNorm takes eps 1e-5 and the BatchNorm 1e-5. Every product goes
through ``ops.c`` (the patch embeddings, the spatial-reduction and
depthwise convolutions, the fuse and the classifier) or ``ops.mm`` (every
linear layer, q k^T and the probabilities times v), so the FLOP counter
and the lower-precision controls see each one. Nothing here imports the
program under test.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from . import Normal, Ops, Uniform, Zeros, batch_norm

NUM_CLASSES = 3
LN_EPS = 1e-5
# nvidia/segformer-b5-finetuned-cityscapes-1024-1024, config.json
SPECS = {
    "segformer_b5": {
        "hidden": (64, 128, 320, 512), "depths": (3, 6, 40, 3),
        "heads": (1, 2, 5, 8), "sr": (8, 4, 2, 1), "patch": (7, 3, 3, 3),
        "stride": (4, 2, 2, 2), "mlp_ratio": 4, "decoder": 768,
        "head_dim": 64},
}

# calibrated (lib/weights.calibrate_bn): the decoder's one BatchNorm
CALIBRATE_PREFIX = "classifier.batch_norm"
CALIBRATE_EXCLUDE = ()
# the std of an attention score q . k / sqrt(d) that the query and key
# weights would give on independent LayerNorm-ed tokens, stage by stage
# (``init_rule``), and the scale of the std of the two layers that write a
# block's output into the residual stream (the attention's output layer
# and the feed-forward's second). A random network's tokens grow alike
# with depth, so its scores spread less than that, and most in the long
# third stage; a quarter of the usual std on the branches keeps the tokens
# apart, so every block's attention is peaked (the mean over its queries
# of a query's largest probability at least 20 / M over M keys) without
# the sharp scores that amplify the bf16 program's rounding. On the
# cell's images (an H100): one score std of 3 and full branches left the
# least peaked block at 2.4-3.0 / M and the e4m3 control 2.45x above the
# sound program; 2 separated 4.5x with blocks at 1.4-2.0 / M (PERF.md §6,
# PR 23, gives every reading)
SCORE_STD = (3.5, 3.5, 5.0, 6.0)
BRANCH_SCALE = 0.25


def spec(model: str) -> dict:
    if model not in SPECS:
        raise ValueError(f"no reference for model {model!r}")
    return SPECS[model]


def trains(model: str) -> bool:
    """SegFormer trains with stochastic depth and decoder dropout, which
    the training reference does not draw."""
    return False


def init_rule(name: str, shape: tuple) -> Normal | Uniform | Zeros:
    """How lib/weights.py draws the entry ``name`` of ``shape``:
    convolutions He-normal; the query and key weights of stage i
    N(0, SCORE_STD[i] / C) so that the attention is peaked; the output
    layers of a block's attention and feed-forward N(0, BRANCH_SCALE^2 /
    fan_in); the other linear layers N(0, 1 / fan_in); LayerNorm and
    BatchNorm scales U(0.5, 1.5), biases and running means N(0, 0.1),
    running variances U(0.5, 2)."""
    if name.endswith("num_batches_tracked"):
        return Zeros(torch.int64)
    if len(shape) == 4:
        return Normal((2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)
    if len(shape) == 2:
        if name.endswith((".query.weight", ".key.weight")):
            stage = int(name.split(".")[2])  # backbone.block.<stage>...
            return Normal((SCORE_STD[stage] / shape[1]) ** 0.5)
        if name.endswith(("attention.output.dense.weight",
                          "mlp.dense2.weight")):
            return Normal(BRANCH_SCALE * (1.0 / shape[1]) ** 0.5)
        return Normal((1.0 / shape[1]) ** 0.5)
    if name.endswith("running_var"):
        return Uniform(0.5, 2.0)
    if name.endswith(("running_mean", "bias")):
        return Normal(0.1)
    return Uniform(0.5, 1.5)


def _pair(p: str, c_out: int, c_in: int) -> dict:
    return {f"{p}.weight": (c_out, c_in), f"{p}.bias": (c_out,)}


def _norm(p: str, c: int) -> dict:
    return {f"{p}.weight": (c,), f"{p}.bias": (c,)}


def param_shapes(model: str) -> dict[str, tuple]:
    """Every state-dict entry and its shape, in the program's order and
    names (transformers' under ``backbone.`` for ``segformer.encoder.``
    and ``classifier.`` for ``decode_head.``)."""
    sp = spec(model)
    s: dict[str, tuple] = {}
    cin = 3
    for i, c in enumerate(sp["hidden"]):
        k = sp["patch"][i]
        p = f"backbone.patch_embeddings.{i}"
        s[f"{p}.proj.weight"] = (c, cin, k, k)
        s[f"{p}.proj.bias"] = (c,)
        s.update(_norm(f"{p}.layer_norm", c))
        cin = c
    for i, c in enumerate(sp["hidden"]):
        sr, hid = sp["sr"][i], c * sp["mlp_ratio"]
        for j in range(sp["depths"][i]):
            p = f"backbone.block.{i}.{j}"
            s.update(_norm(f"{p}.layer_norm_1", c))
            a = f"{p}.attention.self"
            for name in ("query", "key", "value"):
                s.update(_pair(f"{a}.{name}", c, c))
            if sr > 1:
                s[f"{a}.sr.weight"] = (c, c, sr, sr)
                s[f"{a}.sr.bias"] = (c,)
                s.update(_norm(f"{a}.layer_norm", c))
            s.update(_pair(f"{p}.attention.output.dense", c, c))
            s.update(_norm(f"{p}.layer_norm_2", c))
            s.update(_pair(f"{p}.mlp.dense1", hid, c))
            s[f"{p}.mlp.dwconv.dwconv.weight"] = (hid, 1, 3, 3)
            s[f"{p}.mlp.dwconv.dwconv.bias"] = (hid,)
            s.update(_pair(f"{p}.mlp.dense2", c, hid))
    for i, c in enumerate(sp["hidden"]):
        s.update(_norm(f"backbone.layer_norm.{i}", c))
    d = sp["decoder"]
    for i, c in enumerate(sp["hidden"]):
        s.update(_pair(f"classifier.linear_c.{i}.proj", d, c))
    s["classifier.linear_fuse.weight"] = (d, d * len(sp["hidden"]), 1, 1)
    s.update(_norm("classifier.batch_norm", d))
    s["classifier.batch_norm.running_mean"] = (d,)
    s["classifier.batch_norm.running_var"] = (d,)
    s["classifier.batch_norm.num_batches_tracked"] = ()
    s["classifier.classifier.weight"] = (NUM_CLASSES, d, 1, 1)
    s["classifier.classifier.bias"] = (NUM_CLASSES,)
    return s


def stage_sizes(model: str, h: int, w: int) -> list[tuple[int, int, int]]:
    """(queries N, keys M, width C) of each stage's attention for an h x w
    image."""
    sp = spec(model)
    out = []
    for i, c in enumerate(sp["hidden"]):
        k, st = sp["patch"][i], sp["stride"][i]
        h = (h + 2 * (k // 2) - k) // st + 1
        w = (w + 2 * (k // 2) - k) // st + 1
        sr = sp["sr"][i]
        out.append((h * w, (h // sr) * (w // sr), c))
    return out


def attention_flops(model: str, h: int, w: int) -> int:
    """The FLOPs of the attention's two products (q k^T and the
    probabilities times v) of one h x w image: 4 N M C a block."""
    return sum(4 * n * m * c * d for (n, m, c), d in
               zip(stage_sizes(model, h, w), spec(model)["depths"]))


@dataclass
class PeakOps(Ops):
    """``Ops`` that also show each attention's probabilities [heads, N, M]
    to ``on_probs``."""
    on_probs: Callable | None = None


def _linear(ops: Ops, st: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return ops.mm(x, st[f"{p}.weight"].t()) + st[f"{p}.bias"]


def _ln(st: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], st[f"{p}.weight"], st[f"{p}.bias"],
                        LN_EPS)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H, W, C]."""
    return x.permute(0, 2, 3, 1)


def _image(t: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> NCHW."""
    return t.permute(0, 3, 1, 2)


def _attention(st: dict, p: str, x: torch.Tensor, heads: int, sr: int,
               head_dim: int, ops: Ops) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, C]: efficient self-attention and its
    output layer."""
    b, hh, ww, c = x.shape
    a = f"{p}.attention.self"
    kv = x
    if sr > 1:
        kv = _ln(st, f"{a}.layer_norm", _tokens(ops.c(
            _image(x), st[f"{a}.sr.weight"], st[f"{a}.sr.bias"], sr)))

    def split(t):
        return t.reshape(b, -1, heads, head_dim).transpose(1, 2)

    q = split(_linear(ops, st, f"{a}.query", x))
    k = split(_linear(ops, st, f"{a}.key", kv))
    v = split(_linear(ops, st, f"{a}.value", kv))
    out = []
    for i in range(b):  # one image's scores at a time
        scores = ops.mm(q[i], k[i].transpose(-1, -2)) * head_dim ** -0.5
        probs = torch.softmax(scores, dim=-1)
        if getattr(ops, "on_probs", None) is not None:
            ops.on_probs(probs)
        out.append(ops.mm(probs, v[i]))
    o = torch.stack(out).transpose(1, 2).reshape(b, hh, ww, c)
    return _linear(ops, st, f"{p}.attention.output.dense", o)


def _mix_ffn(st: dict, p: str, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    y = _linear(ops, st, f"{p}.mlp.dense1", x)
    y = _tokens(ops.c(_image(y), st[f"{p}.mlp.dwconv.dwconv.weight"],
                      st[f"{p}.mlp.dwconv.dwconv.bias"], 1, 1, 1,
                      y.shape[-1]))
    return _linear(ops, st, f"{p}.mlp.dense2", F.gelu(y))


def _block(st: dict, p: str, heads: int, sr: int, head_dim: int, ops: Ops,
           x: torch.Tensor) -> torch.Tensor:
    x = x + _attention(st, p, _ln(st, f"{p}.layer_norm_1", x), heads, sr,
                       head_dim, ops)
    return x + _mix_ffn(st, p, _ln(st, f"{p}.layer_norm_2", x), ops)


def encoder(st: dict, x: torch.Tensor, model: str, ops: Ops
            ) -> list[torch.Tensor]:
    """NCHW normalized images -> each stage's NCHW map."""
    sp = spec(model)
    feats = []
    for i in range(len(sp["hidden"])):
        p = f"backbone.patch_embeddings.{i}"
        k = sp["patch"][i]
        t = _ln(st, f"{p}.layer_norm", _tokens(ops.c(
            x, st[f"{p}.proj.weight"], st[f"{p}.proj.bias"], sp["stride"][i],
            k // 2)))
        for j in range(sp["depths"][i]):
            t = ops.block(partial(_block, st, f"backbone.block.{i}.{j}",
                                  sp["heads"][i], sp["sr"][i],
                                  sp["head_dim"], ops), t)
        x = _image(_ln(st, f"backbone.layer_norm.{i}", t))
        feats.append(x)
    return feats


def decoder(st: dict, feats: list[torch.Tensor], ops: Ops) -> torch.Tensor:
    """The four maps -> logits at the first map's size (NCHW)."""
    if ops.train:
        raise ValueError("the reference does not train SegFormer")
    size = feats[0].shape[-2:]
    ups = []
    for i, f in enumerate(feats):
        y = _image(_linear(ops, st, f"classifier.linear_c.{i}.proj",
                           _tokens(f)))
        ups.append(F.interpolate(y, size=size, mode="bilinear",
                                 align_corners=False))
    y = ops.c(torch.cat(ups[::-1], dim=1),
              st["classifier.linear_fuse.weight"])
    y = F.relu(batch_norm(ops, st, "classifier.batch_norm", y))
    return ops.c(y, st["classifier.classifier.weight"],
                 st["classifier.classifier.bias"])


def logits(st: dict, x: torch.Tensor, model: str,
           ops: Ops | None = None) -> torch.Tensor:
    """NCHW normalized images [B, 3, H, W] -> float32 logits [B, 3, H, W]
    at the input's resolution (bicubic, align_corners=False)."""
    ops = ops or Ops()
    out = decoder(st, encoder(st, x, model, ops), ops)
    return F.interpolate(out, size=x.shape[-2:], mode="bicubic",
                         align_corners=False)


def attention_peaks(st: dict, x: torch.Tensor, model: str) -> list[float]:
    """Each block's mean over its queries (and heads and images) of the
    largest attention probability, in the order the blocks run."""
    peaks: list[float] = []
    ops = PeakOps(on_probs=lambda p: peaks.append(float(p.amax(-1).mean())))
    with torch.no_grad():
        logits(st, x, model, ops)
    b = x.shape[0]
    return [sum(peaks[k:k + b]) / b for k in range(0, len(peaks), b)]
