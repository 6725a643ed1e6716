"""SegFormer (Xie et al. 2021, arXiv:2105.15203): the Mix Transformer
encoder (MiT) and the all-MLP decoder, at the widths of
``nvidia/segformer-b5-finetuned-cityscapes-1024-1024`` (MiT-B5), with the
application's 3 classes.

The layer equations and their order are those of transformers'
``modeling_segformer.py``, and so are the state-dict names, under the
port's ``backbone.`` (the encoder, ``segformer.encoder.`` there) and
``classifier.`` (the decode head, ``decode_head.`` there):

- overlapping patch embedding: a k x k convolution at stride s, padding
  k // 2, then a LayerNorm over the channels;
- a block: x + attention(LayerNorm(x)), then x + MixFFN(LayerNorm(x));
- efficient self-attention: queries from every token; keys and values
  from the tokens reduced by a sr x sr convolution at stride sr and a
  LayerNorm where the stage's ratio sr > 1; heads of 64 channels (the
  spec's ``head_dim``), softmax of q k^T / 8, an output linear layer;
- MixFFN: a linear layer to 4 x the width, a 3 x 3 depthwise convolution,
  exact GELU, a linear layer back;
- a LayerNorm after each stage's blocks;
- the decoder: each stage's map through a linear layer to 768 channels,
  resized bilinearly (align_corners False) to the first stage's size,
  concatenated in the order 4, 3, 2, 1, a bias-free 1 x 1 convolution 3072
  -> 768, BatchNorm, ReLU, (dropout,) a 1 x 1 classifier.

Every LayerNorm takes torch's default eps 1e-5, as modeling_segformer.py
builds them; the decoder's BatchNorm eps 1e-5. The logits come at the
first stage's stride, 4 (``logit_stride``), the encoder's features end at
32.

Inference only. The port's engine runs it on the exact-height path
(``supports_ragged`` False: under global attention a padded row is a key
of every query, so a padded batch is not the model), bf16 and
channels_last where a tensor is an image, the decoder's BatchNorm folded
into ``linear_fuse`` (models/fold.py). Refused at the entry points, each
with its reason: training (``supports_training``, refused by
train/loop.build_model: its stochastic depth and dropout have no
reference to be held against), int8 (no int8 twin), a split of the width
(``strip_multiple`` None, refused by the engine through
parallel/spatial.check_width_split: global attention over a strip is not
the model) and a JAX checkpoint (the JAX package has no SegFormer).

Spans (utils/profiling): ``predict/attention`` around each attention call
(ops/attention.py, one a block), ``predict/decode_head`` around the
decoder.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import NUM_CLASSES
from ..ops.attention import attention
from ..parallel.distributed import World
from ..utils.profiling import stage_timer
from .resnet import BN_EPS

LN_EPS = 1e-5


@dataclass(frozen=True)
class SegformerSpec:
    """The widths of a MiT encoder and its decoder, one entry a stage."""
    hidden_sizes: tuple[int, ...]
    depths: tuple[int, ...]
    heads: tuple[int, ...]
    sr_ratios: tuple[int, ...]
    patch_sizes: tuple[int, ...]
    strides: tuple[int, ...]
    mlp_ratio: int = 4
    decoder_hidden: int = 768
    head_dim: int = 64


# config.json of nvidia/segformer-b5-finetuned-cityscapes-1024-1024
MIT_B5 = SegformerSpec(hidden_sizes=(64, 128, 320, 512), depths=(3, 6, 40, 3),
                       heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                       patch_sizes=(7, 3, 3, 3), strides=(4, 2, 2, 2))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] tokens as an NCHW image (channels_last when ``x`` is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride, patch // 2)
        self.layer_norm = nn.LayerNorm(cout, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image -> [B, h, w, C] tokens."""
        return self.layer_norm(_nhwc(self.proj(x)))


class EfficientSelfAttention(nn.Module):
    def __init__(self, c: int, heads: int, head_dim: int, sr: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.sr_ratio = sr
        if sr > 1:
            self.sr = nn.Conv2d(c, c, sr, sr)
            self.layer_norm = nn.LayerNorm(c, eps=LN_EPS)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """[B, ..., C] -> [B, heads, tokens, head_dim]."""
        return t.reshape(t.shape[0], -1, self.heads,
                         self.head_dim).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kv = x
        if self.sr_ratio > 1:
            kv = self.layer_norm(_nhwc(self.sr(_nchw(x))))
        out = attention(self._heads(self.query(x)), self._heads(self.key(kv)),
                        self._heads(self.value(kv)))
        return out.transpose(1, 2).reshape(x.shape)


class SelfOutput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, c: int, heads: int, head_dim: int, sr: int):
        super().__init__()
        self.self = EfficientSelfAttention(c, heads, head_dim, sr)
        self.output = SelfOutput(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x))


class DWConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 3, 1, 1, groups=c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.dwconv(_nchw(x)))


class MixFFN(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(c, hidden)
        self.dwconv = DWConv(hidden)
        self.dense2 = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(F.gelu(self.dwconv(self.dense1(x))))


class SegformerLayer(nn.Module):
    def __init__(self, c: int, heads: int, head_dim: int, sr: int,
                 mlp_ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attention = Attention(c, heads, head_dim, sr)
        self.layer_norm_2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = MixFFN(c, c * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x))
        return x + self.mlp(self.layer_norm_2(x))


class MixTransformer(nn.Module):
    """The MiT encoder: NCHW images -> each stage's NCHW map (4 of them,
    at strides 4, 8, 16, 32)."""

    supports_ragged = False  # global attention: exact heights only
    supports_quantize = False
    supports_training = False
    feature_stride = 32
    strip_multiple = None  # the width is never split
    bn_eps = BN_EPS  # no BatchNorm here; the fold's default

    def __init__(self, spec: SegformerSpec = MIT_B5, folded: bool = False):
        super().__init__()
        self.spec = spec
        self.folded = folded  # nothing to fold: LayerNorms stay
        cin = 3
        self.patch_embeddings = nn.ModuleList()
        self.block = nn.ModuleList()
        self.layer_norm = nn.ModuleList()
        for i, c in enumerate(spec.hidden_sizes):
            self.patch_embeddings.append(OverlapPatchEmbed(
                cin, c, spec.patch_sizes[i], spec.strides[i]))
            self.block.append(nn.ModuleList(
                SegformerLayer(c, spec.heads[i], spec.head_dim,
                               spec.sr_ratios[i], spec.mlp_ratio)
                for _ in range(spec.depths[i])))
            self.layer_norm.append(nn.LayerNorm(c, eps=LN_EPS))
            cin = c
        self.out_channels = spec.hidden_sizes

    def folded_twin(self) -> "MixTransformer":
        return MixTransformer(self.spec, folded=True)

    def valid_feature_height(self, valid_h):
        raise ValueError("SegFormer runs on exact heights only (its "
                         "attention is global: padded rows would be keys)")

    def forward(self, x: torch.Tensor, dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> tuple[torch.Tensor, ...]:
        feats = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            t = embed(x)
            for blk in blocks:
                t = blk(t)
            x = _nchw(norm(t))
            feats.append(x)
        return tuple(feats)


class MLP(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class SegformerDecodeHead(nn.Module):
    """The all-MLP decoder: the encoder's four maps -> NCHW logits at the
    first map's size."""

    supports_quantize = False
    logit_stride = 4

    def __init__(self, in_channels: tuple[int, ...], hidden: int = 768,
                 num_classes: int = NUM_CLASSES, folded: bool = False):
        super().__init__()
        self.in_channels, self.hidden = tuple(in_channels), hidden
        self.num_classes, self.folded = num_classes, folded
        self.linear_c = nn.ModuleList(MLP(c, hidden) for c in in_channels)
        self.linear_fuse = nn.Conv2d(hidden * len(in_channels), hidden, 1,
                                     bias=folded)
        self.batch_norm = (nn.Identity() if folded
                           else nn.BatchNorm2d(hidden, eps=BN_EPS))
        self.classifier = nn.Conv2d(hidden, num_classes, 1)

    def folded_twin(self) -> "SegformerDecodeHead":
        return SegformerDecodeHead(self.in_channels, self.hidden,
                                   self.num_classes, folded=True)

    def forward(self, feats: tuple[torch.Tensor, ...],
                valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """The encoder's four maps -> NCHW logits (the encoder refuses
        ``valid_h`` first)."""
        with stage_timer("predict/decode_head"):
            size = feats[0].shape[-2:]
            ups = []
            for f, mlp in zip(feats, self.linear_c):
                y = _nchw(mlp.proj(_nhwc(f)))
                if y.shape[-2:] != size:
                    y = F.interpolate(y, size=size, mode="bilinear",
                                      align_corners=False)
                ups.append(y)
            y = self.linear_fuse(torch.cat(ups[::-1], dim=1))
            return self.classifier(F.relu(self.batch_norm(y)))

