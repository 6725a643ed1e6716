"""Inference-time constant folding: BatchNorm -> conv weight/bias.

In eval mode every BatchNorm of the zoo is an affine map applied directly
to a bias-free conv's output. Folding it into the conv,

    weight' = weight * (gamma / sqrt(var + eps))   (per output channel)
    bias'   = beta - mean * gamma / sqrt(var + eps)

removes every BN pass from the inference forward. The fold is computed in
float64 and cast back to float32, so the folded forward matches the
unfolded one to float32 rounding. A depthwise weight [C, 1, k, k] folds
the same way (the scale rides its output channel). It has no reference
equivalent: the reference always runs BN at inference.

Each BN's producer conv is found by its name (``_conv_of``):
- ResNet: ``bnN`` -> ``convN``;
- a BN at index i of an ``nn.Sequential`` -> the conv at i - 1
  (``downsample.1``, the FCN head's ``classifier.1``, DeepLab's
  ``classifier.2``, the ASPP's ``convs.*.1``, ``convs.4.2`` and
  ``project.1``);
- EfficientNet (efficientnet_pytorch's names): ``_bn0`` -> ``_conv_stem``
  and ``_bn1`` -> ``_conv_head`` at the top level; inside a block
  (``_blocks.{j}``) ``_bn0`` / ``_bn1`` / ``_bn2`` -> ``_expand_conv`` /
  ``_depthwise_conv`` / ``_project_conv``. The two ``_bn1`` are told apart
  by their scope;
- SegFormer's decoder: ``batch_norm`` -> ``linear_fuse`` (its encoder's
  LayerNorms stay).
``eps`` is per top-level scope: the backbone's ``bn_eps`` (1e-3 for
EfficientNet) and 1e-5 for the heads.

The input normalize is not folded: the stem conv's zero padding stands
for zeros in normalized space, so a bias correction would be wrong at the
border and would break the zero-beyond-valid_h ragged invariant.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .resnet import BN_EPS
from .segmentation import SegmentationModel

_EFF_TOP = {"_bn0": "_conv_stem", "_bn1": "_conv_head"}
_EFF_BLOCK = {"_bn0": "_expand_conv", "_bn1": "_depthwise_conv",
              "_bn2": "_project_conv"}


def _conv_of(bn: str) -> str:
    """The producer conv of a BN module name."""
    parent, _, leaf = bn.rpartition(".")
    if leaf in _EFF_BLOCK and parent.rpartition(".")[0].endswith("_blocks"):
        return f"{parent}.{_EFF_BLOCK[leaf]}"
    if leaf in _EFF_TOP:
        return f"{parent}.{_EFF_TOP[leaf]}"
    if leaf == "batch_norm":
        return f"{parent}.linear_fuse"
    if leaf.startswith("bn"):
        return f"{parent}.conv{leaf[2:]}"
    if leaf.isdigit() and int(leaf) > 0:
        return f"{parent}.{int(leaf) - 1}"
    raise ValueError(f"unrecognized BatchNorm module {bn!r}")


def fold_state_dict(state: Mapping[str, torch.Tensor],
                    eps: float | Mapping[str, float] = BN_EPS
                    ) -> dict[str, torch.Tensor]:
    """Unfolded state dict -> folded state dict (BN entries gone, their
    convs with a bias), for a folded model. ``eps``: the BN epsilon, or a
    mapping from the top-level scope ('backbone' / 'classifier') to it."""
    bns = sorted(k[:-len(".running_mean")] for k in state
                 if k.endswith(".running_mean"))
    if not bns:
        raise ValueError("no BatchNorm statistics to fold (already folded?)")
    out = {k: v for k, v in state.items()
           if k.rpartition(".")[0] not in bns}
    for bn in bns:
        conv = _conv_of(bn)
        if f"{conv}.weight" not in state:
            raise ValueError(f"BN {bn} has no conv {conv}")
        bn_eps = (eps.get(bn.split(".")[0], BN_EPS)
                  if isinstance(eps, Mapping) else eps)
        w = state[f"{conv}.weight"].double()
        k = (state[f"{bn}.weight"].double()
             / torch.sqrt(state[f"{bn}.running_var"].double() + bn_eps))
        out[f"{conv}.weight"] = (w * k[:, None, None, None]).float()
        out[f"{conv}.bias"] = (state[f"{bn}.bias"].double()
                               - state[f"{bn}.running_mean"].double() * k
                               ).float()
    return out


def fold_model(model: SegmentationModel) -> SegmentationModel:
    """An unfolded model of any factory -> its folded twin (same device,
    float32, eval mode)."""
    folded = SegmentationModel(model.backbone.folded_twin(),
                               model.classifier.folded_twin())
    state = fold_state_dict({k: v.detach().cpu()
                             for k, v in model.state_dict().items()},
                            eps={"backbone": model.backbone.bn_eps,
                                 "classifier": BN_EPS})
    folded.load_state_dict(state, strict=True)
    device = next(model.parameters()).device
    return folded.to(device).eval()
