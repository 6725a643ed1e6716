"""Inference-time constant folding: BatchNorm -> conv weight/bias.

In eval mode every BatchNorm here is an affine map applied directly to a
bias-free conv's output. Folding it into the conv,

    weight' = weight * (gamma / sqrt(var + eps))   (per output channel)
    bias'   = beta - mean * gamma / sqrt(var + eps)

removes every BN pass from the inference forward. The fold is computed in
float64 and cast back to float32, so the folded forward matches the
unfolded one to float32 rounding. It has no reference equivalent: the
reference always runs BN at inference.

The input normalize is not folded: the stem conv's zero padding stands
for zeros in normalized space, so a bias correction would be wrong at the
border and would break the zero-beyond-valid_h ragged invariant.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .heads import FCNHead
from .resnet import BN_EPS, DilatedResNet
from .segmentation import SegmentationModel


def _conv_of(bn: str) -> str:
    """The producer conv of a BN module name (torchvision naming):
    'backbone.bn1' -> 'backbone.conv1', '...downsample.1' ->
    '...downsample.0', 'classifier.1' -> 'classifier.0'."""
    parent, _, leaf = bn.rpartition(".")
    if leaf.startswith("bn"):
        return f"{parent}.conv{leaf[2:]}"
    if leaf == "1" and (parent.endswith("downsample")
                        or parent == "classifier"):
        return f"{parent}.0"
    raise ValueError(f"unrecognized BatchNorm module {bn!r}")


def fold_state_dict(state: Mapping[str, torch.Tensor],
                    eps: float = BN_EPS) -> dict[str, torch.Tensor]:
    """Unfolded state dict -> folded state dict (BN entries gone, their
    convs with a bias), for a ``folded=True`` model."""
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
        w = state[f"{conv}.weight"].double()
        k = (state[f"{bn}.weight"].double()
             / torch.sqrt(state[f"{bn}.running_var"].double() + eps))
        out[f"{conv}.weight"] = (w * k[:, None, None, None]).float()
        out[f"{conv}.bias"] = (state[f"{bn}.bias"].double()
                               - state[f"{bn}.running_mean"].double() * k
                               ).float()
    return out


def fold_model(model: SegmentationModel) -> SegmentationModel:
    """An unfolded model -> its folded twin (same device, float32)."""
    bb, head = model.backbone, model.classifier
    folded = SegmentationModel(
        DilatedResNet(bb.stage_sizes, bb.replace_stride_with_dilation,
                      folded=True),
        FCNHead(head.in_channels, head.channels, dropout=head.dropout,
                folded=True))
    state = fold_state_dict({k: v.detach().cpu()
                             for k, v in model.state_dict().items()})
    folded.load_state_dict(state, strict=True)
    device = next(model.parameters()).device
    return folded.to(device).eval()
