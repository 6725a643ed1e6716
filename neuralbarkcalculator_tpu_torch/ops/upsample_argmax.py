"""Fused bicubic upsample + class argmax: the CUDA kernel and its plain
version.

``upsample_argmax(feat, row_ops, colt)`` maps head logits at the model's
logit stride (8 for the ResNets' ragged batches, 32 for EfficientNet's
exact heights, 4 for SegFormer's, whose kernel's buffers are sized for
it) ``feat [B, F, Wf, 3]`` (float32), per-image row operators
``row_ops [B, OH, F]`` and the transposed width operator ``colt [Wf, OW]``
to the uint8 class map ``[B, OH, OW]``, without writing the float
upsampled logits anywhere. It replaces the Pallas TPU kernel
``neuralbarkcalculator_tpu/ops/pallas_kernels.py::upsample_argmax``.

- On CUDA tensors it launches the hand-written kernel
  (``csrc/upsample_argmax.cu``, built at first use) or raises.
- On CPU tensors it runs ``upsample_argmax_plain``, the same function as
  torch ops. That is the only case the plain version serves.

The kernel computes only over each operator row's and column's nonzero
window (``operator_windows``): at most 4 entries for the bicubic
operators, the whole axis for a dense one. It finds the row windows from
the row tiles it loads; the column windows are ``column_windows(colt)``,
which a caller that reuses one ``colt`` computes once and passes as
``col_windows`` (the predict engine caches them beside ``colt``). Without
it the wrapper computes them on each call.

``launches`` counts kernel launches (``LAUNCHES.count``), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .kernels import LaunchCounter, check_launch, kernel_lib

LAUNCHES = LaunchCounter()

# the per-block shared-memory ceiling on Hopper (232,448 bytes)
_MAX_SMEM = 227 * 1024


def upsample_argmax_plain(feat: torch.Tensor, row_ops: torch.Tensor,
                          colt: torch.Tensor) -> torch.Tensor:
    """The same function as plain torch ops: two float32 products per
    class plane (run with TF32 off on a card), then argmax with
    first-index ties (torch.argmax returns the first maximal index)."""
    planes = feat.float().permute(0, 3, 1, 2)            # [B, 3, F, Wf]
    rows = torch.einsum("bof,bcfw->bcow", row_ops.float(), planes)
    logits = torch.einsum("bcow,wp->bcop", rows, colt.float())
    return logits.argmax(dim=1).to(torch.uint8)


def operator_windows(op: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The nonzero window of each row of ``op [..., N]``: (first nonzero
    index, last nonzero index + 1), and (0, 0) for an all-zero row. For
    colT's columns pass ``colt.t()``."""
    nz = op != 0
    n = op.shape[-1]
    idx = torch.arange(n, device=op.device)
    lo = torch.where(nz, idx, n).amin(dim=-1)
    hi = torch.where(nz, idx + 1, 0).amax(dim=-1)
    return torch.where(hi > 0, lo, 0), hi


def column_windows(colt: torch.Tensor) -> torch.Tensor:
    """Each column's nonzero window of ``colt [Wf, OW]`` as the kernel
    takes it: int32 [2, OW], first nonzero row then last + 1."""
    return torch.stack(operator_windows(colt.t())).to(torch.int32).contiguous()


def _check(feat, row_ops, colt) -> None:
    for name, t in (("feat", feat), ("row_ops", row_ops), ("colt", colt)):
        if t.dtype != torch.float32:
            raise TypeError(f"upsample_argmax: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"upsample_argmax: {name} must be contiguous")
    if feat.dim() != 4 or feat.shape[3] != 3:
        raise ValueError(f"upsample_argmax: feat must be [B, F, Wf, 3], "
                         f"got {tuple(feat.shape)}")
    b, f, wf, _ = feat.shape
    if row_ops.dim() != 3 or row_ops.shape[0] != b or row_ops.shape[2] != f:
        raise ValueError(f"upsample_argmax: row_ops must be [{b}, OH, {f}], "
                         f"got {tuple(row_ops.shape)}")
    if colt.dim() != 2 or colt.shape[0] != wf:
        raise ValueError(f"upsample_argmax: colt must be [{wf}, OW], got "
                         f"{tuple(colt.shape)}")


def upsample_argmax(feat: torch.Tensor, row_ops: torch.Tensor,
                    colt: torch.Tensor,
                    col_windows: torch.Tensor | None = None) -> torch.Tensor:
    """[B, F, Wf, 3] f32, [B, OH, F] f32, [Wf, OW] f32 -> [B, OH, OW] u8.
    ``col_windows`` must be ``column_windows(colt)`` when given."""
    _check(feat, row_ops, colt)
    if col_windows is None:
        col_windows = column_windows(colt)
    if (col_windows.dtype != torch.int32
            or tuple(col_windows.shape) != (2, colt.shape[1])
            or not col_windows.is_contiguous()):
        raise ValueError(f"upsample_argmax: col_windows must be contiguous "
                         f"int32 [2, {colt.shape[1]}], got "
                         f"{col_windows.dtype} {tuple(col_windows.shape)}")
    devices = {feat.device, row_ops.device, colt.device, col_windows.device}
    if len(devices) != 1:
        raise ValueError(f"upsample_argmax: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    device = feat.device
    if device.type == "cpu":
        return upsample_argmax_plain(feat, row_ops, colt)
    if device.type != "cuda":
        raise ValueError(f"upsample_argmax: no kernel for device {device}")
    b, f, wf, _ = feat.shape
    oh, ow = row_ops.shape[1], colt.shape[1]
    lib = kernel_lib("upsample_argmax")
    smem = lib.upsample_argmax_smem_bytes(f, wf, ow)
    if smem > _MAX_SMEM:
        raise ValueError(f"upsample_argmax: F={f}, Wf={wf} need {smem} B of "
                         f"shared memory per block, above {_MAX_SMEM}")
    out = torch.empty((b, oh, ow), dtype=torch.uint8, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.upsample_argmax_launch(
            feat.data_ptr(), row_ops.data_ptr(), colt.data_ptr(),
            col_windows.data_ptr(), out.data_ptr(), b, oh, f, wf, ow, stream)
    check_launch("upsample_argmax", rc)
    LAUNCHES.add()
    return out
