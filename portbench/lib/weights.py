"""Random weights of a model, drawn on the device from the run's seed.

The recipe is a frozen copy of ``random_state_dict`` in the repository's
``chip_smoke.py``: He-normal convolutions (std sqrt(2 / fan_in)), a
nonzero BatchNorm state (running mean N(0, 0.1), running variance U(0.5,
2), scale U(0.5, 1.5), the scale of a BN that ends a residual branch
U(0.1, 0.3) so that the random network stays in range), biases N(0, 0.1).
Here the values come from one ``torch.Generator`` on the device in two
large calls (one normal, one uniform draw), split over the entries.

``calibrate_bn`` then sets every BatchNorm's running statistics to the
batch statistics of a few of the run's own images (the reference forward
with BatchNorm on batch statistics, float32, on the device): with the
drawn statistics a random network's logits hardly depend on the image and
its class map is nearly one class; calibrated, each layer stays
normalized and the map follows the image, so that the comparison with the
reference has class boundaries to judge.
"""
from __future__ import annotations

import torch

from portbench.reference import model as M

RESIDUAL_END_BN = (".bn3.weight", "downsample.1.weight")
HEAD = "classifier."
# DeepLab's pooled branch: its batch statistics are over one value an
# image, a variance of a few samples; it keeps its drawn statistics
POOLED_BN = ("classifier.0.convs.4.2",)


def random_state_dict(shapes: dict[str, tuple], seed: int,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for every entry of ``shapes``
    (reference/model.param_shapes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    numel = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    normal_keys = [k for k, s in shapes.items()
                   if len(s) == 4 or k.endswith(("running_mean", "bias"))]
    uniform_keys = [k for k, s in shapes.items()
                    if k not in normal_keys
                    and not k.endswith("num_batches_tracked")]
    normal = torch.randn(sum(numel[k] for k in normal_keys), generator=gen,
                         device=device)
    uniform = torch.rand(sum(numel[k] for k in uniform_keys), generator=gen,
                         device=device)
    state: dict[str, torch.Tensor] = {}
    at = 0
    for k in normal_keys:
        s = shapes[k]
        v = normal[at:at + numel[k]].view(s)
        at += numel[k]
        std = (2.0 / (s[1] * s[2] * s[3])) ** 0.5 if len(s) == 4 else 0.1
        state[k] = v * std
    at = 0
    for k in uniform_keys:
        v = uniform[at:at + numel[k]].view(shapes[k])
        at += numel[k]
        if k.endswith("running_var"):
            lo, hi = 0.5, 2.0
        elif k.endswith(RESIDUAL_END_BN):
            lo, hi = 0.1, 0.3
        else:
            lo, hi = 0.5, 1.5
        state[k] = lo + (hi - lo) * v
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return {k: state[k] for k in shapes}


def calibrate_bn(state: dict[str, torch.Tensor], model: str,
                 images_u8: torch.Tensor, mean, std,
                 prefix: str = HEAD) -> None:
    """Running mean and variance of the BatchNorms of ``state`` whose name
    starts with ``prefix`` (in place), from uint8 NHWC ``images_u8`` on the
    state's device: the forward runs with the drawn statistics up to each
    of them."""
    stats: dict[str, tuple] = {}

    def record(p, m, v):
        if p.startswith(prefix) and p not in POOLED_BN:
            stats[p] = (m, v)

    ops = M.Ops(batch_stats=True, batch_stats_prefix=prefix, on_bn=record)
    with torch.no_grad():
        M.logits(state, M.normalize(images_u8, mean, std), model, ops)
    for p, (m, v) in stats.items():
        state[f"{p}.running_mean"] = m.float()
        state[f"{p}.running_var"] = v.float()
