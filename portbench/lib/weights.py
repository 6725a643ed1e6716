"""Random weights of a model, drawn on the device from the run's seed.

Each entry is drawn by its reference module's ``init_rule``
(reference/__init__.py): normal with a given std, uniform within given
bounds, or zeros. The values come from one ``torch.Generator`` on the
device in two large calls, one normal and one uniform draw, split over the
normal and the uniform entries in the order of ``param_shapes``. The dilated
ResNets' rule (reference/model.py) is a frozen copy of ``random_state_dict``
in the repository's ``chip_smoke.py``.

``calibrate_bn`` then sets the running statistics of the BatchNorms the
module names (``CALIBRATE_PREFIX``, less ``CALIBRATE_EXCLUDE``) to the
batch statistics of a few of the run's own images (the reference forward
with those BatchNorms on batch statistics, float32, on the device): with
the drawn statistics a random network's logits hardly depend on the image
and its class map is nearly one class; calibrated, each layer stays
normalized and the map follows the image, so that the comparison with the
reference has class boundaries to judge.
"""
from __future__ import annotations

import torch

from portbench import reference
from portbench.reference import Normal, Uniform, Zeros


def random_state_dict(config: dict, seed: int, device: torch.device
                      ) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` for every entry of the configuration's model,
    float32 but for a rule's other dtype, in ``param_shapes``' order."""
    ref = reference.module_for(config)
    shapes = ref.param_shapes(config["model"])
    rules = {k: ref.init_rule(k, s) for k, s in shapes.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    numel = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    normal_keys = [k for k in shapes if isinstance(rules[k], Normal)]
    uniform_keys = [k for k in shapes if isinstance(rules[k], Uniform)]
    normal = torch.randn(sum(numel[k] for k in normal_keys), generator=gen,
                         device=device)
    uniform = torch.rand(sum(numel[k] for k in uniform_keys), generator=gen,
                         device=device)
    state: dict[str, torch.Tensor] = {}
    at = 0
    for k in normal_keys:
        v = normal[at:at + numel[k]].view(shapes[k])
        at += numel[k]
        state[k] = v * rules[k].std
    at = 0
    for k in uniform_keys:
        v = uniform[at:at + numel[k]].view(shapes[k])
        at += numel[k]
        lo, hi = rules[k].lo, rules[k].hi
        state[k] = lo + (hi - lo) * v
    for k, s in shapes.items():
        if isinstance(rules[k], Zeros):
            state[k] = torch.zeros(s, dtype=rules[k].dtype, device=device)
    return {k: state[k] for k in shapes}


def calibrate_bn(config: dict, state: dict[str, torch.Tensor],
                 images_u8: torch.Tensor) -> None:
    """Running mean and variance of the BatchNorms of ``state`` that the
    reference module names (in place), from uint8 NHWC ``images_u8`` on
    the state's device: the forward runs with the drawn statistics up to
    each of them."""
    ref = reference.module_for(config)
    prefix = ref.CALIBRATE_PREFIX
    stats: dict[str, tuple] = {}

    def record(p, m, v):
        if p.startswith(prefix) and p not in ref.CALIBRATE_EXCLUDE:
            stats[p] = (m, v)

    ops = reference.Ops(batch_stats=True, batch_stats_prefix=prefix,
                        on_bn=record)
    with torch.no_grad():
        ref.logits(state, reference.normalize(images_u8, config["mean"],
                                              config["std"]),
                   config["model"], ops)
    for p, (m, v) in stats.items():
        state[f"{p}.running_mean"] = m.float()
        state[f"{p}.running_var"] = v.float()
