"""The training cells: the port's ``train/step.train_step`` on a
device-resident dataset, driven as ``Experiment.train`` drives it (one
augmentation generator on the device, a 64-bit dropout seed a step), for
the window.

Set-up: the traffic's training set (lib/inputs.make_train_set) on the
device; the zoo model with the run's weights (lib/weights.py) and
``torch.optim.Adam``, in the precision the configuration states (float32
with TF32 off: the program's ``set_float32_exact``); then the first
``checked_steps`` steps through the same call, on rows that all differ,
which warm every shape and which the reference follows.

Window: steps until the window's seconds have passed, then one device
synchronise: ``train_step_ms`` is the window's wall time over its steps,
``train_peak_gib`` the allocator's peak over the window.

Data-parallel traffic (``global_batch`` in the traffic file; harness.py
runs the cell as ``chips`` ranks) is driven as ``train/loop.py`` drives it
under a world: the model's BatchNorms converted to the cross-rank
BatchNorm (``convert_batchnorm``), each rank's rows of every global batch
(``World.rank_slice``), ``train_step(..., world=world)``. Rank 0's clock
ends the window for every rank (lib/common.Steps); the memory peaks are
the largest over the ranks and a traced run's busy seconds their mean;
then every rank leaves the group and rank 0 checks alone. Without
``global_batch`` the batch is the configuration's.

Correctness, after the window and with the program's state freed: the
reference (reference/train.run_steps, on the whole global batch, its
backbone blocks recomputed in backward where the traffic sets
``recompute``) takes the same initial weights, rows, augmentation seed and
dropout seeds through the checked steps.
Compared: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the worst leaf's gap between the norms of the first gradient
as Adam holds it (its first moment over 1 - beta1); ``change_gap``, the
worst leaf's gap between the norms of its change over the checked steps.
A leaf's gap is measured against the larger of the reference's norm of
that leaf and the median leaf's; leaves whose reference gradient is under
a thousandth of the median leaf's are left out of both.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from portbench import reference
from portbench.lib import common, flops, inputs, weights
from portbench.lib.harness import Outcome, Run
from portbench.lib.spans import Spans
from portbench.lib.trace import Trace
from portbench.reference import train as ref

ZERO_GRAD_SHARE = 1e-3


def plan(seed: int, n_rows: int, batch: int):
    """Batches of rows: permutations of the dataset, one after another, so
    that the first n_rows // batch batches hold every row at most once;
    and a 64-bit dropout seed a step."""
    rng = np.random.default_rng([seed, 6])
    seeds = np.random.default_rng([seed, 7])
    order: list[int] = []
    while True:
        while len(order) < batch:
            order += rng.permutation(n_rows).tolist()
        rows, order = order[:batch], order[batch:]
        yield np.asarray(rows), int(seeds.integers(0, 2 ** 63))


def leaf_gap(got: dict, want: dict, keep: list[str]) -> tuple[float, str]:
    """The worst leaf's |got - want| / max(want, median want) over keep."""
    med = float(np.median([want[k] for k in keep]))
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(got[k] - want[k]) / max(want[k], med)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def compare(got: dict, want: dict, limits: dict) -> tuple[list, dict,
                                                          dict]:
    """Every number read (the module docstring's, and ``loss1_gap``, the
    first step's alone, and ``change_median_gap``, the median leaf's
    change gap); those the cell's limits name are the checks."""
    med = float(np.median(list(want["grad"].values())))
    keep = [k for k, v in want["grad"].items() if v >= ZERO_GRAD_SHARE * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                  want["loss"])]
    grad_gap, grad_at = leaf_gap(got["grad"], want["grad"], keep)
    change_gap, change_at = leaf_gap(got["change"], want["change"], keep)
    cmed = float(np.median([want["change"][k] for k in keep]))
    reads = {"loss_gap": max(losses), "loss1_gap": losses[0],
             "grad_gap": grad_gap, "change_gap": change_gap,
             "change_median_gap": float(np.median([
                 abs(got["change"][k] - want["change"][k])
                 / max(want["change"][k], cmed) for k in keep]))}
    checks = [(k, v, limits[k]) for k, v in reads.items() if k in limits]
    return checks, {"grad_at": grad_at, "change_at": change_at,
                    "left_out": sorted(set(want["grad"]) - set(keep)),
                    "loss_gaps": losses}, reads


def global_batch(r: Run) -> int:
    return r.cell.traffic.get("global_batch",
                              r.cell.config["train"]["batch_size"])


def run(r: Run) -> Outcome:
    from neuralbarkcalculator_tpu_torch.models.convert import \
        load_state_dict_into
    from neuralbarkcalculator_tpu_torch.models.segmentation import \
        MODEL_FACTORIES
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import \
        convert_batchnorm
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import (make_loss_fn,
                                                           train_step)
    from neuralbarkcalculator_tpu_torch.utils.device import \
        set_float32_exact

    cfg, tr = r.cell.config, r.cell.traffic
    t = cfg["train"]
    name, dev, world = cfg["model"], r.device, r.world
    if t["dtype"] != "float32" or t["tf32"]:
        raise ValueError("the train driver runs float32 with TF32 off")
    set_float32_exact(dev)
    images, labels = inputs.make_train_set(r.seed, tr)
    images_d = torch.from_numpy(images).to(dev)
    labels_d = torch.from_numpy(labels).to(dev)
    state0 = weights.random_state_dict(cfg, r.seed, dev)
    model = MODEL_FACTORIES[name]()
    load_state_dict_into(model, state0)
    model = model.to(dev)
    if world is not None and world.group is not None:
        convert_batchnorm(model, world)
    state0 = {k: v.cpu() for k, v in state0.items()}
    opt = adam(model.parameters(), t["lr"], t["weight_decay"])
    beta1 = opt.param_groups[0]["betas"][0]
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    loss_fn = make_loss_fn(t["loss"])
    batch = global_batch(r)
    batches = plan(r.seed, len(images), batch)
    spans = Spans()

    def step(rows: np.ndarray, seed: int):
        if world is not None:
            rows = rows[world.rank_slice(len(rows))]
        with spans.span("harness/train_step"):
            return train_step(
                model, opt, images_d, labels_d,
                torch.as_tensor(rows, device=dev), gen, seed, t["crop"],
                mean, std, t["brightness"], t["saturation"], loss_fn,
                bf16=False, f1_postprocess=False, world=world)

    checked = []
    got = {"loss": [], "grad": {}, "change": {}}
    names = dict((id(p), k) for k, p in model.named_parameters())
    for k in range(tr["checked_steps"]):
        rows, seed = next(batches)
        checked.append((rows, seed))
        got["loss"].append(float(step(rows, seed)["loss"]))
        if k == 0:
            # a step that left the optimizer without moments reads 0
            got["grad"] = {names[id(p)]: float(
                opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                if "exp_avg" in opt.state[p] else 0.0
                for p in model.parameters()}
    got["change"] = {k: float((p.detach().cpu() - state0[k]).norm())
                     for k, p in model.named_parameters()}
    spans.clear()
    steps_go = common.Steps(world)
    if world is not None:
        world.barrier()
    setup_peak = common.reset_peak(dev)
    steps = 0
    with Trace(r.trace) as trace:
        t_start = time.perf_counter()
        setup_s = t_start - r.t0
        with trace.window():
            while steps_go.go(time.perf_counter() - t_start < r.seconds):
                step(*next(batches))
                steps += 1
            common.sync(dev)
            seconds = time.perf_counter() - t_start
    window_peak = common.peak(dev)
    window_peak, memory_peak = common.max_over(
        world, window_peak, max(setup_peak, window_peak))
    busy = (common.mean_over(world, trace.busy_s())
            if r.trace and world is not None else None)
    del model, opt, gen
    common.free(dev)
    common.leave(world)
    if world is not None and world.rank != 0:
        return Outcome(e2e={}, attempted=steps, failed=0, checks=[],
                       memory_peak_bytes=memory_peak)

    r.log(f"train: {steps} steps in {seconds:.3f} s "
          f"({seconds / steps * 1e3:.3f} ms a step); window peak "
          f"{window_peak / 2 ** 30:.3f} GiB, set-up peak "
          f"{setup_peak / 2 ** 30:.3f} GiB; set-up {setup_s:.3f} s")
    reference.exact_float32()
    common.reset_peak(dev)
    t_ref = time.perf_counter()
    want = ref.run_steps(cfg, state0, images_d, labels_d,
                         [c[0] for c in checked], [c[1] for c in checked],
                         r.seed, dev, recompute=tr.get("recompute", False))
    r.log(f"train: reference {len(checked)} steps of {batch} rows in "
          f"{time.perf_counter() - t_ref:.3f} s, peak "
          f"{common.peak(dev) / 2 ** 30:.3f} GiB")
    checks, info, reads = compare(got, want, r.cell.limits)
    for i, (a, b) in enumerate(zip(got["loss"], want["loss"])):
        r.log(f"check step {i + 1}: loss {a!r} reference {b!r}")
    r.log(f"check: worst grad leaf {info['grad_at']}, worst change leaf "
          f"{info['change_at']}, left out {info['left_out']}")
    r.log("check readings: " + json.dumps(reads))
    readings = {"kind": "train", "steps": steps, "seconds": seconds,
                "step_flops": flops.train_step_flops(cfg, batch, t["crop"]),
                "chips": r.cell.chips,
                "spans": spans, "trace": trace if r.trace else None,
                "peaks": flops.PEAKS, "check_readings": reads}
    return Outcome(
        e2e={"train_step_ms": seconds / steps * 1e3,
             "train_peak_gib": window_peak / 2 ** 30, "setup_s": setup_s},
        attempted=steps, failed=0, checks=checks,
        memory_peak_bytes=memory_peak, readings=readings,
        trace=trace if r.trace else None, busy_s=busy)


def control(r: Run, hooks: dict) -> tuple[list, dict, dict]:
    """The reference with ``hooks`` (``Ops``' conv and matmul,
    reference/control.py) in the program's place, on the run's inputs,
    weights and seeds, through the same comparison."""
    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    images, labels = inputs.make_train_set(r.seed, tr)
    images_d = torch.from_numpy(images).to(dev)
    labels_d = torch.from_numpy(labels).to(dev)
    state0 = weights.random_state_dict(cfg, r.seed, dev)
    batches = plan(r.seed, len(images), global_batch(r))
    checked = [next(batches) for _ in range(tr["checked_steps"])]
    reference.exact_float32()
    args = (cfg, state0, images_d, labels_d, [c[0] for c in checked],
            [c[1] for c in checked], r.seed, dev)
    recompute = tr.get("recompute", False)
    want = ref.run_steps(*args, recompute=recompute)
    got = ref.run_steps(*args, hooks=hooks, recompute=recompute)
    return compare(got, want, r.cell.limits)
