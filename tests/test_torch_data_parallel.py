"""PyTorch port: data-parallel training (parallel/, train/step.py,
train/loop.py) on the CPU over gloo.

Each test that needs two ranks starts two processes of this module's
``_run_rank`` (a ``file://`` rendezvous under the test's tmp_path, no TCP
port, a timeout of its own); each rank saves what it computed and the
test compares in this process. The tiny model of tests/torch_port_common:

- with dropout 0 the 2-rank step (global batch 4) equals the JAX
  package's train step on the same carried weights: the loss within 1e-5,
  the summed gradients as tests/test_torch_train_zoo.py holds the port's
  single-process ones (the last conv's elementwise, rtol 1e-4 / atol 1e-4
  of the largest entry; every other by cosine >= 0.999 and relative L2 <=
  0.05: at this batch a ReLU mask flip moves one of the head BN's 512
  shift gradients by 3 %), the running means within 1e-6, and the parameters after one Adam step (the JAX package's adam on
  its own gradients): the last conv's within 1e-6, every other tensor's
  update by direction and norm (cosine >= 0.99, relative L2 <= 0.15;
  measured >= 0.9934 and <= 0.115). Adam's first step moves each weight
  by about lr * sign(g + wd * w), so an element whose small gradient the
  two frameworks round to opposite signs moves 2 lr apart;
- with the FCN head's dropout at 0.5, and with the DeepLab head in train
  mode (its ASPP dropout), the 2-rank step equals the port's
  single-process step: the masks bit for bit (each rank's rows of the
  global mask), the loss and metrics within 1e-6 relative, the BN running
  statistics within rtol 1e-4 / atol 1e-6, the last conv's gradients
  elementwise (rtol 1e-4 / atol 1e-4 of the largest entry), every other
  gradient by cosine >= 0.9999 and relative L2 <= 0.01 (measured >=
  0.9999981 and <= 0.002), every tensor's Adam update by cosine >= 0.998
  and relative L2 <= 0.1 (measured >= 0.99915 and <= 0.042). The global
  BN sums and the gradient sum run in another order than on one process,
  a ReLU mask flips where the two forwards straddle 0, and Adam's first
  step turns a small gradient's sign into a whole step; the two ranks'
  steps are equal bit for bit; the DeepLab case again at 104 x 320,
  where the ASPP's convs run as their taps;
- the random layers alone: a rank's ASPP dropout and stochastic depth
  are the rows of the global batch's, bit for bit; a world without a
  process group issues no collective, and a batch that does not divide
  raises;
- cross-rank BN: at world size 1 it is nn.BatchNorm2d bit for bit; at
  world size 2 its forward, input and parameter gradients and running
  statistics equal nn.BatchNorm2d's on the concatenated batch, within
  float32 rounding (rtol 1e-5 / atol 1e-6); under bf16 autocast (a bf16
  input) they equal nn.BatchNorm2d's under autocast there, its bf16
  output and input gradient within one bf16 ulp (rtol 2^-7);
- ``Experiment.evaluate`` over a split of 7 (batch 8 and 4: padded with
  repeats weighted 0) gives the 1-process numbers at world size 2, within
  1e-6 relative;
- the evaluation report at world size 2 writes, from rank 0 alone, the
  1-process report's CSV;
- one prioritized epoch: both ranks' sampler weights, RandomState and
  parameters equal after every step; only rank 0 writes checkpoints and
  best_model.pt; a global batch of 5 over 2 ranks raises ValueError;
- ``cli/train --distributed --device cpu`` (the torchrun path): at world
  size 1 bit for bit the run without a process group (losses and
  parameters after each step); at world size 2 the first step's loss
  within 1e-6 relative and the epoch's within 1e-3, rank 0 alone writing
  the checkpoints and the report.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (jax_train_loss_and_grads,
                               tiny_deeplab_torch_model, tiny_torch_model,
                               tiny_variables, write_train_root)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 4
SEED = 7
LR, WD = 5e-4, 2e-3

_RUN = r"""
import sys
import test_torch_data_parallel as t
t._run_rank(*sys.argv[1:])
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _spawn(case: str, tmp_path, size: int = 2, timeout: float = 120,
           **kwargs) -> list[dict]:
    """Run ``case`` on ``size`` ranks over gloo; each rank's result."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    init = f"file://{tmp_path / f'rendezvous-{case}'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RUN, case, str(rank), str(size), init,
         str(tmp_path), json.dumps(kwargs)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(tmp_path / f"{case}-{rank}.pt", weights_only=False)
            for rank in range(size)]


def _run_rank(case, rank, size, init, out_dir, kwargs) -> None:
    """A rank's body: join the group, run the case, save its result."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed)

    torch.set_num_threads(1)
    world = initialize_distributed(init_method=init, rank=int(rank),
                                   world_size=int(size), device="cpu")
    try:
        result = _CASES[case](world, out_dir, **json.loads(kwargs))
        torch.save(result, os.path.join(out_dir, f"{case}-{rank}.pt"))
    finally:
        shutdown_distributed()


# ------------------------------------------------------------------ steps

def _batch(seed: int = 0, hw: tuple = (64, 64)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(GLOBAL_BATCH, *hw, 3)).astype(np.float32)
    labels = np.kron(rng.integers(0, 3, (GLOBAL_BATCH, hw[0] // 8,
                                         hw[1] // 8)),
                     np.ones((1, 8, 8), np.int64)).astype(np.int32)
    return x, labels


def _model(kind: str, dropout: float, state: dict):
    model = (tiny_deeplab_torch_model() if kind == "deeplab"
             else tiny_torch_model(dropout))
    model.load_state_dict(state)
    return model.train()


def _recording_masks(masks: list):
    """Patch the random layers to record the values they draw: the FCN
    head's kernel mask (regenerated from its seed and offset) and every
    ``batch_rand`` draw (the ASPP dropout's uniforms); returns the undo."""
    from neuralbarkcalculator_tpu_torch.models import heads, seeding
    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        dropout_mask)

    real_fdm, real_rand = heads.fused_dropout_matmul, seeding.batch_rand

    def fdm(h, w, b, seed, rate, offset=0):
        masks.append(dropout_mask(h.shape, seed, rate, offset))
        return real_fdm(h, w, b, seed, rate, offset)

    def rand(*args, **kw):
        u = real_rand(*args, **kw)
        masks.append(u.clone())
        return u

    heads.fused_dropout_matmul, seeding.batch_rand = fdm, rand

    def undo():
        heads.fused_dropout_matmul, seeding.batch_rand = real_fdm, real_rand
    return undo


def _one_step(kind: str, dropout: float, state: dict, world=None,
              hw: tuple = (64, 64)) -> dict:
    """One port train step from ``state`` on an ``hw`` batch:
    single-process on the global batch, or the rank's rows under
    ``world``."""
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import (
        convert_batchnorm)
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    model = _model(kind, dropout, state)
    x, labels = _batch(hw=tuple(hw))
    rows = slice(None)
    if world is not None:
        convert_batchnorm(model, world)
        rows = world.rank_slice(GLOBAL_BATCH)
    masks: list = []
    undo = _recording_masks(masks)
    try:
        metrics = step_on_batch(model, adam(model.parameters(), LR, WD),
                                torch.from_numpy(x[rows]),
                                torch.from_numpy(labels[rows]).long(), SEED,
                                world=world)
    finally:
        undo()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "masks": masks}


def _case_step(world, out_dir, kind: str, dropout: float,
               hw: tuple = (64, 64)) -> dict:
    state = torch.load(os.path.join(out_dir, "weights.pt"))
    return _one_step(kind, dropout, state, world, hw)


def _weights(tmp_path, kind: str) -> dict:
    """The step's starting weights, saved for the ranks."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    if kind == "deeplab":
        torch.manual_seed(0)
        state = tiny_deeplab_torch_model().state_dict()
    else:
        state = tiny_torch_model().state_dict()
        state.update(variables_to_state_dict(tiny_variables(seed=0)))
    torch.save(state, tmp_path / "weights.pt")
    return state


def _rows_of(world_size: int, rank: int, t: torch.Tensor) -> torch.Tensor:
    b = t.shape[0] // world_size
    return t[rank * b:(rank + 1) * b]


def test_two_rank_step_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.train.optim import adam as jax_adam
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    variables = tiny_variables(seed=0)
    state = _weights(tmp_path, "fcn")
    ranks = _spawn("step", tmp_path, kind="fcn", dropout=0.0)
    x, labels = _batch()
    want_loss, want_stats, want_grads = jax_train_loss_and_grads(
        variables, x, labels)
    tx = jax_adam(LR, WD)
    params = jax.tree.map(jnp.asarray, variables["params"])
    updates, _ = tx.update(jax.tree.map(jnp.asarray, want_grads),
                           tx.init(params), params)
    want_params = variables_to_state_dict({"params": jax.tree.map(
        np.asarray, jax.tree.map(lambda p, u: p + u, params, updates))})
    want_grads = variables_to_state_dict({"params": want_grads})
    want_stats = variables_to_state_dict({"batch_stats": want_stats})

    for r in ranks:
        assert r["masks"] == []  # dropout 0: no random layer ran
        assert abs(r["metrics"]["loss"] - want_loss) <= 1e-5
        for name, g in want_grads.items():
            got = r["grads"][name]
            if name.startswith("classifier.4."):
                np.testing.assert_allclose(
                    got.numpy(), g.numpy(), rtol=1e-4,
                    atol=1e-4 * float(g.abs().max()), err_msg=name)
            else:  # ill-conditioned here: tests/test_torch_train_zoo.py
                a, b = got.double().flatten(), g.double().flatten()
                assert float(a @ b / (a.norm() * b.norm())) >= 0.999, name
                assert float((a - b).norm() / b.norm()) <= 0.05, name
            if name.startswith("classifier.4."):
                np.testing.assert_allclose(r["state"][name].numpy(),
                                           want_params[name].numpy(),
                                           rtol=0, atol=1e-6, err_msg=name)
                continue
            a = (r["state"][name] - state[name]).double().flatten()
            b = (want_params[name] - state[name]).double().flatten()
            assert float(a @ b / (a.norm() * b.norm())) >= 0.99, name
            assert float((a - b).norm() / b.norm()) <= 0.15, name
        for name, want in want_stats.items():
            if name.endswith("running_mean"):
                np.testing.assert_allclose(r["state"][name].numpy(),
                                           want.numpy(), rtol=0, atol=1e-6,
                                           err_msg=name)


def _same_direction(a, b, min_cos: float, max_rel: float, name: str):
    a, b = a.double().flatten(), b.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    assert cos >= min_cos and rel <= max_rel, (name, cos, rel)


@pytest.mark.parametrize("kind,dropout", [("fcn", 0.5), ("deeplab", 0.0)])
def test_two_rank_step_matches_one_rank(tmp_path, kind, dropout):
    _ranks_match_one_process(tmp_path, kind, dropout, (64, 64))


def test_two_rank_step_on_the_aspp_taps_matches_one_rank(tmp_path,
                                                         monkeypatch):
    """The DeepLab case on a 104 x 320 batch, whose 13 x 40 map puts every
    ASPP rate on the sum of its taps (at 64 x 64 each reads its centre
    tap alone). At this batch Adam's first update turns more near-zero
    gradients' sign flips into whole steps: 18 of 148 tensors read under
    cosine 0.998, the least 0.99256 and relative L2 0.122
    (layer1.0.bn3.bias), with the taps and with the phase form alike. So
    the update is held as the JAX comparison above holds it (cosine >=
    0.99, relative L2 <= 0.15); every other check as in the 64 x 64
    cases (the gradients read >= 0.999975 and <= 0.0071)."""
    from neuralbarkcalculator_tpu_torch.models.heads import AtrousConv2d

    taps = []
    tap_sum = AtrousConv2d._taps
    monkeypatch.setattr(AtrousConv2d, "_taps", lambda conv, x: (
        taps.append(conv.dilation[0]) or tap_sum(conv, x)))
    _ranks_match_one_process(tmp_path, "deeplab", 0.0, (104, 320),
                             update=(0.99, 0.15))
    assert taps == [12, 24, 36]


def _ranks_match_one_process(tmp_path, kind: str, dropout: float,
                             hw: tuple, update: tuple = (0.998, 0.1)
                             ) -> None:
    state = _weights(tmp_path, kind)
    ranks = _spawn("step", tmp_path, kind=kind, dropout=dropout, hw=hw)
    want = _one_step(kind, dropout, state, hw=hw)
    assert len(want["masks"]) == 1
    for rank, r in enumerate(ranks):
        assert len(r["masks"]) == len(want["masks"])
        for got, m in zip(r["masks"], want["masks"]):
            assert torch.equal(got, _rows_of(2, rank, m))
        for k in ("loss", "miou", "f1"):
            assert r["metrics"][k] == pytest.approx(want["metrics"][k],
                                                    rel=1e-6, abs=1e-6), k
        for name, g in want["grads"].items():
            got = r["grads"][name]
            if name.startswith("classifier.4."):
                torch.testing.assert_close(
                    got, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()),
                    msg=name)
            else:
                _same_direction(got, g, 0.9999, 0.01, name)
        for name, v in want["state"].items():
            got = r["state"][name]
            if name.endswith(("running_mean", "running_var",
                              "num_batches_tracked")):
                torch.testing.assert_close(got, v, rtol=1e-4, atol=1e-6,
                                           msg=name)
            else:
                _same_direction(got - state[name], v - state[name],
                                *update, name)
    # the ranks' steps are equal, bit for bit: the same global loss and
    # summed gradients go through the same Adam
    for name, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][name]), name


@pytest.mark.parametrize("layer", ["inverted_dropout", "drop_path"])
def test_random_layers_draw_the_global_batchs_rows(layer):
    from neuralbarkcalculator_tpu_torch.models import seeding

    fn = getattr(seeding, layer)
    x = torch.randn(6, 5, 4, 4) + 3.0
    want = fn(x, 0.5, seeding.layer_generator(SEED, seeding.HEAD_STREAM,
                                              x.device))
    for size in (2, 3):
        b = x.shape[0] // size
        for rank in range(size):
            rows = slice(rank * b, (rank + 1) * b)
            got = fn(x[rows], 0.5, seeding.layer_generator(
                SEED, seeding.HEAD_STREAM, x.device), (rank, size))
            assert torch.equal(got, want[rows]), (size, rank)


def test_a_world_without_a_group_issues_no_collective(monkeypatch):
    import torch.distributed as dist
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        World, pad_to_multiple, single_process)

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran")

    for name in ("all_reduce", "all_gather", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    world = single_process()
    x = torch.randn(4, 3, requires_grad=True)
    assert world.gather_rows(x) is x and world.all_reduce_sum(x) is x
    x.sum().backward()
    world.all_reduce_grads([x])
    world.barrier()
    assert world.is_main and world.rank_slice(5) == slice(0, 5)
    assert [pad_to_multiple(n, 2) for n in (1, 2, 7, 8)] == [2, 2, 8, 8]
    two = World(1, 2, torch.device("cpu"))
    assert not two.is_main and two.rank_slice(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not divide"):
        two.rank_slice(5)


# --------------------------------------------------------- cross-rank BN

def _bn_inputs():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(1.5, 2.0, (4, 6, 5, 5)).astype(
        np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(4, 6, 5, 5)).astype(np.float32))
    return x, weight, bias, gy


def _bn_run(bn, x, gy, world=None, bf16: bool = False) -> dict:
    """Two train-mode forwards (the running statistics move twice) and
    the backward of the second; under bf16 autocast with ``bf16``."""
    x = x.clone().requires_grad_(True)
    bn.train()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
        with torch.no_grad():
            bn(x)
        y = bn(x)
    (y * gy).sum().backward()
    if world is not None:
        world.all_reduce_grads(bn.parameters())
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(),
            "count": int(bn.num_batches_tracked)}


def _plain_bn(weight, bias):
    bn = torch.nn.BatchNorm2d(6, momentum=0.3)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    return bn


def _case_bn(world, out_dir, bf16: bool = False) -> dict:
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import (
        convert_batchnorm)

    x, weight, bias, gy = _bn_inputs()
    if bf16:
        x = x.bfloat16()  # a conv's output under autocast
    model = convert_batchnorm(torch.nn.Sequential(_plain_bn(weight, bias)),
                              world)
    rows = world.rank_slice(x.shape[0])
    return _bn_run(model[0], x[rows], gy[rows], world, bf16)


def test_cross_rank_bn_at_one_rank_is_batchnorm_bit_for_bit():
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        single_process)
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import (
        CrossRankBatchNorm2d, convert_batchnorm)

    x, weight, bias, gy = _bn_inputs()
    model = convert_batchnorm(torch.nn.Sequential(_plain_bn(weight, bias)),
                              single_process())
    assert type(model[0]) is CrossRankBatchNorm2d
    plain = _plain_bn(weight, bias)
    got = _bn_run(model[0], x, gy)
    want = _bn_run(plain, x, gy)
    for k, v in want.items():
        assert (v == got[k]) if k == "count" else torch.equal(v, got[k]), k
    with torch.no_grad():  # eval mode: the running statistics
        assert torch.equal(model.eval()(x), plain.eval()(x))


def test_cross_rank_bn_at_two_ranks_is_batchnorm_of_the_global_batch(
        tmp_path):
    x, weight, bias, gy = _bn_inputs()
    want = _bn_run(_plain_bn(weight, bias), x, gy)
    ranks = _spawn("bn", tmp_path)
    for rank, r in enumerate(ranks):
        for k in ("y", "dx"):
            torch.testing.assert_close(r[k], _rows_of(2, rank, want[k]),
                                       rtol=1e-5, atol=1e-6, msg=k)
        for k in ("dw", "db", "mean", "var"):
            torch.testing.assert_close(r[k], want[k], rtol=1e-5, atol=1e-6,
                                       msg=k)
        assert r["count"] == want["count"] == 2


def test_cross_rank_bn_under_bf16_autocast_is_batchnorm_of_the_global_batch(
        tmp_path):
    # a bf16 input: the statistics in float32 as nn.BatchNorm2d's; the bf16
    # output and input gradient within one bf16 ulp (2^-8 to 2^-7 of a
    # value), the float32 rest within float32 rounding
    x, weight, bias, gy = _bn_inputs()
    want = _bn_run(_plain_bn(weight, bias), x.bfloat16(), gy, bf16=True)
    ranks = _spawn("bn", tmp_path, bf16=True)
    for rank, r in enumerate(ranks):
        for k in ("y", "dx"):
            assert r[k].dtype == want[k].dtype == torch.bfloat16, k
            torch.testing.assert_close(
                r[k].float(), _rows_of(2, rank, want[k]).float(),
                rtol=2 ** -7, atol=1e-3, msg=k)
        for k in ("dw", "db", "mean", "var"):
            torch.testing.assert_close(r[k], want[k], rtol=1e-5, atol=1e-6,
                                       msg=k)
        assert r["count"] == want["count"] == 2


# -------------------------------------------------------------- experiment

def _config(batch_size: int = GLOBAL_BATCH):
    from neuralbarkcalculator_tpu_torch.config import TrainConfig

    return TrainConfig(pad_resize_size=64, crop_size=32,
                       batch_size=batch_size, samples_per_epoch_factor=1)


def _experiment(data_root: str, directory: str, world=None):
    from neuralbarkcalculator_tpu_torch.models import segmentation
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        return Experiment(data_root, directory, config=_config(),
                          model_name="_tiny_test", sampler="prioritized",
                          device="cpu", world=world)
    finally:
        segmentation.MODEL_FACTORIES.pop("_tiny_test")


def _evaluations(exp) -> dict:
    split = np.arange(7)
    return {bs: exp.evaluate(split, batch_size=bs) for bs in (8, 4)}


def _report(exp, root) -> list[list[str]] | None:
    """The evaluation report's CSV rows under ``root``, or None when this
    process wrote none."""
    import csv

    from neuralbarkcalculator_tpu_torch.train.evaluate import (
        evaluation_report)

    path = evaluation_report(exp, str(root), dpi=20)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


def _parameter_digest(model) -> str:
    """sha256 over the parameters' bytes in ``model.parameters()`` order:
    equal digests hold the parameters equal bit for bit."""
    return hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes() for p in model.parameters())
    ).hexdigest()


def _case_experiment(world, out_dir, data_root: str) -> dict:
    import neuralbarkcalculator_tpu_torch.train.loop as loop

    saved = []
    real_save = torch.save
    torch.save = lambda obj, f, *a, **kw: (saved.append(str(f)),
                                           real_save(obj, f, *a, **kw))[1]
    weights, rng_states, params = [], [], []

    class Recording(loop.PrioritizedSampler):
        def update(self, batch_idxs, metric_value):
            super().update(batch_idxs, metric_value)
            weights.append(self.weights.copy())
            rng_states.append(self._rng.get_state()[1].copy())
            params.append(_parameter_digest(exp.model))

    loop.PrioritizedSampler = Recording
    try:
        exp = _experiment(data_root, os.path.join(out_dir, "moar"), world)
        evaluations = _evaluations(exp)
        # each rank names its own root: only rank 0's may hold a report
        report = _report(exp, os.path.join(out_dir, f"report-{world.rank}"))
        exp.train(epochs=1)
        exp.config.batch_size = 5
        with pytest.raises(ValueError, match="does not divide"):
            exp.train(epochs=1)
    finally:
        torch.save = real_save
    return {"evaluations": evaluations, "report": report, "weights": weights,
            "rng_states": rng_states, "params": params, "saved": saved,
            "steps": exp.step_count}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train")
    yield write_train_root(root)
    shutil.rmtree(root, ignore_errors=True)


def test_two_rank_experiment(data_root, tmp_path):
    ranks = _spawn("experiment", tmp_path, timeout=180,
                   data_root=data_root)
    single = _experiment(data_root, str(tmp_path / "single"))
    want = _evaluations(single)
    want_report = _report(single, tmp_path / "single_report")
    assert len(want_report) == 31
    assert ranks[0]["report"] == want_report
    assert ranks[1]["report"] is None

    for r in ranks:
        assert r["evaluations"].keys() == want.keys()
        for bs, metrics in want.items():
            assert r["evaluations"][bs].keys() == metrics.keys()
            for k, v in metrics.items():
                assert r["evaluations"][bs][k] == pytest.approx(
                    v, rel=1e-6, abs=1e-6), (bs, k)
        assert r["steps"] == 24 // GLOBAL_BATCH
    a, b = ranks
    # lockstep: the same sampler weights, RandomState and parameters after
    # every step
    assert len(a["weights"]) == len(b["weights"]) == 24 // GLOBAL_BATCH
    for key in ("weights", "rng_states"):
        for wa, wb in zip(a[key], b[key]):
            np.testing.assert_array_equal(wa, wb)
    assert a["params"] == b["params"]
    assert not np.array_equal(a["weights"][0], a["weights"][-1])
    # rank 0 alone writes
    moar = tmp_path / "moar"
    assert b["saved"] == []
    assert sorted(os.path.basename(p) for p in a["saved"]) == [
        "best_model.pt", "checkpoint_epoch_1.pt"]
    assert (moar / "checkpoint_epoch_1.pt").is_file()
    assert (moar / "best_model.pt").is_file()
    assert (moar / "experiment_log.json").is_file()


# ---------------------------------------------------------------- the CLI

def _cli_run(root: str, data_root: str, distributed: bool) -> dict:
    """cli/train.main on the tiny model for one 6-step epoch and its
    report, on one thread (the CPU's sums depend on the thread count):
    each step's loss and a digest of the parameters after it, and the
    files this process saved with torch.save."""
    import neuralbarkcalculator_tpu_torch.train.loop as loop
    from neuralbarkcalculator_tpu_torch.cli import train as cli
    from neuralbarkcalculator_tpu_torch.models import segmentation

    digests, saved = [], []
    real_step, real_save = loop.train_step, torch.save

    def step(model, *args, **kwargs):
        metrics = real_step(model, *args, **kwargs)
        digests.append(_parameter_digest(model))
        return metrics

    loop.train_step = step
    torch.save = lambda obj, f, *a, **kw: (saved.append(str(f)),
                                           real_save(obj, f, *a, **kw))[1]
    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        exp = cli.main(cli.build_parser().parse_args(
            [root, "--device", "cpu", "--data_dir", data_root, "--model",
             "_tiny_test", "--epochs", "1", "--batch_size", "4",
             "--crop_size", "32", "--pad_size", "64", "--samples_factor", "1",
             "--report_dpi", "20", *(["--distributed"] if distributed
                                     else [])]))
    finally:
        torch.set_num_threads(threads)
        loop.train_step, torch.save = real_step, real_save
        segmentation.MODEL_FACTORIES.pop("_tiny_test")
    return {"losses": exp.step_losses, "digests": digests, "saved": saved}


def _case_cli(world, out_dir, data_root: str) -> dict:
    return _cli_run(os.path.join(out_dir, "cli"), data_root, True)


@pytest.mark.parametrize("size", [1, 2])
def test_cli_trains_distributed(data_root, tmp_path, size):
    ranks = _spawn("cli", tmp_path, size=size, timeout=180,
                   data_root=data_root)
    want = _cli_run(str(tmp_path / "plain"), data_root, False)
    assert len(want["losses"]) == 24 // GLOBAL_BATCH
    for r in ranks:
        if size == 1:  # one rank: the plain run, bit for bit
            assert r["losses"] == want["losses"]
            assert r["digests"] == want["digests"]
        else:  # the first step within float32 rounding; Adam's first
            # steps then turn rounding into whole steps where a gradient
            # is small (measured 1.2e-4 apart by step 6)
            assert r["losses"][0] == pytest.approx(want["losses"][0],
                                                   rel=1e-6)
            np.testing.assert_allclose(r["losses"], want["losses"],
                                       rtol=1e-3, atol=0)
    assert ranks[-1]["digests"] == ranks[0]["digests"]
    assert sorted(os.path.basename(p) for p in ranks[0]["saved"]) == \
        sorted(os.path.basename(p) for p in want["saved"])
    assert all(r["saved"] == [] for r in ranks[1:])
    report = tmp_path / "cli" / "Images" / "results" / "moar"
    assert (report / "final_stats.csv").is_file()


_CASES = {"step": _case_step, "bn": _case_bn, "experiment": _case_experiment,
          "cli": _case_cli}
