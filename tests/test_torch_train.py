"""PyTorch port: the training path (train/, cli/train.py) against the JAX
package.

- One ``step_on_batch`` of the tiny model with dropout 0 against the JAX
  model applied with ``train=True`` (batch statistics mutated), its Lovász
  loss and ``jax.grad``, from the same carried weights: loss within 1e-5,
  running means within 1e-6, the head's gradients within rtol 1e-4 /
  atol 1e-6. Every gradient is also held, within rtol 1e-4 / atol 1e-6,
  to the float64 gradient of the port's own forward. The backbone's are
  held to JAX's by direction and norm (cosine >= 0.999, relative L2 <=
  0.05; measured >= 0.99983 and <= 0.0185): at this input they move by
  ~8 % of their largest entry when the input moves by 1e-6 (ReLU masks
  flip where the forwards straddle 0), so no elementwise bound between
  two frameworks holds there.
  Running variances differ by design: torch's BatchNorm2d (the original
  reference's) updates them with the unbiased batch variance, flax's
  nn.BatchNorm with the biased one, so the port's update term is JAX's
  times n/(n-1) (n = the pixels per channel the BN saw); the test applies
  that factor and then holds them within rtol 1e-5.
- Adam from identical gradients against the JAX package's optax chain,
  within 1e-7, as tests/test_train.py holds torch.optim.Adam.
- The eval step's metrics against ``make_eval_step``'s on a padded batch.
- One CPU epoch through the CLI (``--device cpu``) on a synthetic 64x64
  dataset: checkpoints, best_model.pt and the report CSV.
"""
import csv
import os

import numpy as np
import pytest
import torch

from torch_port_common import (jax_train_loss_and_grads, tiny_jax_model,
                               tiny_variables, torch_train_model_with,
                               write_train_root)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(rng, n=2, size=64):
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    labels = np.kron(rng.integers(0, 3, (n, size // 8, size // 8)),
                     np.ones((1, 8, 8), np.int64)).astype(np.int32)
    return x, labels


def _float64_grads(variables, x, labels) -> dict:
    """The port's loss gradients with the model in float64 (the logits
    are cast to float32 before the upsample, as in float32 training)."""
    from neuralbarkcalculator_tpu_torch.ops.losses import lovasz_softmax_loss

    model = torch_train_model_with(variables).double()
    lovasz_softmax_loss(model(torch.from_numpy(x).double()),
                        torch.from_numpy(labels).long()).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_train_step_matches_jax():
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    variables = tiny_variables(seed=0)
    x, labels = _batch(np.random.default_rng(0))
    want_loss, want_stats, want_grads = jax_train_loss_and_grads(
        variables, x, labels)

    model = torch_train_model_with(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}  # pixels per channel each BatchNorm normalized over
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, inp, out, name=name: seen.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    metrics = step_on_batch(model, adam(model.parameters(), 5e-4, 2e-3),
                            torch.from_numpy(x),
                            torch.from_numpy(labels).long(), seed=0)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5

    grads = variables_to_state_dict({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    exact = _float64_grads(variables, x, labels)
    for name, g in grads.items():
        got = params[name].grad
        # every gradient is the exact gradient of the port's forward (whose
        # logits equal JAX's, tests/test_torch_model.py): float64 of it
        np.testing.assert_allclose(got.double().numpy(), exact[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        if name.startswith("classifier."):
            np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        else:
            # the backbone's gradient is ill-conditioned at this input: a
            # ReLU mask flips wherever the two frameworks' forwards (1e-5
            # apart) straddle 0, and train-mode BN over 128 pixels per
            # channel spreads each flip. Perturbing the input by 1e-6 moves
            # the port's own layer4 gradients by ~8 % of their largest
            # entry, so JAX's are held by direction and norm, as
            # tests/test_grad_parity.py holds its deep layers.
            a, b = got.double().flatten(), g.double().flatten()
            assert float(a @ b / (a.norm() * b.norm())) >= 0.999, name
            assert float((a - b).norm() / b.norm()) <= 0.05, name

    stats = variables_to_state_dict({"batch_stats": want_stats})
    state = model.state_dict()
    assert len(seen) == len(stats) // 2
    for name, want in stats.items():
        if name.endswith("running_mean"):
            np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
            continue
        n = seen[name[:-len(".running_var")]]
        old = 0.9 * before[name]
        unbiased = old + (want - old) * (n / (n - 1))
        np.testing.assert_allclose(state[name].numpy(), unbiased.numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)


def test_adam_update_matches_jax_adam():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.train.optim import adam as jax_adam
    from neuralbarkcalculator_tpu_torch.train.optim import (
        adam, get_learning_rate, set_learning_rate)

    w0 = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    grads = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = adam([p], 5e-4, 2e-3)
    tx = jax_adam(5e-4, 2e-3)
    params = jnp.asarray(w0)
    state = tx.init(params)
    for g in grads:
        opt.zero_grad()
        p.grad = torch.tensor(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = params + updates
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-7)
    set_learning_rate(opt, 1e-4)
    assert get_learning_rate(opt) == 1e-4


def test_plateau_early_stop_and_seeding_equal_jax():
    """The host-side controllers and the seeding helper are copies of the
    JAX package's: the same metric stream gives the same lrs and stops."""
    from neuralbarkcalculator_tpu.train import optim as jo
    from neuralbarkcalculator_tpu_torch.train import optim as to

    metrics = [10.0, 10.05, 10.3, 10.31, 10.2, 10.35, 10.32, 10.1, 10.0,
               10.36, 10.2, 10.2, 10.2, 10.2, 10.2, 10.2, 10.2, 10.2]
    for mode in ("max", "min"):
        jp, tp = jo.ReduceLROnPlateau(mode=mode), to.ReduceLROnPlateau(
            mode=mode)
        je = jo.EarlyStopping(mode=mode, verbose=False)
        te = to.EarlyStopping(mode=mode, verbose=False)
        jlr = tlr = 1e-3
        for epoch, m in enumerate(metrics, 1):
            jlr, tlr = jp.step(m, jlr), tp.step(m, tlr)
            assert jlr == tlr
            assert je.step(m, epoch) == te.step(m, epoch)
        assert te.stopped_epoch == je.stopped_epoch > 0
    state = to.make_training_deterministic(7)
    assert np.array_equal(state.rand(4), np.random.RandomState(7).rand(4))
    assert torch.initial_seed() == 7


def test_eval_step_matches_jax_on_a_padded_batch():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.parallel.mesh import (ShardingRules,
                                                        make_mesh)
    from neuralbarkcalculator_tpu.train.step import make_eval_step
    from neuralbarkcalculator_tpu_torch.train.step import eval_step

    from torch_port_common import torch_model_with

    variables = tiny_variables(seed=1)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    labels = np.kron(rng.integers(0, 3, (3, 8, 8)),
                     np.ones((1, 8, 8), np.int64)).astype(np.uint8)
    idx = np.array([0, 1, 2, 2])
    valid = np.array([1, 1, 1, 0], np.float32)
    mean, std = [0.5, 0.45, 0.4], [0.25, 0.2, 0.3]
    step = make_eval_step(tiny_jax_model(), ShardingRules(make_mesh(
        n_data=2)), mean=mean, std=std)
    want = step(variables, jnp.asarray(images), jnp.asarray(labels),
                jnp.asarray(idx, jnp.int32), jnp.asarray(valid))
    got = eval_step(torch_model_with(variables), torch.from_numpy(images),
                    torch.from_numpy(labels), torch.from_numpy(idx),
                    torch.from_numpy(valid), torch.tensor(mean),
                    torch.tensor(std))
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
    for key in ("iou_per_class", "f1_per_class", "miou", "f1"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


def test_dropout_step_runs_the_op_with_the_step_seed(monkeypatch):
    from neuralbarkcalculator_tpu_torch.models import heads
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    seeds = []
    real = heads.fused_dropout_matmul
    monkeypatch.setattr(heads, "fused_dropout_matmul",
                        lambda h, w, b, seed, rate: (seeds.append(seed),
                                                     real(h, w, b, seed,
                                                          rate))[1])
    variables = tiny_variables(seed=0)
    x, labels = _batch(np.random.default_rng(3))
    losses = []
    for seed in (11, 11, 12):
        model = torch_train_model_with(variables, dropout=0.8)
        m = step_on_batch(model, adam(model.parameters(), 5e-4),
                          torch.from_numpy(x),
                          torch.from_numpy(labels).long(), seed)
        losses.append(float(m["loss"]))
    assert seeds == [11, 11, 12]
    assert losses[0] == losses[1] != losses[2]
    assert all(np.isfinite(losses))


def test_build_model_is_deterministic():
    from neuralbarkcalculator_tpu_torch.train.loop import build_model

    state = torch.random.get_rng_state()
    a, b = build_model("fcn_resnet50", 0.8, 3), build_model("fcn_resnet50",
                                                            0.8, 3)
    assert torch.equal(torch.random.get_rng_state(), state)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.classifier.dropout == 0.8


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_train_root(tmp_path_factory.mktemp("trainroot"))


def test_cli_trains_one_epoch_on_cpu(data_root, tmp_path):
    from neuralbarkcalculator_tpu.data.dataset import BarkDataset
    from neuralbarkcalculator_tpu.data.sampling import get_splits
    from neuralbarkcalculator_tpu_torch.cli.train import build_parser, main
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_torch_checkpoint)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    exp = main(build_parser().parse_args(
        [str(tmp_path), "--device", "cpu", "--data_dir", data_root,
         "--epochs", "1", "--batch_size", "4", "--crop_size", "32",
         "--pad_size", "64", "--samples_factor", "1", "--report_dpi", "40"]))
    assert exp.device == torch.device("cpu")
    assert exp.step_count == 24 // 4 and len(exp.step_losses) == 6
    assert all(np.isfinite(exp.step_losses))
    assert len(exp.step_seconds) == 6

    # splits: the JAX package's for the same seed
    ds = BarkDataset(data_root)
    nonzero = [np.count_nonzero(ds[i][1]) for i in range(len(ds))]
    want = get_splits(nonzero, [r.wood_type for r in ds.records],
                      np.random.RandomState(42))
    for got, w in zip((exp.train_split, exp.valid_split, exp.test_split,
                       exp.train_weights), want):
        np.testing.assert_array_equal(got, w)

    moar = tmp_path / "moar"
    assert (moar / "checkpoint_epoch_1.pt").is_file()
    assert (moar / "experiment_log.json").is_file()
    best = str(moar / "best_model.pt")
    state = load_torch_checkpoint(best)
    ckpt = torch.load(moar / "checkpoint_epoch_1.pt", weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "step"}
    for k, v in state.items():
        assert torch.equal(v, ckpt["model"][k]), k
    NeuralBarkCalculator(best, device="cpu")  # the predict engine loads it

    csv_path = tmp_path / "Images" / "results" / "moar" / "final_stats.csv"
    with open(csv_path) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert len(rows) == 31 and {len(r) for r in rows} == {15}
    for row in rows[1:]:
        split = row[2]
        for kind in ("combined_images", "outputs"):
            assert os.path.isfile(tmp_path / "Images" / "results" / "moar" /
                                  kind / row[1] / split / row[0])


def test_unported_options_raise(data_root, tmp_path):
    """What the training CLI and Experiment still refuse: --mpl (the
    matplotlib renderer is not ported), --device tpu, an unknown loss, and
    the default device without a card. Every other option of the JAX
    package's CLI parses (tests/test_torch_train_zoo.py runs them)."""
    from neuralbarkcalculator_tpu_torch.cli.train import build_parser
    from neuralbarkcalculator_tpu_torch.config import TrainConfig
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment
    from neuralbarkcalculator_tpu_torch.train.step import make_loss_fn

    parser = build_parser()
    assert parser.parse_args(["root"]).device == "cuda"
    for flag in (["--mpl"], ["--device", "tpu"], ["--loss", "dice"]):
        with pytest.raises(SystemExit):
            parser.parse_args(["root", *flag])
    args = parser.parse_args(["root", "--bf16", "--backbone_ckpt", "x.pt",
                              "--tpu-native-recipe", "--resume", "--loss",
                              "cwe"])
    assert (args.bf16, args.backbone_ckpt, args.tpu_native_recipe,
            args.resume, args.loss) == (True, "x.pt", True, True, "cwe")
    with pytest.raises(ValueError, match="unknown loss"):
        make_loss_fn("nope")
    with pytest.raises(ValueError, match="unknown loss"):
        Experiment(data_root, str(tmp_path / "c"), loss_name="dice",
                   device="cpu")
    config = TrainConfig(pad_resize_size=64, crop_size=32, batch_size=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Experiment(data_root, str(tmp_path / "a"), config=config)
