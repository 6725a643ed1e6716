"""PyTorch port: training the whole zoo, and the rest of the JAX training
recipe (train/loop.py, train/step.py, models/seeding.py,
models/convert.load_backbone_checkpoint / merge_backbone).

- Exact path: one train step of fcn_resnet101 (full depth), deeplabv3_
  resnet50 (full depth) and fcn_efficientnet_b0 (full width) with the
  random layers off on both sides (the port's dropout and stochastic
  depth at rate 0; JAX's EfficientNet built with drop_connect_rate 0 and
  flax's Dropout patched to the identity in this process), from the same
  weights (``zoo_model``'s, carried to JAX by its own converter) and
  batch, with flax's BatchNorm taking the exact batch variance in this
  process (``flax_exact_train_mode`` says why): logits within 1e-4 of the
  largest, the loss within 1e-5, the BN running statistics (the n/(n-1)
  term as in test_torch_train.py), the last conv's gradients elementwise
  (rtol 1e-4, atol 1e-4 of the largest entry), every other gradient by
  direction and norm (a ReLU mask that flips where the two forwards
  straddle 0 moves single elements; bounds and measurements in
  ``EXACT``). The weights damp the residual branches (the BN that ends
  each is drawn from [0.02, 0.06], near torchvision's
  zero_init_residual): at zoo_model's [0.1, 0.3] a train-mode ResNet-101
  moves by 3e-4 of its largest logit between float32 and float64, at this
  init by 7e-5.
- Random layers: the ASPP dropout and the stochastic depth against a
  materialised-mask oracle from the same seeded generator, their keep
  fraction and per-sample structure, the same seed giving the same step.
- The recipe: resume (weights, Adam moments, lr, step and generators
  restored; the replayed plateau / early-stop state equal to JAX's on the
  same epoch log), backbone_ckpt (.pt and .npz, JAX merge_backbone's
  logits; a ResNet-50 / -101 mix-up and a wrong shape raise),
  host-resident data equal to device-resident, the prioritized sampler,
  a bf16 step against float32, the CLI's recipe flags, and every
  MODEL_FACTORIES name trained for one tiny epoch through cli/train.main,
  its best_model.pt loaded and run by the predict engine.
"""
import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, normalized, tiny_jax_model,
                               tiny_torch_model, tiny_variables,
                               write_train_root, zoo_model)

# per model: the input size. Measured on these weights, as the largest
# logit difference over the largest |logit|, the least cosine and the
# largest relative L2 distance of a gradient held by direction and norm:
# ResNet-101 6.5e-5, 0.99969, 0.0248 (layer4.0.bn2.bias); DeepLab 5.6e-5,
# 0.99995, 0.0098; EfficientNet-B0 4.1e-5, 0.99999997, 2.4e-4.
EXACT = {"fcn_resnet101": 32, "deeplabv3_resnet50": 64,
         "fcn_efficientnet_b0": 64}
LOGIT_TOL = 1e-4
COS_MIN = 0.999
REL_MAX = 0.05
# BN running statistics: means within MEAN_ATOL, variances (with the n/(n-1)
# term) within VAR_RTOL; measured 4.1e-6 and 2.3e-5 (ResNet-101's layer4)
MEAN_ATOL = 1e-5
VAR_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """Checkpoints of full-width models take hundreds of MB a test: none
    outlives its test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _random_layers_off(model):
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        MBConvBlock)
    from neuralbarkcalculator_tpu_torch.models.heads import FCNHead

    for m in model.modules():
        if isinstance(m, MBConvBlock):
            m.drop_rate = 0.0
    if isinstance(model.classifier, FCNHead):
        model.classifier.dropout = 0.0
        model.classifier[3].p = 0.0
    else:
        model.classifier[0].project[3].p = 0.0
    return model


def _parity_model(name, seed=3):
    """zoo_model's weights with damped residual branches, random layers
    off."""
    model = zoo_model(name, seed)
    rng = np.random.default_rng(seed + 100)
    state = model.state_dict()
    for k, v in state.items():
        if k.endswith((".bn3.weight", "downsample.1.weight", "._bn2.weight")):
            state[k] = torch.from_numpy(
                rng.uniform(0.02, 0.06, v.shape).astype(np.float32))
    model.load_state_dict(state)
    return _random_layers_off(model)


def _jax_model(name):
    from neuralbarkcalculator_tpu.models import segmentation as js
    from neuralbarkcalculator_tpu.models.efficientnet import (
        EfficientNetFeatures)
    from neuralbarkcalculator_tpu.models.heads import FCNHead

    if name == "fcn_efficientnet_b0":
        return js.SegmentationModel(
            backbone=EfficientNetFeatures(variant=0, drop_connect_rate=0.0),
            classifier=FCNHead(3, dropout=0.0))
    if name.startswith("fcn"):
        return js.MODEL_FACTORIES[name](dropout=0.0)
    return js.MODEL_FACTORIES[name]()


@pytest.fixture
def flax_exact_train_mode(monkeypatch):
    """In this process only (nothing in the JAX package changes): flax's
    Dropout as the identity (the JAX DeepLab head's ASPP dropout at 0.5),
    and flax's BatchNorm with ``use_fast_variance`` off. flax's default
    takes the batch variance as E[x^2] - E[x]^2 in float32, which loses
    digits where a channel's mean is large against its spread: with it,
    the JAX ResNets' train-mode logits lie 2.0e-4 and 2.3e-4 of the
    largest from the port's (torch's two-pass variance), without it
    6.5e-5 and 5.6e-5."""
    import flax.linen as fnn

    class NoDropout(fnn.Module):
        rate: float = 0.0
        deterministic: bool = True

        def __call__(self, x):
            return x

    class ExactVarianceBatchNorm(fnn.BatchNorm):
        use_fast_variance: bool = False

    monkeypatch.setattr(fnn, "Dropout", NoDropout)
    monkeypatch.setattr(fnn, "BatchNorm", ExactVarianceBatchNorm)


def _float64_grads(state, name, x, labels) -> dict:
    """The port's loss gradients with the model in float64 from ``state``
    (the logits cast to float32 before the upsample, as in float32
    training)."""
    from neuralbarkcalculator_tpu_torch.ops.losses import lovasz_softmax_loss

    model = _random_layers_off(zoo_model(name, 0))
    model.load_state_dict(state)
    model = model.double().train()
    lovasz_softmax_loss(model(torch.from_numpy(x).double(), dropout_seed=0),
                        torch.from_numpy(labels).long()).backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(EXACT))
def test_train_step_matches_jax(name, flax_exact_train_mode):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)
    from neuralbarkcalculator_tpu.ops.losses import lovasz_softmax_loss
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    size = EXACT[name]
    variant = 0 if "efficientnet" in name else None
    model = _parity_model(name)
    # copies: JAX may alias numpy memory and runs asynchronously, while
    # the port's step below updates its weights and statistics in place
    variables = torch_state_dict_to_variables(
        {k: v.numpy().copy() for k, v in model.state_dict().items()},
        head="deeplab" if name.startswith("deeplab") else "fcn",
        efficientnet_variant=variant)
    rng = np.random.default_rng(0)
    x = normalized([blob_image(rng, size, size) for _ in range(2)])
    labels = np.kron(rng.integers(0, 3, (2, size // 8, size // 8)),
                     np.ones((1, 8, 8), np.int64)).astype(np.int32)

    jax_model = _jax_model(name)

    def loss_fn(params, batch_stats):
        logits, mutated = jax_model.apply(
            {"params": params, "batch_stats": batch_stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        return lovasz_softmax_loss(logits, jnp.asarray(labels)), (
            logits, mutated["batch_stats"])

    (want_loss, (want_logits, want_stats)), want_grads = jax.block_until_ready(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"]))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen, out = {}, {}  # pixels per channel each BN saw; the logits
    for mod_name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, inp, o, n=mod_name: seen.__setitem__(
                    n, inp[0].numel() // inp[0].shape[1]))
    model.register_forward_hook(
        lambda m, inp, o: out.__setitem__("logits", o.detach()))
    metrics = step_on_batch(model, adam(model.parameters(), 5e-4, 2e-3),
                            torch.from_numpy(x),
                            torch.from_numpy(labels).long(), seed=0)

    want_logits = np.asarray(want_logits)
    scale = np.abs(want_logits).max()
    assert np.abs(out["logits"].numpy() - want_logits).max() <= \
        LOGIT_TOL * scale
    assert abs(float(metrics["loss"]) - float(want_loss)) <= 1e-5

    grads = variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, want_grads)}, variant)
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    exact = _float64_grads(copy.deepcopy(before), name, x, labels)
    largest = max(float(g.abs().max()) for g in exact.values())
    cosines, rel_norms = {}, {}
    for k, g in grads.items():
        got = params[k].grad.double()
        g = g.double()
        if k.startswith("classifier.4."):
            np.testing.assert_allclose(
                got.numpy(), g.numpy(), rtol=1e-4,
                atol=1e-4 * float(g.abs().max()), err_msg=k)
            continue
        # a gradient that is 0 in exact arithmetic (a BN shift that reaches
        # the next train-mode BN only through a 1x1 conv, whose mean
        # subtraction removes it): float64 leaves < 1e-9 of the largest
        # gradient there, and the float32 sides only rounding, with no
        # direction to compare
        if float(exact[k].abs().max()) <= 1e-9 * largest:
            continue
        a, b = got.flatten(), g.flatten()
        cosines[k] = float(a @ b / (a.norm() * b.norm()))
        rel_norms[k] = float((a - b).norm() / b.norm())
    assert len(cosines) > 0.8 * sum(1 for k in params
                                    if not k.startswith("classifier.4."))
    worst = min(cosines, key=cosines.get)
    assert cosines[worst] >= COS_MIN, (worst, cosines[worst])
    worst = max(rel_norms, key=rel_norms.get)
    assert rel_norms[worst] <= REL_MAX, (worst, rel_norms[worst])

    stats = variables_to_state_dict(
        {"batch_stats": jax.tree.map(np.asarray, want_stats)}, variant)
    state = model.state_dict()
    momentum = {n: m.momentum for n, m in model.named_modules()
                if isinstance(m, torch.nn.BatchNorm2d)}
    assert len(seen) == len(stats) // 2
    for k, want in stats.items():
        bn = k.rsplit(".", 1)[0]
        if k.endswith("running_mean"):
            np.testing.assert_allclose(state[k].numpy(), want.numpy(),
                                       rtol=0, atol=MEAN_ATOL, err_msg=k)
            continue
        n, keep = seen[bn], 1.0 - momentum[bn]
        old = keep * before[k]
        unbiased = old + (want - old) * (n / (n - 1))
        np.testing.assert_allclose(state[k].numpy(), unbiased.numpy(),
                                   rtol=VAR_RTOL, atol=0, err_msg=k)


# ------------------------------------------------------------ random layers

def test_aspp_dropout_against_its_mask_oracle():
    """The ASPP's Dropout(0.5) in train mode: exactly where(mask, y / 0.5,
    0) for the mask a generator seeded from the step's seed draws (the
    head's stream); keep fraction ~0.5; the same seed the same output, the
    next seed another mask."""
    from neuralbarkcalculator_tpu_torch.models.heads import ASPP
    from neuralbarkcalculator_tpu_torch.models.seeding import (
        HEAD_STREAM, layer_generator)

    torch.manual_seed(0)
    aspp = ASPP(64).train()
    x = torch.randn(4, 64, 12, 12)
    y = aspp(x, generator=layer_generator(7, HEAD_STREAM, x.device))
    with torch.no_grad():
        pre = aspp.project[:3](torch.cat(
            [c(x) for c in aspp.convs[:-1]] + [aspp.convs[-1](x)], 1))
    kept = torch.rand(pre.shape, generator=layer_generator(
        7, HEAD_STREAM, x.device)) < 0.5
    torch.testing.assert_close(y.detach(), torch.where(kept, pre / 0.5, 0.0),
                               rtol=0, atol=1e-6)
    assert 0.48 <= float(kept.float().mean()) <= 0.52
    assert bool((y[~kept] == 0).all())
    again = aspp(x, generator=layer_generator(7, HEAD_STREAM, x.device))
    other = aspp(x, generator=layer_generator(8, HEAD_STREAM, x.device))
    assert torch.equal(again, y) and not torch.equal(other, y)
    with pytest.raises(ValueError, match="generator"):
        aspp(x)
    aspp.eval()  # no dropout in eval mode
    with torch.no_grad():
        pre = aspp.project[:3](torch.cat(
            [c(x) for c in aspp.convs[:-1]] + [aspp.convs[-1](x)], 1))
        torch.testing.assert_close(aspp(x), pre, rtol=0, atol=0)


def test_stochastic_depth_against_its_mask_oracle():
    """MBConv's stochastic depth: each sample's residual branch kept whole
    (x + h / keep) or dropped (x), from a per-sample draw of the seeded
    generator; keep fraction ~1 - rate; only residual blocks drop; the
    block rates are DROP_CONNECT_RATE * j / blocks, as JAX's."""
    from neuralbarkcalculator_tpu.models.efficientnet import (
        BASE_BLOCKS, round_repeats)
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        EfficientNetBackbone, MBConvBlock)
    from neuralbarkcalculator_tpu_torch.models.seeding import (
        BACKBONE_STREAM, layer_generator)

    torch.manual_seed(0)
    block = MBConvBlock(16, 16, 6, 3, 1, drop_rate=0.3).train()
    x = torch.randn(2000, 16, 4, 4)
    with torch.no_grad():
        gen = layer_generator(11, BACKBONE_STREAM, x.device)
        y = block(x, gen)
        block.drop_rate = 0.0
        h = block(x) - x  # the branch, from the same batch statistics
    kept = torch.rand((2000, 1, 1, 1), generator=layer_generator(
        11, BACKBONE_STREAM, x.device)) < 0.7
    torch.testing.assert_close(y, x + h * kept / 0.7, rtol=0, atol=1e-5)
    per_sample_kept = (y - x).flatten(1).abs().amax(1) > 0
    assert torch.equal(per_sample_kept, kept.flatten())
    assert 0.67 <= float(kept.float().mean()) <= 0.73

    backbone = EfficientNetBackbone(3)
    rates = [b.drop_rate for b in backbone.model._blocks]
    total = sum(round_repeats(r, 1.4) for _, _, r, _, _ in BASE_BLOCKS)
    assert rates == [0.2 * j / total for j in range(total)]
    assert not MBConvBlock(16, 24, 6, 3, 1, drop_rate=0.3).skip


@pytest.mark.parametrize("name", ["deeplabv3_resnet50",
                                  "fcn_efficientnet_b0"])
def test_train_forward_is_a_function_of_the_seed(name):
    """Every random layer draws from the step's seed and nothing else: the
    same seed gives the same train-mode logits after other uses of
    torch's global generator, another seed others."""
    model = zoo_model(name, seed=4).train()
    x = torch.from_numpy(normalized([blob_image(np.random.default_rng(1),
                                                64, 64) for _ in range(2)]))
    with torch.no_grad():
        a = model.head_logits(x, dropout_seed=21)
        torch.rand(100)
        b = model.head_logits(x, dropout_seed=21)
        c = model.head_logits(x, dropout_seed=22)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_fcn_head_upcasts_bf16_for_the_kernel(monkeypatch):
    """Under bf16 autocast the FCN head's ReLU output is bf16; the head
    hands fused_dropout_matmul a contiguous float32 copy (the kernel takes
    float32 only)."""
    from neuralbarkcalculator_tpu_torch.models import heads

    seen = []
    real = heads.fused_dropout_matmul
    monkeypatch.setattr(heads, "fused_dropout_matmul",
                        lambda h, w, b, seed, rate: (
                            seen.append((h.dtype, h.is_contiguous())),
                            real(h, w, b, seed, rate))[1])
    model = tiny_torch_model(dropout=0.8).train()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = model(torch.randn(2, 32, 32, 3), dropout_seed=3)
    assert seen == [(torch.float32, True)]
    assert out.dtype == torch.float32


# ------------------------------------------------------------------ recipe

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_train_root(tmp_path_factory.mktemp("zootrain"))


def _config(**kw):
    from neuralbarkcalculator_tpu_torch.config import TrainConfig

    return TrainConfig(pad_resize_size=64, crop_size=32, batch_size=4,
                       samples_per_epoch_factor=1, **kw)


def test_resume_restores_the_checkpoint(data_root, tmp_path):
    """train(resume=True) restores the last checkpoint's weights, Adam
    moments, lr (as saved: 1.25e-4 here) and step count, seeds the
    generators from (seed, next epoch), and goes on at that epoch."""
    from neuralbarkcalculator_tpu_torch.models.seeding import fold_seed
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment
    from neuralbarkcalculator_tpu_torch.train.optim import get_learning_rate

    directory = str(tmp_path / "moar")
    first = Experiment(data_root, directory, config=_config(), device="cpu")
    first.train(epochs=1)
    path = os.path.join(directory, "checkpoint_epoch_1.pt")
    saved = torch.load(path, weights_only=True)
    saved["optimizer"]["param_groups"][0]["lr"] = 1.25e-4
    torch.save(saved, path)

    exp = Experiment(data_root, directory, config=_config(), device="cpu")
    exp.train(epochs=1, resume=True)  # restores; no epoch left to run
    assert exp.history == [] and exp.step_count == saved["step"] == 6
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    state = exp.opt.state_dict()
    assert get_learning_rate(exp.opt) == 1.25e-4
    for i, moments in saved["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state["state"][i][key], moments[key]), key
    fresh = torch.Generator().manual_seed(fold_seed(42, 2))
    assert torch.equal(exp.augment_gen.get_state(), fresh.get_state())

    exp.train(epochs=2, resume=True)
    assert [log.epoch for log in exp.history] == [2]
    assert exp.history[0].lr == 1.25e-4 and exp.step_count == 12
    assert [e["epoch"] for e in exp.ckpts.log["epochs"]] == [1, 2]


def test_resume_replays_the_controllers_like_jax(data_root, tmp_path):
    """The plateau and early-stop state after replaying an epoch log equal
    the JAX package's replay of the same log (train/loop.py:214-221)."""
    from neuralbarkcalculator_tpu.train import optim as jo
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment
    from neuralbarkcalculator_tpu_torch.train.optim import get_learning_rate

    directory = tmp_path / "moar"
    Experiment(data_root, str(directory), config=_config(),
               device="cpu").train(epochs=1)
    monitored = [10.0, 10.05, 10.3, 10.31, 10.2, 10.35, 10.32]
    entries = [{"epoch": i + 1, "val_miou": m, "lr": 5e-4}
               for i, m in enumerate(monitored)]
    (directory / "experiment_log.json").write_text(
        json.dumps({"epochs": entries, "best_epoch": 6}))
    shutil.copy(directory / "checkpoint_epoch_1.pt",
                directory / "checkpoint_epoch_7.pt")
    exp = Experiment(data_root, str(directory), config=_config(),
                     device="cpu")
    exp.train(epochs=7, resume=True)

    cfg = exp.config
    plateau = jo.ReduceLROnPlateau(
        mode="max", factor=cfg.plateau_factor, patience=cfg.plateau_patience,
        threshold=cfg.plateau_threshold, threshold_mode="abs")
    early = jo.EarlyStopping(mode="max", min_delta=cfg.early_stop_min_delta,
                             patience=cfg.early_stop_patience)
    lr = get_learning_rate(exp.opt)
    for entry in entries:
        lr = plateau.step(entry["val_miou"], lr)
        early.step(entry["val_miou"], entry["epoch"])
    for attr in ("best", "num_bad_epochs", "cooldown_counter"):
        assert getattr(exp.plateau, attr) == getattr(plateau, attr), attr
    for attr in ("best", "wait", "stopped_epoch"):
        assert getattr(exp.early_stopping, attr) == getattr(early, attr), attr
    assert exp.early_stopping.wait == 4  # the log was replayed


def _tiny_backbone_file(tmp_path, suffix, seed=5, prefix=""):
    """A random torchvision-named tiny ResNet backbone state dict with an
    ImageNet fc, as ``.pt`` or ``.npz``."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in tiny_torch_model().backbone.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = np.asarray(7, np.int64)
        elif k.endswith("running_var"):
            state[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            state[k] = (0.05 * rng.standard_normal(v.shape)).astype(
                np.float32)
    state["fc.weight"] = rng.standard_normal((10, 2048)).astype(np.float32)
    state["fc.bias"] = np.zeros(10, np.float32)
    path = str(tmp_path / f"backbone{suffix}")
    if suffix == ".npz":
        np.savez(path, **state)
    else:
        torch.save({prefix + k: torch.from_numpy(v)
                    for k, v in state.items()}, path)
    return path, state


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
def test_backbone_checkpoint_merges_like_jax(tmp_path, suffix):
    """The same file through JAX's load_backbone_checkpoint +
    merge_backbone and the port's gives the same logits (1e-4, as the
    logit tests), and the port's backbone holds the file's tensors."""
    import jax
    from neuralbarkcalculator_tpu.models import convert as jc
    from neuralbarkcalculator_tpu.models.segmentation import (
        SegmentationModel)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_backbone_checkpoint, load_state_dict_into, merge_backbone,
        variables_to_state_dict)

    path, state = _tiny_backbone_file(tmp_path, suffix)
    variables = tiny_variables(seed=6)
    merged = jc.merge_backbone(variables, jc.load_backbone_checkpoint(path))
    x = np.random.default_rng(2).normal(size=(2, 64, 48, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: tiny_jax_model().apply(
        v, x, train=False, method=SegmentationModel.head_logits))(merged, x))

    model = tiny_torch_model()
    load_state_dict_into(model, variables_to_state_dict(variables))
    merge_backbone(model, load_backbone_checkpoint(path))
    for k, v in model.backbone.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    with torch.inference_mode():
        got = model.eval().head_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_backbone_checkpoint_layouts_and_mismatches(tmp_path):
    """A full segmentation checkpoint and a bare efficientnet_pytorch state
    dict load too; a ResNet-50 backbone into ResNet-101 (and back), and a
    tensor of another shape, raise before any weight is touched."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_backbone_checkpoint, merge_backbone)
    from neuralbarkcalculator_tpu_torch.models.resnet import (
        resnet50_dilated)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    path, state = _tiny_backbone_file(tmp_path, ".pth", prefix="backbone.")
    full = torch.load(path, weights_only=True)
    full["classifier.4.bias"] = torch.zeros(3)
    torch.save({"state_dict": full}, path)
    loaded = load_backbone_checkpoint(path)
    assert set(loaded) == {k for k in state if not k.startswith("fc.")}

    b0 = zoo_model("fcn_efficientnet_b0", seed=0)
    bare = {k[len("backbone.model."):]: v
            for k, v in b0.state_dict().items() if k.startswith("backbone.")}
    bare["_fc.weight"] = torch.zeros(1000, 1280)
    torch.save(bare, tmp_path / "b0.pt")
    target = MODEL_FACTORIES["deeplabv3_efficientnet_b0"]()
    merge_backbone(target, load_backbone_checkpoint(str(tmp_path / "b0.pt")))
    for k, v in target.backbone.state_dict().items():
        assert torch.equal(v, b0.backbone.state_dict()[k]), k

    r50 = resnet50_dilated().state_dict()
    with torch.device("meta"):
        r101 = MODEL_FACTORIES["fcn_resnet101"]()
    with pytest.raises(ValueError, match="missing"):
        merge_backbone(r101, r50)
    with torch.device("meta"):
        r50_model = MODEL_FACTORIES["deeplabv3_resnet50"]()
    with pytest.raises(ValueError, match="unexpected"):
        merge_backbone(r50_model, {**r50, "layer3.6.conv1.weight":
                                   torch.zeros(256, 1024, 1, 1)})
    r50["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch at layer1.0.conv1"):
        merge_backbone(r50_model, r50)


def test_host_resident_data_gives_the_same_steps(data_root, tmp_path):
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    runs = []
    for resident in (True, False):
        exp = Experiment(data_root, str(tmp_path / str(resident)),
                         config=_config(device_resident_data=resident),
                         device="cpu")
        exp.train(epochs=1)
        runs.append(exp)
    assert runs[1].images.device == torch.device("cpu")
    assert runs[0].step_losses == runs[1].step_losses
    assert runs[0].history[0].val_miou == runs[1].history[0].val_miou
    for (k, a), b in zip(runs[0].model.state_dict().items(),
                         runs[1].model.state_dict().values()):
        assert torch.equal(a, b), k


def test_prioritized_sampler_runs_its_update_loop(data_root, tmp_path,
                                                  capsys):
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    exp = Experiment(data_root, str(tmp_path / "moar"), config=_config(),
                     sampler="prioritized", device="cpu")
    exp.train(epochs=1)
    stats = exp.sampler_stats
    assert exp.step_count == 6
    # a batch's repeated draw counts one visit (numpy's fancy +=, as in the
    # JAX package's copy)
    assert 0 < stats["avg_visits"] <= 6 * 4 / len(exp.train_split)
    # every visited item's weight is the running mean of its batches'
    # miou / 100, no longer the initial 1
    assert stats["biggest_weight"][1] < 1.0 or stats["least_visited"][1] == 0
    assert stats["smallest_weight"][1] < 1.0
    assert "avg_visits" in capsys.readouterr().out


def test_train_f1_postprocess_matches_jax(data_root, tmp_path, monkeypatch):
    """train_f1_postprocess: the loop asks every step for the postprocessed
    F1, and a step's F1 equals the JAX package's pixelwise_f1 on the
    step's own logits, with the connected-component postprocess and
    without it (the two differ on this batch)."""
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import metrics as jm
    from neuralbarkcalculator_tpu_torch.train import loop
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    seen = []
    real = loop.train_step
    monkeypatch.setattr(loop, "train_step",
                        lambda *a: (seen.append(a[-1]), real(*a))[1])
    exp = loop.Experiment(data_root, str(tmp_path / "moar"),
                          config=_config(train_f1_postprocess=True),
                          device="cpu")
    exp.train(epochs=1)
    assert seen == [True] * exp.step_count == [True] * 6

    rng = np.random.default_rng(12)
    x = torch.from_numpy(normalized([blob_image(rng, 64, 64)
                                     for _ in range(2)]))
    labels = np.kron(rng.integers(0, 3, (2, 8, 8)),
                     np.ones((1, 8, 8), np.int64))
    base = tiny_torch_model(dropout=0.8).train()
    with torch.no_grad():
        logits = copy.deepcopy(base)(x, dropout_seed=5).numpy()
    f1 = {}
    for post in (True, False):
        model = copy.deepcopy(base)
        got = step_on_batch(model, adam(model.parameters(), 5e-4), x,
                            torch.from_numpy(labels), seed=5,
                            f1_postprocess=post)["f1"]
        want = float(jnp.mean(jm.pixelwise_f1(
            jnp.asarray(logits), jnp.asarray(labels), postprocess=post)))
        assert float(got) == pytest.approx(want, rel=1e-5), post
        f1[post] = want
    assert f1[True] != f1[False]


def test_test_uses_the_best_or_the_current_weights(data_root, tmp_path):
    """test(use_best=False) evaluates the weights as they are and leaves
    them; test() restores the best epoch's checkpoint first."""
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    exp = Experiment(data_root, str(tmp_path / "moar"), config=_config(),
                     device="cpu")
    exp.train(epochs=1)
    best = copy.deepcopy(exp.model.state_dict())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in exp.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    current = copy.deepcopy(exp.model.state_dict())
    want_current = exp.evaluate(exp.test_split)
    assert exp.test(use_best=False) == want_current
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, current[k]), k
    got_best = exp.test()
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert got_best != want_current
    assert got_best == exp.evaluate(exp.test_split)


def test_bf16_step_against_float32():
    """A bf16-autocast step of the tiny model against the float32 step from
    the same weights: parameters and gradients stay float32, the loss
    within 1e-2 relative and the head's last gradients within cosine 0.99
    (measured 1.4e-4 and 0.99916)."""
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    rng = np.random.default_rng(9)
    x = torch.from_numpy(normalized([blob_image(rng, 64, 64)
                                     for _ in range(2)]))
    labels = torch.from_numpy(np.kron(rng.integers(0, 3, (2, 8, 8)),
                                      np.ones((1, 8, 8), np.int64)))
    base = tiny_torch_model(dropout=0.8).train()
    out = {}
    for bf16 in (False, True):
        model = copy.deepcopy(base)
        m = step_on_batch(model, adam(model.parameters(), 5e-4), x, labels,
                          seed=5, bf16=bf16)
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        out[bf16] = (float(m["loss"]), model.classifier[4].weight.grad)
    (l32, g32), (l16, g16) = out[False], out[True]
    assert abs(l16 - l32) <= 1e-2 * abs(l32)
    cos = float((g16 * g32).sum() / (g16.norm() * g32.norm()))
    assert cos >= 0.99


def test_cli_recipe_flags(data_root, tmp_path, monkeypatch):
    """--tpu-native-recipe is lovasz_hist + bf16; an explicit --loss wins;
    --bf16, --backbone_ckpt, --resume reach the Experiment."""
    from neuralbarkcalculator_tpu_torch.cli import train as cli
    from neuralbarkcalculator_tpu_torch.train import loop

    seen = []

    class Spy:
        def __init__(self, data_dir, directory, config, model_name,
                     loss_name, monitor, device):
            seen.append((config.use_bfloat16, config.backbone_ckpt,
                         loss_name, model_name))
            self.ckpts = type("C", (), {"best_epoch": None})()

        def train(self, resume):
            seen.append(resume)

        def test(self):
            pass

    monkeypatch.setattr(loop, "Experiment", Spy)
    for argv, want in (
            (["--tpu-native-recipe"], (True, None, "lovasz_hist")),
            (["--tpu-native-recipe", "--loss", "cwe"], (True, None, "cwe")),
            (["--bf16", "--backbone_ckpt", "b.pt", "--resume"],
             (True, "b.pt", "lovasz")),
            ([], (False, None, "lovasz"))):
        seen.clear()
        cli.main(cli.build_parser().parse_args(
            [str(tmp_path), "--device", "cpu", "--no_report", *argv]))
        assert seen[0][:3] == want
        assert seen[1] == ("--resume" in argv)


def test_cli_trains_bf16_hist_from_a_backbone_then_resumes(data_root,
                                                          tmp_path):
    """The card run's CLI path at a tiny size: deeplabv3_resnet50 from a
    random torchvision-named ResNet-50 file, in bf16 with lovasz_hist; then
    --resume --epochs 2 starts at epoch 2 with the restored lr."""
    from neuralbarkcalculator_tpu_torch.cli.train import build_parser, main
    from neuralbarkcalculator_tpu_torch.models.resnet import (
        resnet50_dilated)

    torch.manual_seed(0)
    ckpt = str(tmp_path / "resnet50.pt")
    torch.save({**resnet50_dilated().state_dict(),
                "fc.weight": torch.zeros(1000, 2048),
                "fc.bias": torch.zeros(1000)}, ckpt)
    common = [str(tmp_path), "--device", "cpu", "--data_dir", data_root,
              "--batch_size", "4", "--crop_size", "32", "--pad_size", "64",
              "--samples_factor", "1", "--no_report", "--model",
              "deeplabv3_resnet50"]
    first = main(build_parser().parse_args(
        common + ["--epochs", "1", "--bf16", "--loss", "lovasz_hist",
                  "--backbone_ckpt", ckpt]))
    assert first.config.use_bfloat16 and all(np.isfinite(first.step_losses))
    saved = torch.load(ckpt, weights_only=True)
    ckpt1 = torch.load(tmp_path / "moar" / "checkpoint_epoch_1.pt",
                       weights_only=True)
    # the first step moved the weights from the file's
    assert not torch.equal(ckpt1["model"]["backbone.conv1.weight"],
                           saved["conv1.weight"])
    second = main(build_parser().parse_args(
        common + ["--epochs", "2", "--resume", "--bf16", "--loss",
                  "lovasz_hist"]))
    assert [log.epoch for log in second.history] == [2]
    assert second.history[0].lr == first.history[0].lr
    assert second.step_count == 2 * first.step_count


# -------------------------------------------------------- every zoo name

def _zoo_names():
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    return sorted(MODEL_FACTORIES)


@pytest.mark.parametrize("name", _zoo_names())
def test_every_zoo_model_trains_through_the_cli(name, data_root, tmp_path):
    """One tiny epoch (2 steps of 12 at crop 32) of each MODEL_FACTORIES
    name through cli/train.main on the CPU, with finite losses; the
    predict engine loads its best_model.pt and answers one image. The two
    bare EfficientNet names need the variant, as in the JAX package."""
    from neuralbarkcalculator_tpu_torch.cli.train import build_parser, main
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    argv = [str(tmp_path), "--device", "cpu", "--data_dir", data_root,
            "--epochs", "1", "--batch_size", "12", "--crop_size", "32",
            "--pad_size", "64", "--samples_factor", "1", "--no_report",
            "--model", name]
    if name in ("fcn_efficientnet", "deeplabv3_efficientnet"):
        with pytest.raises(ValueError, match="variant"):
            main(build_parser().parse_args(argv))
        return
    exp = main(build_parser().parse_args(argv))
    assert exp.step_count == 2 and all(np.isfinite(exp.step_losses))
    engine = NeuralBarkCalculator(str(tmp_path / "moar" / "best_model.pt"),
                                  model_name=name, device="cpu")
    img = blob_image(np.random.default_rng(0), 64, 64)
    (_, class_map), = engine.predict_images(
        [ProcessedImage(img, "a.png", "sapin")])
    assert class_map.shape == (64, 64)
