"""The interface of a reference module (reference/__init__.py) on another
architecture: a depthwise convolution, a LayerNorm, linear layers and
attention over the pixels, in a module registered as
``portbench.reference.tinymix`` for the test. A configuration finds it by
name; the weight rules draw each of its entries; the FLOP counters count
every product, grouped convolutions and matrix products included; the
TF32 control rounds every product; a forward recomputed in backward gives
the same step."""
import sys
import types

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.lib import flops, weights
from portbench.reference import control
from portbench.reference import train as ref

SOURCE = '''
import torch
import torch.nn.functional as F

from portbench.reference import Normal, Uniform, Zeros

C = 8
CALIBRATE_PREFIX = "none."
CALIBRATE_EXCLUDE = ()


def param_shapes(model):
    return {"stem.weight": (C, 3, 3, 3), "dw.weight": (C, 1, 3, 3),
            "norm.weight": (C,), "norm.bias": (C,),
            "qkv.weight": (3 * C, C), "qkv.bias": (3 * C,),
            "head.weight": (2, C), "head.bias": (2,), "steps": ()}


def init_rule(name, shape):
    if name == "steps":
        return Zeros(torch.int64)
    if name == "norm.weight":
        return Uniform(0.5, 1.5)
    if name.endswith("bias"):
        return Zeros()
    if len(shape) == 4:
        return Normal((2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)
    return Normal(0.2)


def trains(model):
    return True


def logits(st, x, model, ops):
    y = ops.c(x, st["stem.weight"], None, 2, 1)
    y = ops.block(lambda t: F.relu(ops.c(t, st["dw.weight"], None, 1, 1, 1,
                                         C)), y)
    b, c, h, w = y.shape
    t = F.layer_norm(y.flatten(2).transpose(1, 2), (C,), st["norm.weight"],
                     st["norm.bias"])
    q, k, v = (ops.mm(t, st["qkv.weight"].t()) + st["qkv.bias"]).chunk(3, -1)
    a = torch.softmax(ops.mm(q, k.transpose(1, 2)) / C ** 0.5, -1)
    t = ops.mm(a, v)
    out = ops.mm(t, st["head.weight"].t()) + st["head.bias"]
    out = out.transpose(1, 2).reshape(b, 2, h, w)
    return F.interpolate(out, size=x.shape[-2:], mode="bilinear",
                         align_corners=False)
'''
CONFIG = {"model": "tiny", "reference": "tinymix", "mean": [0.5] * 3,
          "std": [0.25] * 3,
          "train": {"lr": 5e-4, "weight_decay": 2e-3, "crop": 16,
                    "brightness": 0.1, "saturation": 0.2}}


@pytest.fixture
def tinymix(monkeypatch):
    mod = types.ModuleType("portbench.reference.tinymix")
    exec(compile(SOURCE, "tinymix.py", "exec"), mod.__dict__)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    flops._model_flops.cache_clear()
    flops._train_step_flops.cache_clear()
    yield mod
    flops._model_flops.cache_clear()
    flops._train_step_flops.cache_clear()


def test_a_configuration_finds_its_module(tinymix):
    assert reference.module_for(CONFIG) is tinymix
    assert reference.module_for({"model": "fcn_resnet50"}).__name__ == \
        "portbench.reference.model"
    for bad in ("../model", "model.py", "a b", ""):
        with pytest.raises(ValueError):
            reference.name_for({"reference": bad})


def test_weights_follow_the_rules(tinymix):
    seed, cpu = 2 ** 31 + 3, torch.device("cpu")
    state = weights.random_state_dict(CONFIG, seed, cpu)
    shapes = tinymix.param_shapes("tiny")
    assert list(state) == list(shapes)
    assert state["steps"].dtype == torch.int64 and int(state["steps"]) == 0
    for k in ("norm.bias", "qkv.bias", "head.bias"):
        assert not state[k].any()
    # one normal draw, then one uniform draw, split in the entries' order
    g = torch.Generator().manual_seed(seed)
    normal = torch.randn(3 * 3 * 3 * 8 + 8 * 9 + 24 * 8 + 2 * 8, generator=g)
    uniform = torch.rand(8, generator=g)
    assert torch.equal(state["stem.weight"].flatten(),
                       normal[:216] * (2.0 / 27) ** 0.5)
    assert torch.equal(state["dw.weight"].flatten(),
                       normal[216:288] * (2.0 / 9) ** 0.5)
    assert torch.equal(state["head.weight"].flatten(),
                       normal[480:] * 0.2)
    assert torch.equal(state["norm.weight"], 0.5 + 1.0 * uniform)


def test_flops_count_every_product(tinymix):
    # a 16 x 16 image: stem to 8 x 8 x 8, then per pixel (N = 64 tokens)
    n, c = 64, 8
    by_hand = [2 * c * n * 27,          # stem, 3 x 3 x 3 each output
               2 * c * n * 9,           # depthwise 3 x 3, one channel each
               2 * n * 3 * c * c,       # qkv
               2 * n * n * c,           # q k^T
               2 * n * c * n,           # a v
               2 * n * 2 * c]           # head
    assert flops._product_flops("tinymix", "tiny", 1, 16, 16, False) == \
        by_hand
    assert flops.model_flops(CONFIG, 16, 16) == sum(by_hand)
    assert flops.train_step_flops(CONFIG, 2, 16) == \
        3 * 2 * sum(by_hand) - 2 * by_hand[0]


@pytest.mark.parametrize("shapes", [((5, 4), (4, 3)),
                                    ((2, 5, 4), (4, 3)),
                                    ((2, 5, 4), (2, 4, 3))])
def test_tf32_matmul_rounds_both_factors_and_the_gradient(shapes):
    g = torch.Generator().manual_seed(1)
    a, b = (torch.randn(s, generator=g, dtype=torch.float32)
            for s in shapes)
    ar, br = control.tf32(a), control.tf32(b)
    a.requires_grad_(), b.requires_grad_()
    y = control.tf32_matmul(a, b)
    assert torch.equal(y, torch.matmul(ar, br))
    go = torch.randn(y.shape, generator=g)
    y.backward(go)
    a2, b2 = ar.clone().requires_grad_(), br.clone().requires_grad_()
    torch.matmul(a2, b2).backward(control.tf32(go))
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(b.grad, b2.grad, rtol=0, atol=1e-6)
    assert not torch.equal(y, torch.matmul(a.detach(), b.detach()))


def steps(hooks=None, recompute=False):
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (4, 24, 24, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, (4, 24, 24),
                                           dtype=np.uint8))
    state = weights.random_state_dict(CONFIG, 9, torch.device("cpu"))
    return ref.run_steps(CONFIG, state, images, labels,
                         [np.array([0, 1]), np.array([2, 3])], [11, 12], 7,
                         torch.device("cpu"), hooks=hooks,
                         recompute=recompute)


def test_the_tf32_control_rounds_every_product(tinymix):
    seen = {"conv": 0, "matmul": 0}

    def counted(kind):
        def hook(*args):
            seen[kind] += 1
            return control.TF32[kind](*args)
        return hook

    exact = steps()
    rounded = steps({k: counted(k) for k in seen})
    # 2 convolutions and 4 matrix products a forward, 2 steps
    assert seen == {"conv": 4, "matmul": 8}
    assert rounded["loss"][0] != exact["loss"][0]
    assert abs(rounded["loss"][0] - exact["loss"][0]) < 1e-3


def test_recomputing_blocks_gives_the_same_steps(tinymix):
    assert steps(recompute=True) == steps()


def test_recomputing_the_resnet_blocks_gives_the_same_step():
    cfg = {"model": "deeplabv3_resnet50", "mean": [0.5] * 3,
           "std": [0.25] * 3, "train": dict(CONFIG["train"], crop=32)}
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 3, (2, 40, 40),
                                           dtype=np.uint8))
    state = weights.random_state_dict(cfg, 4, torch.device("cpu"))
    args = (cfg, state, images, labels, [np.array([0, 1])], [3], 5,
            torch.device("cpu"))
    torch.set_num_threads(2)
    assert ref.run_steps(*args, recompute=True) == ref.run_steps(*args)
