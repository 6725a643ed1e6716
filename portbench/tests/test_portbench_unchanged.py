"""The configurations already in the benchmark read what they read before
each configuration named its reference module: the same weights drawn from
a seed (their SHA-256 on the CPU) and the same FLOP counts. The values
were recorded with the harness of the parent commit, in which every file
imported reference/model.py by name."""
import hashlib
import os

import pytest
import torch

from portbench.lib import flops, harness, weights

SHA256 = {
    ("fcn_resnet50", 7):
        "7c20cb99bf31b3e56d0233fec8bfb3a5f65215d478e1d6cb936e459d520bc10b",
    ("fcn_resnet50", 2 ** 31 + 12345):
        "e69e2a44b755b2e6aa2e29e70f7ef129636a2caeeb17bd74f96f92b08a242645",
    ("deeplabv3_resnet101", 7):
        "7ca29ac39c15ad1b7ff42073227c954201d4e5dfb5a8f041ef952e08c8d0c7c5",
    ("deeplabv3_resnet101", 2 ** 31 + 12345):
        "17851711883eaa65f98c0bdc289419422d43df4da416930ed012b64108fdbbf5",
}
MODEL_FLOPS = {  # at height x 1024
    ("fcn_resnet50", 896): 968311701504,
    ("fcn_resnet50", 960): 1037476823040,
    ("fcn_resnet50", 1024): 1106641944576,
    ("deeplabv3_resnet101", 896): 1687966187520,
    ("deeplabv3_resnet101", 960): 1808535126016,
    ("deeplabv3_resnet101", 1024): 1929104064512,
}
TRAIN_STEP_FLOPS = 7227986411520  # deeplabv3_resnet101, batch 5, crop 512


def config(name: str) -> dict:
    return harness.read_json(os.path.join(harness.BENCH, "configs",
                                          f"{name}.json"))


def digest(state: dict) -> str:
    """Every entry's name, dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed", sorted(SHA256))
def test_the_same_weights(name, seed):
    state = weights.random_state_dict(config(name), seed,
                                      torch.device("cpu"))
    assert digest(state) == SHA256[(name, seed)]


@pytest.mark.parametrize("name, height", sorted(MODEL_FLOPS))
def test_the_same_model_flops(name, height):
    assert flops.model_flops(config(name), height, 1024) == \
        MODEL_FLOPS[(name, height)]


def test_the_same_train_step_flops():
    assert flops.train_step_flops(config("deeplabv3_resnet101"), 5, 512) == \
        TRAIN_STEP_FLOPS
