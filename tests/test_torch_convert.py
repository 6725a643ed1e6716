"""PyTorch port: carrying weights across from the JAX package.

``variables_to_state_dict`` must map every leaf of the JAX variable tree
to exactly one key of the port's state dict, with none left over; and a
``best_model.pt`` written from the JAX package's own exporter
(``variables_to_torch_state_dict``, the reference checkpoint format) must
load into the port and give the same module state.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (count_leaves, tiny_torch_model,
                               tiny_variables)
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def variables():
    return tiny_variables(seed=3)


def test_every_leaf_maps_once(variables):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    state = variables_to_state_dict(variables)
    assert len(state) == count_leaves(variables)
    model = tiny_torch_model()
    expected = {k for k in model.state_dict()
                if not k.endswith("num_batches_tracked")}
    assert set(state) == expected
    for k, v in model.state_dict().items():
        if k in state:
            assert state[k].shape == v.shape, k
    # a flax conv kernel [kh, kw, I, O] arrives as torch [O, I, kh, kw]
    kernel = variables["params"]["backbone"]["layer1_0"]["conv2"]["kernel"]
    np.testing.assert_array_equal(
        state["backbone.layer1.0.conv2.weight"].numpy(),
        kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["classifier.1.running_var"].numpy(),
        variables["batch_stats"]["classifier"]["bn1"]["var"])


def test_unmapped_leaf_is_an_error(variables):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    bad = {"params": {"backbone": {"layer1_0": {"conv9": {
        "weights": np.zeros(3, np.float32)}}}}}
    with pytest.raises(KeyError):
        variables_to_state_dict(bad)


def test_load_rejects_mismatched_state(variables):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)

    state = variables_to_state_dict(variables)
    state.pop("backbone.layer2.0.conv1.weight")
    with pytest.raises(KeyError):
        load_state_dict_into(tiny_torch_model(), state)


def test_jax_exported_pt_loads_into_port(variables, tmp_path):
    from neuralbarkcalculator_tpu.models.convert import (
        variables_to_torch_state_dict)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, load_torch_checkpoint, variables_to_state_dict)

    exported = {k: torch.tensor(v) for k, v in
                variables_to_torch_state_dict(variables).items()}
    path = tmp_path / "best_model.pt"
    torch.save(exported, path)
    from_pt = tiny_torch_model()
    load_state_dict_into(from_pt, load_torch_checkpoint(str(path)))
    direct = tiny_torch_model()
    load_state_dict_into(direct, variables_to_state_dict(variables))
    a, b = from_pt.state_dict(), direct.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)

    # the wrapped {'state_dict': ...} form loads the same
    torch.save({"state_dict": exported}, path)
    assert sorted(load_torch_checkpoint(str(path))) == sorted(exported)
