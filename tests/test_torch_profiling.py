"""PyTorch port: ``utils.device_trace``, the counterpart of the JAX
package's ``jax.profiler`` trace. On the CPU it writes one Chrome trace
into its directory, holding the traced ops' events and none from outside
the block."""
import json
import os

import torch

from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)


def test_device_trace_writes_one_chrome_trace(tmp_path):
    from neuralbarkcalculator_tpu_torch.utils import device_trace

    x = torch.ones(64, 64)
    torch.mm(x, x)  # outside the trace
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16),
                                   torch.ones(4, 3, 3, 3))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names
    assert "aten::mm" not in names
