"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; top-level names are compared
whole."""
import os
import subprocess
import sys

from portbench.lib import harness

SCRIPT = r"""
import sys, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from small import small_cell, run_small
out = run_small(small_cell("fcn_resnet50.folder"))
assert out.correct, out.checks
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set[str]:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_level(SCRIPT.format(root=harness.ROOT,
                                   tests=os.path.dirname(__file__)))
    assert not mods & {"jax", "jaxlib", "flax", "neuralbarkcalculator_tpu"}
    assert "neuralbarkcalculator_tpu_torch" in mods  # the program ran


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {harness.ROOT!r})\n"
            "import portbench.reference.model, portbench.reference.train\n"
            "import portbench.reference.postprocess\n"
            "import portbench.reference.control\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    mods = top_level(code)
    assert not mods & {"jax", "jaxlib", "flax", "neuralbarkcalculator_tpu",
                       "neuralbarkcalculator_tpu_torch"}
