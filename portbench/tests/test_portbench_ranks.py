"""A cell whose ``chips`` is 2 runs from new files and manifest entries
alone, as 2 gloo processes started by the harness's own launcher
(lib/harness.launch): rank 0 alone prints one result, correct against the
reference on the global batch; a rank that raises or stalls ends every
rank, and the run prints no result."""
import json

import pytest

from copies import BenchCopy, tiny_train

SEED = 2 ** 31 + 91
CONFIG = "deeplabv3_resnet101-tiny"
# the tiny cell's limits: at this size and seed the sound two ranks read a
# loss1_gap of 2.53e-6 and a grad_gap of 7.2e-3, the same as the reference
# itself when its BatchNorm sums the two halves of the batch apart as the
# cross-rank BatchNorm does (rounding); per-rank BatchNorm reads 9.6e-3
# and 0.586
LIMITS = {"loss1_gap": 1e-4, "grad_gap": 0.02, "change_gap": 0.2}


def dp2(tmp_path) -> tuple[BenchCopy, str]:
    """The copy with a tiny data-parallel training cell of 2 chips: global
    batch 4, 2 rows a rank."""
    copy = BenchCopy(tmp_path)
    traffic = tiny_train(copy, copy.read("configs/deeplabv3_resnet101.json"),
                         CONFIG, global_batch=4)
    copy.write("traffic/train-dp2.json", traffic)
    copy.write(f"limits/{CONFIG}.train-dp2.json", LIMITS)
    name = copy.add_cell(CONFIG, "train-dp2", 2,
                         ("train_step_ms", "train_peak_gib"))
    copy.save_manifest()
    return copy, name


def json_lines(text: str) -> list[dict]:
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_print_one_correct_result(tmp_path, trace):
    copy, name = dp2(tmp_path)
    out = copy.launch(name, SEED, 1.0, trace=trace)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = json_lines(out.stdout)
    assert len(lines) == 1, out.stdout
    line = lines[0]
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["count"] == 2
    if trace:
        # every rank traced its window; the CPU has no device events
        assert line["device"]["busy_s"] == 0.0
        assert line["device"]["window_s"] > 0
        assert "mfu.train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "train_step_ms",
                                        "train_peak_gib"}
    assert "rank 1 of 2" in out.stderr and "rank 0 of 2" in out.stderr
    assert "train: reference 1 steps of 4 rows" in out.stderr
    assert copy.unchanged()


@pytest.mark.parametrize("fault, margin", [("raise", 300.0),
                                           ("stall", 40.0)])
def test_a_failing_rank_ends_every_rank(tmp_path, fault, margin):
    """Rank 1 raises, or never returns, in its second step: the launcher
    ends both ranks, prints nothing and exits nonzero, well inside the
    test's limit (a stall within the margin given)."""
    copy, name = dp2(tmp_path)
    act = ("raise RuntimeError('rank 1 fails')" if fault == "raise"
           else "threading.Event().wait()")
    entry = copy.entry("fault_entry", f"""
import os, threading
from neuralbarkcalculator_tpu_torch.train import step as S
_step, _calls = S.train_step, []
def train_step(*a, **k):
    _calls.append(1)
    if os.environ["RANK"] == "1" and len(_calls) == 2:
        {act}
    return _step(*a, **k)
S.train_step = train_step
""")
    out = copy.launch(name, SEED, 1.0, entry=entry, margin_s=margin,
                      timeout=240)
    assert out.returncode != 0
    assert json_lines(out.stdout) == [], out.stdout
    assert "every rank ended, no result" in out.stderr
