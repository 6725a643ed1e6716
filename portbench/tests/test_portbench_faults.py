"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have; the unbroken small run comes out correct.
The runs skip the harness's look for a card and drive the rest of a run
on the CPU at a small size (tests/small.py)."""
import numpy as np
import pytest
import torch

from small import run_small, small_cell


def altered_upsample_argmax(monkeypatch):
    """A class map altered where it is produced: every class of a 32 x 32
    block of each map moved to the next class."""
    from neuralbarkcalculator_tpu_torch.pipeline import predict as P
    original = P.upsample_argmax

    def broken(*args, **kw):
        out = original(*args, **kw).clone()
        out[:, 8:40, 8:40] = (out[:, 8:40, 8:40] + 1) % 3
        return out

    monkeypatch.setattr(P, "upsample_argmax", broken)


@pytest.mark.parametrize("workload", ["fcn_resnet50.folder",
                                      "fcn_resnet50.serve"])
def test_sound_small_run_is_correct(workload):
    out = run_small(small_cell(workload))
    assert out.correct, out.checks
    assert out.e2e["setup_s"] > 0 and out.attempted > 0


@pytest.mark.parametrize("workload", ["fcn_resnet50.folder",
                                      "fcn_resnet50.serve"])
def test_altered_answer_is_not_correct(workload, monkeypatch):
    altered_upsample_argmax(monkeypatch)
    out = run_small(small_cell(workload))
    assert not out.correct, out.checks


def test_sound_small_train_run_is_correct():
    cell = small_cell("deeplabv3_resnet101.train")
    cell.traffic["checked_steps"] = 1
    out = run_small(cell)
    assert out.correct, out.checks


def test_unchanged_state_is_not_correct(monkeypatch):
    from neuralbarkcalculator_tpu_torch.train import optim

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(optim, "adam", lambda params, lr, wd=0.0:
                        Frozen(params, lr=lr, weight_decay=wd))
    cell = small_cell("deeplabv3_resnet101.train")
    cell.traffic["checked_steps"] = 1
    out = run_small(cell)
    assert not out.correct, out.checks


def test_half_the_batch_is_not_correct(monkeypatch):
    from neuralbarkcalculator_tpu_torch.ops import losses as L
    from neuralbarkcalculator_tpu_torch.train import step as S

    def half(name):
        def loss(logits, labels, pixel_weights=None):
            b = max(1, logits.shape[0] // 2)
            return L.lovasz_softmax_loss(logits[:b], labels[:b])
        return loss

    monkeypatch.setattr(S, "make_loss_fn", half)
    cell = small_cell("deeplabv3_resnet101.train")
    cell.traffic["checked_steps"] = 1
    out = run_small(cell)
    assert not out.correct, out.checks
    assert np.isfinite([v for _, v, _ in out.checks]).all()


def test_wrong_csv_arithmetic_is_not_correct(monkeypatch):
    """final_stats.csv's areas computed with a wrong pixel size."""
    from neuralbarkcalculator_tpu_torch.pipeline import report as R
    original = R.class_stats_row

    def broken(fname, wood_type, counts, total_pixels, mm_per_pix=12.96):
        return original(fname, wood_type, counts, total_pixels,
                        mm_per_pix * 1.001)

    monkeypatch.setattr(R, "class_stats_row", broken)
    out = run_small(small_cell("fcn_resnet50.folder"))
    assert not out.correct, out.checks
    assert dict((k, v) for k, v, _ in out.checks)["csv_arith_pp"] > 1e-5


def test_per_rank_batchnorm_is_not_correct(tmp_path):
    """Two ranks whose BatchNorms normalise over each rank's own rows (the
    plain per-rank BatchNorm in the cross-rank one's place): the run is
    not correct against the reference on the global batch."""
    from test_portbench_ranks import SEED, dp2, json_lines
    copy, name = dp2(tmp_path)
    entry = copy.entry("per_rank_bn", """
from neuralbarkcalculator_tpu_torch.parallel import sync_bn
sync_bn.convert_batchnorm = lambda model, world: model
""")
    out = copy.launch(name, SEED, 1.0, entry=entry)
    assert out.returncode == 0, out.stderr[-4000:]
    (line,) = json_lines(out.stdout)
    assert line["correct"] is False, line["checks"]
