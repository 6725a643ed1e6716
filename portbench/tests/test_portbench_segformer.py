"""The SegFormer cell's pieces of the benchmark: device time by the
program's spans where cuDNN, cuBLAS or NCCL launch through the driver
(lib/launched.py), the readers of ``attention_roofline``,
``decode_head_ms.folder`` and ``collectives_ms.train`` on a synthetic
event list (a number where their spans are, None where not, as on a
parent without them), and the e4m3 control (reference/fp8.py,
tests/fp8_control.py), which comes out as not correct."""
import os
import re
import sys

import pytest
import torch

from portbench.lib import harness, launched
from portbench.reference import segformer as R
from small import run_small, small_cell
from test_portbench_program_spans import (BASE, MS, Event, host, kernel,
                                          launch, read)
from portbench.lib.trace import WINDOW

# two kernels launched through the driver, correlation ids 4 and 6, whose
# launches the trace does not keep, among kept launches 3 (59 ms, BASE's),
# 5 (64 ms) and 7 (80 ms): the gemm's launch lies in 59-64 ms, the conv's
# in 64-80 ms
DRIVER = [Event("sm90_xmma_gemm", 95 * MS, 4 * MS, cuda=True, kind="kernel",
                corr=4),
          launch(64 * MS, 5), kernel("pytorch_flash::flash_fwd_kernel",
                                     92 * MS, 2 * MS, 5),
          Event("cudnn_conv", 91 * MS, 3 * MS, cuda=True, kind="kernel",
                corr=6),
          launch(80 * MS, 7), kernel("add", 90 * MS, 1 * MS, 7)]


@pytest.fixture
def spans(monkeypatch):
    """The program's span log: (name, start ms, end ms[, native thread])
    each, on native thread 7 unless named."""
    from neuralbarkcalculator_tpu_torch.utils import profiling

    def use(*spans):
        rows = [(name, s * MS, e * MS, None, rest[0] if rest else 7)
                for name, s, e, *rest in spans]
        monkeypatch.setattr(profiling, "thread_spans", lambda: list(rows))
        monkeypatch.setattr(profiling, "spans",
                            lambda: [r[:4] for r in rows])
    return use


def test_driver_launches_fall_in_the_span_their_neighbours_bound(spans):
    tr = read(BASE + DRIVER)
    # a span over 62-66 ms holds the flash launch and meets both intervals
    spans(("predict/decode_head", 62, 66))
    assert launched.span_device_s(tr, "predict/decode_head") == (
        pytest.approx(0.009), 3)
    # one over 75-85 ms holds launch 7 and meets the conv's interval
    spans(("predict/decode_head", 75, 85))
    assert launched.span_device_s(tr, "predict/decode_head") == (
        pytest.approx(0.004), 2)
    # one that meets no interval and holds no launch
    spans(("predict/decode_head", 1, 5))
    assert launched.span_device_s(tr, "predict/decode_head") == (0.0, 0)
    spans(("predict/attention", 62, 66))
    assert launched.span_device_s(tr, "predict/attention",
                                  re.compile("flash")) == (
        pytest.approx(0.002), 1)
    assert launched.span_device_s(None, "predict/attention") == (0.0, 0)


# two threads launching at once, as the prediction pump's two workers do:
# A (the profiler's thread 1, native 101) and B (thread 2, native 202), in
# one correlation sequence; each kernel's time in ms is a power of two, so
# a sum names the kernels counted
TWO = [host(WINDOW, 0, 100 * MS),
       launch(11 * MS, 1, thread=1), kernel("a_up0", 20 * MS, 4096 * MS, 1),
       launch(41 * MS, 2, thread=1), kernel("a_up", 20 * MS, 1 * MS, 2),
       launch(42 * MS, 3, thread=2), kernel("b_norm", 21 * MS, 8 * MS, 3),
       # A's gemm: neighbours B (42) and A (43); A's own launches bound it
       # in 41-43, B's in 42-46
       Event("a_gemm", 22 * MS, 2 * MS, cuda=True, kind="kernel", corr=4),
       launch(43 * MS, 5, thread=1), kernel("a_relu", 23 * MS, 16 * MS, 5),
       # B's gemm: neighbours A (43) and B (46); A's own bound it in 43-48,
       # B's in 42-46
       Event("b_gemm", 24 * MS, 32 * MS, cuda=True, kind="kernel", corr=6),
       launch(46 * MS, 7, thread=2), kernel("b_gelu", 25 * MS, 64 * MS, 7),
       launch(48 * MS, 8, thread=1), kernel("a_cat", 26 * MS, 128 * MS, 8),
       launch(61 * MS, 9, thread=2), kernel("b_up", 27 * MS, 256 * MS, 9),
       Event("b_gemm2", 28 * MS, 1024 * MS, cuda=True, kind="kernel",
             corr=10),
       launch(65 * MS, 11, thread=2), kernel("b_cat", 29 * MS, 512 * MS, 11)]


def test_spans_take_only_their_own_threads_kernels(spans):
    tr = read(TWO)
    # A's decoder over 40-50 ms, while B launches its encoder; A alone in
    # its span over 10-12 ms; B's decoder over 60-70 ms
    spans(("predict/decode_head", 10, 12, 101),
          ("predict/decode_head", 40, 50, 101),
          ("predict/decode_head", 60, 70, 202))
    assert launched.span_device_s(tr, "predict/decode_head") == (
        pytest.approx((4096 + 1 + 2 + 16 + 128 + 256 + 1024 + 512) / 1e3),
        8)
    # A's spans alone: B's kernels launched meanwhile are not A's
    spans(("predict/decode_head", 10, 12, 101),
          ("predict/decode_head", 40, 50, 101))
    assert launched.span_device_s(tr, "predict/decode_head") == (
        pytest.approx((4096 + 1 + 2 + 16 + 128) / 1e3), 5)
    # a span of a thread not matched (none in the log), as a span that
    # launches nothing kept leaves its thread: every kernel launched in
    # 40-50 ms is taken, as it is by a single thread's
    spans(("predict/decode_head", 40, 50, None))
    assert launched.span_device_s(tr, "predict/decode_head") == (
        pytest.approx((1 + 8 + 2 + 16 + 32 + 64 + 128) / 1e3), 7)


def reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics",
                                            f"{name}.py"))


def test_readers(spans, monkeypatch):
    from neuralbarkcalculator_tpu_torch.utils import profiling

    tr = read(BASE + DRIVER)
    peaks = {"bf16_flops_per_s": 989e12}
    calls = [(8, 256, 256, 1024, 1024), (8, 224, 256, 896, 1024)]
    folder = {"trace": tr, "upsample_argmax_calls": calls, "peaks": peaks}
    spans(("predict/attention", 62, 66), ("predict/decode_head", 75, 85))
    work = 8 * (R.attention_flops("segformer_b5", 1024, 1024)
                + R.attention_flops("segformer_b5", 896, 1024))
    # the FLOPs of the run's configuration, named by its --workload
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "segformer_b5.folder", "--seed", "1"])
    assert reader("attention_roofline").read(folder) == pytest.approx(
        work / 0.002 / 989e12 * 100)
    # a configuration whose reference counts no attention reads nothing
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "fcn_resnet50.folder"])
    assert reader("attention_roofline").read(folder) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "segformer_b5.folder"])
    assert reader("decode_head_ms.folder").read(folder) == pytest.approx(
        4.0 / 16)
    # adam (launched at 59 ms) and the gemm; the add and the conv
    spans(("train/collective/grads", 58, 60),
          ("train/collective/bn", 75, 85))
    assert reader("collectives_ms.train").read(
        {"trace": tr, "steps": 2}) == pytest.approx((30 + 4 + 1 + 3) / 2)
    # no such span, and a program without the span log (the parent's)
    spans(("predict/plan", 0, 100))
    for name, readings in (("attention_roofline", folder),
                           ("decode_head_ms.folder", folder),
                           ("collectives_ms.train", {"trace": tr,
                                                     "steps": 2})):
        assert reader(name).read(readings) is None
        assert reader(name).read({}) is None
    spans(("predict/attention", 62, 66), ("predict/decode_head", 75, 85))
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "thread_spans")
    for name in ("attention_roofline", "decode_head_ms.folder"):
        assert reader(name).read(folder) is None


def small_sizes():
    cell = small_cell("segformer_b5.folder", float32=False)
    cell.traffic.update(width=128, copies=1, check_images=3,
                        sizes={"heights": [96, 128], "counts": [1, 2]})
    return cell


def test_e4m3_control_separates_small():
    """At a small size the numbers the cell compares read three times
    higher or more for the e4m3 reference than for the sound bf16 program,
    on the same seed."""
    import fp8_control
    torch.set_num_threads(4)
    seed = 2 ** 31 + 13
    sound = run_small(small_sizes(), seed=seed, seconds=0.5)
    control = fp8_control.control(small_sizes(), seed, torch.device("cpu"))
    assert control["correct"] is False
    got = {k: v for k, v, _ in sound.checks}
    ratios = {k: control["readings"][k] / max(got[k], 1e-12) for k in got
              if control["readings"].get(k, 0) > 0}
    assert max(ratios.values()) >= 3.0, (ratios, got, control["readings"])
    # peaked attention: every block's mean largest probability well above
    # the uniform 1 / keys
    peaks = control["attention_peaks"]
    assert all(p > 2 * u for p, u in zip(peaks["mean_max_prob"],
                                         peaks["uniform"]))


@pytest.mark.cuda
def test_e4m3_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    import fp8_control
    cell = harness.find_cell("segformer_b5.folder")
    out = fp8_control.control(cell, 11, torch.device("cuda"))
    assert out["correct"] is False, out["checks"]
