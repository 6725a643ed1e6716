"""The program's spans in a traced run (lib/program.py) and the metrics that
read them, on a synthetic event list: the trace reader keeps reading the
same device events whatever program ranges the profiler recorded, the
idle gaps are named by the harness's ranges and then the program's, and
each new reader gives a number where its spans are and None where not."""
import os
import types

import pytest
from torch.autograd import DeviceType

from portbench.lib import harness, program
from portbench.lib.trace import WINDOW, Trace

MS = 1_000_000  # ns


class Event:
    """The part of a profiler event that ``Trace._read`` reads."""

    def __init__(self, name, start, dur, *, cuda=False, kind="",
                 annotation=False, corr=0, thread=1):
        self._v = (name, start, dur, cuda, kind, annotation, corr, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._v[7]


def host(name, start, dur, thread=1):
    return Event(name, start, dur, kind="user_annotation", annotation=True,
                 thread=thread)


def kernel(name, start, dur, corr):
    return Event(name, start, dur, cuda=True, kind="kernel", corr=corr)


def launch(start, corr, thread=1):
    return Event("cudaLaunchKernel", start, 1000, kind="cuda_runtime",
                 corr=corr, thread=thread)


# the window: 0-100 ms; kernels at 10-20, 30-35 and 60-90 ms, launched at
# 9, 29 and 59 ms; the harness's pass range over 0-100 ms
BASE = [host(WINDOW, 0, 100 * MS), host("harness/predict_pass", 0, 100 * MS),
        launch(9 * MS, 1), kernel("conv", 10 * MS, 10 * MS, 1),
        launch(29 * MS, 2), kernel("augment", 30 * MS, 5 * MS, 2),
        launch(59 * MS, 3), kernel("adam", 60 * MS, 30 * MS, 3)]
# program ranges as the profiler records them: on the host, and their
# device-side copies, which span the device work launched inside them
PROGRAM = [host("predict/plan", 0, 8 * MS),
           host("predict/decode", 20 * MS, 10 * MS, thread=2),
           host("train/augment", 28 * MS, 3 * MS),
           host("report/dual", 36 * MS, 20 * MS, thread=3),
           Event("train/augment", 30 * MS, 5 * MS, cuda=True,
                 kind="gpu_user_annotation"),
           Event("predict/launch_h1024", 10 * MS, 80 * MS, cuda=True,
                 kind="gpu_user_annotation")]


def read(events) -> Trace:
    tr = Trace(False)
    tr._prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tr._read()
    return tr


def test_program_ranges_leave_the_device_events_as_they_were():
    base, with_program = read(BASE), read(BASE + PROGRAM)
    assert with_program.device == base.device
    assert with_program.busy_s() == base.busy_s() == pytest.approx(0.045)
    assert with_program.idle_gaps() == base.idle_gaps()
    assert with_program.device_ops() == base.device_ops()
    names = {row[0] for row in with_program.device_ops()}
    assert not any(n.startswith(program.PREFIXES) for n in names)
    # the harness's ranges are what it kept before
    assert with_program.ranges == base.ranges


@pytest.fixture
def logged(monkeypatch):
    """The program's span log holding PROGRAM's host ranges (and one
    outside the window)."""
    from neuralbarkcalculator_tpu_torch.utils import profiling

    log = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), None)
           for e in PROGRAM if not e._v[3]]
    log.append(("predict/plan", 200 * MS, 210 * MS, None))
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return log


def test_ranges_are_the_logged_spans_inside_the_window(logged):
    tr = read(BASE + PROGRAM)
    got = program.ranges(tr)
    assert [r[2] for r in got] == ["predict/plan", "predict/decode",
                                   "train/augment", "report/dual"]
    assert program.ranges(None) == []


def test_gap_labels_name_harness_then_program_spans(logged):
    tr = read(BASE + PROGRAM)
    got = program.gap_labels(tr, program.ranges(tr))
    # the same gaps, in the same order, as the harness's own labels
    assert [g[1] for g in got] == [g[1] for g in tr.idle_gaps()]
    # gaps 35-60, 0-10, 20-30 and 90-100 ms, named at their middles
    assert got == [["harness/predict_pass+report/dual", pytest.approx(0.025)],
                   ["harness/predict_pass+predict/plan", pytest.approx(0.01)],
                   ["harness/predict_pass+predict/decode",
                    pytest.approx(0.01)],
                   ["harness/predict_pass", pytest.approx(0.01)]]
    long = [(0, 100 * MS, "predict/" + "x" * 300, None)]
    assert all(len(label) <= 160 for label, _ in
               program.gap_labels(tr, long))


def test_idle_split_sums_to_the_idle_time(logged):
    tr = read(BASE + PROGRAM)
    split = program.idle_split(tr, program.ranges(tr))
    assert sum(split.values()) == pytest.approx(
        tr.window_s() - tr.busy_s())
    assert split == {"report/dual": pytest.approx(0.025),
                     "predict/plan": pytest.approx(0.01),
                     "predict/decode": pytest.approx(0.01),
                     "no program span": pytest.approx(0.01)}


def test_device_time_of_the_kernels_launched_inside_a_span(logged):
    tr = read(BASE + PROGRAM)
    spans = program.ranges(tr)
    assert program.device_s(tr, spans, "train/augment") == (
        pytest.approx(0.005), 1)
    assert program.device_s(tr, spans, "train/optimizer") == (0.0, 0)
    assert program.step_device_ms({"trace": tr, "steps": 2},
                                  "train/augment") == pytest.approx(2.5)
    assert program.step_device_ms({"trace": tr, "steps": 2},
                                  "train/metrics") is None
    assert program.step_device_ms({}, "train/augment") is None


def reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics",
                                            f"{name}.py"))


def stage(calls, total_s):
    return {"calls": calls, "total_s": total_s, "mean_s": total_s / calls}


FOLDER = {"images": 16, "stages": {
    "predict/plan": stage(2, 0.4), "predict/finalize": stage(2, 0.2),
    "predict/decode": stage(4, 0.16), "predict/wait": stage(4, 0.08),
    "predict/dispatch_h1024": stage(4, 0.2),
    "predict/upload_h1024": stage(3, 0.09),
    "predict/upload_h896": stage(1, 0.03),
    "predict/launch_h1024": stage(4, 0.08),
    "report/figure": stage(16, 0.64), "report/dual": stage(16, 0.32)}}


@pytest.mark.parametrize("name, want", [
    ("upload_ms.folder", 30.0), ("launch_ms.folder", 20.0),
    ("decode_ms.folder", 10.0), ("pump_wait_ms.folder", 20.0),
    ("pass_edges_ms.folder", 300.0), ("artifacts_ms.folder", 60.0)])
def test_folder_readers(name, want):
    assert reader(name).read(FOLDER) == pytest.approx(want)
    # the parent's stages, without this metric's
    old = {"images": 16, "stages": {
        k: v for k, v in FOLDER["stages"].items()
        if k.startswith(("predict/dispatch_h", "predict/postprocess_h"))}}
    assert reader(name).read(old) is None
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name, prefix", [
    ("augment_ms.train", "train/augment"),
    ("optimizer_ms.train", "train/optimizer"),
    ("step_metrics_ms.train", "train/metrics")])
def test_train_readers(monkeypatch, name, prefix):
    from neuralbarkcalculator_tpu_torch.utils import profiling

    tr = read(BASE)
    # a span around the launch of each kernel in turn: 10, 5 or 30 ms of
    # device time over 2 steps
    for (start, ms) in ((8, 5.0), (28, 2.5), (58, 15.0)):
        monkeypatch.setattr(profiling, "spans", lambda s=start: [
            (prefix, s * MS, (s + 2) * MS, None)])
        assert reader(name).read({"trace": tr, "steps": 2}) == \
            pytest.approx(ms)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name).read({"trace": tr, "steps": 2}) is None
    # a program without the span log (the parent's)
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read({"trace": tr, "steps": 2}) is None
