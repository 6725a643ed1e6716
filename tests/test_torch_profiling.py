"""PyTorch port: ``utils.device_trace``, the counterpart of the JAX
package's ``jax.profiler`` trace. On the CPU it writes one Chrome trace
into its directory, holding the traced ops' events and none from outside
the block. ``stage_timer``: a host range of the profiler's on its own
thread in a session, none outside one, and a running (calls, seconds)
sum a stage."""
import contextlib
import json
import os

import pytest
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


def _profile_all_threads():
    from torch.profiler import ProfilerActivity, profile

    from neuralbarkcalculator_tpu_torch.utils.profiling import _all_threads
    return profile(activities=[ProfilerActivity.CPU], **_all_threads())


def test_stage_timer_is_a_host_range_on_its_thread():
    import threading

    from neuralbarkcalculator_tpu_torch.utils import profiling

    profiling.report(reset=True)

    def work(name, chunk):
        with profiling.stage_timer(name, chunk):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))

    with _profile_all_threads() as prof:
        work("unit/main", None)
        work("unit/main", 3)
        t = threading.Thread(target=work, args=("unit/worker", 5))
        t.start()
        t.join()
    events = prof.profiler.kineto_results.events()
    ranges = [e for e in events if e.name().startswith("unit/")]
    mms = [e for e in events if e.name() == "aten::mm"]
    assert sorted(e.name() for e in ranges) == ["unit/main", "unit/main",
                                                "unit/worker"]
    # host events, with no device-side copy (a user annotation has one)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation() for e in ranges)
    for r in ranges:  # each brackets its own mm, on its own thread
        inside = [m for m in mms if r.start_ns() <= m.start_ns()
                  and m.end_ns() <= r.end_ns()]
        assert len(inside) == 1
        assert inside[0].start_thread_id() == r.start_thread_id()
    main = {r.start_thread_id() for r in ranges if r.name() == "unit/main"}
    worker = {r.start_thread_id() for r in ranges
              if r.name() == "unit/worker"}
    assert len(main) == 1 and main != worker
    # the log of profiled spans: name, wall-clock interval, chunk
    log = profiling.spans()
    assert [(n, c) for n, _, _, c in log] == [
        ("unit/main", None), ("unit/main", 3), ("unit/worker", 5)]
    for (_, s, e, _), r in zip(log, sorted(ranges,
                                          key=lambda r: r.start_ns())):
        assert s <= e and r.start_ns() <= s + 10_000_000
    assert profiling.report()["unit/main"]["calls"] == 2
    profiling.report(reset=True)
    assert profiling.spans() == []


@pytest.mark.parametrize("profiled", [False, True])
def test_stage_timer_enters_a_range_only_in_a_session(monkeypatch,
                                                      profiled):
    from neuralbarkcalculator_tpu_torch.utils import profiling

    entered = []
    real = profiling._RecordFunctionFast
    monkeypatch.setattr(profiling, "_RecordFunctionFast",
                        lambda *a: (entered.append(a), real(*a))[1])
    real_rf = torch.autograd.profiler.record_function.__enter__
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: (entered.append(self.name),
                                      real_rf(self))[1])
    profiling.report(reset=True)
    session = _profile_all_threads() if profiled else contextlib.nullcontext()
    with session:
        for k in range(4):
            with profiling.stage_timer("unit/a", k):
                pass
    assert entered == ([("unit/a", (k,)) for k in range(4)] if profiled
                       else [])
    assert len(profiling.spans()) == (4 if profiled else 0)
    assert profiling.report()["unit/a"]["calls"] == 4
    profiling.report(reset=True)


@pytest.mark.parametrize("profiled", [False, True])
def test_report_keeps_running_sums(monkeypatch, profiled):
    import types

    from neuralbarkcalculator_tpu_torch.utils import profiling

    clock = iter([10.0, 10.5, 20.0, 22.0, 30.0, 30.25])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock), time_ns=lambda: 0))
    profiling.report(reset=True)
    session = _profile_all_threads() if profiled else contextlib.nullcontext()
    with session:
        for name in ("unit/a", "unit/a", "unit/b"):
            with profiling.stage_timer(name):
                pass
    assert profiling.report(reset=True) == {
        "unit/a": {"calls": 2, "total_s": 2.5, "mean_s": 1.25},
        "unit/b": {"calls": 1, "total_s": 0.25, "mean_s": 0.25}}
    assert profiling.report() == {}
    # one running (calls, seconds) pair a stage, however many calls
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: 1.0, time_ns=lambda: 0))
    for _ in range(1000):
        with profiling.stage_timer("unit/c"):
            pass
    assert profiling._STAGES["unit/c"] == [1000, 0.0]
    profiling.report(reset=True)
