"""PyTorch port: the serving tools (neuralbarkcalculator_tpu_torch/tools/
bench_data.py, serving_bench.py, serving_soak.py) on the CPU.

- bench_data's structured masks and images equal the JAX package's
  tools/bench_data.py at the same seeds;
- the soak's RSS-per-upload fit is clamped at 0 before the residual is
  taken; its slope checks (the staging bound, and on a clean platform the
  flat-RSS bound) stay off below MIN_SLOPE_UPLOAD_MB and apply above it; its calibration uploads at
  least 1024 x 1024 x 3 bytes a put, tens of MB in all, whatever the
  workload's shapes;
- a seconds-long soak and a seq_n=2, conc=2, conc_m=1 bench against the
  tiny model print JSON with the JAX tools' keys, and the soak's
  telemetry adds up.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)
from torch_port_common import tiny_engines, tiny_torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of the JAX tools' JSON (tools/serving_bench.py run_config,
# tools/serving_soak.py run_soak)
JAX_BENCH_KEYS = ({"phase", "n", "p50_ms", "p95_ms"},
                  {"phase", "clients", "total", "p50_ms", "p95_ms",
                   "req_per_s"})
JAX_SOAK_KEYS = {"tool", "seconds", "clients", "shapes", "requests",
                 "served", "errors", "rejected", "batches", "mean_batch",
                 "throughput_rps", "latency_ms", "rss_mb",
                 "platform_retention", "rss_resid_mb", "violations"}
JAX_RETENTION_KEYS = {"calibrated_mb_per_mb", "fitted_mb_per_mb",
                      "uploaded_mb", "clean_platform", "note"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("seed,h,w", [(0, 96, 128), (7, 64, 64),
                                      (3, 200, 150)])
def test_bench_data_equals_jax(seed, h, w):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import bench_data as jax_data
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    from neuralbarkcalculator_tpu_torch.tools import bench_data

    got = bench_data.structured_dual_mask(np.random.default_rng(seed), h, w)
    want = jax_data.structured_dual_mask(np.random.default_rng(seed), h, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bench_data.structured_image(np.random.default_rng(seed), got),
        jax_data.structured_image(np.random.default_rng(seed), want))


def test_negative_slope_is_clamped_before_the_residual():
    from neuralbarkcalculator_tpu_torch.tools.serving_soak import (
        fit_rss_per_upload)

    up = np.arange(10, dtype=np.float64) * 9.0
    rss = 4000.0 - 2.4 * up  # a noise-dominated negative fit
    raw, fit, resid = fit_rss_per_upload(rss, up)
    assert raw == pytest.approx(-2.4)
    assert fit == 0.0
    np.testing.assert_array_equal(resid, rss)  # not rss + 2.4 * up
    rss = 4000.0 + 0.5 * up
    raw, fit, resid = fit_rss_per_upload(rss, up)
    assert raw == fit == pytest.approx(0.5)
    np.testing.assert_allclose(resid, 4000.0)


def test_slope_check_needs_the_minimum_volume():
    from neuralbarkcalculator_tpu_torch.tools.serving_soak import (
        MIN_SLOPE_UPLOAD_MB, slope_violations)

    below, above = MIN_SLOPE_UPLOAD_MB / 10, MIN_SLOPE_UPLOAD_MB
    assert slope_violations(0.5, 0.0, below) == []
    assert len(slope_violations(0.5, 0.0, above)) == 1
    assert slope_violations(0.04, 0.0, above) == []
    assert slope_violations(0.5, 0.9, above) == []  # not a clean platform
    # the staging bound, on any platform, also once the volume is there
    assert slope_violations(2.0, 0.9, below) == []
    assert len(slope_violations(2.0, 0.9, above)) == 1


def test_calibration_uploads_large_buffers():
    from neuralbarkcalculator_tpu_torch.tools.serving_soak import (
        calibrate_platform_retention)

    for shape in ((64, 64, 3), (128, 2048, 3)):
        cal = calibrate_platform_retention("cpu", shape=shape)
        assert cal["put_bytes"] >= 1024 * 1024 * 3
        assert cal["puts"] * cal["put_bytes"] >= 32 * 2**20
        assert cal["mb_per_mb"] >= 0.0
    assert calibrate_platform_retention(
        "cpu", shape=(128, 2048, 3))["put_bytes"] == 1024 * 2048 * 3


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    import shutil

    directory = tmp_path_factory.mktemp("tools")
    torch.manual_seed(5)
    path = str(directory / "best_model.pt")
    torch.save(tiny_torch_model().state_dict(), path)
    yield path
    shutil.rmtree(directory, ignore_errors=True)


def test_soak_reports_and_adds_up(checkpoint):
    from neuralbarkcalculator_tpu_torch.tools.serving_soak import run_soak

    _, engine = tiny_engines(checkpoint, jax_engine=False, batch_size=4,
                             height_bucket=32)
    report = run_soak(engine, seconds=3.0, clients=3, heights=(48, 64),
                      widths=(64,), max_wait_ms=10.0)
    report = json.loads(json.dumps(report))  # what the tool prints
    assert JAX_SOAK_KEYS <= set(report)
    assert JAX_RETENTION_KEYS <= set(report["platform_retention"])
    assert report["device"] == "cpu"
    assert report["violations"] == []
    assert report["served"] + report["errors"] + report["rejected"] == \
        report["requests"] > 0
    assert report["errors"] == 0 and report["batches"] > 0
    assert report["mean_batch"] > 1.0
    assert report["shapes"] == [[48, 64], [64, 64]]
    retention = report["platform_retention"]
    assert retention["fitted_mb_per_mb"] >= 0.0
    assert retention["calibration_put_bytes"] >= 1024 * 1024 * 3
    # a few MB uploaded: far below the volume the slope check needs
    assert retention["uploaded_mb"] < retention[
        "min_upload_mb_for_slope_check"]
    assert not retention["slope_checked"]


def test_bench_prints_its_phases(checkpoint):
    from neuralbarkcalculator_tpu_torch.models import segmentation
    from neuralbarkcalculator_tpu_torch.tools.serving_bench import (
        run_config)

    segmentation.MODEL_FACTORIES["_tiny_test"] = tiny_torch_model
    try:
        rows = run_config([checkpoint, "--port", "0", "--batch_size", "4",
                           "--device", "cpu", "--model", "_tiny_test",
                           "--fixed_height", "0", "--float32"],
                          seq_n=2, conc=2, conc_m=1, size=64)
    finally:
        segmentation.MODEL_FACTORIES.pop("_tiny_test")
    assert [r["phase"] for r in rows] == ["float32_sequential",
                                          "float32_concurrent"]
    for row, keys in zip(rows, JAX_BENCH_KEYS):
        assert keys <= set(json.loads(json.dumps(row)))
        assert row["device"] == "cpu"
        assert 0 < row["p50_ms"] <= row["p95_ms"]
    assert rows[0]["n"] == 2 and rows[1]["total"] == 2
    assert rows[1]["req_per_s"] > 0
