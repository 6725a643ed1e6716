#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phase 1 builds every native piece from this checkout (the CUDA kernel
library from neuralbarkcalculator_tpu_torch/csrc/ with nvcc for sm_90a,
and the host IO runtime from native/barkio.cc with g++), in parallel, and
prints the card's name and power limit.

Phase 2 holds each kernel against its plain PyTorch version at the main
path's shapes and times the kernel, the plain version and the unfused
PyTorch yardstick with CUDA events.

Phase 3 drives the main path, folder prediction, through the engine a user
calls: a synthetic folder of 16 processed 1024-wide images at trimmed
heights 896/960/1024, a full-width fcn_resnet50 with random weights drawn
from the seed (bf16, BN folded, batch 8). It checks the artifacts, that
upsample_argmax was launched during the timed pass, profiles one more
pass for the device's busy share, and holds the engine's maps against a
per-image float32 reference on the card.

The last lines are the kernels' JSON line, the card's name and power
limit, and the result line. The script exits nonzero, with no result line,
when there is no CUDA device, when the port's package is not beside it, or
when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor cores
# and HBM3 bandwidth, at the full 700 W power limit.
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

# Main-path shapes: fcn_resnet50 at 1024-wide processed images, batch 8,
# the 1024-row height bucket, and trimmed heights as a folder gives them.
BATCH = 8
PAD_H = 1024
WIDTH = 1024
HEIGHTS = (896, 960, 1024, 1000, 904, 1024, 968, 936)
# The main-path folder (bench.py's layout: 16 images, these heights).
N_IMAGES = 16
FOLDER_HEIGHTS = (896, 960, 1024)
DPI = 100
# A kernel map may differ from the plain version's only at pixels whose
# top-2 logit margin there is below this (float32 summation order).
FLIP_MARGIN = 1e-5
# The bf16 engine's stride-8 logits may differ from the float32 engine's by
# at most this fraction of the float32 logits' standard deviation: about
# twice the 0.206 measured on an H100 with --seed 0. The random weights
# give logits with a small spread beside a large common offset that the
# head's bias cancels, and bf16 rounds relative to that offset.
BF16_LOGIT_TOL = 0.4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, warmup: int = 3, reps: int = 20, runs: int = 5
            ) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls,
    from CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def phase_build() -> str:
    """Build the kernel library and the native runtime side by side;
    returns the card's `name, power.limit` line."""
    from neuralbarkcalculator_tpu_torch.utils.build import (
        build_kernels, build_log, build_native)

    with ThreadPoolExecutor(max_workers=2) as pool:
        kern = pool.submit(build_kernels)
        native = pool.submit(build_native)
        kern_path, native_path = kern.result(), native.result()
    log(f"built {os.path.relpath(kern_path, REPO)} and "
        f"{os.path.relpath(native_path, REPO)}")
    for line in build_log(kern_path).splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return card


def phase_kernel(torch, seed: int) -> dict:
    """upsample_argmax against upsample_argmax_plain on the card."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.models.resnet import resnet50_dilated
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        column_operator_t, embedded_bicubic_rows)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax, upsample_argmax_plain)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        backbone = resnet50_dilated()
    f, wf = PAD_H // 8, WIDTH // 8
    rng = np.random.default_rng(seed)
    feat = torch.from_numpy(
        rng.standard_normal((BATCH, f, wf, 3), dtype=np.float32)).to(dev)
    rows = torch.from_numpy(np.stack([
        embedded_bicubic_rows(backbone.valid_feature_height(h), h, f, PAD_H)
        for h in HEIGHTS])).to(dev)
    colt = torch.from_numpy(column_operator_t(wf, WIDTH)).to(dev)

    got = upsample_argmax(feat, rows, colt)
    torch.cuda.synchronize()
    want = upsample_argmax_plain(feat, rows, colt)
    planes = torch.einsum("bof,bfwc->bcow", rows, feat)
    logits = torch.einsum("bcow,wp->bcop", planes, colt)
    top2 = logits.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = got != want
    flips = int(differ.sum())
    worst = float(margin[differ].max()) if flips else 0.0
    max_abs_err = int((got.int() - want.int()).abs().max())
    log(f"upsample_argmax: {flips} flips against the plain version "
        f"(largest flipped margin {worst:.3g}, allowed < {FLIP_MARGIN})")
    if flips and worst >= FLIP_MARGIN:
        raise AssertionError(
            f"upsample_argmax differs from its plain version at a pixel "
            f"with margin {worst} >= {FLIP_MARGIN}")
    for i, h in enumerate(HEIGHTS):
        if h < PAD_H and bool((got[i, h:] != 0).any()):
            raise AssertionError(f"padded rows of image {i} are not 0")

    def library():
        y = torch.matmul(torch.matmul(rows[:, None], feat.permute(0, 3, 1, 2)),
                         colt)
        return y.argmax(dim=1).to(torch.uint8)

    if bool((library() != want).any()) and flips == 0:
        log("note: the unfused yardstick differs from the plain version "
            "at near-tie pixels")
    ms = time_ms(torch, lambda: upsample_argmax(feat, rows, colt))
    plain_ms = time_ms(torch, lambda: upsample_argmax_plain(feat, rows, colt))
    library_ms = time_ms(torch, library)
    ops = 2 * BATCH * PAD_H * f * wf * 3 + 2 * BATCH * PAD_H * wf * WIDTH * 3
    nbytes = (4 * (feat.numel() + rows.numel() + colt.numel())
              + BATCH * PAD_H * WIDTH)
    op_ms = ops / H100_F32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES * 1e3
    log(f"upsample_argmax [{BATCH}x{PAD_H}x{WIDTH}]: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, unfused torch {library_ms:.4f} ms, "
        f"bound {max(op_ms, byte_ms):.4f} ms ({ops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.3f} MB)")
    return {
        "name": "upsample_argmax", "route": "cuda",
        "source": "neuralbarkcalculator_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "neuralbarkcalculator_tpu/ops/pallas_kernels.py:64",
        "launches": 0, "max_abs_err": max_abs_err, "flips": flips,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
    }


def make_folder(root: str, seed: int) -> None:
    """N_IMAGES processed 1024-wide PNGs at the trimmed heights, laid out
    as a predict root (processed/samples/<wood>/, results/<kind>/<wood>/),
    written with the native PNG encoder. Content: blobby low-frequency
    colour fields plus fine noise, drawn from `seed`."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.io.native import save_image_u8

    rng = np.random.default_rng(seed)
    samples = os.path.join(root, "processed", "samples", "sapin")
    os.makedirs(samples)
    for sub in ("combined_images", "outputs"):
        os.makedirs(os.path.join(root, "results", sub, "sapin"))
    for i in range(N_IMAGES):
        h = FOLDER_HEIGHTS[i % len(FOLDER_HEIGHTS)]
        coarse = rng.random((h // 64 + 2, WIDTH // 64 + 2, 3),
                            dtype=np.float32)
        img = np.kron(coarse, np.ones((64, 64, 1), np.float32))[:h, :WIDTH]
        img += 0.2 * rng.random(img.shape, dtype=np.float32)
        save_image_u8(os.path.join(samples, f"img{i:02d}.png"),
                      np.clip(img * 210, 0, 255).astype(np.uint8))


def random_state_dict(model, seed: int) -> dict:
    """fcn_resnet50 weights drawn with numpy from `seed`: He-normal convs,
    BN with non-trivial statistics (the residual-branch BNs scaled down so
    the random network stays in range), small biases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros_like(v)
            continue
        if len(shape) == 4:
            std = np.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        elif k.endswith("running_mean") or k.endswith("bias"):
            arr = rng.normal(0.0, 0.1, shape)
        elif k.endswith("running_var"):
            arr = rng.uniform(0.5, 2.0, shape)
        elif k.endswith(".bn3.weight") or k.endswith("downsample.1.weight"):
            arr = rng.uniform(0.1, 0.3, shape)
        else:  # other BN scales
            arr = rng.uniform(0.5, 1.5, shape)
        state[k] = torch.from_numpy(np.asarray(arr, np.float32))
    return state


def phase_main_path(torch, seed: int, workdir: str, device: str = "cuda"
                    ) -> dict:
    """Folder prediction through the engine on the card: one warm-up
    pass, then one timed pass with every launch count set to 0 just
    before it and read just after."""
    import importlib.util

    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import (
        DEFAULT_MEAN, DEFAULT_STD, PredictConfig)
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import LAUNCHES
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.utils import profiling

    root = os.path.join(workdir, "root")
    make_folder(root, seed)
    ckpt = os.path.join(workdir, "best_model.pt")
    model = fcn_resnet50().eval()
    model.load_state_dict(random_state_dict(model, seed))
    # centre the random head's logits on the first image, so the maps mix
    # classes and the postprocess and the reference check see real zones
    first = load_image_u8(os.path.join(root, "processed", "samples",
                                       "sapin", "img00.png"))
    with torch.inference_mode():
        model.to(device)
        x = torch.from_numpy(first).to(device).float() / 255.0
        x = ((x - torch.tensor(DEFAULT_MEAN, device=device))
             / torch.tensor(DEFAULT_STD, device=device))
        mean = model.head_logits(x[None]).mean(dim=(0, 1, 2)).cpu()
        model.cpu()
    model.classifier[4].bias.data -= mean
    torch.save(model.state_dict(), ckpt)
    del model
    engine = NeuralBarkCalculator(
        ckpt, config=PredictConfig(model_path=ckpt, figure_dpi=DPI),
        device=device)
    param = next(engine.model.parameters())
    if param.device.type != device or param.dtype != torch.bfloat16:
        raise AssertionError(f"weights on {param.device} {param.dtype}, "
                             f"expected {device} bfloat16")
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError("PIL is missing: the combined figures need it")

    engine.predict(root, progress=False)  # warm-up: cuDNN plans, caches
    profiling.report(reset=True)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    csv = engine.predict(root, progress=False)
    seconds = time.perf_counter() - t0
    launches = LAUNCHES.count
    stages = profiling.report(reset=True)

    with open(csv) as f:
        lines = f.read().splitlines()
    if len(lines) != 1 + N_IMAGES:
        raise AssertionError(f"final_stats.csv has {len(lines) - 1} rows, "
                             f"expected {N_IMAGES}")
    classes = set()
    for i in range(N_IMAGES):
        for sub in ("combined_images", "outputs"):
            path = os.path.join(root, "results", sub, "sapin",
                                f"img{i:02d}.png")
            if not os.path.isfile(path):
                raise AssertionError(f"missing artifact {path}")
        dual = load_image_u8(os.path.join(root, "results", "outputs",
                                          "sapin", f"img{i:02d}.png"),
                             grayscale=True)
        if dual.shape != (FOLDER_HEIGHTS[i % len(FOLDER_HEIGHTS)], WIDTH):
            raise AssertionError(f"dual mask {i} has shape {dual.shape}")
        classes |= set(np.unique(dual).tolist())
    if not classes <= {0, 127, 255}:
        raise AssertionError(f"dual masks hold values {sorted(classes)}")
    if launches == 0:
        raise AssertionError("the main path never launched upsample_argmax")
    log(f"main path: {N_IMAGES} images (heights {FOLDER_HEIGHTS}, width "
        f"{WIDTH}, batch {engine.config.batch_size}, bf16, BN folded) in "
        f"{seconds:.3f} s = {N_IMAGES / seconds:.3f} images/s (warm pass); "
        f"upsample_argmax launches {launches}; dual values "
        f"{sorted(classes)}; cache {engine.cache_stats()}")
    for name, row in sorted(stages.items()):
        log(f"stage {name:28s} {row['calls']:3d} calls "
            f"{row['total_s'] * 1e3:9.3f} ms total")
    return {"launches": launches, "engine": engine, "ckpt": ckpt,
            "root": root, "seconds": seconds}


def phase_profile(torch, main: dict) -> None:
    """One more folder pass under torch.profiler: the device's busy time
    (the sum of the device-side events: kernels and copies), set against
    this profiled pass's own wall time for the busy share, and the kernels
    that take the most of it. Then the device step alone, at the full batch
    and at the batch a 6-image bucket would launch without the
    power-of-two ladder's dummy rows, and the one-off cost of a batch
    shape the engine has not run before, which is what the ladder saves."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = main["engine"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # timed inside the block: the profiler's start-up and trace
        # processing are not part of the pass
        t0 = time.perf_counter()
        engine.predict(main["root"], progress=False)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    # device-side events only: a CPU op may carry the device time of the
    # kernels it launched, which would count that time twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    busy_s = sum(device_us(e) for e in events) / 1e6
    if busy_s == 0:
        log("profile: the profiler recorded no device time (busy share "
            "not measured)")
    else:
        log(f"profile: device busy {busy_s * 1e3:.3f} ms in the profiled "
            f"pass of {profiled_s * 1e3:.3f} ms (busy share "
            f"{busy_s / profiled_s:.4f}; the unprofiled timed pass took "
            f"{main['seconds'] * 1e3:.3f} ms)")
        for e in sorted(events, key=device_us, reverse=True)[:8]:
            log(f"profile: {device_us(e) / 1e3:10.3f} ms {e.count:5d}x "
                f"{e.key[:90]}")

    # the engine's device step alone, back to back on device-resident
    # inputs: the ceiling the host would have to keep up with
    import numpy as np

    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(
        0, 256, (BATCH, PAD_H, WIDTH, 3), dtype=np.uint8)).to(engine.device)
    valid_h = torch.tensor(HEIGHTS, dtype=torch.int32, device=engine.device)
    rows = torch.stack([engine._row_op_dev(h, PAD_H) for h in HEIGHTS])

    def step_wall_ms(n: int) -> float:
        """Host wall time of one device step at batch n, synchronized."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._device_step(batch[:n], valid_h[:n], rows[:n], pack=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        # batch 5 is a launch shape no pass has run: its first step pays
        # the per-shape set-up (cuDNN plan selection) the ladder avoids
        cold5_ms = step_wall_ms(5)
        warm5_ms = statistics.median(step_wall_ms(5) for _ in range(5))
        warm8_ms = statistics.median(step_wall_ms(BATCH) for _ in range(5))
        step_ms = time_ms(torch, lambda: engine._device_step(
            batch, valid_h, rows, pack=True), reps=5)
        step6_ms = time_ms(torch, lambda: engine._device_step(
            batch[:6], valid_h[:6], rows[:6], pack=True), reps=5)
    log(f"profile: device step alone {step_ms:.3f} ms per batch of "
        f"{BATCH} at {PAD_H}x{WIDTH} = {BATCH / step_ms * 1e3:.1f} "
        f"images/s ceiling")
    log(f"profile: device step at batch 6 {step6_ms:.3f} ms, against "
        f"{step_ms:.3f} ms for the same 6 images padded to batch {BATCH} "
        f"by the power-of-two ladder")
    log(f"profile: first step at the unseen batch 5 {cold5_ms:.3f} ms wall, "
        f"warm {warm5_ms:.3f} ms wall (median of 5): a one-off "
        f"{cold5_ms - warm5_ms:.3f} ms per new shape, against "
        f"{warm8_ms - warm5_ms:.3f} ms per launch for padding 5 images to "
        f"batch {BATCH} ({warm8_ms:.3f} ms wall)")


def check_bf16_step(torch, bf16, f32, items) -> None:
    """The bf16 engine's device step (bf16 convs, channels_last) against
    the float32 engine's (TF32 off) on one ragged batch, before any
    postprocess. The stride-8 logits over the valid rows must agree within
    BF16_LOGIT_TOL of the float32 logits' spread; a class-map pixel may
    differ only where the float32 top-2 margin is under twice the largest
    change the measured logit error can make after the upsample (the
    error times the largest absolute row sum of the row and the column
    operators)."""
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax)

    dev = bf16.device
    n = len(items)
    heights = [it.image.shape[0] for it in items]
    batch = torch.from_numpy(bf16._pad_group(items, PAD_H, n)).to(dev)
    valid_h = torch.tensor(heights, dtype=torch.int32, device=dev)
    rows = torch.stack([bf16._row_op_dev(h, PAD_H) for h in heights])
    colt = bf16._colt_dev(WIDTH // 8, WIDTH)
    with torch.inference_mode():
        lo16 = bf16._logits(batch, valid_h)
        lo32 = f32._logits(batch, valid_h)
        map16 = upsample_argmax(lo16, rows, colt)
        planes = torch.einsum("bof,bfwc->bcow", rows, lo32)
        up32 = torch.einsum("bcow,wp->bcop", planes, colt)
    top2 = up32.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    map32 = up32.argmax(dim=1).to(torch.uint8)
    err = spread = 0.0
    flips = near = total = 0
    worst = 0.0
    gain = (float(rows.abs().sum(dim=2).max())
            * float(colt.abs().sum(dim=0).max()))
    for i, h in enumerate(heights):
        fh = bf16.model.backbone.valid_feature_height(h)
        err = max(err, float((lo16[i, :fh] - lo32[i, :fh]).abs().max()))
        spread = max(spread, float(lo32[i, :fh].std()))
    allowed = 2 * gain * err
    for i, h in enumerate(heights):
        differ = map16[i, :h] != map32[i, :h]
        flips += int(differ.sum())
        near += int((margin[i, :h] < allowed).sum())
        total += h * WIDTH
        if bool(differ.any()):
            worst = max(worst, float(margin[i, :h][differ].max()))
        if h < PAD_H and bool((map16[i, h:] != 0).any()):
            raise AssertionError(f"bf16 step: padded rows of image {i} "
                                 f"are not 0")
    log(f"bf16 step vs float32 step: logit max abs err {err:.5g} "
        f"({err / spread:.5f} of the float32 logits' std {spread:.5g}, "
        f"allowed {BF16_LOGIT_TOL}); {flips} of {total} pixels flipped "
        f"({flips / total:.6f}), largest flipped float32 margin "
        f"{worst:.5g}, allowed < {allowed:.5g} (operator gain "
        f"{gain:.4f}); {near} pixels ({near / total:.6f}) lie under that "
        f"margin")
    if err > BF16_LOGIT_TOL * spread:
        raise AssertionError(f"bf16 logits differ from float32 by {err}, "
                             f"above {BF16_LOGIT_TOL} x {spread}")
    if flips and worst >= allowed:
        raise AssertionError(f"bf16 class map flips a pixel whose float32 "
                             f"margin {worst} is >= {allowed}")


def phase_reference(torch, main: dict) -> None:
    """The engine against a per-image reference on the card: each image
    alone, unpadded, through the float32 folded model and the plain
    upsample, then the same native postprocess. The float32 engine (TF32
    off, ragged batches, the kernel) must agree on >= 99.9% of pixels;
    the bf16 engine's agreement is printed and must be >= 95%. The bf16
    device step is also held against the float32 one before the
    postprocess (check_bf16_step)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import (
        load_image_u8, remove_small_zones_host2)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    samples = os.path.join(main["root"], "processed", "samples", "sapin")
    items = [ProcessedImage(load_image_u8(os.path.join(
        samples, f"img{i:02d}.png")), f"img{i:02d}.png", "sapin")
        for i in range(4)]
    f32 = NeuralBarkCalculator(
        main["ckpt"], config=PredictConfig(model_path=main["ckpt"],
                                           use_bfloat16=False),
        device=main["engine"].device)
    ref = []
    with torch.inference_mode():
        for it in items:
            x = torch.from_numpy(it.image).to(f32.device).float() / 255.0
            x = (x - f32.mean) / f32.std
            cmap = f32.model(x[None]).argmax(-1).to(torch.uint8).cpu()
            cleaned, _ = remove_small_zones_host2(
                cmap.numpy(), cmap.shape[2],
                np.array([it.image.shape[0]], np.int32))
            ref.append(cleaned[0])
    for label, engine, floor in (("float32", f32, 0.999),
                                 ("bf16", main["engine"], 0.95)):
        got = {it.fname: m for it, m in engine.predict_images(items)}
        agree = sum(int((got[it.fname] == r).sum())
                    for it, r in zip(items, ref))
        total = sum(r.size for r in ref)
        log(f"reference check ({label} engine vs per-image float32): "
            f"{agree / total:.6f} pixel agreement over {len(items)} images")
        if agree / total < floor:
            raise AssertionError(f"{label} engine agrees with the reference "
                                 f"on {agree / total:.6f} < {floor}")
    check_bf16_step(torch, main["engine"], f32, items)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(REPO, "neuralbarkcalculator_tpu_torch")):
        print("chip_smoke: the neuralbarkcalculator_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    card = phase_build()
    kernel = phase_kernel(torch, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_path = phase_main_path(torch, args.seed, workdir)
        kernel["launches"] = main_path["launches"]
        phase_profile(torch, main_path)
        phase_reference(torch, main_path)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
