#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phase 1 builds every native piece from this checkout (one library per
CUDA kernel source in neuralbarkcalculator_tpu_torch/csrc/ with nvcc for
sm_90a, and the host IO runtime from native/barkio.cc with g++), one
compiler each, all started together, prints each kernel's registers,
spills and shared memory from ptxas, and the card's name and power limit.

Phase 2 holds each kernel against its plain PyTorch version at its path's
shapes and times the kernel, the plain version and the PyTorch yardstick
by profiler device time: upsample_argmax at the mixed 8x1024x1024 batch
(and at small dense operators, and at a uniform batch against one
F.interpolate + argmax call), and fused_dropout_matmul forward and
backward at the training head's [5, 512, 64, 64] -> 3, rate 0.8 (the
dropout mask bit for bit; two calls bitwise equal; shapes that miss every
tile at 1, 3 and 4 classes and rates 0 and 0.8; the integer instructions
of a step of each kernel's loop, counted in its SASS, from which an
estimate of the integer pipe's time is printed beside the byte bound).
upsample_argmax is also held at the EfficientNet path's stride-32 logits
(8 images at heights 896/960/1024, F = 28/30/32, Wf = 32, and at width
1000), and its 1024 x 1024 case timed. Each timing window's device events
are counted against what the function launches.

Phase 3 drives the predict path, folder prediction, through the engine a
user calls: a synthetic folder of 16 processed 1024-wide images at trimmed
heights 896/960/1024, a full-width fcn_resnet50 with random weights drawn
from the seed (bf16, BN folded, batch 8). It checks the artifacts, that
upsample_argmax was launched during the timed pass, profiles one more
pass for the device's busy share, and holds the engine's maps against a
per-image float32 reference on the card.

Phase 4 drives the training path through cli/train.main: a synthetic
30-image 1024x1024 dataset with duals, the full-width, full-depth
fcn_resnet50 at the recipe's batch 5 and crop 512, one epoch of 9 steps,
validation, test and the report. It checks the checkpoint, best_model.pt,
the report's 15 columns, finite losses and that the fused dropout kernels
ran, and prints the warm step time and the peak memory. Then one training
step on the card is held against the same step on the CPU.

Phases 5-7 run between phases 3 and 4. Phase 5, the device preprocess:
10 synthetic BMP scans from the seed (8 at 4096 x 4096 over two wood
types with dark bands of their own heights, one 3072 x 4096 resized and
trimmed, one 1000 x 1024 neither) through Preprocessor(backend="device")
on the card and backend="host", held to the same names and shapes, max
|diff| <= 1 on under 1e-3 of the values; a warm pass of each, the resize
products' device time for 4 scans against their float32 FLOP bound, the
bytes uploaded and what 'auto' picks. Phase 6, cli/predict.main over the
scans with the device preprocess, then --resume (no launch, the CSV byte
for byte), then --resume with 3 images' artifacts deleted (exactly those
written again, the CSV byte for byte). Phase 7, serving through
cli/serve.make_server with the predict path's checkpoint (bf16, batch 8,
25 ms, fixed height 1024): warm-up, 16 sequential and 8 x 4 concurrent
JSON requests of the phase 3 images, a raw scan, mask / combined /
exclude_nodes answers, /healthz and /v1/stats, every answer's numbers and
the launch shapes checked; then a --float32 server's masks against a
direct predict_images call (>= 99.9 % of pixels).

The zoo phase runs after phase 7: fcn_resnet101, deeplabv3_resnet50,
deeplabv3_resnet101, fcn_efficientnet_b0 and deeplabv3_efficientnet_b7
at full width and depth with random weights from the seed, each through
the engine over the phase 3 folder (bf16, BN folded, batch 8: a warm
pass, a timed pass with upsample_argmax launched, a profiled pass, the
device step alone), held against a per-image float32 reference (the
float32 engine >= 99.9 % of pixels, the bf16 step within the logit bound);
the DeepLab head's atrous convs timed against cuDNN's dilated conv; a
bucketed-height fcn_efficientnet_b0 pass (at most one launch shape per
bucket and ladder batch); and one served request each for
deeplabv3_resnet50 and fcn_efficientnet_b0. Every phase prints its wall
time.

Every path runs with all launch counts set to 0 just before it and read
just after. The last lines are the kernels' JSON line, the card's name and
power limit, and the result line. The script exits nonzero, with no result line,
when there is no CUDA device, when the port's package is not beside it, or
when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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
# F.interpolate's bicubic computes its own float32 coefficients, so its map
# may differ from the kernel's at pixels whose margin is below this.
INTERP_MARGIN = 1e-4
# The bf16 engine's stride-8 logits may differ from the float32 engine's by
# at most this fraction of the float32 logits' standard deviation: about
# twice the 0.206 measured on an H100 with --seed 0. The random weights
# give logits with a small spread beside a large common offset that the
# head's bias cancels, and bf16 rounds relative to that offset.
BF16_LOGIT_TOL = 0.4
# A reference pixel counts as a near tie where its float32 top-2 margin is
# below this share of the image's largest |logit| (the bound between the
# port and the JAX package in the CPU tests).
REF_NEAR_TIE = 1e-4
# The training head's fused dropout + 1x1 conv: h [5, 512, 64, 64] -> 3
# classes (batch 5 at crop 512, output stride 8), the recipe's rate.
FDM_SHAPE = (5, 512, 64, 3)  # (B, C, H = W, K)
FDM_RATE = 0.8
# Shapes that miss every tile of the kernels (72 channels: not a multiple
# of 16; 60 x 60 = 3600 pixels: not a multiple of 32 or 1024), each class
# count and rate 0 (the identity) and the recipe's.
FDM_ODD_SHAPE = (1, 72, 60, 60)  # (B, C, H, W)
FDM_ODD_CLASSES = (1, 3, 4)
FDM_ODD_RATES = (0.0, 0.8)
# CUDA events around back-to-back wrapper calls timed the forward at
# 0.0385, 0.0613 and 0.0660 ms in three rounds of one run on an H100 at
# constant clocks: they timed the host. The fused kernels are timed by
# device time, in rounds, each beside the card's clocks.
FDM_TIMING_ROUNDS = 3
# Idle time at each end of a device_times window: one run's middle round
# read the forward 11 % low and the backward 6 % high beside two steady
# rounds, as events crossing windows would.
DEVICE_TIMES_MARGIN_S = 0.005
# The training phase's synthetic dataset: 10 images per wood type (so the
# 80/10/10 split gives 24/3/3), 1024x1024; a samples factor of 2 gives
# 24 * 2 // 5 = 9 train steps.
TRAIN_PER_TYPE = 10
TRAIN_SIZE = 1024
TRAIN_SAMPLES_FACTOR = 2
# The card-against-CPU check of one training step. The head's weight
# gradient is a sum over 2048 feature pixels of products that largely
# cancel, after 53 float32 layers that sum in other orders on the two
# devices. Measured on an H100 (--seed 0): card vs CPU 3.08e-4 of its
# largest entry; the CPU against itself on inputs moved by 1e-6, 3.45e-4;
# the CPU with the next dropout seed, 1.13. So the bound is 1e-3, and the
# check requires another mask to move it by more than 10x that.
CHECK_BATCH = 2
CHECK_CROP = 256
STEP_GRAD_TOL = 1e-3
# The device-preprocess phase: SCAN_PER_TYPE square SCAN_SIZE scans per
# wood type, each with dark bands at top and bottom, plus a 3072 x 4096
# scan (resized to 1024^2, then trimmed) and a 1000 x 1024 source
# (neither resized nor trimmed), both as (name, height, width).
SCAN_SIZE = 4096
SCAN_PER_TYPE = 4
SCAN_WOODS = ("epinette_gelee", "sapin")
SCAN_EXTRA = (("wide.bmp", 3072, 4096), ("small.bmp", 1000, 1024))
PRE_TARGET = 1024
PRE_BATCH = 4
# The JAX package's bound between its device and host backends
# (tests/test_pipeline.py): max |diff| <= 1 on under this share of values.
PRE_DIFF_SHARE = 1e-3
# Images whose dual and figure PNGs the second resumed CLI run finds gone.
RESUME_DELETE = 3
# The zoo phase: every other factory family at full width and depth, with
# the widest backbone among them (B7, 2560 feature channels).
ZOO = ("fcn_resnet101", "deeplabv3_resnet50", "deeplabv3_resnet101",
       "fcn_efficientnet_b0", "deeplabv3_efficientnet_b7")
# upsample_argmax on the EfficientNet path: stride-32 logits at the
# folder's exact heights (F = 28, 30, 32; Wf = 32) and a width-1000 case;
# the 1024 x 1024 case is timed.
STRIDE32_CASES = ((896, 1024), (960, 1024), (1024, 1024), (960, 1000))
STRIDE32_TIMED = (1024, 1024)
# The serving phase: batch, the first request's wait, and the concurrent
# traffic (tools/serving_bench.py's shape: clients x requests each).
SERVE_BATCH = 8
SERVE_WAIT_MS = 25
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_clocks() -> str:
    """The card's SM and memory clocks and power draw, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from neuralbarkcalculator_tpu_torch.ops import fused_dropout_matmul
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import LAUNCHES

    return {"upsample_argmax": LAUNCHES,
            "fused_dropout_matmul_fwd": fused_dropout_matmul.FWD_LAUNCHES,
            "fused_dropout_matmul_bwd": fused_dropout_matmul.BWD_LAUNCHES}


def reset_counters() -> dict:
    """Every launch counter set to 0; returns them by kernel name."""
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    return counters


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


def event_device_us(e) -> float:
    """A profiler event's own device time, in microseconds."""
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def device_times(torch, fns, expect=None, warmup: int = 3, reps: int = 20,
                 attempts: int = 3
                 ) -> tuple[list[dict[str, float]], list[dict[str, int]]]:
    """The device time per call of each of `fns`, by kernel label, from one
    torch.profiler session: each fn's `reps` calls, after `warmup` calls of
    it, run inside a record_function window, and the device events
    (kernels and copies) that start inside it are its own. The window
    holds DEVICE_TIMES_MARGIN_S of idle time at each end, and the warm-up
    calls end that long before it, so a drift of the device clock against
    the host's below that margin moves no event across a window's edge.
    Each window's events are counted by label: where `expect` gives a fn's
    events per call by label (the port's kernels), the window must hold
    exactly `reps` times that; for the others (torch's own calls) each
    label's count must be a multiple of `reps`. A window that lost or
    gained events at an edge fails that.
    One session for many fns, and few events in each: on an H100 a process
    that had opened some twenty sessions saw every later one record no
    device event, and a session that also held the plain versions' ~16,000
    kernels twice recorded none for 2 of its 8 fns. A session that fails a
    count is run again, up to `attempts` sessions. Returns each fn's device
    ms per call and its event counts, by label."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    expect = expect or [None] * len(fns)
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i, fn in enumerate(fns):
                for _ in range(warmup):
                    fn()
                torch.cuda.synchronize()
                time.sleep(DEVICE_TIMES_MARGIN_S)
                with record_function(f"device_times_{i}"):
                    time.sleep(DEVICE_TIMES_MARGIN_S)
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    time.sleep(DEVICE_TIMES_MARGIN_S)
        events = prof.events()
        windows = [(e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("device_times_")]
        out: list[dict[str, float]] = [{} for _ in fns]
        counts: list[dict[str, int]] = [{} for _ in fns]
        for e in events:
            if e.device_type != DeviceType.CUDA or e.is_user_annotation \
                    or e.name.startswith("device_times_"):
                continue
            for i, (lo, hi) in enumerate(windows):
                if lo <= e.time_range.start <= hi:
                    label = kernel_label(e.name)
                    out[i][label] = (out[i].get(label, 0.0)
                                     + e.time_range.elapsed_us() / reps / 1e3)
                    counts[i][label] = counts[i].get(label, 0) + 1
                    break
        bad = [i for i, (n, want) in enumerate(zip(counts, expect))
               if not n or (n != {k: reps * v for k, v in want.items()}
                            if want else any(v % reps for v in n.values()))]
        if len(windows) == len(fns) and not bad:
            return out, counts
        log(f"device_times: profiler session {attempt + 1}: functions {bad} "
            f"of {len(fns)} recorded {[counts[i] for i in bad]} device "
            f"events in {reps} calls (expected per call: "
            f"{[expect[i] for i in bad]}, None: a multiple of {reps})")
    raise RuntimeError(f"the profiler did not record every function's device "
                       f"events in {attempts} sessions")


def same_counts(name: str, counts_by_round: list[list[dict[str, int]]]
                ) -> None:
    """Raise unless every round of `device_times` counted the same device
    events, by label, for each function."""
    for i, per_round in enumerate(zip(*counts_by_round)):
        if any(c != per_round[0] for c in per_round):
            raise AssertionError(f"{name} timing: function {i} recorded "
                                 f"other device events in other rounds: "
                                 f"{per_round}")


def kernel_label(mangled: str) -> str:
    """`fdm_forward_kernel<3>` from a kernel's name, mangled or not (the
    name itself where no port kernel is found in it)."""
    m = re.search(r"((?:fdm|upsample)_[a-z_]*?kernel)(?:ILi(\d+)E|<(\d+)>)?",
                  mangled)
    if not m:
        return mangled
    k = m.group(2) or m.group(3)
    return m.group(1) + (f"<{k}>" if k else "")


def ptxas_report(text: str) -> dict[str, str]:
    """Each kernel's registers, spills and shared memory from a `-Xptxas
    -v` log, by kernel."""
    out: dict[str, list[str]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)", line)
        if m:
            kernel = kernel_label(m.group(1))
        elif kernel and ("spill" in line or "registers" in line):
            out.setdefault(kernel, []).append(line.split(":", 1)[-1]
                                              .strip())
    return {k: "; ".join(v) for k, v in out.items()}


# The opcodes of the SM's integer pipes, and the rate assumed for each of
# them: 64 a clock per SM (4 x 16 INT32 lanes), IMAD.WIDE (a 64-bit
# result) included, which is not checked on the card.
INT_OPCODES = ("IMAD", "IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP",
               "SEL", "PRMT", "IMNMX", "IABS")
H100_INT_OPS_PER_CLOCK_PER_SM = 64


def step_loop_sass(lib_path: str, kernel: str) -> tuple[dict[str, float],
                                                        int]:
    """The opcodes one step of a kernel's main loop issues, from its SASS
    (`cuobjdump -sass`): the loop is the backward branch whose body holds
    the most `DEPBAR` waits (one cp.async wait a step), and its opcodes,
    NOPs left out, are divided by the steps it is unrolled to. Returns
    that histogram and the steps in the body."""
    from neuralbarkcalculator_tpu_torch.utils.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    code: list[tuple[int, str, str]] = []  # (address, opcode, operands)
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel_label(line.split("Function :")[1].strip()) == kernel
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)\s*([^;]*)", line)
        if inside and m and m.group(2) != "NOP":
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best: list[str] = []
    steps = 0
    for addr, op, operands in code:
        target = re.match(r"0x([0-9a-f]+)", operands)
        if op.split(".")[0] == "BRA" and target \
                and int(target.group(1), 16) < addr:
            body = [o for a, o, _ in code
                    if int(target.group(1), 16) <= a <= addr]
            waits = sum(o.startswith("DEPBAR") for o in body)
            if waits > steps:
                best, steps = body, waits
    if not steps:
        raise RuntimeError(f"no cp.async step loop in the SASS of {kernel} "
                           f"in {lib_path}")
    hist: dict[str, float] = {}
    for op in best:
        hist[op] = hist.get(op, 0.0) + 1.0 / steps
    return hist, steps


def phase_build() -> str:
    """Build every kernel library and the native runtime, one compiler
    each, all started together; returns the card's `name, power.limit`
    line."""
    from neuralbarkcalculator_tpu_torch.utils.build import (
        build_kernel, build_log, build_native, kernel_names)

    names = kernel_names()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        kerns = {n: pool.submit(build_kernel, n) for n in names}
        native = pool.submit(build_native)
        paths = {n: f.result() for n, f in kerns.items()}
        paths["barkio"] = native.result()
    log(f"built {[os.path.relpath(p, REPO) for p in paths.values()]} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in names:
        for kernel, props in ptxas_report(build_log(paths[name])).items():
            log(f"ptxas ({name}) {kernel}: {props}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return card


def check_map(torch, name: str, got, want, feat, rows, colt,
              allowed: float) -> tuple[int, float]:
    """Hold a class map against another: they may differ only at pixels
    whose top-2 float32 logit margin (two einsums) is below `allowed`.
    Returns the number of differing pixels and their largest margin."""
    planes = torch.einsum("bof,bfwc->bcow", rows, feat)
    logits = torch.einsum("bcow,wp->bcop", planes, colt)
    top2 = logits.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = got != want
    n = int(differ.sum())
    worst = float(margin[differ].max()) if n else 0.0
    log(f"upsample_argmax {name}: {n} of {got.numel()} pixels differ "
        f"(largest margin among them {worst:.3g}, allowed < {allowed})")
    if n and worst >= allowed:
        raise AssertionError(f"upsample_argmax {name}: a pixel with margin "
                             f"{worst} >= {allowed} differs")
    return n, worst


def band_ops(torch, rows, colt) -> int:
    """The float32 operations the inputs need when each operator row and
    column is summed over its nonzero window only: the row side, each
    row's window x Wf x 3 planes; the column side, for each row that is not
    all zero, every column's window x 3 planes; 2 operations per FMA."""
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        operator_windows)

    lo, hi = operator_windows(rows)
    row_taps = int((hi - lo).sum())
    live_rows = int((hi > 0).sum())
    clo, chi = operator_windows(colt.t())
    col_taps = int((chi - clo).sum())
    return 2 * 3 * (row_taps * colt.shape[0] + live_rows * col_taps)


def phase_kernel(torch, seed: int) -> dict:
    """upsample_argmax on the card: against upsample_argmax_plain at the
    main path's mixed batch and at small dense operators, against one
    F.interpolate + argmax call at a uniform batch, then timed by device
    time (the kernel, the plain version, two matmuls + argmax at the mixed
    batch; the kernel and F.interpolate + argmax at the uniform batch) in
    FDM_TIMING_ROUNDS rounds beside the card's clocks."""
    import numpy as np
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.models.resnet import resnet50_dilated
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        column_operator_t, embedded_bicubic_rows)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        column_windows, upsample_argmax, upsample_argmax_plain)

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
    # computed once per width operator, as the engine caches it
    col_win = column_windows(colt)

    # the main path's mixed batch: equal to the plain version up to
    # float32 near-ties, padded rows 0
    got = upsample_argmax(feat, rows, colt, col_win)
    torch.cuda.synchronize()
    want = upsample_argmax_plain(feat, rows, colt)
    flips, _ = check_map(torch, "mixed batch vs plain", got, want, feat,
                         rows, colt, FLIP_MARGIN)
    max_abs_err = int((got.int() - want.int()).abs().max())
    for i, h in enumerate(HEIGHTS):
        if h < PAD_H and bool((got[i, h:] != 0).any()):
            raise AssertionError(f"padded rows of image {i} are not 0")

    # dense operators at a small shape: the windows are found from the
    # values (the whole axis here), not assumed; odd F and OW take the
    # kernel's scalar copy and byte store paths; logits ~ N(0, 1)
    db, doh, dfh, dwf, dow = 2, 70, 23, 20, 200
    d_feat = torch.from_numpy(rng.standard_normal(
        (db, dfh, dwf, 3), dtype=np.float32)).to(dev)
    d_rows = torch.from_numpy(rng.standard_normal(
        (db, doh, dfh), dtype=np.float32) / np.float32(np.sqrt(dfh))).to(dev)
    d_colt = torch.from_numpy(rng.standard_normal(
        (dwf, dow), dtype=np.float32) / np.float32(np.sqrt(dwf))).to(dev)
    d_got = upsample_argmax(d_feat, d_rows, d_colt)
    torch.cuda.synchronize()
    check_map(torch, "dense operators vs plain", d_got,
              upsample_argmax_plain(d_feat, d_rows, d_colt), d_feat, d_rows,
              d_colt, FLIP_MARGIN)

    # a uniform batch (every image 1024 rows): the same function as one
    # F.interpolate(bicubic) + argmax call, up to that call's own float32
    # coefficients at near-ties
    u_rows = torch.from_numpy(np.stack([embedded_bicubic_rows(
        backbone.valid_feature_height(PAD_H), PAD_H, f, PAD_H)] * BATCH)).to(
            dev)
    planes_nchw = feat.permute(0, 3, 1, 2)

    def interpolate():
        return F.interpolate(planes_nchw, size=(PAD_H, WIDTH), mode="bicubic",
                             align_corners=False).argmax(1)

    u_got = upsample_argmax(feat, u_rows, colt, col_win)
    interp_differ, interp_margin = check_map(
        torch, "uniform batch vs F.interpolate + argmax", u_got,
        interpolate().to(torch.uint8), feat, u_rows, colt, INTERP_MARGIN)

    def library():
        y = torch.matmul(torch.matmul(rows[:, None], feat.permute(0, 3, 1, 2)),
                         colt)
        return y.argmax(dim=1).to(torch.uint8)

    fns = (lambda: upsample_argmax(feat, rows, colt, col_win),
           lambda: upsample_argmax_plain(feat, rows, colt),
           library,
           lambda: upsample_argmax(feat, u_rows, colt, col_win),
           interpolate)
    one = {"upsample_argmax_kernel": 1}
    rounds, counts = [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, (one, None, None, one, None))
        rounds.append([sum(t.values()) for t in times])
        counts.append(n)
        log(f"upsample_argmax timing round {r + 1} (device ms per call): "
            f"mixed batch kernel {rounds[-1][0]:.4f}, plain "
            f"{rounds[-1][1]:.4f}, two matmuls + argmax {rounds[-1][2]:.4f}; "
            f"uniform batch kernel {rounds[-1][3]:.4f}, F.interpolate + "
            f"argmax {rounds[-1][4]:.4f}; clocks.sm, clocks.mem, power.draw "
            f"after it: {card_clocks()}")
    same_counts("upsample_argmax", counts)
    ms, plain_ms, library_ms, uniform_ms, interp_ms = (
        statistics.median(col) for col in zip(*rounds))

    ops = band_ops(torch, rows, colt)
    nbytes = (4 * (feat.numel() + rows.numel() + colt.numel())
              + BATCH * PAD_H * WIDTH)
    op_ms = ops / H100_F32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES * 1e3
    bound = max(op_ms, byte_ms)
    log(f"upsample_argmax [{BATCH}x{PAD_H}x{WIDTH}, mixed]: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, two matmuls + argmax "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms ({ops / 1e9:.4f} GFLOP "
        f"over the windows, {nbytes / 1e6:.3f} MB; {bound / ms:.3f} of it); "
        f"uniform batch: kernel {uniform_ms:.4f} ms, F.interpolate + argmax "
        f"{interp_ms:.4f} ms")
    return {
        "name": "upsample_argmax", "route": "cuda",
        "source": "neuralbarkcalculator_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "neuralbarkcalculator_tpu/ops/pallas_kernels.py:64",
        "launches": 0, "max_abs_err": max_abs_err, "flips": flips,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
        "uniform_ms": uniform_ms, "interpolate_ms": interp_ms,
        "interpolate_differ": interp_differ,
        "interpolate_worst_margin": interp_margin,
    }


def check_fdm(torch, label: str, h, w, bias, g, dseed: int, rate: float,
              keep_range: tuple[float, float] | None = None) -> dict:
    """Both fused_dropout_matmul kernels against their plain versions on
    one input: the mask bit for bit (with w = g = 1, dh is K/keep where
    kept and 0 where dropped), dh exactly 0 where dropped, y, dh, dw and db
    within the stated tolerances. Returns the outputs and the errors."""
    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        dropout_mask, fused_dropout_matmul_backward,
        fused_dropout_matmul_backward_plain, fused_dropout_matmul_forward,
        fused_dropout_matmul_plain)

    dh1, _, _ = fused_dropout_matmul_backward(
        h, torch.ones_like(w), torch.ones_like(g), dseed, rate)
    torch.cuda.synchronize()
    mask = dropout_mask(h.shape, dseed, rate, h.device)
    kept = mask != 0
    mask_diff = int(((dh1 != 0) != kept).sum())
    keep_frac = float(kept.float().mean())
    if mask_diff:
        raise AssertionError(f"fused_dropout_matmul {label}: the kernel's "
                             f"dropout mask differs from the plain "
                             f"version's at {mask_diff} elements")
    if keep_range and not keep_range[0] <= keep_frac <= keep_range[1]:
        raise AssertionError(f"fused_dropout_matmul {label}: keep fraction "
                             f"{keep_frac} outside {keep_range}")

    y = fused_dropout_matmul_forward(h, w, bias, dseed, rate)
    dh, dw, db = fused_dropout_matmul_backward(h, w, g, dseed, rate)
    torch.cuda.synchronize()
    y_p = fused_dropout_matmul_plain(h, w, bias, dseed, rate)
    dh_p, dw_p, db_p = fused_dropout_matmul_backward_plain(h, w, g, dseed,
                                                           rate)
    # y: a sum over C channels in another order; 1e-5 of max|y|
    y_err = float((y - y_p).abs().max())
    y_tol = 1e-5 * float(y_p.abs().max())
    # dh: exactly 0 where dropped; elsewhere a K-term sum in another order,
    # held to 1e-6 of the sum of its terms' magnitudes
    dh_err = float((dh - dh_p).abs().max())
    terms = torch.einsum("bkhw,ck->bchw", g.abs(), w.abs()) * mask
    dh_excess = float(((dh - dh_p).abs() - 1e-6 * terms).max())
    dh_dropped = int((dh[~kept] != 0).sum())
    # dw: a sum over B*H*W pixels per entry in another order, 1e-4 of
    # max|dw|; db: the same sum of g, in the kernel's order (a lane's 32
    # quads, 8 lanes, then the segments' rows: at most ~60 roundings deep,
    # so within ~60 * 2^-24 = 3.6e-6 of the sum of its terms' magnitudes),
    # against torch's own order: 1e-5 of that sum
    dw_err = float((dw - dw_p).abs().max())
    dw_tol = 1e-4 * float(dw_p.abs().max())
    db_err = float((db - db_p).abs().max())
    db_tol = 1e-5 * float(g.abs().sum(dim=(0, 2, 3)).max())
    log(f"fused_dropout_matmul {label} [{'x'.join(map(str, h.shape))} -> "
        f"{w.shape[1]}, rate {rate}]: 0 of {mask.numel()} keep decisions "
        f"differ (keep fraction {keep_frac:.5f}); y max abs err {y_err:.4g} "
        f"(allowed {y_tol:.4g}); dh max abs err {dh_err:.4g}, {dh_dropped} "
        f"nonzero at dropped elements; dw max abs err {dw_err:.4g} (allowed "
        f"{dw_tol:.4g}); db max abs err {db_err:.4g} (allowed {db_tol:.4g})")
    if y_err > y_tol or dh_excess > 0 or dh_dropped or dw_err > dw_tol \
            or db_err > db_tol:
        raise AssertionError(f"fused_dropout_matmul {label} differs from "
                             f"its plain version beyond the stated "
                             f"tolerances")
    return {"y": y, "dh": dh, "dw": dw, "db": db, "y_err": y_err,
            "dh_err": dh_err}


def fdm_inputs(torch, rng, b_: int, c_: int, hh: int, ww: int, k_: int):
    """h, w, bias, g drawn from `rng` on the card, and a full 64-bit seed."""
    import numpy as np

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()

    return (draw(b_, c_, hh, ww), draw(c_, k_), draw(k_),
            draw(b_, k_, hh, ww), int(rng.integers(0, 2 ** 63)) * 2 + 1)


def integer_pipe_ms(torch, k_: int, elements: int) -> dict[str, tuple]:
    """An estimate, not a bound, of each fused_dropout_matmul kernel's
    integer-pipe time at `elements` elements of h: a step of either kernel
    (one lane: one Philox4x32-10 call, 4 elements) issues the integer
    instructions its step loop's SASS holds (`step_loop_sass`), at the
    assumed H100_INT_OPS_PER_CLOCK_PER_SM and the card's maximum SM clock;
    and the same with every IMAD.WIDE counted twice, in case the 64-bit
    multiply issues at half that rate. Returns, per direction, the two
    times in ms and the step's histogram."""
    from neuralbarkcalculator_tpu_torch.utils.build import build_kernel

    lib_path = build_kernel("fused_dropout_matmul")
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = sms * H100_INT_OPS_PER_CLOCK_PER_SM * max_mhz * 1e3
    out = {}
    for direction in ("forward", "backward"):
        kernel = f"fdm_{direction}_kernel<{k_}>"
        hist, steps = step_loop_sass(lib_path, kernel)
        ints = sum(v for op, v in hist.items() if op.startswith(INT_OPCODES))
        wide = sum(v for op, v in hist.items() if op.startswith("IMAD.WIDE"))
        lo = elements // 4 * ints / per_ms
        hi = elements // 4 * (ints + wide) / per_ms
        log(f"{kernel}: a step of its loop ({steps} unrolled) issues "
            f"{sum(hist.values()):.2f} instructions, {ints:.2f} integer "
            f"({wide:.2f} IMAD.WIDE): "
            f"{dict((op, round(v, 2)) for op, v in sorted(hist.items()))}")
        log(f"{kernel}: integer pipe, estimated: {elements // 4} steps x "
            f"{ints:.2f} / ({sms} SMs x {H100_INT_OPS_PER_CLOCK_PER_SM} a "
            f"clock x {max_mhz:.0f} MHz) = {lo:.4f} ms; {hi:.4f} ms with "
            f"IMAD.WIDE at half rate")
        out[direction] = (lo, hi, hist)
    return out


def phase_fdm_kernel(torch, seed: int) -> list[dict]:
    """fused_dropout_matmul's forward and backward kernels against their
    plain versions on the card: at the training head's shapes (h [5, 512,
    64, 64], K = 3, rate 0.8), twice, bitwise equal; at shapes that miss
    every tile (FDM_ODD_SHAPE, each of FDM_ODD_CLASSES and FDM_ODD_RATES).
    Then timed, with an estimate of the integer pipe's time from the
    kernels' SASS beside the byte bound."""
    import numpy as np
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        fused_dropout_matmul_backward, fused_dropout_matmul_backward_plain,
        fused_dropout_matmul_forward, fused_dropout_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    b_, c_, hw, k_ = FDM_SHAPE
    rate = FDM_RATE
    h, w, bias, g, dseed = fdm_inputs(torch, rng, b_, c_, hw, hw, k_)
    main = check_fdm(torch, "main shape", h, w, bias, g, dseed, rate,
                     (0.18, 0.22))
    # determinism: a second call gives the same bits
    again = check_fdm(torch, "main shape, again", h, w, bias, g, dseed, rate)
    same = {n: torch.equal(main[n], again[n]) for n in ("y", "dh", "dw", "db")}
    log(f"fused_dropout_matmul: two calls at the main shape bitwise equal: "
        f"{same}")
    if not all(same.values()):
        raise AssertionError(f"fused_dropout_matmul is not deterministic: "
                             f"{same}")
    for odd_k in FDM_ODD_CLASSES:
        for odd_rate in FDM_ODD_RATES:
            check_fdm(torch, "odd shape",
                      *fdm_inputs(torch, rng, *FDM_ODD_SHAPE, odd_k), odd_rate,
                      (0.18, 0.22) if odd_rate else (1.0, 1.0))

    # times: device time per call from the profiler (a ~0.03 ms kernel
    # behind a Python wrapper leaves the card idle between back-to-back
    # calls, so CUDA events around them time the host), for the kernels,
    # the library yardstick (F.dropout + a 1x1 F.conv2d through autograd),
    # the plain versions, and what the card's memory gives torch's own
    # kernels for the kernels' main traffic (h summed: h read once; h
    # copied: h read and written once), in FDM_TIMING_ROUNDS rounds beside
    # the card's clocks; then the medians.
    hl = h.clone().requires_grad_(True)
    h_copy = torch.empty_like(h)
    w4 = w.t().reshape(k_, c_, 1, 1).contiguous().requires_grad_(True)
    bl = bias.clone().requires_grad_(True)

    def lib_fwd():
        return F.conv2d(F.dropout(hl, rate, training=True), w4, bl)

    y_lib = lib_fwd()
    fns = (lambda: fused_dropout_matmul_forward(h, w, bias, dseed, rate),
           lambda: fused_dropout_matmul_backward(h, w, g, dseed, rate),
           lambda: lib_fwd().detach(),
           lambda: torch.autograd.grad(y_lib, (hl, w4, bl), g,
                                       retain_graph=True),
           h.sum,
           lambda: h_copy.copy_(h))
    # ~400 kernels a call each, ~6 ms: a few calls suffice
    plain_fns = (lambda: fused_dropout_matmul_plain(h, w, bias, dseed, rate),
                 lambda: fused_dropout_matmul_backward_plain(h, w, g, dseed,
                                                             rate))
    # the op's events per call: the forward one kernel, the backward the
    # kernel and the sum of its partials
    expect = ({f"fdm_forward_kernel<{k_}>": 1},
              {f"fdm_backward_kernel<{k_}>": 1,
               "fdm_backward_reduce_kernel": 1}, None, None, None, None)
    rounds, parts, counts = [], [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, expect)
        plain, n_plain = device_times(torch, plain_fns, warmup=1, reps=3)
        rounds.append([sum(t.values()) for t in times + plain])
        parts.append(times[:2])
        counts.append(n + n_plain)
        log(f"fused_dropout_matmul timing round {r + 1} (device ms per "
            f"call): forward {rounds[-1][0]:.4f}, backward "
            f"{rounds[-1][1]:.4f}, F.dropout + conv2d {rounds[-1][2]:.4f} / "
            f"{rounds[-1][3]:.4f}, h summed {rounds[-1][4]:.4f}, h copied "
            f"{rounds[-1][5]:.4f}, plain {rounds[-1][6]:.4f} / "
            f"{rounds[-1][7]:.4f}; clocks.sm, clocks.mem, power.draw after "
            f"it: {card_clocks()}")
    del y_lib, h_copy
    same_counts("fused_dropout_matmul", counts)
    (fwd_ms, bwd_ms, fwd_lib_ms, bwd_lib_ms, sum_ms, copy_ms, fwd_plain_ms,
     bwd_plain_ms) = (statistics.median(col) for col in zip(*rounds))
    log(f"fused_dropout_matmul: the card's memory for the main traffic, "
        f"through torch's kernels: h summed {sum_ms:.4f} ms "
        f"({4 * h.numel() / sum_ms / 1e9:.3f} TB/s), h copied "
        f"{copy_ms:.4f} ms ({8 * h.numel() / copy_ms / 1e9:.3f} TB/s)")
    for i, label in enumerate(("forward", "backward")):
        kernels = sorted({k for p in parts for k in p[i]})
        log(f"fused_dropout_matmul {label} op by kernel (device ms per call, "
            f"median of the rounds): " + ", ".join(
                f"{k} {statistics.median(p[i].get(k, 0.0) for p in parts):.4f}"
                for k in kernels))

    n_h, n_y = h.numel(), main["y"].numel()
    ops = 2 * n_h * k_
    fwd_bytes = 4 * (n_h + w.numel() + k_ + n_y)
    bwd_bytes = 4 * (n_h + w.numel() + n_y + n_h + w.numel() + k_)
    int_est = integer_pipe_ms(torch, k_, n_h)
    rows = []
    for name, ms, plain_ms, lib_ms, nbytes, nops, err, line, est in (
            ("fused_dropout_matmul_fwd", fwd_ms, fwd_plain_ms, fwd_lib_ms,
             fwd_bytes, ops, main["y_err"], 139, int_est["forward"]),
            ("fused_dropout_matmul_bwd", bwd_ms, bwd_plain_ms, bwd_lib_ms,
             bwd_bytes, 2 * ops, main["dh_err"], 148, int_est["backward"])):
        op_ms = nops / H100_F32_FLOPS * 1e3
        byte_ms = nbytes / H100_HBM_BYTES * 1e3
        bound = max(op_ms, byte_ms)
        log(f"{name} [{b_}x{c_}x{hw}x{hw} -> {k_}, rate {rate}]: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.dropout + conv2d "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB, "
            f"{nops / 1e6:.1f} MFLOP; {bound / ms:.3f} of it); integer "
            f"pipe estimated at {est[0]:.4f}-{est[1]:.4f} ms")
        rows.append({
            "name": name, "route": "cuda",
            "source": "neuralbarkcalculator_tpu_torch/csrc/"
                      "fused_dropout_matmul.cu",
            "replaces": f"neuralbarkcalculator_tpu/ops/pallas_kernels.py:"
                        f"{line}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": lib_ms,
        })
    return rows


def make_train_root(data_dir: str, seed: int) -> None:
    """TRAIN_PER_TYPE 1024x1024 samples per wood type with their duals, in
    the reference layout (samples/<wood>/, duals/<wood>/), written with the
    native PNG encoder. Samples: blobby colour fields plus fine noise;
    duals: a smooth field cut into nothing / bark / node (~50/40/10 %)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import WOOD_TYPES
    from neuralbarkcalculator_tpu_torch.io.native import save_image_u8

    rng = np.random.default_rng(seed)
    size = TRAIN_SIZE
    for wood in WOOD_TYPES:
        sdir = os.path.join(data_dir, "samples", wood)
        ddir = os.path.join(data_dir, "duals", wood)
        os.makedirs(sdir)
        os.makedirs(ddir)
        for i in range(TRAIN_PER_TYPE):
            coarse = rng.random((size // 64, size // 64, 4), dtype=np.float32)
            field = np.kron(coarse, np.ones((64, 64, 1), np.float32))
            img = field[..., :3] + 0.2 * rng.random((size, size, 3),
                                                    dtype=np.float32)
            save_image_u8(os.path.join(sdir, f"img{i:02d}.png"),
                          np.clip(img * 210, 0, 255).astype(np.uint8))
            dual = np.where(field[..., 3] < 0.5, 0,
                            np.where(field[..., 3] < 0.9, 127, 255))
            save_image_u8(os.path.join(ddir, f"img{i:02d}.png"),
                          dual.astype(np.uint8))


def phase_train(torch, seed: int, workdir: str) -> dict:
    """Training through cli/train.main on the card: the full-width, full-
    depth fcn_resnet50 at the recipe's batch 5, crop 512 and pad 1024, one
    epoch of >= 6 steps, validation, test and report. Every launch count is
    set to 0 just before and read just after."""
    import csv
    import math

    from neuralbarkcalculator_tpu_torch.cli.train import (build_parser,
                                                          main as train_main)
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_torch_checkpoint)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)

    root = os.path.join(workdir, "train_root")
    make_train_root(os.path.join(root, "Images", "1024_with_jedi"), seed)
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    exp = train_main(build_parser().parse_args(
        [root, "--seed", str(seed), "--epochs", "1", "--samples_factor",
         str(TRAIN_SAMPLES_FACTOR), "--report_dpi", str(DPI)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    steps = exp.step_count
    if steps < 6:
        raise AssertionError(f"the training run took {steps} steps, < 6")
    if not all(math.isfinite(x) for x in exp.step_losses):
        raise AssertionError(f"non-finite train losses {exp.step_losses}")
    for name in ("fused_dropout_matmul_fwd", "fused_dropout_matmul_bwd"):
        if launches[name] == 0:
            raise AssertionError(f"the training path never launched {name}")
    moar = os.path.join(root, "moar")
    for path in (os.path.join(moar, "checkpoint_epoch_1.pt"),
                 os.path.join(moar, "best_model.pt")):
        if not os.path.isfile(path):
            raise AssertionError(f"missing {path}")
    fcn_resnet50().load_state_dict(load_torch_checkpoint(
        os.path.join(moar, "best_model.pt")))
    report = os.path.join(root, "Images", "results", "moar",
                          "final_stats.csv")
    with open(report) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    n_images = 3 * TRAIN_PER_TYPE
    if len(rows) != 1 + n_images or any(len(r) != 15 for r in rows):
        raise AssertionError(f"report CSV: {len(rows) - 1} rows, column "
                             f"counts {sorted({len(r) for r in rows})}")
    warm = exp.step_seconds[1:]
    log(f"train path: {steps} steps of batch {exp.config.batch_size} at "
        f"crop {exp.config.crop_size} (fcn_resnet50, float32, TF32 off, "
        f"dropout {exp.config.dropout}) in an epoch of "
        f"{exp.history[0].time_s:.3f} s; whole CLI run {seconds:.3f} s; "
        f"launches {launches}")
    log(f"train path: step times (device clock) "
        f"{[round(s * 1e3, 3) for s in exp.step_seconds]} ms; warm steps "
        f"2..{steps}: median {statistics.median(warm) * 1e3:.3f} ms; peak "
        f"memory allocated {peak / 2 ** 30:.3f} GiB")
    log(f"train path: losses {[round(x, 6) for x in exp.step_losses]}; "
        f"epoch log {exp.history[0].as_dict()}")
    profile_train_step(torch, exp)
    return {"launches": launches, "step_ms": statistics.median(warm) * 1e3}


# device kernels of a train step, grouped by name (first match wins)
STEP_GROUPS = (
    ("fused_dropout_matmul", ("fdm_",)),
    ("Lovász sort + cumsum", ("sort", "radix", "scan")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolution", ("conv", "gemm", "cudnn", "xmma", "winograd", "implicit",
                     "wgrad", "dgrad", "fprop", "sm90", "cutlass")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
)


def profile_train_step(torch, exp) -> None:
    """One more train step of the experiment under torch.profiler: device
    time by kernel group (convolutions, batch norm, elementwise, the
    Lovász sort, the fused dropout kernels), against the step's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralbarkcalculator_tpu_torch.train.step import train_step

    idx = torch.as_tensor(exp.train_split[:exp.config.batch_size],
                          device=exp.device)

    def step():
        train_step(exp.model, exp.opt, exp.images, exp.labels, idx,
                   exp.augment_gen, 12345, exp.config.crop_size, exp._mean,
                   exp._std, exp.config.jitter_brightness,
                   exp.config.jitter_saturation, exp.loss_fn)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def event_ms(e) -> float:
        return event_device_us(e) / 1e3

    busy = sum(event_ms(e) for e in events)
    if busy == 0:
        log("train profile: the profiler recorded no device time (not "
            "measured)")
        return
    groups: dict[str, float] = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in STEP_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + event_ms(e)
    log(f"train profile: one step, device busy {busy:.3f} ms in a profiled "
        f"step of {wall_ms:.3f} ms wall (busy share {busy / wall_ms:.4f})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"train profile: {group:22s} {ms:9.3f} ms ({ms / busy:.4f})")
    for e in sorted(events, key=event_ms, reverse=True)[:10]:
        log(f"train profile: {event_ms(e):9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def phase_train_vs_cpu(torch, seed: int) -> None:
    """One training step of the full-width fcn_resnet50 on the card (TF32
    off, the kernels) and on the CPU (the plain versions), from the same
    weights, batch and dropout seed. The masks agree bit for bit, so the
    loss must agree within 1e-4 relative and classifier.4's gradients
    within STEP_GRAD_TOL of their largest magnitude. For scale, the CPU
    step is run once more on inputs perturbed by 1e-6 relative: how far
    float32 rounding alone moves those gradients."""
    import copy

    import numpy as np

    from neuralbarkcalculator_tpu_torch.ops import fused_dropout_matmul
    from neuralbarkcalculator_tpu_torch.train.loop import build_model
    from neuralbarkcalculator_tpu_torch.train.optim import adam
    from neuralbarkcalculator_tpu_torch.train.step import step_on_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    n, crop = CHECK_BATCH, CHECK_CROP
    imgs = rng.standard_normal((n, crop, crop, 3), dtype=np.float32)
    coarse = rng.integers(0, 3, (n, crop // 32, crop // 32))
    labs = np.kron(coarse, np.ones((1, 32, 32), np.int64))
    dseed = int(rng.integers(0, 2 ** 63))
    noise = 1 + 1e-6 * rng.standard_normal(imgs.shape, dtype=np.float32)
    model = build_model("fcn_resnet50", 0.8, seed)
    out = {}
    for name, dev, x, s in (("card", "cuda", imgs, dseed),
                            ("cpu", "cpu", imgs, dseed),
                            ("cpu_perturbed", "cpu", imgs * noise, dseed),
                            ("cpu_other_mask", "cpu", imgs, dseed + 1)):
        m = copy.deepcopy(model).to(dev)
        fwd0 = fused_dropout_matmul.FWD_LAUNCHES.count
        t0 = time.perf_counter()
        metrics = step_on_batch(m, adam(m.parameters(), 5e-4, 2e-3),
                                torch.from_numpy(x).to(dev),
                                torch.from_numpy(labs).to(dev), s)
        out[name] = (float(metrics["loss"]), m.classifier[4].weight.grad.cpu(),
                     m.classifier[4].bias.grad.cpu(),
                     time.perf_counter() - t0,
                     fused_dropout_matmul.FWD_LAUNCHES.count - fwd0)
        del m

    def errors(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]),
                float((a[1] - b[1]).abs().max() / b[1].abs().max()),
                float((a[2] - b[2]).abs().max() / b[2].abs().max()))

    loss_rel, w_err, b_err = errors(out["card"], out["cpu"])
    p_loss, p_w, p_b = errors(out["cpu_perturbed"], out["cpu"])
    o_loss, o_w, o_b = errors(out["cpu_other_mask"], out["cpu"])
    log(f"train step card vs CPU (batch {n}, crop {crop}, full width): "
        f"loss {out['card'][0]:.8f} vs {out['cpu'][0]:.8f} (relative "
        f"{loss_rel:.3g}, allowed 1e-4); classifier.4 grad err / max|grad| "
        f"weight {w_err:.3g}, bias {b_err:.3g} (allowed {STEP_GRAD_TOL}); "
        f"the CPU step on inputs perturbed by 1e-6: loss {p_loss:.3g}, "
        f"weight {p_w:.3g}, bias {p_b:.3g}; with the next dropout seed: "
        f"loss {o_loss:.3g}, weight {o_w:.3g}, bias {o_b:.3g}; kernel "
        f"launches {out['card'][4]} on the card, {out['cpu'][4]} on the CPU; "
        f"step {out['card'][3]:.3f} s card (cold), {out['cpu'][3]:.3f} s CPU")
    if out["card"][4] != 1 or out["cpu"][4] != 0:
        raise AssertionError("the card step must run the kernel once, the "
                             "CPU step the plain version")
    if loss_rel > 1e-4 or max(w_err, b_err) > STEP_GRAD_TOL:
        raise AssertionError("the card's training step disagrees with the "
                             "CPU's")
    if o_w < 10 * STEP_GRAD_TOL:
        raise AssertionError("another dropout mask moves the gradients by "
                             "less than 10x the tolerance: the check cannot "
                             "tell masks apart")


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
    """Weights of any zoo model drawn with numpy from `seed`: He-normal
    convs (a depthwise conv's fan-in is its k x k window), BN with
    non-trivial statistics (the BNs that end a residual branch, ResNet's
    bn3 and downsample.1 and MBConv's _bn2, scaled down so the random
    network stays in range), small biases. fcn_resnet50 draws the values
    it drew before the zoo had other models."""
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
        elif k.endswith((".bn3.weight", "downsample.1.weight",
                         "._bn2.weight")):
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

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.utils import profiling

    root = os.path.join(workdir, "root")
    make_folder(root, seed)
    ckpt = os.path.join(workdir, "best_model.pt")
    random_checkpoint(torch, "fcn_resnet50", seed, root, ckpt, device)
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
    counters = reset_counters()
    t0 = time.perf_counter()
    csv = engine.predict(root, progress=False)
    seconds = time.perf_counter() - t0
    counts = {name: c.count for name, c in counters.items()}
    launches = counts["upsample_argmax"]
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
    if counts["fused_dropout_matmul_fwd"] or counts["fused_dropout_matmul_bwd"]:
        raise AssertionError(f"the predict path launched a training kernel: "
                             f"{counts}")
    log(f"main path: {N_IMAGES} images (heights {FOLDER_HEIGHTS}, width "
        f"{WIDTH}, batch {engine.config.batch_size}, bf16, BN folded) in "
        f"{seconds:.3f} s = {N_IMAGES / seconds:.3f} images/s (warm pass); "
        f"launches {counts}; dual values "
        f"{sorted(classes)}; cache {engine.cache_stats()}")
    for name, row in sorted(stages.items()):
        log(f"stage {name:28s} {row['calls']:3d} calls "
            f"{row['total_s'] * 1e3:9.3f} ms total")
    return {"launches": launches, "engine": engine, "ckpt": ckpt,
            "root": root, "seconds": seconds}


def profile_pass(torch, engine, root: str, seconds: float,
                 label: str = "profile") -> None:
    """One folder pass under torch.profiler: the device's busy time (the
    sum of the device-side events: kernels and copies), set against this
    profiled pass's own wall time for the busy share, and the kernels that
    take the most of it; `seconds` is the unprofiled timed pass's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # timed inside the block: the profiler's start-up and trace
        # processing are not part of the pass
        t0 = time.perf_counter()
        engine.predict(root, progress=False)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    # device-side events only: a CPU op may carry the device time of the
    # kernels it launched, which would count that time twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = event_device_us
    busy_s = sum(device_us(e) for e in events) / 1e6
    if busy_s == 0:
        log(f"{label}: the profiler recorded no device time (busy share "
            f"not measured)")
        return
    log(f"{label}: device busy {busy_s * 1e3:.3f} ms in the profiled "
        f"pass of {profiled_s * 1e3:.3f} ms (busy share "
        f"{busy_s / profiled_s:.4f}; the unprofiled timed pass took "
        f"{seconds * 1e3:.3f} ms)")
    for e in sorted(events, key=device_us, reverse=True)[:8]:
        log(f"{label}: {device_us(e) / 1e3:10.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def phase_profile(torch, main: dict) -> None:
    """One more folder pass under torch.profiler (profile_pass). Then the
    device step alone, at the full batch and at the batch a 6-image bucket
    would launch without the power-of-two ladder's dummy rows, and the
    one-off cost of a batch shape the engine has not run before, which is
    what the ladder saves."""
    engine = main["engine"]
    profile_pass(torch, engine, main["root"], main["seconds"])

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


def step_inputs(torch, engine, items):
    """One launch's device inputs for `items`, as the engine's
    _launch_batch builds them: (uint8 batch, valid heights or None, row
    operators). The ragged path pads to PAD_H with row masks; the
    exact-height path takes items of one height as they are."""
    dev = engine.device
    n = len(items)
    heights = [it.image.shape[0] for it in items]
    if engine._exact_heights:
        pad_h = heights[0]
        if any(h != pad_h for h in heights):
            raise ValueError(f"exact-height launch of heights {heights}")
        return (torch.from_numpy(engine._pad_group(items, pad_h, n)).to(dev),
                None, torch.stack([engine._row_op_dev(pad_h, pad_h)] * n))
    return (torch.from_numpy(engine._pad_group(items, PAD_H, n)).to(dev),
            torch.tensor(heights, dtype=torch.int32, device=dev),
            torch.stack([engine._row_op_dev(h, PAD_H) for h in heights]))


def check_bf16_step(torch, bf16, f32, items, label: str = "") -> None:
    """The bf16 engine's device step (bf16 convs, channels_last) against
    the float32 engine's (TF32 off) on one launch (step_inputs), before any
    postprocess. The head logits over the valid rows must agree within
    BF16_LOGIT_TOL of the float32 logits' spread; a class-map pixel may
    differ only where the float32 top-2 margin is under twice the largest
    change the measured logit error can make after the upsample (the
    error times the largest absolute row sum of the row and the column
    operators)."""
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax)

    batch, valid_h, rows = step_inputs(torch, bf16, items)
    heights = [it.image.shape[0] for it in items]
    pad_h = batch.shape[1]
    with torch.inference_mode():
        lo16 = bf16._logits(batch, valid_h)
        lo32 = f32._logits(batch, valid_h)
        colt, col_win = bf16._colt_dev(lo16.shape[2], WIDTH)
        map16 = upsample_argmax(lo16, rows, colt, col_win)
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
        fh = (lo16.shape[1] if valid_h is None
              else bf16.model.backbone.valid_feature_height(h))
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
        if h < pad_h and bool((map16[i, h:] != 0).any()):
            raise AssertionError(f"bf16 step: padded rows of image {i} "
                                 f"are not 0")
    log(f"{label}bf16 step vs float32 step: logit max abs err {err:.5g} "
        f"({err / spread:.5f} of the float32 logits' std {spread:.5g}, "
        f"allowed {BF16_LOGIT_TOL}); {flips} of {total} pixels flipped "
        f"({flips / total:.6f}), largest flipped float32 margin "
        f"{worst:.5g}, allowed < {allowed:.5g} (operator gain "
        f"{gain:.4f}); {near} pixels ({near / total:.6f}) lie under that "
        f"margin")
    if err > BF16_LOGIT_TOL * spread:
        raise AssertionError(f"{label}bf16 logits differ from float32 by "
                             f"{err}, above {BF16_LOGIT_TOL} x {spread}")
    if flips and worst >= allowed:
        raise AssertionError(f"{label}bf16 class map flips a pixel whose "
                             f"float32 margin {worst} is >= {allowed}")


def folder_items(root: str, indices) -> list:
    """The main-path folder's processed images `indices` as
    ProcessedImage."""
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    samples = os.path.join(root, "processed", "samples", "sapin")
    return [ProcessedImage(load_image_u8(os.path.join(
        samples, f"img{i:02d}.png")), f"img{i:02d}.png", "sapin")
        for i in indices]


def reference_maps(torch, f32, items) -> tuple[list, int]:
    """Each image alone, unpadded, through the float32 engine's folded
    model (head_logits), upsample_argmax_plain with the image's own
    operators and the native postprocess. Returns the maps and the number
    of near-tie pixels: a float32 top-2 margin under REF_NEAR_TIE of the
    image's largest |logit|."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.io.native import (
        remove_small_zones_host2)
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        bicubic_resize_matrix, column_operator_t)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax_plain)

    ref, ties, feats = [], 0, []
    with torch.inference_mode():
        for it in items:
            h, w = it.image.shape[:2]
            x = torch.from_numpy(it.image).to(f32.device).float() / 255.0
            feat = f32.model.head_logits(((x - f32.mean) / f32.std)[None])
            rows = torch.from_numpy(bicubic_resize_matrix(
                feat.shape[1], h).astype(np.float32)).to(f32.device)[None]
            colt = torch.from_numpy(column_operator_t(feat.shape[2], w)).to(
                f32.device)
            feats.append(feat[0])
            cmap = upsample_argmax_plain(feat, rows, colt).cpu()
            top2 = torch.einsum("bcow,wp->bcop", torch.einsum(
                "bof,bfwc->bcow", rows, feat), colt).topk(2, dim=1).values
            ties += int((top2[:, 0] - top2[:, 1]
                         < REF_NEAR_TIE * feat.abs().max()).sum())
            cleaned, _ = remove_small_zones_host2(
                cmap.numpy(), w, np.array([h], np.int32))
            ref.append(cleaned[0])
        # how far the logits depend on the image rather than the position:
        # their spread across the images at each position (over the rows
        # all of them have) against their spread across positions
        f = min(t.shape[0] for t in feats)
        stack = torch.stack([t[:f] for t in feats])
        across = float(stack.std(dim=0).mean())
        spatial = float((stack - stack.mean(dim=(1, 2), keepdim=True)).std())
    log(f"reference logits: spread across {len(items)} images {across:.4g} "
        f"(mean std at a position), across positions {spatial:.4g}")
    return ref, ties


def phase_reference(torch, engine, ckpt: str, items, model_name: str =
                    "fcn_resnet50", label: str = "",
                    bf16_floor: float | None = 0.95) -> float:
    """The engine against a per-image reference on the card
    (reference_maps). The float32 engine (TF32 off, the engine's batches,
    the kernel) must agree on >= 99.9% of pixels; the bf16 engine's
    agreement is printed and, where `bf16_floor` is given, must reach it.
    The bf16 device step is also held against the float32 one before the
    postprocess (check_bf16_step), on the items of the first one's height.
    Returns the float32 engine's agreement."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    f32 = NeuralBarkCalculator(
        ckpt, config=PredictConfig(model_path=ckpt, use_bfloat16=False),
        model_name=model_name, device=engine.device)
    ref, ties = reference_maps(torch, f32, items)
    total = sum(r.size for r in ref)
    agreement = {}
    for kind, eng, floor in (("float32", f32, 0.999),
                             ("bf16", engine, bf16_floor)):
        got = {it.fname: m for it, m in eng.predict_images(items)}
        agree = sum(int((got[it.fname] == r).sum())
                    for it, r in zip(items, ref))
        agreement[kind] = agree / total
        log(f"{label}reference check ({kind} engine vs per-image float32): "
            f"{agree / total:.6f} pixel agreement over {len(items)} images; "
            f"{ties} pixels ({ties / total:.6f}) are near ties (margin < "
            f"{REF_NEAR_TIE} of the largest |logit|)")
        if floor is not None and agree / total < floor:
            raise AssertionError(f"{label}{kind} engine agrees with the "
                                 f"reference on {agree / total:.6f} < {floor}")
    first_h = items[0].image.shape[0]
    check_bf16_step(torch, engine, f32,
                    [it for it in items
                     if not engine._exact_heights
                     or it.image.shape[0] == first_h], label)
    return agreement["float32"]


def make_scan_root(root: str, seed: int) -> list[str]:
    """The device-preprocess sources as a predict root (samples/<wood>/),
    BMPs written with PIL: SCAN_PER_TYPE square SCAN_SIZE scans per wood
    type in SCAN_WOODS, each with dark bands of its own heights at top and
    bottom, and the SCAN_EXTRA sources. Content: blobby colour fields plus
    fine noise, drawn from `seed`. Returns the paths written."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.data.dataset import save_image_u8_pil

    rng = np.random.default_rng(seed)
    specs = [(wood, f"scan{i:02d}.bmp", SCAN_SIZE, SCAN_SIZE)
             for wood in SCAN_WOODS for i in range(SCAN_PER_TYPE)]
    specs += [(SCAN_WOODS[0], name, h, w) for name, h, w in SCAN_EXTRA]
    paths = []
    for k, (wood, name, h, w) in enumerate(specs):
        coarse = rng.integers(60, 200, (h // 64 + 1, w // 64 + 1, 3),
                              dtype=np.uint8)
        img = np.repeat(np.repeat(coarse, 64, 0), 64, 1)[:h, :w]
        img = img + rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        if (h, w) != SCAN_EXTRA[-1][1:]:  # the small source stays unbanded
            img[:h * (3 + 2 * k) // 128] = 0
            img[h - h * (2 + 3 * k) // 128:] = 0
        os.makedirs(os.path.join(root, "samples", wood), exist_ok=True)
        paths.append(os.path.join(root, "samples", wood, name))
        save_image_u8_pil(paths[-1], img)
    return paths


def phase_preprocess(torch, seed: int, workdir: str, card: str) -> dict:
    """The device preprocess backend on the card against the host backend
    over make_scan_root's sources: the same names and shapes (trim
    decisions), max |diff| <= 1 and under PRE_DIFF_SHARE of the pixels
    differing. Then a warm pass of each backend, the resize products'
    device time per batch of 4 square scans against their float32 FLOP
    bound, the bytes uploaded and what 'auto' picks on this machine."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        bspline_resize_matrix, spline_resize)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)

    root = os.path.join(workdir, "scans")
    t0 = time.perf_counter()
    paths = make_scan_root(root, seed)
    log(f"preprocess: wrote {len(paths)} BMP sources in "
        f"{time.perf_counter() - t0:.3f} s")
    dev_pre = Preprocessor(PRE_TARGET, batch_size=PRE_BATCH,
                           backend="device")
    host_pre = Preprocessor(PRE_TARGET, backend="host")
    counters = reset_counters()
    passes = {}
    for label, pre in (("device", dev_pre), ("host", host_pre)):
        for _ in range(2):  # the first pass is cold: operators, cuBLAS
            pre.bytes_h2d = 0
            t0 = time.perf_counter()
            out = pre.preprocess_images(root, save=False, progress=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        passes[label] = (out, seconds)
    launches = {name: c.count for name, c in counters.items()}
    dev, host = passes["device"][0], passes["host"][0]
    if [d.fname for d in dev] != [h.fname for h in host] \
            or len(dev) != len(paths):
        raise AssertionError("preprocess: the backends returned other images")
    differ = total = 0
    worst = 0
    for d, h in zip(dev, host):
        if d.image.shape != h.image.shape:
            raise AssertionError(f"preprocess {d.fname}: device shape "
                                 f"{d.image.shape}, host {h.image.shape}")
        diff = np.abs(d.image.astype(np.int16) - h.image.astype(np.int16))
        worst = max(worst, int(diff.max()))
        share = float((diff > 0).mean())
        differ += int((diff > 0).sum())
        total += diff.size
        if share >= PRE_DIFF_SHARE:
            raise AssertionError(f"preprocess {d.fname}: {share:.3g} of "
                                 f"the values differ, >= {PRE_DIFF_SHARE}")
    if worst > 1:
        raise AssertionError(f"preprocess: device and host differ by {worst}")
    shapes = sorted({d.image.shape[:2] for d in dev})
    log(f"preprocess device vs host backend ({card}): {len(dev)} images, "
        f"trimmed shapes {shapes}; {differ} of {total} values differ "
        f"({differ / total:.3g}, each image < {PRE_DIFF_SHARE}), max |diff| "
        f"{worst} (allowed 1); launches {launches}")
    for label, (out, seconds) in passes.items():
        log(f"preprocess {label} backend, warm pass ({card}): {len(out)} "
            f"images in {seconds:.3f} s = {len(out) / seconds:.3f} images/s")
    log(f"preprocess device backend: {dev_pre.bytes_h2d} bytes uploaded in "
        f"the warm pass (uint8 sources)")

    # the products alone, on a device-resident batch of 4 square scans
    scans = [p for p in paths if os.path.basename(p).startswith("scan")]
    x = torch.from_numpy(np.stack([load_image_u8(p) for p in
                                   scans[:PRE_BATCH]])).cuda().float() / 255
    times, counts = device_times(
        torch, [lambda: spline_resize(x, PRE_TARGET, PRE_TARGET)], reps=5,
        warmup=2)
    products = {k: v for k, v in times[0].items() if "gemm" in k.lower()}
    total_ms = sum(times[0].values())
    gemm_ms = sum(products.values())
    flops = PRE_BATCH * 2 * 3 * (PRE_TARGET * SCAN_SIZE * SCAN_SIZE
                                 + PRE_TARGET * PRE_TARGET * SCAN_SIZE)
    bound_ms = flops / H100_F32_FLOPS * 1e3
    log(f"preprocess resize, batch of {PRE_BATCH} {SCAN_SIZE}^2 -> "
        f"{PRE_TARGET}^2 ({card}): spline_resize {total_ms:.4f} ms of device "
        f"time, its matrix products {gemm_ms:.4f} ms "
        f"({'not identified by name' if not products else len(products)} "
        f"kernels); bound {bound_ms:.4f} ms ({flops / 1e9:.3f} GFLOP at "
        f"{H100_F32_FLOPS / 1e12:g} TFLOP/s, the float32 peak without "
        f"tensor cores), products at {bound_ms / max(gemm_ms, 1e-9):.3f} of "
        f"it; by kernel {dict((k[:60], round(v, 4)) for k, v in times[0].items())}")
    del x
    op = bspline_resize_matrix(SCAN_SIZE, PRE_TARGET).astype(np.float32)
    nz = (op != 0).sum(axis=1)
    log(f"preprocess resize: the float32 {SCAN_SIZE} -> {PRE_TARGET} "
        f"operator holds {nz.min()}-{nz.max()} nonzeros a row (mean "
        f"{nz.mean():.1f}), so its dense products do "
        f"{SCAN_SIZE / nz.max():.1f}-{SCAN_SIZE / nz.min():.1f}x the "
        f"operations of its band")

    auto = Preprocessor(backend="auto")
    cal = auto._calibrate_backend()
    c = auto.calibration
    log(f"preprocess auto ({card}): picks {cal!r}; upload "
        f"{c['bandwidth_bytes_per_s'] / 1e9:.3f} GB/s, predicted "
        f"{c['device_s_per_image']:.4f} s/image device, "
        f"{c['host_s_per_image']:.4f} s/image host ({os.cpu_count()} cores)")
    return {"root": root, "paths": paths}


def artifact_stats(root: str) -> dict:
    """(mtime_ns, size) of every results/ artifact, by relative path."""
    out = {}
    for sub in ("combined_images", "outputs"):
        for dirpath, _, fnames in os.walk(os.path.join(root, "results", sub)):
            for f in fnames:
                st = os.stat(os.path.join(dirpath, f))
                out[os.path.relpath(os.path.join(dirpath, f), root)] = (
                    st.st_mtime_ns, st.st_size)
    return out


def phase_cli_resume(torch, root: str, ckpt: str, n_sources: int) -> None:
    """cli/predict.main over the scans with the device preprocess
    (streaming), then with --resume: no launch and a byte-identical
    final_stats.csv; then with RESUME_DELETE images' dual and figure PNGs
    deleted, --resume again: those images' artifacts written anew, every
    other artifact untouched, the CSV byte-identical again. Every launch
    count is set to 0 before each run and read after it."""
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main

    argv = [root, "--model_path", ckpt, "--preprocess_backend", "device",
            "--dpi", str(DPI)]
    csv_path = os.path.join(root, "results", "final_stats.csv")

    def run(label: str, extra: list[str]) -> tuple[bytes, dict]:
        counters = reset_counters()
        t0 = time.perf_counter()
        main(build_parser().parse_args(argv + extra))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: c.count for name, c in counters.items()}
        with open(csv_path, "rb") as f:
            data = f.read()
        log(f"cli {label}: {seconds:.3f} s, launches {launches}, "
            f"final_stats.csv {len(data)} bytes")
        if launches["fused_dropout_matmul_fwd"] \
                or launches["fused_dropout_matmul_bwd"]:
            raise AssertionError(f"cli {label} launched a training kernel")
        return data, launches

    full, launches = run("full run (device preprocess, streaming)", [])
    if launches["upsample_argmax"] == 0:
        raise AssertionError("the CLI path never launched upsample_argmax")
    rows = full.decode().splitlines()
    if len(rows) != 1 + n_sources:
        raise AssertionError(f"final_stats.csv has {len(rows) - 1} rows")
    names = [r.split("\t")[:2] for r in rows[1:]]
    before = artifact_stats(root)
    if len(before) != 2 * n_sources:
        raise AssertionError(f"{len(before)} artifacts for {n_sources} "
                             f"images")
    again, launches = run("--resume, nothing new", ["--resume"])
    if launches["upsample_argmax"] or again != full:
        raise AssertionError(f"resume: {launches['upsample_argmax']} "
                             f"launches, CSV equal {again == full}")
    gone = names[:RESUME_DELETE]
    for fname, wood in gone:
        for sub in ("combined_images", "outputs"):
            os.remove(os.path.join(root, "results", sub, wood, fname))
    resumed, launches = run(f"--resume, {RESUME_DELETE} images' artifacts "
                            f"deleted", ["--resume"])
    after = artifact_stats(root)
    redone = {k for k in after if before[k] != after[k]}
    want = {os.path.join("results", sub, wood, fname)
            for fname, wood in gone for sub in ("combined_images", "outputs")}
    log(f"cli resume: CSV byte-identical {resumed == full}; artifacts "
        f"written anew {sorted(redone)}")
    if resumed != full or redone != want or set(after) != set(before) \
            or launches["upsample_argmax"] == 0:
        raise AssertionError("resume did not predict exactly the deleted "
                             "images, or the CSV changed")


def http_call(port: int, method: str, path: str, body: bytes | None = None
              ) -> tuple[int, str, bytes, float]:
    """One request to the local server: (status, content type, body,
    seconds)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        c.request(method, path, body=body)
        r = c.getresponse()
        data = r.read()
        return (r.status, r.getheader("Content-Type"), data,
                time.perf_counter() - t0)
    finally:
        c.close()


def check_answer(label: str, status: int, data: bytes) -> dict:
    """A JSON answer: HTTP 200, class pixels summing to height x width,
    the percentages and areas that count's math."""
    from neuralbarkcalculator_tpu_torch.config import DEFAULT_MM_PER_PIXEL

    if status != 200:
        raise AssertionError(f"serving {label}: HTTP {status} {data[:200]!r}")
    p = json.loads(data)
    n = p["height"] * p["width"]
    px = p["class_pixels"]
    want = {"bark_percent": round(px[1] / n * 100.0, 5),
            "node_percent": round(px[2] / n * 100.0, 5),
            "bark_area_mm2": round(px[1] * DEFAULT_MM_PER_PIXEL, 5),
            "node_area_mm2": round(px[2] * DEFAULT_MM_PER_PIXEL, 5)}
    if sum(px) != n or any(p[k] != v for k, v in want.items()):
        raise AssertionError(f"serving {label}: numbers {p} disagree with "
                             f"their class pixels")
    return p


def latency_line(seconds: list[float]) -> str:
    import numpy as np

    ms = np.asarray(seconds) * 1e3
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p95 "
            f"{np.percentile(ms, 95):.3f} ms, max {ms.max():.3f} ms")


def server_line(answers: list[dict]) -> str:
    """The server's own split of the answers' latency: the mean wait in
    the batcher's queue and the mean time of the engine's batch."""
    import numpy as np

    return (f"server mean queue {np.mean([a['queue_ms'] for a in answers]):.3f}"
            f" ms, engine batch "
            f"{np.mean([a['compute_ms'] for a in answers]):.3f} ms")


def start_server(torch, ckpt: str, *extra: str):
    """make_server on an ephemeral port (batch SERVE_BATCH, max wait
    SERVE_WAIT_MS, fixed height 1024), warmed up, serving on a thread.
    Returns (server, thread, warmup seconds)."""
    from neuralbarkcalculator_tpu_torch.cli.serve import (build_parser,
                                                          make_server,
                                                          serve_in_thread)

    srv = make_server(build_parser().parse_args(
        [ckpt, "--port", "0", "--batch_size", str(SERVE_BATCH),
         "--max_wait_ms", str(SERVE_WAIT_MS), "--fixed_height",
         str(PAD_H), *extra]))
    t0 = time.perf_counter()
    srv.state.predictor.warmup(PAD_H, WIDTH)
    torch.cuda.synchronize()
    return srv, serve_in_thread(srv), time.perf_counter() - t0


def stop_server(srv, thread) -> None:
    srv.shutdown()
    srv.server_close()
    srv.state.predictor.close()
    thread.join(timeout=30)


def phase_serving(torch, main_root: str, ckpt: str, scan: str,
                  card: str) -> None:
    """cli/serve.make_server on the card with the predict cell's
    checkpoint (bf16): warm-up, then 16 sequential JSON requests of the
    cell's processed PNGs, SERVE_CLIENTS client threads x SERVE_PER_CLIENT
    requests, one raw scan BMP, one request each of format=mask,
    format=combined and exclude_nodes=1, /healthz and /v1/stats. Every
    answer 200 with consistent numbers, no launch shape after warm-up,
    upsample_argmax launched and no training kernel, every request served.
    Then a --float32 server's mask answers against a direct float32
    predict_images call on the same preprocessed images."""
    import io
    import numpy as np
    from PIL import Image

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage, Preprocessor)
    from neuralbarkcalculator_tpu_torch.utils import profiling

    samples = os.path.join(main_root, "processed", "samples", "sapin")
    pngs = []
    for i in range(N_IMAGES):
        with open(os.path.join(samples, f"img{i:02d}.png"), "rb") as f:
            pngs.append(f.read())
    srv, thread, warm_s = start_server(torch, ckpt)
    predictor = srv.state.predictor
    calc = predictor.calc
    port = srv.server_address[1]
    shapes = set(calc._launch_shapes)
    log(f"serving ({card}): warm-up {warm_s:.3f} s, launch shapes "
        f"(pad_h, batch, width) {sorted(shapes)}")
    try:
        counters = reset_counters()
        profiling.report(reset=True)
        sent = 0
        seq, seq_server = [], []
        t0 = time.perf_counter()
        for i, body in enumerate(pngs):
            status, _, data, dt = http_call(port, "POST", "/v1/predict", body)
            seq_server.append(check_answer(f"sequential {i}", status, data))
            seq.append(dt)
        seq_s = time.perf_counter() - t0
        sent += len(pngs)
        after_seq = predictor.snapshot_stats()
        seq_stages = profiling.report(reset=True)

        def client(c: int) -> list[tuple[float, dict]]:
            out = []
            for k in range(SERVE_PER_CLIENT):
                status, _, data, dt = http_call(
                    port, "POST", "/v1/predict",
                    pngs[(c * SERVE_PER_CLIENT + k) % len(pngs)])
                out.append((dt, check_answer(f"client {c} request {k}",
                                             status, data)))
            return out

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
            answered = [a for f in [pool.submit(client, c)
                                    for c in range(SERVE_CLIENTS)]
                        for a in f.result()]
        conc = [dt for dt, _ in answered]
        conc_s = time.perf_counter() - t0
        sent += SERVE_CLIENTS * SERVE_PER_CLIENT
        after_conc = predictor.snapshot_stats()
        conc_stages = profiling.report(reset=True)

        with open(scan, "rb") as f:
            status, _, data, dt = http_call(port, "POST", "/v1/predict",
                                            f.read())
        sent += 1
        raw = check_answer("raw scan", status, data)
        want_h = Preprocessor(backend="host").preprocess_one(
            load_image_u8(scan)).shape[0]
        if (raw["height"], raw["width"]) != (want_h, WIDTH) or \
                (raw["source_height"], raw["source_width"]) != (SCAN_SIZE,
                                                                SCAN_SIZE):
            raise AssertionError(f"raw scan answer {raw}, host preprocess "
                                 f"height {want_h}")
        for label, path, ctype in (
                ("mask", "/v1/predict?format=mask", "image/png"),
                ("combined", "/v1/predict?format=combined", "image/png"),
                ("exclude_nodes", "/v1/predict?exclude_nodes=1",
                 "application/json")):
            status, got_type, data, _ = http_call(port, "POST", path, pngs[0])
            sent += 1
            if status != 200 or got_type != ctype:
                raise AssertionError(f"serving {label}: HTTP {status} "
                                     f"{got_type}")
            if label == "exclude_nodes":
                excl = check_answer(label, status, data)
                if excl["class_pixels"][2] or excl["node_percent"]:
                    raise AssertionError(f"exclude_nodes answer {excl}")
            else:
                img = np.asarray(Image.open(io.BytesIO(data)))
                log(f"serving {label}: {len(data)} bytes, image "
                    f"{img.shape}")
        status, _, data, _ = http_call(port, "GET", "/healthz")
        health = json.loads(data)
        status2, _, data, _ = http_call(port, "GET", "/v1/stats")
        stats = json.loads(data)
        launches = {name: c.count for name, c in counters.items()}
    finally:
        stop_server(srv, thread)
    log(f"serving health {health}; stats {stats}")
    log(f"serving sequential ({card}): {len(seq)} requests in {seq_s:.3f} s "
        f"= {len(seq) / seq_s:.3f} requests/s; client {latency_line(seq)}; "
        f"mean batch {after_seq['mean_batch']:.3f}; {server_line(seq_server)}")
    n_conc = after_conc["served"] - after_seq["served"]
    conc_batches = after_conc["batches"] - after_seq["batches"]
    log(f"serving {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} ({card}): "
        f"{len(conc)} requests in {conc_s:.3f} s = {len(conc) / conc_s:.3f} "
        f"requests/s; client {latency_line(conc)}; mean batch "
        f"{n_conc / conc_batches:.3f} over {conc_batches} batches; "
        f"{server_line([p for _, p in answered])}")
    for label, stages in (("sequential", seq_stages),
                          ("concurrent", conc_stages)):
        log(f"serving {label}, the engine's stages (calls, ms per call): "
            + ", ".join(f"{name} {row['calls']} x "
                        f"{row['total_s'] * 1e3 / row['calls']:.3f}"
                        for name, row in sorted(stages.items())))
    log(f"serving launches {launches}; launch shapes after the traffic "
        f"{sorted(calc._launch_shapes)}")
    if status != 200 or status2 != 200 or not health["ok"] \
            or health["backend"] != calc.device.type \
            or health["n_devices"] != torch.cuda.device_count():
        raise AssertionError(f"serving health {health}")
    if set(calc._launch_shapes) != shapes:
        raise AssertionError("the traffic ran a launch shape the warm-up "
                             "did not")
    if launches["upsample_argmax"] == 0 or launches[
            "fused_dropout_matmul_fwd"] or launches["fused_dropout_matmul_bwd"]:
        raise AssertionError(f"serving launches {launches}")
    if stats["served"] != sent or stats["requests"] != sent \
            or stats["errors"] or stats["rejected"]:
        raise AssertionError(f"serving: sent {sent}, stats {stats}")
    del srv, predictor, calc

    # exactness: a float32 server's maps against the direct engine
    srv, thread, warm_s = start_server(torch, ckpt, "--float32")
    port = srv.server_address[1]
    host_pre = Preprocessor(backend="host")
    bodies = pngs[:SERVE_BATCH]
    try:
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            answers = list(pool.map(lambda b: http_call(
                port, "POST", "/v1/predict?format=mask", b), bodies))
        batches = srv.state.predictor.snapshot_stats()["batches"]
    finally:
        stop_server(srv, thread)
    del srv
    direct = NeuralBarkCalculator(ckpt, config=PredictConfig(
        model_path=ckpt, use_bfloat16=False, batch_size=SERVE_BATCH,
        fixed_pad_height=PAD_H))
    items = [ProcessedImage(host_pre.preprocess_one(np.asarray(
        Image.open(io.BytesIO(b)).convert("RGB"))), f"d{i}", "serving")
        for i, b in enumerate(bodies)]
    want = {it.fname: m for it, m in direct.predict_images(items)}
    differ = total = 0
    for i, (status, _, data, _) in enumerate(answers):
        if status != 200:
            raise AssertionError(f"float32 serving: HTTP {status}")
        dual = np.asarray(Image.open(io.BytesIO(data)))
        got = np.select([dual == 127, dual == 255], [1, 2], 0)
        if got.shape != want[f"d{i}"].shape:
            raise AssertionError(f"float32 serving: shape {got.shape}")
        differ += int((got != want[f"d{i}"]).sum())
        total += got.size
    log(f"serving float32 (TF32 off) vs a direct predict_images call "
        f"({card}): {differ} of {total} pixels differ, agreement "
        f"{1 - differ / total:.6f} (floor 0.999); served in {batches} "
        f"batches, the direct call in one batch of {len(items)}; warm-up "
        f"{warm_s:.3f} s")
    if 1 - differ / total < 0.999:
        raise AssertionError("the float32 server disagrees with the engine")


def phase_kernel_stride32(torch, seed: int) -> dict:
    """upsample_argmax on the EfficientNet path's shapes: stride-32 logits
    at exact heights (a batch of 8 at each STRIDE32_CASES height and
    width: F = 28 / 30 / 32, so F % 4 != 0 takes the row tile's scalar
    staging; Wf = 32; width 1000 puts the window edges inside quads) held
    against the plain version, the uniform 1024^2 batch also against one
    F.interpolate + argmax call; then the 1024^2 case timed by device time
    (the kernel, the plain version, two matmuls + argmax, F.interpolate +
    argmax) in FDM_TIMING_ROUNDS rounds beside its bound."""
    import numpy as np
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.ops.resize import (
        bicubic_resize_matrix, column_operator_t)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        column_windows, upsample_argmax, upsample_argmax_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 32)
    flips = 0
    for h, w in STRIDE32_CASES:
        f, wf = -(-h // 32), -(-w // 32)
        feat = torch.from_numpy(rng.standard_normal(
            (BATCH, f, wf, 3), dtype=np.float32)).to(dev)
        rows = torch.from_numpy(bicubic_resize_matrix(f, h).astype(
            np.float32)).to(dev).expand(BATCH, -1, -1).contiguous()
        colt = torch.from_numpy(column_operator_t(wf, w)).to(dev)
        col_win = column_windows(colt)
        got = upsample_argmax(feat, rows, colt, col_win)
        torch.cuda.synchronize()
        n, _ = check_map(torch, f"stride 32 [{BATCH}x{h}x{w}, F={f}, "
                         f"Wf={wf}] vs plain", got,
                         upsample_argmax_plain(feat, rows, colt), feat, rows,
                         colt, FLIP_MARGIN)
        flips += n
    # the last 1024 x 1024 case is timed: a uniform batch, so one
    # F.interpolate + argmax call computes the same function
    h, w = STRIDE32_TIMED
    f, wf = h // 32, w // 32
    feat = torch.from_numpy(rng.standard_normal(
        (BATCH, f, wf, 3), dtype=np.float32)).to(dev)
    rows = torch.from_numpy(bicubic_resize_matrix(f, h).astype(
        np.float32)).to(dev).expand(BATCH, -1, -1).contiguous()
    colt = torch.from_numpy(column_operator_t(wf, w)).to(dev)
    col_win = column_windows(colt)
    planes_nchw = feat.permute(0, 3, 1, 2)

    def interpolate():
        return F.interpolate(planes_nchw, size=(h, w), mode="bicubic",
                             align_corners=False).argmax(1)

    def library():
        y = torch.matmul(torch.matmul(rows[:, None], planes_nchw), colt)
        return y.argmax(dim=1).to(torch.uint8)

    check_map(torch, f"stride 32 [{BATCH}x{h}x{w}] vs F.interpolate + "
              f"argmax", upsample_argmax(feat, rows, colt, col_win),
              interpolate().to(torch.uint8), feat, rows, colt, INTERP_MARGIN)
    fns = (lambda: upsample_argmax(feat, rows, colt, col_win),
           lambda: upsample_argmax_plain(feat, rows, colt), library,
           interpolate)
    rounds, counts = [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, ({"upsample_argmax_kernel": 1},
                                             None, None, None))
        rounds.append([sum(t.values()) for t in times])
        counts.append(n)
        log(f"upsample_argmax stride 32 timing round {r + 1} (device ms per "
            f"call): kernel {rounds[-1][0]:.4f}, plain {rounds[-1][1]:.4f}, "
            f"two matmuls + argmax {rounds[-1][2]:.4f}, F.interpolate + "
            f"argmax {rounds[-1][3]:.4f}; clocks.sm, clocks.mem, power.draw "
            f"after it: {card_clocks()}")
    same_counts("upsample_argmax stride 32", counts)
    ms, plain_ms, library_ms, interp_ms = (statistics.median(col)
                                           for col in zip(*rounds))
    ops = band_ops(torch, rows, colt)
    nbytes = (4 * (feat.numel() + rows.numel() + colt.numel())
              + BATCH * h * w)
    op_ms = ops / H100_F32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES * 1e3
    bound = max(op_ms, byte_ms)
    log(f"upsample_argmax stride 32 [{BATCH}x{h}x{w}, F={f}, Wf={wf}]: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, two matmuls + argmax "
        f"{library_ms:.4f} ms, F.interpolate + argmax {interp_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({ops / 1e9:.4f} GFLOP over the windows, "
        f"{nbytes / 1e6:.3f} MB; {bound / ms:.3f} of it)")
    return {"stride32_ms": ms, "stride32_plain_ms": plain_ms,
            "stride32_library_ms": library_ms,
            "stride32_interpolate_ms": interp_ms, "stride32_bound_ms": bound,
            "stride32_bound_by": "operations" if op_ms >= byte_ms
            else "bytes", "stride32_flips": flips}


def random_checkpoint(torch, name: str, seed: int, root: str, path: str,
                      device: str) -> None:
    """A full-width `name` with random_state_dict weights and the head's
    bias centred on the first folder image's logits (so the maps mix
    classes and the postprocess and the reference check see real zones),
    saved as a reference-named .pt. The BN statistics stay as drawn: set
    from a calibration pass, they make the random network amplify bf16
    rounding far past BF16_LOGIT_TOL, while as drawn a random
    EfficientNet's logits depend on the position far more than on the
    image (reference_maps prints the two spreads)."""
    from neuralbarkcalculator_tpu_torch.config import (DEFAULT_MEAN,
                                                       DEFAULT_STD)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    model = MODEL_FACTORIES[name]().eval()
    model.load_state_dict(random_state_dict(model, seed))
    model.to(device)
    first, = folder_items(root, [0])
    x = torch.from_numpy(first.image).to(device).float() / 255.0
    x = ((x - torch.tensor(DEFAULT_MEAN, device=device))
         / torch.tensor(DEFAULT_STD, device=device))
    with torch.inference_mode():
        centre = model.head_logits(x[None]).mean(dim=(0, 1, 2))
    model.classifier[4].bias.data -= centre
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def zoo_step_ms(torch, engine) -> float:
    """The engine's device step alone on a batch of BATCH random 1024 x
    1024 images (the exact-height path at that height), back to back."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    img = np.random.default_rng(0).integers(0, 256, (PAD_H, WIDTH, 3),
                                            np.uint8)
    batch, valid_h, rows = step_inputs(
        torch, engine, [ProcessedImage(img, "step", "zoo")] * BATCH)
    with torch.inference_mode():
        return time_ms(torch, lambda: engine._device_step(
            batch, valid_h, rows, pack=True), reps=3, runs=3)


def atrous_times(torch, engine) -> None:
    """The DeepLab head's atrous convs at the engine's launch (bf16
    channels_last, BATCH x C x 128 x 128): the port's space-to-batch
    AtrousConv2d at each rate against cuDNN's dilated conv on the same
    weights at the first rate (its direct kernel takes seconds), also with
    cudnn.benchmark on, and both in float32 NCHW (TF32 off), by CUDA
    events, with the largest difference between the two in bf16."""
    import copy

    import torch.nn.functional as F

    aspp = engine.model.classifier[0]
    convs = [branch[0] for branch in aspp.convs[1:-1]]
    x = torch.randn(BATCH, convs[0].in_channels, PAD_H // 8, WIDTH // 8,
                    device=engine.device, dtype=engine.dtype).contiguous(
                        memory_format=torch.channels_last)
    conv, rate = convs[0], convs[0].dilation[0]
    conv32 = copy.deepcopy(conv).float()
    x32 = x.float().contiguous()

    def dilated(c, inp):
        return F.conv2d(inp, c.weight, c.bias, padding=rate, dilation=rate)

    def once(fn) -> float:
        return time_ms(torch, fn, warmup=1, reps=1, runs=1)

    with torch.inference_mode():
        port = [time_ms(torch, lambda c=c: c(x), warmup=1, reps=3, runs=3)
                for c in convs]
        cudnn_ms = once(lambda: dilated(conv, x))
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        deterministic=False,
                                        allow_tf32=False):
            bench_ms = once(lambda: dilated(conv, x))
        port32 = time_ms(torch, lambda: conv32(x32), warmup=1, reps=3,
                         runs=3)
        cudnn32 = time_ms(torch, lambda: dilated(conv32, x32), warmup=1,
                          reps=3, runs=3)
        want = dilated(conv, x).float()
        err = float((conv(x).float() - want).abs().max()
                    / want.abs().max())
    log(f"atrous convs [{BATCH}x{convs[0].in_channels}x{PAD_H // 8}x"
        f"{WIDTH // 8}] -> {convs[0].out_channels}, bf16 channels_last: "
        f"space-to-batch "
        + ", ".join(f"rate {c.dilation[0]} {ms:.3f} ms"
                    for c, ms in zip(convs, port))
        + f"; cuDNN's dilated conv at rate {rate} {cudnn_ms:.3f} ms, with "
        f"cudnn.benchmark {bench_ms:.3f} ms; largest difference {err:.3g} "
        f"of the largest output. float32 NCHW at rate {rate}: "
        f"space-to-batch {port32:.3f} ms, cuDNN {cudnn32:.3f} ms")


def phase_zoo(torch, seed: int, workdir: str, root: str,
              device: str = "cuda") -> dict:
    """The rest of the model zoo through the folder engine on the card:
    each ZOO factory at full width and depth (random_checkpoint weights), a
    warm-up pass and a timed pass of the main-path folder (bf16, BN
    folded, batch 8) with every launch count set to 0 just before it and
    read just after, a profiled pass, the device step alone, and the
    reference check (phase_reference: float32 >= 99.9%, the bf16 step's
    logit bound). Then fcn_efficientnet_b0 once more with
    effnet_bucket_heights: at most one launch shape per (bucket, ladder
    batch), its maps against the exact-height engine's. Returns each
    factory's numbers and checkpoint."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    out: dict = {}
    everything = folder_items(root, range(N_IMAGES))
    exact_b0 = None
    for name in ZOO:
        t0 = time.perf_counter()
        ckpt = os.path.join(workdir, f"{name}.pt")
        random_checkpoint(torch, name, seed, root, ckpt, device)
        engine = NeuralBarkCalculator(
            ckpt, model_name=name, device=device,
            config=PredictConfig(model_path=ckpt, figure_dpi=DPI))
        engine.predict(root, progress=False)  # warm-up: cuDNN plans, caches
        counters = reset_counters()
        t1 = time.perf_counter()
        csv = engine.predict(root, progress=False)
        seconds = time.perf_counter() - t1
        counts = {k: c.count for k, c in counters.items()}
        with open(csv) as f:
            rows = len(f.read().splitlines()) - 1
        if rows != N_IMAGES or counts["upsample_argmax"] == 0 \
                or counts["fused_dropout_matmul_fwd"] \
                or counts["fused_dropout_matmul_bwd"]:
            raise AssertionError(f"zoo {name}: {rows} CSV rows, launches "
                                 f"{counts}")
        stats = engine.cache_stats()
        log(f"zoo {name}: {N_IMAGES} images (heights {FOLDER_HEIGHTS}, "
            f"width {WIDTH}, batch {engine.config.batch_size}, bf16, BN "
            f"folded, exact heights {engine._exact_heights}) in "
            f"{seconds:.3f} s = {N_IMAGES / seconds:.3f} images/s (warm "
            f"pass); launches {counts}; cache {stats}")
        profile_pass(torch, engine, root, seconds, f"zoo {name} profile")
        step_ms = zoo_step_ms(torch, engine)
        log(f"zoo {name}: device step alone {step_ms:.3f} ms per batch of "
            f"{BATCH} at {PAD_H}x{WIDTH} = {BATCH / step_ms * 1e3:.1f} "
            f"images/s ceiling")
        if name == "deeplabv3_resnet50":
            atrous_times(torch, engine)
        f32_agree = phase_reference(torch, engine, ckpt,
                                    folder_items(root, range(4)), name,
                                    f"zoo {name}: ", bf16_floor=None)
        if name == "fcn_efficientnet_b0":
            exact_b0 = {it.fname: m for it, m in
                        engine.predict_images(everything)}
        out[name] = {"ckpt": ckpt, "images_per_s": N_IMAGES / seconds,
                     "launches": counts["upsample_argmax"],
                     "launch_shapes": stats["launch_shapes"],
                     "step_ms": step_ms, "float32_agreement": f32_agree}
        del engine
        torch.cuda.empty_cache()
        log(f"zoo {name}: {time.perf_counter() - t0:.3f} s")

    # the opt-in bucketed heights on the exact-height path
    name = "fcn_efficientnet_b0"
    ckpt = out[name]["ckpt"]
    engine = NeuralBarkCalculator(
        ckpt, model_name=name, device=device, config=PredictConfig(
            model_path=ckpt, figure_dpi=DPI, effnet_bucket_heights=True))
    planned = {(pad_h, engine._padded_batch(len(idxs)))
               for pad_h, idxs in engine._plan_chunks(
                   [(i, it.image.shape[0], WIDTH)
                    for i, it in enumerate(everything)])}
    engine.predict(root, progress=False)
    counters = reset_counters()
    t1 = time.perf_counter()
    engine.predict(root, progress=False)
    seconds = time.perf_counter() - t1
    launches = counters["upsample_argmax"].count
    shapes = engine.cache_stats()["launch_shapes"]
    got = {it.fname: m for it, m in engine.predict_images(everything)}
    agree = {}
    for it in everything:
        h = it.image.shape[0]
        key = "on the bucket" if h % engine.config.height_bucket == 0 \
            else "padded"
        same, n = agree.get(key, (0, 0))
        agree[key] = (same + int((got[it.fname] == exact_b0[it.fname]).sum()),
                      n + h * WIDTH)
    log(f"zoo {name} with effnet_bucket_heights (bucket "
        f"{engine.config.height_bucket}): {N_IMAGES / seconds:.3f} images/s "
        f"(warm pass); {launches} upsample_argmax launches; launch shapes "
        f"{sorted(engine._launch_shapes)} for the planned (bucket, batch) "
        f"{sorted(planned)}; agreement with the exact-height maps "
        + ", ".join(f"{k} {s / n:.6f}" for k, (s, n) in sorted(agree.items())))
    if shapes > len(planned) or launches == 0:
        raise AssertionError(f"bucketed heights: {shapes} launch shapes for "
                             f"{len(planned)} (bucket, batch) pairs, "
                             f"{launches} launches")
    out["bucketed"] = {"images_per_s": N_IMAGES / seconds,
                       "launch_shapes": shapes,
                       "agreement": {k: s / n for k, (s, n) in agree.items()}}
    del engine
    torch.cuda.empty_cache()
    return out


def phase_zoo_serving(torch, root: str, zoo: dict, card: str) -> None:
    """One served request per new family through cli/serve.make_server
    (bf16, batch SERVE_BATCH, fixed height 1024, warmed up): the first
    folder image's PNG against deeplabv3_resnet50 and fcn_efficientnet_b0,
    its answer's numbers checked, upsample_argmax launched, and the
    launch shapes before and after (an exact-height model takes a new one
    for a height the warm-up did not run)."""
    samples = os.path.join(root, "processed", "samples", "sapin")
    with open(os.path.join(samples, "img00.png"), "rb") as f:
        body = f.read()
    for name in ("deeplabv3_resnet50", "fcn_efficientnet_b0"):
        srv, thread, warm_s = start_server(torch, zoo[name]["ckpt"],
                                           "--model", name)
        calc = srv.state.predictor.calc
        before = sorted(calc._launch_shapes)
        try:
            counters = reset_counters()
            status, _, data, dt = http_call(srv.server_address[1], "POST",
                                            "/v1/predict", body)
            answer = check_answer(f"{name} request", status, data)
            launches = counters["upsample_argmax"].count
        finally:
            stop_server(srv, thread)
        log(f"serving {name} ({card}): warm-up {warm_s:.3f} s, one request "
            f"in {dt * 1e3:.3f} ms, class pixels {answer['class_pixels']}, "
            f"bark {answer['bark_percent']} %, node "
            f"{answer['node_percent']} %; {launches} upsample_argmax "
            f"launches; launch shapes {before} -> "
            f"{sorted(calc._launch_shapes)}")
        if answer["width"] != WIDTH or launches == 0:
            raise AssertionError(f"serving {name}: answer {answer}, "
                                 f"{launches} launches")
        del srv, calc


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

    def timed(label: str, fn, *fn_args):
        t0 = time.perf_counter()
        result = fn(*fn_args)
        log(f"phase {label}: {time.perf_counter() - t0:.3f} s")
        return result

    card = timed("build", phase_build)
    kernel = timed("upsample_argmax", phase_kernel, torch, args.seed)
    kernel.update(timed("upsample_argmax stride 32", phase_kernel_stride32,
                        torch, args.seed))
    fdm = timed("fused_dropout_matmul", phase_fdm_kernel, torch, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_path = timed("main path", phase_main_path, torch, args.seed,
                          workdir)
        kernel["launches"] = main_path["launches"]
        timed("profile", phase_profile, torch, main_path)
        timed("reference", phase_reference, torch, main_path["engine"],
              main_path["ckpt"], folder_items(main_path["root"], range(4)))
        ckpt, main_root = main_path["ckpt"], main_path["root"]
        del main_path
        scans = timed("preprocess", phase_preprocess, torch, args.seed,
                      workdir, card)
        timed("cli resume", phase_cli_resume, torch, scans["root"], ckpt,
              len(scans["paths"]))
        timed("serving", phase_serving, torch, main_root, ckpt,
              scans["paths"][0], card)
        zoo = timed("zoo", phase_zoo, torch, args.seed, workdir, main_root)
        kernel["zoo_launches"] = {name: zoo[name]["launches"] for name in ZOO}
        timed("zoo serving", phase_zoo_serving, torch, main_root, zoo, card)
        train = timed("train", phase_train, torch, args.seed, workdir)
        for row in fdm:
            row["launches"] = train["launches"][row["name"]]
    timed("train vs cpu", phase_train_vs_cpu, torch, args.seed)
    print(json.dumps({"kernels": [kernel, *fdm]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
