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
backward at the training head's [5, 512, 64, 64] -> 3, rate 0.8, and at
the EfficientNet FCN heads' [5, 320, 16, 16] (B0) and [5, 640, 16, 16]
(B7), each timed and a row of its own (the dropout mask bit for bit; two
calls bitwise equal; shapes that miss every tile at 1, 3 and 4 classes
and rates 0 and 0.8; the integer instructions of a step of each kernel's
loop, counted in its SASS, from which an estimate of the integer pipe's
time is printed beside the main shape's byte bound).
upsample_argmax is also held at the EfficientNet path's stride-32 logits
(8 images at heights 896/960/1024, F = 28/30/32, Wf = 32, and at width
1000), and its 1024 x 1024 case timed; and at SegFormer's stride-4 logits
(8 images at heights 896/960/1024, F = h / 4, Wf = 256), each case timed.
Each timing window's device events
are counted against what the function launches. fused_dropout_matmul is
also held at the main shape at a data-parallel rank's element offset (2
x 512 x 64 x 64): against the plain versions there, its mask equal to
rows 2-4 of the offset-0 mask, the kernels on rows 2-4 alone equal to the
offset-0 run's rows bit for bit, and its time beside offset 0's: the two
timed in turns within each round's profiler session, their medians within
the phase's spread or 3 % of offset 0's, whichever is larger.

The ccl phase, after phase 2, holds the tiled union-find kernels
(csrc/ccl.cu) against their plain version bit for bit: label_components,
component_areas and remove_small_zones on the eval batch of phase 4's
1024² images ([8, 1024, 1024] int64) and on a train step's crops ([5,
512, 512]), remove_small_zones_ragged on the engine's chunk ([8, 1024,
1024] uint8, valid_h 896/960/1024 and 0), each batch holding random maps
at class-0 shares 0.3/0.5/0.7 or 0.5, blob maps and all-class-0 and
all-bark images; the 1024² spiral against scipy.ndimage.label and the
native union-find, with the plain version's sweeps printed; and the
tile-border maps (heights and widths that are no multiple of the tile, a
checkerboard, diagonals and lone pixels at the tile corners, valid_h 0, 1
and H) against scipy's labels and the native union-find. The kernels are
timed by device time (3 rounds, by kernel), the plain version by CUDA
events, beside the native union-find as the port ran it before (the maps
copied to the host, remove_small_zones_batch, the upload), the byte bound
and, in the log only, the bytes the design itself moves (a model, not a
measurement).

Phase 3 drives the predict path, folder prediction, through the engine a
user calls: a synthetic folder of 16 processed 1024-wide images at trimmed
heights 896/960/1024, a full-width fcn_resnet50 with random weights drawn
from the seed (bf16, BN folded, batch 8). It checks the artifacts, that
upsample_argmax was launched during the timed pass, profiles one more
pass for the device's busy share, and holds the engine's maps against a
per-image float32 reference on the card. Then the sharded-predict phase:
cli/predict --shard k/2 --float32 as two concurrent child processes of
this script on the one card over the same folder and checkpoint (shard 0
merges), against the single-process float32 engine: every artifact once,
the merged CSV's names and order equal, the rows whose bytes differ
counted, the dual masks >= 99.9 % equal, each shard's upsample_argmax
launches, the wall time against phase 3's. Then the width phase: the
JAX mesh's model axis, the engine under a (data, model) mesh of child
processes of this script (``--width-rank``, internal) sharing the card
over gloo, each rank uploading its rows and its strip of the width, the
backbone and head exchanging halos (parallel/spatial.py), the logits
gathered to the full width for upsample_argmax: (1, 2) in float32 over
the 16 images at batch 8, each image's dual mask >= 99.9 % the
one-process float32 engine's and the CSV's rows in the same order; (2,
2) in bf16 over 8 of them, >= 95 % the same float32 masks. Each rank
prints its upsample_argmax launches (> 0), its halo exchanges and the
bytes it received beside the bytes the model's shapes give (equal), one
launch batch's largest logit difference from the same model on one
process (model rank 0) relative to their std, and its timed pass beside
one process's warm pass. Then the no-library predict:
cli/predict --float32 --preprocess_backend host over the same folder in
a child process of this script (``--no-native-predict``, internal) that
makes the native runtime's build fail before anything loads it: PIL
codecs, the scipy preprocess, the engine's postprocess through
ops/ccl.remove_small_zones_ragged on the card. It must warn, launch ccl
and upsample_argmax, write final_stats.csv byte for byte as the native
single-process float32 run did, and equal dual masks; its wall time is
printed beside that run's.

Phase 4 drives the training path through cli/train.main: a synthetic
30-image 1024x1024 dataset with duals, the full-width, full-depth
fcn_resnet50 at the recipe's batch 5 and crop 512, one epoch of 9 steps,
validation, test and the report. It checks the checkpoint, best_model.pt,
the report's 15 columns, finite losses, that the fused dropout kernels
ran and that the ccl kernels ran (validation, test and the report's
PixelWiseF1), and prints the warm step time, the epoch's time outside its
steps and the peak memory; one validation image's F1 on the card equals
the CPU's bit for bit. Then one training
step on the card is held against the same step on the CPU. Then the NCCL
phase: cli/train --distributed under torchrun's environment at world size
1 (a NCCL process group on the card: cross-rank BatchNorms, the loss's
inputs gathered, the gradients all-reduced) and the same run without a
process group, on phase 4's dataset for one 4-step epoch with cuDNN's
deterministic algorithms: losses, parameters after each step and dropout
masks bit for bit, fused_dropout_matmul once a step, the collectives
counted, the warm step times beside phase 4's. At one rank the cross-rank
BatchNorm is torch's own and the collectives copy, so then the two-rank
phase runs their arithmetic on the card: two ranks of cli/train
--distributed as child processes sharing the one card over gloo (NCCL
refuses two ranks on one device) at global batch 10 for one 4-step epoch,
against cli/train without a process group at batch 10 and against a
third run from weights moved one float32 ulp (float32's own reach): the
ranks bit for bit, their masks the global batch's rows, the first step's
loss and BN running statistics as the CPU tests hold two ranks, its
gradients by network stage within 3x the nudged run's, the epoch's mean
loss within 1e-3, fused_dropout_matmul once a step on each rank, both
runs' warm step times and peak memory; and first, in each rank, the
cross-rank BatchNorm alone at [10, 512, 64, 64] in float32 and under
bf16 autocast against float64 (cuDNN's BN beside it), with its memory.

The zoo train phase runs after phase 4, in a child process of this
script (its own CUDA context, memory peaks and profiler sessions): every
loss of the training menu on [5, 512, 512, 3] logits on the card against
the CPU; fcn_resnet101, deeplabv3_resnet101, fcn_efficientnet_b0,
fcn_efficientnet_b7 and deeplabv3_efficientnet_b7 trained at full width
and depth on phase 4's dataset (batch 5, crop 512, 9 steps: the warm step
time on the device clock, the peak memory, a profiled step by kernel
group, finite losses, fused_dropout_matmul launched once a step for the
FCN heads and never for DeepLab), each exported best_model.pt loaded by
the predict engine and answering one image; then cli/train.main for
deeplabv3_resnet50 with --bf16 --loss lovasz_hist --backbone_ckpt (a
random torchvision-named ResNet-50 file), and --resume --epochs 2, which
must go on at epoch 2 with the checkpoint's lr and step count.

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
25 ms, fixed height 1024): warm-up, then tools/serving_bench's
sequential and concurrent phases at its defaults (20 requests, 8 clients
x 5) over the phase 3 images, each JSON line printed, a raw scan, mask /
combined / exclude_nodes answers, /healthz and /v1/stats, every answer's
numbers and the launch shapes checked; then a --float32 server's masks
against a direct predict_images call (>= 99.9 % of pixels).

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
deeplabv3_resnet50 and fcn_efficientnet_b0.

The int8 phase runs after the zoo phase: fcn_resnet50 (phase 3's
checkpoint) and deeplabv3_resnet50 (the zoo phase's) through the folder
engine with quantize_int8 (bf16 stem, batch 8) over the phase 3 folder:
the first pass calibrates lazily on the first chunk (its ms printed), a
warm pass gives images/s with upsample_argmax launched; the int8 class
maps against the bf16 and float32 engines' (> 0.5, the JAX package's floor
on random weights); the int8 device step alone against bf16's, in turns,
with their peak memory, and a profiled int8 step split by kernel group
(int8 GEMM, im2col concat, elementwise epilogues); from one post-stem int8
tensor the int8 blocks and head on the card against the CPU, bit for bit
(the DeepLab pooled branch within 1 LSB); the calibrated model saved and
loaded by a new engine, maps bit for bit; one request through a --int8
server; and for fcn_resnet50 cli/quantize_checkpoint -> cli/predict.main
on the .int8.pt against a lazy engine calibrated on the same image. Every
phase prints its wall time.

The width zoo phase runs after the int8 phase: the rest of the ResNet zoo
under the mesh's model axis, as the width phase's child ranks over gloo
on the one card. deeplabv3_resnet50 (the zoo phase's checkpoint) in
float32 under (1, 2) over the 16 images, each dual mask >= 99.9 % a
one-process float32 deeplabv3_resnet50 pass's (made here), and in bf16
under (1, 4) over 8 (strips of 32 feature columns: the ASPP's rate-36
halo spans two ranks), >= 95 % of those float32 masks; fcn_resnet50 with
quantize_int8 under (2, 1) over the 16 and deeplabv3_resnet50 with
quantize_int8 under (1, 2) over the 16 (grid rank 0 calibrates at full
width on the first chunk's images, as the int8 phase's engine, and
shares the stats), each image >= 99.9 % the int8 phase's one-process
maps. Each rank launches upsample_argmax; its halo bytes and its pooled
reductions' bytes equal the shapes' count; the int8 ranks' digests of
their int8 weights and scales are equal (and printed beside the int8
phase's one-process digest).

The width effnet phase runs after the width zoo phase: EfficientNet under
the mesh's model axis (TF-SAME halos on strips of 32 columns, the
squeeze-excite pool summed over the full width), as the width phase's
child ranks over gloo on the one card, with the zoo phase's checkpoints:
fcn_efficientnet_b0 in float32 under (1, 2) over the 16 images and
deeplabv3_efficientnet_b7 in float32 under (1, 2) over 8, each image's
mask >= 99.9 % a one-process float32 pass's of the same model and images
(made here); fcn_efficientnet_b0 in bf16 under (1, 4) over 8, >= 95 % a
one-process bf16 pass's masks. Each rank launches upsample_argmax (at
stride 32 on the gathered full-width logits); its halo bytes and its
squeeze-excite (and ASPP) reductions' bytes equal the shapes' count. The
zoo phase times the one-process device step of fcn_efficientnet_b0 and
deeplabv3_efficientnet_b7 in turns with squeeze-excite's pool as one
process takes it (the mean) and as a split rank takes it (the column
sums).
Then the mesh stream and serve phase (``--mesh-rank``, internal children
over gloo): predict_streaming of fcn_resnet50 in float32 under (2, 1) and
(1, 2) over copies of phase 5's raw scans, grid rank 0 reading and
preprocessing them (host backend) and broadcasting each chunk's plan and
pixels, its CSV's rows in the one-process streaming run's order and each
image's mask >= 99.9 % that run's; then a (2, 1) float32 server, grid rank
0's cli/serve.make_server and the other rank's BatchingPredictor.follow:
warm-up, serving_bench's sequential and concurrent phases over the 16
images (requests/s and p50 logged, not held: the ranks take turns on one
card), each image's mask answer >= 99.9 % a direct one-process float32
predict_images call's; every rank launches upsample_argmax.

The entry points and tools of the port: after phase 3's profile, the
trace phase wraps one warm folder pass in utils.device_trace and finds
upsample_argmax's kernel in the Chrome trace it writes, once a launch.
After the reference check, the float32 batch phase runs the predict
cell's 16 images through the float32 engine (TF32 off, cuDNN's defaults)
at launch batch 8 and 1, prints the pixels that differ and holds each
image's maps to >= 99.9 % agreement: the scope of the float32 batch
invariant on the card (bit for bit across launch batches on the CPU).
After phase 7 (whose traffic goes through tools/serving_bench), the
serving tools phase runs serving_bench's cold start (a child server, bf16,
batch 8, from its start to its first answer) and a SOAK_SECONDS-long
tools/serving_soak (8 clients, heights 896/960/1024) whose checks must
pass, each JSON line printed, with upsample_argmax launched; the curation
phase runs tools/curation fine-tune over 20 structured 1024² duals on
the card (the ccl kernels) and on the CPU (the plain version),
the files byte for byte. After phase 4, the entry-points phase runs the
console scripts bark-predict-torch (over a copy of the main folder) and
bark-train-torch (one epoch over phase 4's dataset) with their default
device, as two child processes of this script at once (``--entrypoint``,
internal), each launching its kernels.

The JAX checkpoints phase runs after the int8 phase, with no jax, flax or
orbax on the machine: phase 3's seeded fcn_resnet50 weights mapped to the
JAX package's variable tree (models/convert.state_dict_to_variables) and
written as a flax .msgpack by io/flax_msgpack; bark-predict-torch
(cli/predict.entrypoint, in this process) over two copies of the main
folder, with the .pt and with the .msgpack, final_stats.csv and every
dual mask byte for byte, upsample_argmax launched by the .msgpack run;
the port's quantize_variables tree of the same weights (calibrated on two
of the folder's images) written as the JAX package's .int8.msgpack (the
NBCQINT8\x01 tag, then the msgpack) and as the port's .int8.pt, the two
engines' int8 state dicts equal and their maps over the folder bit for
bit; the orbax fixture tests/fixtures/orbax_tree (written by the JAX
package's save_variables) read through io/orbax with the system libzstd,
every leaf's sha256 as tests/fixtures/orbax_tree.json says. It prints the
load times of the .pt, the .msgpack, the .int8.pt and the .int8.msgpack:
to a state dict on the host, and to the engine's model on the card.

Every path runs with all launch counts set to 0 just before it and read
just after. The last lines are the kernels' JSON line, the card's name and
power limit, and the result line. The script exits nonzero, with no result line,
when there is no CUDA device, when the port's package is not beside it, or
when any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
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
# The EfficientNet FCN heads' at the same batch and crop (output stride
# 32: 16 x 16 pixels): B0's 1280 / 4 = 320 channels, B7's 2560 / 4 = 640.
FDM_EFFNET_SHAPES = ((5, 320, 16, 3), (5, 640, 16, 3))
FDM_EFFNET_MODELS = {(5, 320, 16, 3): "fcn_efficientnet_b0",
                     (5, 640, 16, 3): "fcn_efficientnet_b7"}
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
# A data-parallel rank's rows of the main shape's batch: rows 2-4 of 5, at
# the mask's element offset of row 2.
FDM_OFFSET_ROWS = 2
# The offset's cost is one 64-bit add a lane. Offset 0 and the offset are
# timed in turns, FDM_OFFSET_TURNS times each in each round's profiler
# session, and their medians over rounds and turns may differ by the
# phase's spread or FDM_OFFSET_SHARE of offset 0's median, whichever is
# larger. Compared once a round against the spread alone, one run on an
# H100 failed: the backward read 0.0355 ms at the offset against 0.0353 at
# offset 0, beside a spread of 0.0002 ms; the next run of the same files
# passed. 3 % is ~0.001 ms of the backward, well under a real cost.
FDM_OFFSET_TURNS = 3
FDM_OFFSET_SHARE = 0.03
# Idle time at each end of a device_times window: one run's middle round
# read the forward 11 % low and the backward 6 % high beside two steady
# rounds, as events crossing windows would; at 5 ms a run failed three
# sessions in a row, a kernel of the next function's warm-up counted in
# the window before it.
DEVICE_TIMES_MARGIN_S = 0.02
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
# The zoo train phase: each head family on each backbone family at full
# width and depth, with the widest FCN head (B7's, 640 channels into
# fused_dropout_matmul) and the widest backbone under the DeepLab head;
# a samples factor of 2 gives 9 steps of batch 5, as the train phase.
ZOO_TRAIN = ("fcn_resnet101", "deeplabv3_resnet101", "fcn_efficientnet_b0",
             "fcn_efficientnet_b7", "deeplabv3_efficientnet_b7")
ZOO_TRAIN_SAMPLES_FACTOR = 2
# The FCN model the zoo train phase trains once more in bf16 (autocast,
# the head upcasting into fused_dropout_matmul): the cheapest FCN step.
ZOO_TRAIN_BF16 = "fcn_efficientnet_b0"
# The losses on the card against the CPU, first in float64 (the witness):
# values and gradients within LOSS_WITNESS_TOL, so the card's sort,
# histogram counts and weighting compute the CPU's function. Then in
# float32, the recipe's type: values within LOSS_VALUE_TOL relative,
# gradients within LOSS_GRAD_TOL of their L2 norm. In float32 the two
# devices' softmax round some errors an ulp apart, and at 1.3 M pixels in
# [0, 1] many neighbours in the Lovász order are that close: a foreground
# and a background pixel that trade places trade Lovász weights (the exact
# sort's gradient read 5.69e-3 on an H100, mixed's 4.79e-5 under its
# larger CWE term), and lovasz_hist moves a pixel on a bin edge to the
# next bin (1.75e-4). In
# float64 an ulp is ~1e-16 against a mean gap of ~8e-7 between
# neighbours, so trades are too rare to show. The elementwise losses sum in other
# orders only.
LOSS_WITNESS_TOL = 1e-5
LOSS_VALUE_TOL = 1e-5
LOSS_GRAD_TOL = {"lovasz": 2e-2, "lovasz_hist": 1e-3, "mixed": 5e-4,
                 "cwe": 1e-4, "jaccard": 1e-4}
# upsample_argmax on the EfficientNet path: stride-32 logits at the
# folder's exact heights (F = 28, 30, 32; Wf = 32) and a width-1000 case;
# the 1024 x 1024 case is timed.
STRIDE32_CASES = ((896, 1024), (960, 1024), (1024, 1024), (960, 1000))
STRIDE32_TIMED = (1024, 1024)
# SegFormer's stride-4 logits at the folder's exact heights (F = 224 / 240 /
# 256, Wf = 256), each of them timed
STRIDE4_CASES = ((896, 1024), (960, 1024), (1024, 1024))
# The serving phase: batch, the first request's wait, and the concurrent
# traffic (tools/serving_bench.py's shape: clients x requests each).
# The int8 phase: each model through the folder engine with lazy int8
# calibration (bf16 stem), its class maps against the bf16 and float32
# engines' at the JAX package's floor for random weights (near-tie logits
# everywhere, tests/test_quantize.py), the offline export path on the
# first INT8_CLI_IMAGES folder images at batch 1.
INT8_MODELS = ("fcn_resnet50", "deeplabv3_resnet50")
INT8_AGREE_FLOOR = 0.5
INT8_CLI_IMAGES = 4
INT8_STEP_GROUPS = (
    ("upsample_argmax", ("upsample_argmax",)),
    ("stem conv", ("fprop", "implicit", "conv", "cudnn")),
    ("im2col concat", ("catarraybatchedcopy",)),
    ("int8 GEMM", ("gemm", "xmma", "cutlass", "imma", "s8", "i8", "sm90")),
    ("elementwise (epilogues, masks, casts, copies)",
     ("elementwise", "vectorized", "unrolled")),
    ("reduction (pool, sums)", ("reduce", "pool")),
)

SERVE_BATCH = 8
# The sharded-predict phase: the main path's folder in this many shards, one
# process each, on the one card; a shard's dual masks must agree with the
# single process's on at least the float32 reference check's floor.
SHARDS = 2
SHARD_AGREE_FLOOR = 0.999
# The width phase: (n_data, n_model, dtype, images) of each mesh over the
# main path's folder, and the bf16 run's floor against the one-process
# float32 masks over its images (phase_reference's bf16 bound); the
# float32 run is held to F32_AGREE_FLOOR an image, the scoped float32
# invariant (cuDNN may take other algorithms for a strip's width).
WIDTH_RUNS = ((1, 2, "float32", N_IMAGES), (2, 2, "bf16", 8))
WIDTH_BF16_FLOOR = 0.95
# The width zoo phase (after the int8 phase): (model, int8, n_data,
# n_model, dtype, images) of each mesh over the main path's folder.
# deeplabv3_resnet50 in float32 at (1, 2) against a one-process float32
# deeplabv3_resnet50 pass, F32_AGREE_FLOOR an image; in bf16 at (1, 4)
# (strips of 32 feature columns against the ASPP's rate 36: the halo
# spans two ranks) against the same float32 masks, WIDTH_BF16_FLOOR over
# the images; the int8 runs (quantize_int8, bf16 stem, calibrated by grid
# rank 0) against the int8 phase's one-process engine of the same model
# over the same images, F32_AGREE_FLOOR an image. The int8 runs take all
# N_IMAGES: the calibration reads the first chunk's first images, so a
# smaller folder calibrates on other images than the int8 phase's engine.
WIDTH_ZOO_RUNS = (("deeplabv3_resnet50", False, 1, 2, "float32", N_IMAGES),
                  ("deeplabv3_resnet50", False, 1, 4, "bf16", 8),
                  ("fcn_resnet50", True, 2, 1, "bf16", N_IMAGES),
                  ("deeplabv3_resnet50", True, 1, 2, "bf16", N_IMAGES))
# The width effnet phase (after the width zoo phase): (model, n_data,
# n_model, dtype, images) of each mesh over the main path's folder, the
# zoo phase's checkpoints. fcn_efficientnet_b0 (1, 2) float32 over the 16
# images and deeplabv3_efficientnet_b7 (1, 2) float32 over 8, each image's
# mask >= F32_AGREE_FLOOR a one-process float32 pass's of the same model
# over the same images (made here); fcn_efficientnet_b0 (1, 4) bf16 over
# 8 (strips of 256 columns, 8 feature columns: B0's head and its last
# stages' halos span ranks) against a one-process bf16 B0 pass's masks,
# WIDTH_BF16_FLOOR over the images.
WIDTH_EFFNET_RUNS = (("fcn_efficientnet_b0", 1, 2, "float32", N_IMAGES),
                     ("deeplabv3_efficientnet_b7", 1, 2, "float32", 8),
                     ("fcn_efficientnet_b0", 1, 4, "bf16", 8))
# The mesh stream and serve phase (after the width effnet phase), float32
# fcn_resnet50 (phase 3's checkpoint): predict_streaming under each
# MESH_STREAMS mesh (the meshes at once) over copies of phase 5's raw
# scans (grid rank 0 reads and preprocesses them, host backend), against
# a one-process streaming
# run (the CSV's rows in its order, masks >= F32_AGREE_FLOOR an image);
# then a MESH_SERVE server (grid rank 0's make_server, the other ranks
# following) through serving_bench's sequential and concurrent phases
# over the 16 images, then each image as a mask answer against a direct
# one-process float32 predict_images call (>= F32_AGREE_FLOOR an image).
MESH_STREAMS = ((2, 1), (1, 2))
MESH_SERVE = (2, 1)
# The two-rank phase: cli/train at global batch 10 (each of 2 ranks the
# main path's 5), samples factor 2: 24 * 2 // 10 = 4 steps. Its first step
# starts from equal weights and is held to the one-process step: the loss
# within 1e-6 relative and the BN running statistics within rtol 1e-4 /
# atol 1e-6, as the CPU tests hold two gloo ranks to one process
# (tests/test_torch_data_parallel.py). The gradients are held against
# float32's own reach: a one-process run from weights moved one ulp up
# (NUDGE) differs from the unmoved run's gradient by what float32 cannot
# determine, growing from the head to the stem as each BN backward
# subtracts two means from its upstream gradient. On an H100 (--seed 0)
# the nudged run read 1.5e-3 of the norm at the last conv and 2.5e-2 at
# layer1, the two ranks 1.5e-3 and 1.8e-2; a lost term, a world-size
# factor or a stale statistic moves a stage by tens of percent. So each
# stage's gradient error is held within TWO_RANK_FLOOR_FACTOR times the
# nudged run's. Adam's first step turns each gradient into about lr x its
# sign, so the updates and the later steps are printed, not held; the
# epoch's mean loss within 1e-3 relative, as the CPU tests hold a
# two-rank epoch.
TWO_RANKS = 2
TWO_RANK_BATCH = 10
TWO_RANK_ARGS = ("--batch_size", str(TWO_RANK_BATCH), "--samples_factor",
                 "2")
TWO_RANK_LOSS_TOL = 1e-6
TWO_RANK_EPOCH_LOSS_TOL = 1e-3
TWO_RANK_BN_RTOL = 1e-4
TWO_RANK_BN_ATOL = 1e-6
TWO_RANK_FLOOR_FACTOR = 3.0
# The cross-rank BatchNorm alone at the FCN head's BN (512 channels) on
# the two-rank phase's global batch, [10, 512, 64, 64]: each rank's rows
# against the BN of the whole batch in float64 from the same values (bf16
# ones as bf16 rounds them), from random inputs and upstream gradients.
# Largest difference over the largest float64 value: float32 within 1e-5,
# the CPU tests' rtol, but the parameter gradients, sums over 40960
# elements whose terms cancel (a float32 sum's rounding, ~log2(N) x 6e-8
# x the sum of |terms|, reaches ~4e-5 of the largest result): 1e-4. Under
# bf16 autocast the output and input gradient are rounded to bf16 (2^-8
# of a value, 3.9e-3), the parameter gradients and statistics float32
# sums of the bf16 values, bounded as in float32. On an H100 cuDNN's bf16
# parameter gradients read 4.4e-3 / 3.1e-3 from the cross-rank module's:
# cuDNN's own distance from float64 is printed beside it.
BN_CHECK_SHAPE = (TWO_RANK_BATCH, 512, 64, 64)
BN_CHECK_TOL = {"float32": {"y": 1e-5, "dx": 1e-5, "dw": 1e-4, "db": 1e-4,
                            "mean": 1e-5, "var": 1e-5},
                "bf16": {"y": 4e-3, "dx": 4e-3, "dw": 1e-4, "db": 1e-4,
                         "mean": 1e-5, "var": 1e-5}}
SERVE_WAIT_MS = 25
# the serving phase's traffic through tools/serving_bench at its defaults:
# sequential requests, then clients x requests each
SERVE_SEQ = 20
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 5
# The ccl phase: PixelWiseF1's eval batch of phase 4's 1024² images (its
# argmax, int64), a train step's crops, and the predict engine's ragged
# chunk of uint8 maps (valid_h as the folder's heights, one image 0). Each
# batch mixes the class-map kinds of CCL_KINDS; the spiral of arm spacing 2
# is the sweep labelling's worst case.
CCL_EVAL = (8, 1024, 1024)
CCL_TRAIN = (5, 512, 512)
CCL_RAGGED_H = (896, 960, 1024, 0, 1024, 896, 960, 1024)
CCL_KINDS = {8: ("random 0.3", "random 0.5", "random 0.7", "blobs", "blobs",
                 "blobs", "all class 0", "all bark"),
             5: ("random 0.5", "blobs", "blobs", "all class 0", "all bark")}
CCL_SPIRAL = 1024
# The ccl phase's tile-border maps: shapes that are no multiple of the
# kernels' tile, a checkerboard (only diagonals connect, across every tile
# corner), one-pixel diagonals through the tile corners, a lone pixel at
# each corner of each tile, and a ragged batch at valid_h 0, 1 and H. Each
# is held against scipy.ndimage.label's partition at its smallest index
# and the native union-find, exact where the plain sweeps may stop.
CCL_BORDER_SHAPES = ((1000, 1024), (896, 1000), (1, 1024), (1024, 1),
                     (33, 129))
CCL_BORDER_VALID_H = (0, 1, 1024)
# The kernels' tile, rows x columns (csrc/ccl.cu's kTileH x kTileW): the
# border maps are built around its corners
CCL_TILE = (32, 128)
# The eval batch's time with the per-pixel union-find this design replaced,
# as PERF.md section 6 records it (device time, NVIDIA H100 80GB HBM3 at
# 700 W); printed beside this run's, not measured by it
CCL_PER_PIXEL_MS = 1.4298
# The float32 batch check: the predict cell's images through the float32
# engine with cuDNN's default algorithms at the largest and the smallest
# launch batch; each image's maps must agree on at least F32_AGREE_FLOOR
# of its pixels (on the card cuDNN may take other algorithms for another
# batch shape; bit identity across launch batches holds on the CPU).
F32_BATCHES = (8, 1)
F32_AGREE_FLOOR = 0.999
# The serving tools: the soak's length and clients
SOAK_SECONDS = 15.0
SOAK_CLIENTS = 8
# The JAX checkpoints phase: the orbax fixture (tests/torch_port_common.
# write_orbax_fixture), each leaf's sha256 in the JSON beside it; the
# images the .int8.msgpack's quantization calibrates on; the load-time
# repetitions of each checkpoint form.
ORBAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_tree")
JAX_INT8_CALIBRATION_IMAGES = 2
LOAD_REPS = 3

# The curation phase: structured 1024² duals through fine-tune
CURATION_DUALS = 20


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
    from neuralbarkcalculator_tpu_torch.ops import ccl, fused_dropout_matmul
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import LAUNCHES

    return {"upsample_argmax": LAUNCHES,
            "fused_dropout_matmul_fwd": fused_dropout_matmul.FWD_LAUNCHES,
            "fused_dropout_matmul_bwd": fused_dropout_matmul.BWD_LAUNCHES,
            "ccl": ccl.LAUNCHES}


def reset_counters() -> dict:
    """Every launch counter set to 0; returns them by kernel name."""
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    return counters


@contextlib.contextmanager
def step_clock(torch):
    """Step times on the card's clock: a CUDA event before and after each
    ``train/loop.train_step`` call of the block; the yielded list holds
    their intervals (seconds) after the block."""
    from neuralbarkcalculator_tpu_torch.train import loop

    real = loop.train_step
    marks: list = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    seconds: list[float] = []
    loop.train_step = timed
    try:
        yield seconds
    finally:
        loop.train_step = real
        if marks:
            marks[-1][1].synchronize()
        seconds += [a.elapsed_time(b) / 1e3 for a, b in marks]


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
                 attempts: int = 5
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
    m = re.search(r"((?:fdm|upsample|ccl)_[a-z_]*?kernel)"
                  r"(?:ILi(\d+)E|<(\d+)>)?", mangled)
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
              keep_range: tuple[float, float] | None = None,
              offset: int = 0) -> dict:
    """Both fused_dropout_matmul kernels against their plain versions on
    one input at the mask's element `offset`: the mask bit for bit (with
    w = g = 1, dh is K/keep where kept and 0 where dropped), dh exactly 0
    where dropped, y, dh, dw and db within the stated tolerances. Returns
    the outputs and the errors."""
    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        dropout_mask, fused_dropout_matmul_backward,
        fused_dropout_matmul_backward_plain, fused_dropout_matmul_forward,
        fused_dropout_matmul_plain)

    dh1, _, _ = fused_dropout_matmul_backward(
        h, torch.ones_like(w), torch.ones_like(g), dseed, rate, offset)
    torch.cuda.synchronize()
    mask = dropout_mask(h.shape, dseed, rate, offset, h.device)
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

    y = fused_dropout_matmul_forward(h, w, bias, dseed, rate, offset)
    dh, dw, db = fused_dropout_matmul_backward(h, w, g, dseed, rate, offset)
    torch.cuda.synchronize()
    y_p = fused_dropout_matmul_plain(h, w, bias, dseed, rate, offset)
    dh_p, dw_p, db_p = fused_dropout_matmul_backward_plain(h, w, g, dseed,
                                                           rate, offset)
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
        f"{w.shape[1]}, rate {rate}, element offset {offset}]: 0 of "
        f"{mask.numel()} keep decisions "
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


def fdm_row(name: str, shape: tuple, ms: float, plain_ms: float,
            lib_ms: float, nbytes: int, nops: int, err: float, line: int,
            rate: float, extra: str = "") -> dict:
    """One fused_dropout_matmul row of the kernels line, logged beside its
    bound (the larger of its bytes over HBM3's rate and its float32
    operations over the non-tensor-core rate)."""
    op_ms = nops / H100_F32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES * 1e3
    bound = max(op_ms, byte_ms)
    b_, c_, hw, k_ = shape
    log(f"{name} [{b_}x{c_}x{hw}x{hw} -> {k_}, rate {rate}]: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.dropout + conv2d "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB, "
        f"{nops / 1e6:.1f} MFLOP; {bound / ms:.3f} of it){extra}")
    return {
        "name": name, "route": "cuda",
        "source": "neuralbarkcalculator_tpu_torch/csrc/"
                  "fused_dropout_matmul.cu",
        "replaces": f"neuralbarkcalculator_tpu/ops/pallas_kernels.py:{line}",
        "shape": list(shape), "launches": 0, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": lib_ms,
    }


def fdm_row_name(direction: str, shape: tuple) -> str:
    """The kernels-line name of a fused_dropout_matmul row: the training
    head's main shape plain, the EfficientNet heads' with their shape."""
    base = f"fused_dropout_matmul_{direction}"
    if tuple(shape) == FDM_SHAPE:
        return base
    b_, c_, hw, _ = shape
    return f"{base}_{b_}x{c_}x{hw}x{hw}"


def phase_fdm_kernel(torch, seed: int) -> list[dict]:
    """fused_dropout_matmul's forward and backward kernels against their
    plain versions on the card: at the training head's shapes (h [5, 512,
    64, 64], K = 3, rate 0.8) and the EfficientNet FCN heads'
    (FDM_EFFNET_SHAPES), each twice, bitwise equal; at shapes that miss
    every tile (FDM_ODD_SHAPE, each of FDM_ODD_CLASSES and FDM_ODD_RATES).
    Then each of the path's shapes timed, with an estimate of the integer
    pipe's time from the kernels' SASS beside the main shape's byte
    bound."""
    import numpy as np
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        fused_dropout_matmul_backward, fused_dropout_matmul_backward_plain,
        fused_dropout_matmul_forward, fused_dropout_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    rate = FDM_RATE
    cases = []  # (shape, (h, w, bias, g, dseed), the first check's outputs)
    for shape in (FDM_SHAPE, *FDM_EFFNET_SHAPES):
        b_, c_, hw, k_ = shape
        inputs = fdm_inputs(torch, rng, b_, c_, hw, hw, k_)
        label = ("main shape" if shape == FDM_SHAPE
                 else f"EfficientNet head {b_}x{c_}x{hw}x{hw}")
        first = check_fdm(torch, label, *inputs, rate, (0.18, 0.22))
        # determinism: a second call gives the same bits
        again = check_fdm(torch, f"{label}, again", *inputs, rate)
        same = {n: torch.equal(first[n], again[n])
                for n in ("y", "dh", "dw", "db")}
        log(f"fused_dropout_matmul: two calls at the {label} bitwise "
            f"equal: {same}")
        if not all(same.values()):
            raise AssertionError(f"fused_dropout_matmul is not "
                                 f"deterministic at the {label}: {same}")
        cases.append((shape, inputs, first))
    for odd_k in FDM_ODD_CLASSES:
        for odd_rate in FDM_ODD_RATES:
            check_fdm(torch, "odd shape",
                      *fdm_inputs(torch, rng, *FDM_ODD_SHAPE, odd_k), odd_rate,
                      (0.18, 0.22) if odd_rate else (1.0, 1.0))
    offset = check_fdm_offset(torch, cases[0][1], cases[0][2], rate)

    # times: device time per call from the profiler (a ~0.03 ms kernel
    # behind a Python wrapper leaves the card idle between back-to-back
    # calls, so CUDA events around them time the host), for the kernels,
    # the library yardstick (F.dropout + a 1x1 F.conv2d through autograd)
    # and the plain versions at each shape, and what the card's memory
    # gives torch's own kernels for the main shape's traffic (h summed: h
    # read once; h copied: h read and written once), in FDM_TIMING_ROUNDS
    # rounds beside the card's clocks, all shapes in one profiler session
    # a round; then the medians.
    fns, plain_fns, expect, keep = [], [], [], []
    for shape, (h, w, bias, g, dseed), _ in cases:
        b_, c_, hw, k_ = shape
        hl = h.clone().requires_grad_(True)
        w4 = w.t().reshape(k_, c_, 1, 1).contiguous().requires_grad_(True)
        bl = bias.clone().requires_grad_(True)

        def lib_fwd(hl=hl, w4=w4, bl=bl):
            return F.conv2d(F.dropout(hl, rate, training=True), w4, bl)

        y_lib = lib_fwd()
        keep.append(y_lib)
        fns += [
            lambda h=h, w=w, bias=bias, dseed=dseed:
                fused_dropout_matmul_forward(h, w, bias, dseed, rate),
            lambda h=h, w=w, g=g, dseed=dseed:
                fused_dropout_matmul_backward(h, w, g, dseed, rate),
            lambda lib_fwd=lib_fwd: lib_fwd().detach(),
            lambda y_lib=y_lib, hl=hl, w4=w4, bl=bl, g=g:
                torch.autograd.grad(y_lib, (hl, w4, bl), g,
                                    retain_graph=True)]
        # the op's events per call: the forward one kernel, the backward
        # the kernel and the sum of its partials
        expect += [{f"fdm_forward_kernel<{k_}>": 1},
                   {f"fdm_backward_kernel<{k_}>": 1,
                    "fdm_backward_reduce_kernel": 1}, None, None]
        # ~400 kernels a call each, ~6 ms at the main shape: a few calls
        plain_fns += [
            lambda h=h, w=w, bias=bias, dseed=dseed:
                fused_dropout_matmul_plain(h, w, bias, dseed, rate),
            lambda h=h, w=w, g=g, dseed=dseed:
                fused_dropout_matmul_backward_plain(h, w, g, dseed, rate)]
    # the main shape's kernels at offset 0 and at a data-parallel rank's
    # element offset, in turns: forward 0, forward at the offset, backward
    # 0, backward at the offset
    h, w, bias, g, dseed = cases[0][1]
    k_ = FDM_SHAPE[3]
    at_offset = 4 * len(cases)
    for _ in range(FDM_OFFSET_TURNS):
        for at in (0, offset):
            fns.append(lambda h=h, w=w, bias=bias, dseed=dseed, at=at:
                       fused_dropout_matmul_forward(h, w, bias, dseed, rate,
                                                    at))
            expect.append({f"fdm_forward_kernel<{k_}>": 1})
        for at in (0, offset):
            fns.append(lambda h=h, w=w, g=g, dseed=dseed, at=at:
                       fused_dropout_matmul_backward(h, w, g, dseed, rate,
                                                     at))
            expect.append({f"fdm_backward_kernel<{k_}>": 1,
                           "fdm_backward_reduce_kernel": 1})

    def turn_columns(j: int) -> list[int]:
        """Column j of each turn: 0 forward at 0, 1 forward at the
        offset, 2 backward at 0, 3 backward at the offset."""
        return [at_offset + 4 * t + j for t in range(FDM_OFFSET_TURNS)]

    h_copy = torch.empty_like(h)
    fns += [h.sum, lambda: h_copy.copy_(h)]
    expect += [None, None]
    rounds, parts, counts = [], [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, expect)
        plain, n_plain = device_times(torch, plain_fns, warmup=1, reps=3)
        rounds.append([sum(t.values()) for t in times]
                      + [sum(t.values()) for t in plain])
        parts.append(times[:2])
        counts.append(n + n_plain)
        log(f"fused_dropout_matmul timing round {r + 1} (device ms per "
            f"call): main shape forward {rounds[-1][0]:.4f}, backward "
            f"{rounds[-1][1]:.4f}, F.dropout + conv2d {rounds[-1][2]:.4f} / "
            f"{rounds[-1][3]:.4f}; EfficientNet heads forward / backward "
            + ", ".join(f"{rounds[-1][4 * i]:.4f} / "
                        f"{rounds[-1][4 * i + 1]:.4f}"
                        for i in range(1, len(cases)))
            + f"; main shape in turns, forward at 0 / at element offset "
            f"{offset} " + ", ".join(
                f"{rounds[-1][c]:.4f} / {rounds[-1][c + 1]:.4f}"
                for c in turn_columns(0))
            + "; backward " + ", ".join(
                f"{rounds[-1][c]:.4f} / {rounds[-1][c + 1]:.4f}"
                for c in turn_columns(2))
            + f"; h summed {rounds[-1][len(fns) - 2]:.4f}, h copied "
            f"{rounds[-1][len(fns) - 1]:.4f}; clocks.sm, clocks.mem, "
            f"power.draw after it: {card_clocks()}")
    del keep, h_copy
    same_counts("fused_dropout_matmul", counts)
    med = [statistics.median(col) for col in zip(*rounds)]
    sum_ms, copy_ms = med[len(fns) - 2], med[len(fns) - 1]
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

    # the offset's cost (FDM_OFFSET_TURNS): the medians of the turns at
    # offset 0 and at the offset, over every round, within the phase's
    # spread (the largest max - min over the rounds of any of the port's
    # kernels timed here) or FDM_OFFSET_SHARE of offset 0's median
    kernel_cols = [4 * i + j for i in range(len(cases)) for j in (0, 1)]
    kernel_cols += [c for j in range(4) for c in turn_columns(j)]
    spread = max(max(r[c] for r in rounds) - min(r[c] for r in rounds)
                 for c in kernel_cols)

    def turn_median(j: int) -> float:
        return statistics.median(r[c] for r in rounds
                                 for c in turn_columns(j))

    offset_ms = (turn_median(1), turn_median(3))
    for j, direction in enumerate(("forward", "backward")):
        base = turn_median(2 * j)
        diff = abs(offset_ms[j] - base)
        bound = max(spread, FDM_OFFSET_SHARE * base)
        log(f"fused_dropout_matmul {direction} at the main shape, in turns: "
            f"{base:.4f} ms at offset 0, {offset_ms[j]:.4f} ms at element "
            f"offset {offset} (medians of {FDM_OFFSET_TURNS} turns x "
            f"{FDM_TIMING_ROUNDS} rounds; difference {diff:.4f} ms, allowed "
            f"{bound:.4f}: the phase's spread {spread:.4f} ms or "
            f"{FDM_OFFSET_SHARE:.0%} of offset 0's)")
        if diff > bound:
            raise AssertionError(f"fused_dropout_matmul {direction}: the "
                                 f"kernel at an element offset times "
                                 f"{diff:.4f} ms away from offset 0, beyond "
                                 f"{bound:.4f} ms")
    int_est = integer_pipe_ms(torch, FDM_SHAPE[3], h.numel())
    rows = []
    for i, (shape, (h, w, _, _, _), first) in enumerate(cases):
        k_ = shape[3]
        n_h, n_y = h.numel(), first["y"].numel()
        ops = 2 * n_h * k_
        fwd_bytes = 4 * (n_h + w.numel() + k_ + n_y)
        bwd_bytes = 4 * (n_h + w.numel() + n_y + n_h + w.numel() + k_)
        plain = med[len(fns):]
        for j, (direction, nbytes, nops, err, line) in enumerate((
                ("fwd", fwd_bytes, ops, first["y_err"], 139),
                ("bwd", bwd_bytes, 2 * ops, first["dh_err"], 148))):
            est = int_est["forward" if j == 0 else "backward"]
            extra = ("" if i else f"; integer pipe estimated at "
                     f"{est[0]:.4f}-{est[1]:.4f} ms")
            rows.append(fdm_row(
                fdm_row_name(direction, shape), shape, med[4 * i + j],
                plain[2 * i + j], med[4 * i + 2 + j], nbytes, nops, err,
                line, rate, extra))
            if i == 0:
                rows[-1]["offset_ms"] = offset_ms[j]
    return rows


def check_fdm_offset(torch, inputs, first: dict, rate: float) -> int:
    """The main shape's kernels at a data-parallel rank's element offset:
    against their plain versions there (check_fdm, masks bit for bit); the
    offset's mask of rows FDM_OFFSET_ROWS.. equal to those rows of the
    offset-0 mask of the whole batch; and the kernels on those rows alone,
    at the offset, equal to the rows of the offset-0 run (y and dh, bit for
    bit: each row's sums are the same in both). Returns the offset."""
    from neuralbarkcalculator_tpu_torch.ops.fused_dropout_matmul import (
        dropout_mask, fused_dropout_matmul_backward,
        fused_dropout_matmul_forward)

    h, w, bias, g, dseed = inputs
    r0 = FDM_OFFSET_ROWS
    offset = r0 * h[0].numel()
    check_fdm(torch, "main shape at a rank's offset", h, w, bias, g, dseed,
              rate, (0.18, 0.22), offset)
    rows_mask = dropout_mask((h.shape[0] - r0, *h.shape[1:]), dseed, rate,
                             offset, h.device)
    same_mask = torch.equal(rows_mask, dropout_mask(
        h.shape, dseed, rate, 0, h.device)[r0:])
    part, g_part = h[r0:].contiguous(), g[r0:].contiguous()
    y = fused_dropout_matmul_forward(part, w, bias, dseed, rate, offset)
    dh, _, _ = fused_dropout_matmul_backward(part, w, g_part, dseed, rate,
                                             offset)
    torch.cuda.synchronize()
    same_y = torch.equal(y, first["y"][r0:])
    same_dh = torch.equal(dh, first["dh"][r0:])
    log(f"fused_dropout_matmul rows {r0}-{h.shape[0] - 1} of the main shape "
        f"at element offset {offset}: the mask equals those rows of the "
        f"offset-0 mask {same_mask}; the kernels on those rows equal the "
        f"offset-0 run's rows bit for bit: y {same_y}, dh {same_dh}")
    if not (same_mask and same_y and same_dh):
        raise AssertionError("fused_dropout_matmul at an element offset is "
                             "not the global batch's rows")
    return offset


def ccl_maps(np, rng, shape: tuple) -> "np.ndarray":
    """int64 class maps {0, 1, 2} of `shape`, one kind of CCL_KINDS an
    image: random pixels with that share of class 0 (the rest bark, a
    fifth of it node), blob maps shaped like real masks (regions of a
    64-pixel scale with 8-pixel detail and pixel noise, so zones of every
    size down to single pixels), an all-class-0 and an all-bark image."""
    b, h, w = shape
    out = np.empty(shape, np.int64)
    for i, kind in enumerate(CCL_KINDS[b]):
        if kind.startswith("random"):
            p0 = float(kind.split()[1])
            out[i] = rng.choice(3, size=(h, w),
                                p=[p0, 0.8 * (1 - p0), 0.2 * (1 - p0)])
        elif kind == "blobs":
            field = (np.kron(rng.random((h // 64, w // 64)), np.ones((64, 64)))
                     + 0.5 * np.kron(rng.random((h // 8, w // 8)),
                                     np.ones((8, 8)))
                     + 0.25 * rng.random((h, w)))
            out[i] = np.where(field < 0.85, 0,
                              np.where(rng.random((h, w)) < 0.05, 2, 1))
        else:
            out[i] = 0 if kind == "all class 0" else 1
    return out


def spiral(np, n: int):
    """One spiral of arm spacing 2 over an n x n bool grid (the JAX
    package's worst case for its sweep labelling, tests/test_ccl.py)."""
    grid = np.zeros((n, n), bool)
    top, bottom, left, right = 0, n - 1, 0, n - 1
    while left <= right and top <= bottom:
        grid[top, left:right + 1] = True
        grid[top:bottom + 1, right] = True
        grid[bottom, left:right + 1] = True
        if left + 2 <= right:
            grid[top:bottom + 1, left] = False
            grid[top + 2:bottom + 1, left + 2] = True
        top += 2
        bottom -= 2
        left += 2
        right -= 2
    return grid


def ccl_expect(kind: str) -> dict[str, int]:
    """The device kernels one ccl wrapper call launches, by label: one
    labelling is a tile, a border and a finalize kernel."""
    if kind == "labels":
        return {"ccl_tile_kernel": 1, "ccl_border_kernel": 1,
                "ccl_finalize_kernel": 1}
    return {"ccl_tile_kernel": 2, "ccl_border_kernel": 2,
            "ccl_finalize_kernel": 2, "ccl_writeback_kernel": 1}


def ccl_design_bytes(elem_bytes: int, pixels: int) -> int:
    """The bytes remove_small_zones moves in csrc/ccl.cu's design, roots
    left out: the map read twice (holes tile load, write-back), the result
    written, two int32 label planes written and read once each."""
    return (3 * elem_bytes + 16) * pixels


def scipy_labels(np, ndimage, mask):
    """label_components' contract from scipy.ndimage.label (8-connected):
    each component at its smallest per-image flat index, H * W on the
    background; [B, H, W] bool in, int32 out."""
    out = np.empty(mask.shape, np.int32)
    for i, m in enumerate(mask):
        lab, n = ndimage.label(m, structure=np.ones((3, 3), bool))
        smallest = np.full(n + 1, m.size, np.int32)
        ids, first = np.unique(lab.ravel(), return_index=True)
        smallest[ids[ids > 0]] = first[ids > 0]  # raster order
        out[i] = smallest[lab]
    return out


def ccl_border_maps(np, rng, tile: tuple) -> list:
    """(label, class maps [B, H, W], valid_h or None) of CCL_BORDER_SHAPES
    and the maps that stress the tile borders, built for `tile`."""
    th, tw = tile
    n = 1024
    maps = []
    for h, w in CCL_BORDER_SHAPES:
        maps.append((f"random {h}x{w}", rng.choice(
            3, size=(2, h, w), p=[0.5, 0.4, 0.1]).astype(np.int64), None))
    rows, cols = np.indices((n, n))
    maps.append(("checkerboard", np.where((rows + cols) % 2 == 0, 0, 1)
                 [None].astype(np.int32), None))
    corners = [(r, c) for r in range(0, n, th) for c in range(0, n, tw)]
    diag = np.zeros((n, n), bool)
    for d in {c - r for r, c in corners}:
        diag |= cols - rows == d
    for d in {c + r for r, c in corners}:
        diag |= cols + rows == d
    maps.append(("diagonals through tile corners", np.stack(
        [np.where(diag, 0, 1), np.where(diag, 1, 0)]).astype(np.uint8),
        None))
    lone = np.ones((n, n), np.uint8)
    for r, c in corners:
        for rr, cc in ((r, c), (r, c + tw - 1), (r + th - 1, c),
                       (r + th - 1, c + tw - 1)):
            if rr < n and cc < n:
                lone[rr, cc] = 0
    maps.append(("a lone pixel at each tile corner",
                 np.stack([lone, 1 - lone]), None))
    maps.append((f"ragged, valid_h {list(CCL_BORDER_VALID_H)}", rng.choice(
        3, size=(len(CCL_BORDER_VALID_H), n, n),
        p=[0.5, 0.4, 0.1]).astype(np.uint8),
        np.array(CCL_BORDER_VALID_H, np.int32)))
    return maps


def check_border_maps(torch, np, ndimage, rng) -> int:
    """Every map of ccl_border_maps through the kernels: label_components
    of the class-0 mask and of its complement against scipy,
    component_areas against the areas of scipy's labels, and
    remove_small_zones[_ragged] against the native union-find, all bit
    for bit. Returns the wrapper calls that launched."""
    from neuralbarkcalculator_tpu_torch.io.native import (
        remove_small_zones_batch)
    from neuralbarkcalculator_tpu_torch.ops import ccl

    dev = torch.device("cuda")
    before = ccl.LAUNCHES.count
    for label, maps_np, vh_np in ccl_border_maps(np, rng, CCL_TILE):
        x = torch.from_numpy(maps_np).to(dev)
        for name, m_np in (("class-0 mask", maps_np == 0),
                           ("its complement", maps_np != 0)):
            want = torch.from_numpy(scipy_labels(np, ndimage, m_np)).to(dev)
            m = torch.from_numpy(m_np).to(dev)
            check_exact(torch, f"{label} labels of the {name}",
                        ccl.label_components(m), want)
            check_exact(torch, f"{label} areas of the {name}",
                        ccl.component_areas(m),
                        ccl.component_areas_plain(m, want))
        native = remove_small_zones_batch(maps_np.astype(np.uint8), vh_np)
        got = (ccl.remove_small_zones(x) if vh_np is None else
               ccl.remove_small_zones_ragged(x, torch.from_numpy(vh_np)))
        if got.dtype != x.dtype:
            raise AssertionError(f"ccl {label}: remove_small_zones gave "
                                 f"{got.dtype} for {x.dtype}")
        check_exact(torch, f"{label} remove_small_zones",
                    got.cpu().to(torch.uint8), torch.from_numpy(native))
        log(f"ccl border map {label} {list(maps_np.shape)} {x.dtype}: "
            f"labels and areas of the class-0 mask and its complement equal "
            f"scipy's, remove_small_zones equal to the native union-find")
    return ccl.LAUNCHES.count - before


def check_exact(torch, label: str, got, want) -> int:
    """Raise unless `got` equals `want` bit for bit (dtype too); returns
    the largest absolute difference, 0."""
    if got.dtype != want.dtype or not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"ccl {label}: the kernels differ from the "
                             f"plain version ({got.dtype} vs {want.dtype}, "
                             f"{n} elements differ)")
    return 0


def phase_ccl(torch, seed: int, card: str) -> dict:
    """The ccl kernels on the card against their plain version, bit for
    bit: label_components and component_areas on the class-0 masks and
    remove_small_zones at the eval batch (int64) and a train step's crops,
    remove_small_zones_ragged on the engine's chunk (uint8, valid_h with a
    0); the 1024² spiral against scipy.ndimage.label and the native
    union-find, with the plain version's sweeps; the tile-border maps
    (check_border_maps). Then the kernels timed by device time in
    FDM_TIMING_ROUNDS rounds, by kernel, the plain version by CUDA events
    around one call (seconds a call), beside the native union-find as the
    port ran it before (device-to-host copy, remove_small_zones_batch,
    upload; wall clock) and the byte bound; the log also gives the bytes
    the design moves by its own count (ccl_design_bytes, a model)."""
    import numpy as np
    from scipy import ndimage

    from neuralbarkcalculator_tpu_torch.io.native import (
        remove_small_zones_batch)
    from neuralbarkcalculator_tpu_torch.ops import ccl

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    maps = torch.from_numpy(ccl_maps(np, rng, CCL_EVAL)).to(dev)
    crops = torch.from_numpy(ccl_maps(np, rng, CCL_TRAIN)).to(dev)
    chunk = maps.to(torch.uint8)
    vh = torch.tensor(CCL_RAGGED_H, dtype=torch.int32, device=dev)
    errors = []
    t0 = time.perf_counter()
    for label, x in (("eval batch", maps), ("train crops", crops)):
        mask = x == 0
        before = ccl.LAUNCHES.count
        lab, areas, zones = (ccl.label_components(mask),
                             ccl.component_areas(mask),
                             ccl.remove_small_zones(x))
        torch.cuda.synchronize()
        launched = ccl.LAUNCHES.count - before
        lab_p = ccl.label_components_plain(mask)
        zones_p = ccl.remove_small_zones_plain(x, None)
        errors += [check_exact(torch, f"{label} labels", lab, lab_p),
                   check_exact(torch, f"{label} areas", areas,
                               ccl.component_areas_plain(mask, lab_p)),
                   check_exact(torch, f"{label} remove_small_zones", zones,
                               zones_p)]
        changed = (zones != x).flatten(1).sum(1).tolist()
        kinds = ", ".join(CCL_KINDS[x.shape[0]])
        log(f"ccl {label} {list(x.shape)} {x.dtype} ({kinds}): "
            f"labels, areas and remove_small_zones equal to the plain "
            f"version; {launched} wrapper calls launched; pixels changed "
            f"per image {changed}")
    before = ccl.LAUNCHES.count
    ragged = ccl.remove_small_zones_ragged(chunk, vh)
    torch.cuda.synchronize()
    launched = ccl.LAUNCHES.count - before
    errors.append(check_exact(torch, "ragged chunk", ragged,
                              ccl.remove_small_zones_plain(chunk, vh)))
    for i, h in enumerate(CCL_RAGGED_H):
        if bool(ragged[i, h:].any()):
            raise AssertionError(f"ccl ragged: padded rows of image {i} "
                                 f"are not 0")
    log(f"ccl ragged chunk {list(chunk.shape)} uint8, valid_h "
        f"{list(CCL_RAGGED_H)}: equal to the plain version, padded rows 0; "
        f"{launched} wrapper call launched; checks {time.perf_counter() - t0:.3f} s")

    # the spiral: one component; the union-find is exact, the sweeps may
    # stop at their bound
    grid_np = spiral(np, CCL_SPIRAL)
    grid = torch.from_numpy(grid_np).to(dev)
    lab = ccl.label_components(grid)
    want, n_comp = ndimage.label(grid_np, structure=np.ones((3, 3), bool))
    lab_np = lab.cpu().numpy()
    first = int(np.flatnonzero(grid_np.ravel())[0])
    if n_comp != 1 or set(np.unique(lab_np[grid_np]).tolist()) != {first} \
            or (lab_np[~grid_np] != CCL_SPIRAL ** 2).any():
        raise AssertionError("ccl spiral: the labels are not scipy's single "
                             "component at its smallest index")
    spiral_map = np.where(grid_np, 0, 1).astype(np.uint8)[None]
    native_zones = remove_small_zones_batch(spiral_map)
    card_zones = ccl.remove_small_zones(
        torch.from_numpy(spiral_map).to(dev)).cpu().numpy()
    if not np.array_equal(card_zones, native_zones):
        raise AssertionError("ccl spiral: remove_small_zones differs from "
                             "the native union-find")
    t0 = time.perf_counter()
    lab_p, sweeps = ccl.label_components_plain(grid[None],
                                               return_sweeps=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    log(f"ccl spiral {CCL_SPIRAL}² (arm spacing 2, {int(grid_np.sum())} "
        f"pixels, one component): kernel labels equal scipy.ndimage.label's "
        f"partition and the smallest index; remove_small_zones equal to the "
        f"native union-find; the plain version ran {sweeps} sweeps "
        f"(bound {ccl._MAX_SWEEPS}) in {plain_s:.3f} s, its labels "
        f"{'equal to' if torch.equal(lab_p[0], lab) else 'NOT equal to'} the "
        f"kernels' (not held: the sweeps may stop unconverged)")

    border_launches = check_border_maps(torch, np, ndimage, rng)

    # timing
    mask = maps == 0
    fns = (lambda: ccl.remove_small_zones(maps),
           lambda: ccl.remove_small_zones_ragged(chunk, vh),
           lambda: ccl.remove_small_zones(crops),
           lambda: ccl.label_components(mask))
    expect = (ccl_expect("zones"), ccl_expect("zones"), ccl_expect("zones"),
              ccl_expect("labels"))
    names = ("eval batch", "ragged chunk", "train crops", "labels alone")
    rounds, counts, by_kernel = [], [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, expect)
        rounds.append([sum(t.values()) for t in times])
        counts.append(n)
        by_kernel.append(times)
        log(f"ccl timing round {r + 1} (device ms per call): "
            + ", ".join(f"{name} {t:.4f}" for name, t in zip(names, rounds[-1]))
            + f"; by kernel: "
            + "; ".join(f"{name} { {k: round(v, 4) for k, v in t.items()} }"
                        for name, t in zip(names, times))
            + f"; clocks.sm, clocks.mem, power.draw after it: "
              f"{card_clocks()}")
    same_counts("ccl", counts)
    ms, ragged_ms, crops_ms, labels_ms = (statistics.median(col)
                                          for col in zip(*rounds))
    eval_by_kernel = {k: statistics.median(t[0][k] for t in by_kernel)
                      for k in by_kernel[0][0]}
    # the plain version (~10^5 small kernels and a host sync a sweep) by
    # CUDA events around one call: a profiler session of its events took
    # minutes to read on an H100
    plain_ms = time_ms(torch, lambda: ccl.remove_small_zones_plain(maps, None),
                       warmup=0, reps=1, runs=1)
    native_s = []
    for _ in range(FDM_TIMING_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = remove_small_zones_batch(maps.to(torch.uint8).cpu().numpy())
        torch.from_numpy(out).to(dev)
        torch.cuda.synchronize()
        native_s.append(time.perf_counter() - t0)
    native_ms = statistics.median(native_s) * 1e3
    nbytes = 2 * maps.numel() * maps.element_size()
    bound = nbytes / H100_HBM_BYTES * 1e3
    chunk_bound = 2 * chunk.numel() / H100_HBM_BYTES * 1e3
    design = ccl_design_bytes(maps.element_size(), maps.numel())
    chunk_design = ccl_design_bytes(1, chunk.numel())
    log(f"ccl ({card}): remove_small_zones at the eval batch "
        f"{list(maps.shape)} int64: kernels {ms:.4f} ms (the per-pixel "
        f"union-find it replaced: {CCL_PER_PIXEL_MS} ms on an H100 80GB HBM3 "
        f"at 700 W, PERF.md's figure, not this run's), by kernel "
        f"{ {k: round(v, 4) for k, v in eval_by_kernel.items()} }; plain "
        f"{plain_ms:.4f} ms (one call, CUDA events), native union-find as "
        f"before (copy to the host, remove_small_zones_batch, upload; wall "
        f"clock, median of {FDM_TIMING_ROUNDS}) {native_ms:.4f} ms; byte "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB: the map read once, "
        f"the result written once; {bound / ms:.4f} of it); the design's "
        f"byte model {design / 1e6:.3f} MB, "
        f"{design / H100_HBM_BYTES * 1e3:.4f} ms at the memory rate (a "
        f"count, not a time of this run); ragged chunk uint8 "
        f"{ragged_ms:.4f} ms (bound {chunk_bound:.4f}, byte model "
        f"{chunk_design / H100_HBM_BYTES * 1e3:.4f}); train crops "
        f"{crops_ms:.4f} ms; labels alone {labels_ms:.4f} ms; border-map "
        f"wrapper calls {border_launches}")
    return {
        "name": "ccl", "route": "cuda",
        "source": "neuralbarkcalculator_tpu_torch/csrc/ccl.cu",
        "replaces": "neuralbarkcalculator_tpu/ops/ccl.py:206",
        "launches": 0, "max_abs_err": max(errors), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None, "native_ms": native_ms,
        "ragged_ms": ragged_ms, "train_crops_ms": crops_ms,
        "labels_ms": labels_ms, "spiral_plain_sweeps": sweeps,
        "eval_ms_by_kernel": eval_by_kernel,
    }


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
    with step_clock(torch) as step_s:
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
    for name in ("fused_dropout_matmul_fwd", "fused_dropout_matmul_bwd",
                 "ccl"):
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
    warm = step_s[1:]
    log(f"train path: {steps} steps of batch {exp.config.batch_size} at "
        f"crop {exp.config.crop_size} (fcn_resnet50, float32, TF32 off, "
        f"dropout {exp.config.dropout}) in an epoch of "
        f"{exp.history[0].time_s:.3f} s; whole CLI run {seconds:.3f} s; "
        f"launches {launches}")
    log(f"train path: step times (device clock) "
        f"{[round(s * 1e3, 3) for s in step_s]} ms; warm steps "
        f"2..{steps}: median {statistics.median(warm) * 1e3:.3f} ms; peak "
        f"memory allocated {peak / 2 ** 30:.3f} GiB")
    log(f"train path: losses {[round(x, 6) for x in exp.step_losses]}; "
        f"epoch log {exp.history[0].as_dict()}")
    log(f"train path: epoch minus steps (validation and the loop's host "
        f"work) {exp.history[0].time_s - sum(step_s):.3f} s; ccl "
        f"launched {launches['ccl']} times (validation, test and the "
        f"report's PixelWiseF1)")
    eval_f1_card_vs_cpu(torch, exp)
    profile_train_step(torch, exp)
    return {"launches": launches, "step_ms": statistics.median(warm) * 1e3}


def eval_f1_card_vs_cpu(torch, exp) -> None:
    """PixelWiseF1 of one validation image of the trained model on the
    card (the ccl kernels) against the same logits' on the CPU (the plain
    version), equal bit for bit: the CCL is exact and the counts are
    integers."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.ops import ccl
    from neuralbarkcalculator_tpu_torch.ops.metrics import pixelwise_f1

    rows = np.asarray(exp.valid_split[:1])
    images, labels, idx = exp.batch_inputs(rows)
    exp.model.eval()
    with torch.no_grad():
        x = (images[idx].float() / 255.0 - exp._mean) / exp._std
        logits, labs = exp.model(x), labels[idx].long()
        before = ccl.LAUNCHES.count
        f1 = pixelwise_f1(logits, labs).cpu()
        launched = ccl.LAUNCHES.count - before
        t0 = time.perf_counter()
        f1_cpu = pixelwise_f1(logits.cpu(), labs.cpu())
    log(f"train path: eval F1 of validation image {int(rows[0])} "
        f"{list(logits.shape)}: card {f1.tolist()} ({launched} ccl call), "
        f"CPU {f1_cpu.tolist()} (plain version, "
        f"{time.perf_counter() - t0:.3f} s)")
    if launched != 1 or not torch.equal(f1, f1_cpu):
        raise AssertionError("the eval F1 on the card differs from the "
                             "CPU's, or the card did not run the ccl kernels")


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


def profile_train_step(torch, exp, label: str = "train") -> dict:
    """One more train step of the experiment under torch.profiler: device
    time by kernel group (convolutions, batch norm, elementwise, the
    Lovász sort, the fused dropout kernels), against the step's wall
    time. Returns the groups' device ms (empty when the profiler recorded
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralbarkcalculator_tpu_torch.train.step import train_step

    idx = torch.as_tensor(exp.train_split[:exp.config.batch_size],
                          device=exp.device)

    def step():
        train_step(exp.model, exp.opt, exp.images, exp.labels, idx,
                   exp.augment_gen, 12345, exp.config.crop_size, exp._mean,
                   exp._std, exp.config.jitter_brightness,
                   exp.config.jitter_saturation, exp.loss_fn,
                   exp.config.use_bfloat16)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels and copies; not the user annotations that torch
    # records on the device timeline too (Optimizer.step#Adam.step spans
    # the optimizer's own kernels)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]

    def event_ms(e) -> float:
        return event_device_us(e) / 1e3

    busy = sum(event_ms(e) for e in events)
    if busy == 0:
        log(f"{label} profile: the profiler recorded no device time (not "
            f"measured)")
        return {}
    groups: dict[str, float] = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in STEP_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + event_ms(e)
    log(f"{label} profile: one step, device busy {busy:.3f} ms in a "
        f"profiled step of {wall_ms:.3f} ms wall (busy share "
        f"{busy / wall_ms:.4f}), {sum(e.count for e in events)} device "
        f"events")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{label} profile: {group:22s} {ms:9.3f} ms ({ms / busy:.4f})")
    for e in sorted(events, key=event_ms, reverse=True)[:10]:
        log(f"{label} profile: {event_ms(e):9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")
    return groups


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


def losses_card_vs_cpu(torch, seed: int) -> None:
    """Every loss of the training menu, value and gradient with respect to
    the logits, on the same [5, 512, 512, 3] logits (the recipe's batch
    and crop) on the card and on the CPU, with and without a validity mask
    (one image's lower half masked): in float64 within LOSS_WITNESS_TOL,
    then in float32 within LOSS_VALUE_TOL / LOSS_GRAD_TOL (the constants
    say why). Prints each loss's float32 value and gradient time on the
    card (CUDA events, 5 calls)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.train.step import (LOSS_NAMES,
                                                           make_loss_fn)

    rng = np.random.default_rng(seed)
    b_, crop = 5, 512
    logits = 2.0 * rng.standard_normal((b_, crop, crop, 3))
    labels = np.kron(rng.integers(0, 3, (b_, crop // 32, crop // 32)),
                     np.ones((1, 32, 32), np.int64))
    mask = np.ones((b_, crop, crop))
    mask[-1, crop // 2:] = 0.0
    for name in LOSS_NAMES:
        fn = make_loss_fn(name)
        for dtype in (torch.float64, torch.float32):
            v_tol, g_tol = ((LOSS_WITNESS_TOL, LOSS_WITNESS_TOL)
                            if dtype == torch.float64 else
                            (LOSS_VALUE_TOL, LOSS_GRAD_TOL[name]))
            for masked in (False, True):
                out = {}
                for dev in ("cuda", "cpu"):
                    x = torch.from_numpy(logits).to(dev, dtype)
                    x.requires_grad_(True)
                    kw = ({"pixel_weights": torch.from_numpy(mask).to(
                        dev, dtype)} if masked else {})
                    value = fn(x, torch.from_numpy(labels).to(dev), **kw)
                    value.backward()
                    out[dev] = (float(value.detach()), x.grad.cpu())
                (vc, gc_), (vp, gp) = out["cuda"], out["cpu"]
                v_err = abs(vc - vp) / abs(vp)
                g_err = float((gc_ - gp).norm() / gp.norm())
                timed = ""
                if dtype == torch.float32:
                    x = torch.from_numpy(logits).to("cuda", dtype)
                    x.requires_grad_(True)
                    y = torch.from_numpy(labels).cuda()
                    kw = ({"pixel_weights": torch.from_numpy(mask).to(
                        "cuda", dtype)} if masked else {})
                    ms = time_ms(torch, lambda: fn(x, y, **kw).backward(),
                                 warmup=1, reps=5, runs=1)
                    timed = f"; value + gradient {ms:.3f} ms on the card"
                log(f"loss {name}{' masked' if masked else ''} "
                    f"{str(dtype)[6:]} on [{b_}, {crop}, {crop}, 3]: card "
                    f"{vc:.10f}, CPU {vp:.10f} (relative {v_err:.3g}, "
                    f"allowed {v_tol:g}); gradient L2 error {g_err:.3g} "
                    f"(allowed {g_tol:g}){timed}")
                if v_err > v_tol or g_err > g_tol:
                    raise AssertionError(f"loss {name} {dtype}: the card "
                                         f"disagrees with the CPU")


def zoo_train_model(torch, seed: int, data_dir: str, root: str,
                    name: str, bf16: bool = False) -> dict:
    """One zoo model trained on the card through Experiment, in float32
    or (``bf16``) under bf16 autocast: full width and depth, the recipe's
    batch 5, crop 512 and pad 1024, one epoch of
    ZOO_TRAIN_SAMPLES_FACTOR * 24 // 5 steps, validation and checkpoint,
    every launch count set to 0 just before and read just after; then a
    profiled step by kernel group, and the exported best_model.pt loaded by
    the predict engine, which answers one 1024 x 1024 image."""
    import gc
    import math

    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import (PredictConfig,
                                                       TrainConfig)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)
    from neuralbarkcalculator_tpu_torch.train.loop import Experiment

    label = f"{name} bf16" if bf16 else name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    exp = Experiment(data_dir, os.path.join(root, label.replace(" ", "_")),
                     config=TrainConfig(
                         seed=seed, epochs=1, use_bfloat16=bf16,
                         samples_per_epoch_factor=ZOO_TRAIN_SAMPLES_FACTOR),
                     model_name=name, device="cuda")
    with step_clock(torch) as step_s:
        exp.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = exp.step_count
    if steps < 6 or not all(math.isfinite(x) for x in exp.step_losses):
        raise AssertionError(f"zoo train {label}: {steps} steps, losses "
                             f"{exp.step_losses}")
    fdm = (launches["fused_dropout_matmul_fwd"],
           launches["fused_dropout_matmul_bwd"])
    want = (steps, steps) if name.startswith("fcn") else (0, 0)
    if fdm != want or launches["upsample_argmax"]:
        raise AssertionError(f"zoo train {label}: launches {launches}, "
                             f"fused_dropout_matmul expected {want}")
    warm = statistics.median(step_s[1:]) * 1e3
    log(f"zoo train {label}: {steps} steps (batch {exp.config.batch_size}, "
        f"crop {exp.config.crop_size}, {'bf16' if bf16 else 'float32'}, "
        f"TF32 off) in an epoch of "
        f"{exp.history[0].time_s:.3f} s; Experiment + epoch {seconds:.3f} "
        f"s; step times (device clock) "
        f"{[round(x * 1e3, 3) for x in step_s]} ms; warm median "
        f"{warm:.3f} ms; peak memory allocated {peak:.3f} GiB; losses "
        f"{[round(x, 6) for x in exp.step_losses]}; launches {launches}")
    groups = profile_train_step(torch, exp, f"zoo train {label}")
    best = exp.ckpts.best_model_path
    del exp
    gc.collect()
    torch.cuda.empty_cache()
    engine = NeuralBarkCalculator(best, model_name=name, device="cuda",
                                  config=PredictConfig(model_path=best))
    img = np.random.default_rng(seed).integers(0, 256, (1024, 1024, 3),
                                               dtype=np.uint8)
    (_, class_map), = engine.predict_images(
        [ProcessedImage(img, "zoo.png", "sapin")])
    if class_map.shape != (1024, 1024) or int(class_map.max()) > 2:
        raise AssertionError(f"zoo train {label}: the engine answered "
                             f"{class_map.shape} max {class_map.max()}")
    log(f"zoo train {label}: the predict engine loaded its best_model.pt "
        f"and answered a 1024 x 1024 image: class shares "
        f"{np.bincount(class_map.reshape(-1), minlength=3) / class_map.size}")
    del engine
    return {"step_ms": warm, "peak_gib": peak, "launches": launches,
            "groups": groups, "steps": steps}


def zoo_train_cli(torch, seed: int, data_dir: str, workdir: str) -> dict:
    """cli/train.main for deeplabv3_resnet50 on the card: one epoch in bf16
    with lovasz_hist from a random torchvision-named ResNet-50 file
    (--backbone_ckpt), with the report; then --resume --epochs 2
    --no_report, which must start at epoch 2 with the checkpoint's lr.
    Launch counts set to 0 before each run and read after."""
    import math

    from neuralbarkcalculator_tpu_torch.cli.train import (build_parser,
                                                          main as train_main)
    from neuralbarkcalculator_tpu_torch.models.resnet import (
        resnet50_dilated)

    root = os.path.join(workdir, "cli_train_root")
    os.makedirs(root)
    ckpt = os.path.join(root, "resnet50_random.pth")
    torch.manual_seed(seed)
    torch.save({**resnet50_dilated().state_dict(),
                "fc.weight": torch.randn(1000, 2048) * 0.01,
                "fc.bias": torch.zeros(1000)}, ckpt)
    common = [root, "--seed", str(seed), "--data_dir", data_dir,
              "--model", "deeplabv3_resnet50", "--samples_factor", "1",
              "--bf16", "--loss", "lovasz_hist"]
    out = {}
    for run, extra in (("first", ["--epochs", "1", "--backbone_ckpt", ckpt,
                                  "--report_dpi", str(DPI)]),
                       ("resumed", ["--epochs", "2", "--resume",
                                    "--no_report"])):
        counters = reset_counters()
        t0 = time.perf_counter()
        with step_clock(torch) as step_s:
            exp = train_main(build_parser().parse_args(common + extra))
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in counters.items()}
        log(f"zoo train CLI {run} run ({' '.join(extra)}): epochs "
            f"{[h.epoch for h in exp.history]}, lr "
            f"{[h.lr for h in exp.history]}, steps {exp.step_count}, step "
            f"times (device clock) "
            f"{[round(x * 1e3, 3) for x in step_s]} ms, losses "
            f"{[round(x, 6) for x in exp.step_losses]}, "
            f"{time.perf_counter() - t0:.3f} s, launches {launches}")
        if not exp.config.use_bfloat16 or not all(
                math.isfinite(x) for x in exp.step_losses):
            raise AssertionError(f"zoo train CLI {run} run")
        out[run] = exp
        del exp
    moar = os.path.join(root, "moar")
    first = torch.load(os.path.join(moar, "checkpoint_epoch_1.pt"),
                       map_location="cpu", weights_only=True)
    file_w = torch.load(ckpt, weights_only=True)["conv1.weight"]
    moved = float((first["model"]["backbone.conv1.weight"] - file_w).abs()
                  .max())
    steps1 = first["step"]
    steps2 = torch.load(os.path.join(moar, "checkpoint_epoch_2.pt"),
                        map_location="cpu", weights_only=True)["step"]
    lr1 = first["optimizer"]["param_groups"][0]["lr"]
    resumed = out["resumed"]
    log(f"zoo train CLI: the backbone moved {moved:.3g} from the file in "
        f"{steps1} Adam steps at lr {lr1:g} (a fresh init is O(0.1) away); "
        f"the resumed run's epochs {[h.epoch for h in resumed.history]} at "
        f"lr {[h.lr for h in resumed.history]}, step count {steps2} at its "
        f"end")
    if moved > 10 * lr1 * steps1:
        raise AssertionError("the backbone checkpoint was not loaded")
    if [h.epoch for h in resumed.history] != [2] or \
            resumed.history[0].lr != lr1 or steps2 != 2 * steps1:
        raise AssertionError("the resumed run did not continue at epoch 2 "
                             "with the restored lr and step count")
    return {"steps": steps1}


def zoo_train(torch, seed: int, root: str, workdir: str) -> dict:
    """The zoo train phase's body (run in a child process): the losses on
    the card against the CPU, ZOO_TRAIN each trained, ZOO_TRAIN_BF16 in
    bf16, then the CLI run."""
    data_dir = os.path.join(root, "Images", "1024_with_jedi")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses_card_vs_cpu(torch, seed)
    out = {name: zoo_train_model(torch, seed, data_dir, workdir, name)
           for name in ZOO_TRAIN}
    out[f"{ZOO_TRAIN_BF16} bf16"] = zoo_train_model(
        torch, seed, data_dir, workdir, ZOO_TRAIN_BF16, bf16=True)
    zoo_train_cli(torch, seed, data_dir, workdir)
    return out


def predict_shard_child(torch, argv: list[str]) -> dict:
    """The sharded-predict phase's child (``--predict-shard ARGV``):
    cli/predict.main on ARGV with every launch count set to 0 just before
    and read just after; returns them and the run's seconds."""
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main

    counters = reset_counters()
    t0 = time.perf_counter()
    main(build_parser().parse_args(argv))
    torch.cuda.synchronize()
    return {"launches": {name: c.count for name, c in counters.items()},
            "seconds": time.perf_counter() - t0}


def copy_folder(src_root: str, dst_root: str, as_sources: bool) -> None:
    """The main path's processed folder under `dst_root`, with empty
    results/ folders; with `as_sources` also as its samples/ (1024-wide
    sources that the preprocess leaves as they are, and finds done)."""
    import shutil

    src = os.path.join(src_root, "processed", "samples")
    shutil.copytree(src, os.path.join(dst_root, "processed", "samples"))
    if as_sources:
        shutil.copytree(src, os.path.join(dst_root, "samples"))
    for wood in os.listdir(src):
        for sub in ("combined_images", "outputs"):
            os.makedirs(os.path.join(dst_root, "results", sub, wood))


def phase_sharded_predict(torch, workdir: str, main_root: str, ckpt: str,
                          main_seconds: float, card: str) -> dict:
    """Sharded folder prediction on the card: `cli/predict --shard k/N
    --float32` for k < SHARDS as concurrent child processes over the main
    path's folder and checkpoint (shard 0 owns the preprocess, which finds
    every image done, and merges), against the single-process float32
    engine over a copy of the folder. Every artifact exactly once, the
    merged CSV's names and order equal, the rows whose bytes differ
    counted, the dual masks agreeing on >= SHARD_AGREE_FLOOR of pixels
    (cuDNN may take other algorithms for other batch compositions: byte
    identity is held in the CPU tests). Each shard's launch counts are set
    to 0 before its run and read after; each must launch upsample_argmax.
    Returns the shards' upsample_argmax launches, and the single process's
    warm pass: its seconds, its native postprocess's seconds and its
    folder."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.utils import profiling

    single_root = os.path.join(workdir, "single_f32")
    shard_root = os.path.join(workdir, "sharded")
    copy_folder(main_root, single_root, False)
    copy_folder(main_root, shard_root, True)
    f32 = NeuralBarkCalculator(
        ckpt, config=PredictConfig(model_path=ckpt, use_bfloat16=False,
                                   figure_dpi=DPI))
    f32.predict(single_root, progress=False)  # warm-up
    profiling.report(reset=True)
    t0 = time.perf_counter()
    with open(f32.predict(single_root, progress=False), "rb") as f:
        single = f.read()
    single_s = time.perf_counter() - t0
    post_s = postprocess_seconds(profiling.report(reset=True))
    del f32

    argv = [shard_root, "--model_path", ckpt, "--float32", "--dpi", str(DPI),
            "--preprocess_backend", "device"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--predict-shard",
         *argv, "--shard", f"{k}/{SHARDS}"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(SHARDS)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    shards = []
    for k, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"shard {k}/{SHARDS} exited {p.returncode}: "
                               f"{err[-3000:]}")
        shards.append(json.loads(out.strip().splitlines()[-1]))

    results = os.path.join(shard_root, "results")
    with open(os.path.join(results, "final_stats.csv"), "rb") as f:
        merged = f.read()
    leftovers = [n for n in os.listdir(results) if ".shard-" in n]
    got_rows, want_rows = (merged.decode().splitlines(),
                           single.decode().splitlines())
    same_names = ([r.split("\t")[:2] for r in got_rows]
                  == [r.split("\t")[:2] for r in want_rows])
    differ = sum(a != b for a, b in zip(got_rows, want_rows))
    agree = total = 0
    for row in want_rows[1:]:
        fname, wood = row.split("\t")[:2]
        for sub in ("combined_images", "outputs"):
            if not os.path.isfile(os.path.join(results, sub, wood, fname)):
                raise AssertionError(f"sharded run: missing {sub}/{fname}")
        a = load_image_u8(os.path.join(results, "outputs", wood, fname),
                          grayscale=True)
        b = load_image_u8(os.path.join(single_root, "results", "outputs",
                                       wood, fname), grayscale=True)
        agree += int((a == b).sum())
        total += b.size
    counts = {sub: sum(len(files) for _, _, files in os.walk(
        os.path.join(results, sub))) for sub in ("combined_images",
                                                 "outputs")}
    launches = [sh["launches"]["upsample_argmax"] for sh in shards]
    log(f"sharded predict ({card}): {SHARDS} processes of cli/predict "
        f"--shard k/{SHARDS} --float32 on one card over the {N_IMAGES}-image "
        f"folder: wall {wall:.3f} s from launch to both exits (process start "
        f"and model load included); the shards' own CLI runs "
        f"{[round(sh['seconds'], 3) for sh in shards]} s; launches "
        f"{[sh['launches'] for sh in shards]}; single-process float32 "
        f"engine, warm pass {single_s:.3f} s; the main path's bf16 warm "
        f"pass {main_seconds:.3f} s")
    log(f"sharded predict: merged final_stats.csv {len(got_rows) - 1} rows, "
        f"names and order equal {same_names}; "
        f"{differ} rows differ in bytes from the single process's; dual "
        f"masks agree on {agree / total:.6f} of pixels (floor "
        f"{SHARD_AGREE_FLOOR}); artifacts {counts}; shard files left "
        f"{leftovers}")
    if not same_names or leftovers \
            or counts != {"combined_images": N_IMAGES, "outputs": N_IMAGES}:
        raise AssertionError("sharded predict: the merged CSV's rows or the "
                             "artifacts differ from the single process's")
    if agree / total < SHARD_AGREE_FLOOR:
        raise AssertionError(f"sharded predict: masks agree on "
                             f"{agree / total:.6f} < {SHARD_AGREE_FLOOR}")
    if min(launches) == 0 or any(
            sh["launches"]["fused_dropout_matmul_fwd"]
            or sh["launches"]["fused_dropout_matmul_bwd"] for sh in shards):
        raise AssertionError(f"sharded predict launches: "
                             f"{[sh['launches'] for sh in shards]}")
    return {"launches": launches, "single_s": single_s,
            "single_postprocess_s": post_s, "single_root": single_root}


def expected_halo_bytes(model_name: str, rows: int, pad_h: int,
                        n_model: int, rank: int, elem: int,
                        int8: bool = False) -> int:
    """The halo bytes model rank ``rank`` of ``n_model`` receives from
    other ranks in one launch of ``rows`` images at ``pad_h``, worked out
    from the factory's shapes alone. The dilated ResNets: the max pool's
    (1, 0) columns on the stem's 64 channels (``elem``-byte elements, the
    engine's dtype), each block's conv2 (1-byte elements after the stem
    for int8). EfficientNet: each block's depthwise SAME conv, its
    ``same_halo`` on its expanded channels at the block's input height
    (the 3x3/2 stem's halo comes with the input). Then the FCN head's 3x3,
    or the ASPP's one exchange at the widest rate that reads past its
    centre tap (float: unless the rate reaches past the map's height and
    width; int8: past its width) and the DeepLab head's 3x3. A halo wider
    than a strip takes columns from as many ranks as it spans, none past
    the image."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        EfficientNetBackbone)
    from neuralbarkcalculator_tpu_torch.models.heads import (
        ASPP_CHANNELS, ASPP_RATES, DeepLabHead)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import same_halo
    import torch

    with torch.device("meta"):  # the layout only
        layout = MODEL_FACTORIES[model_name]()

    def received(left, right, channels, height, w, e):
        cols = min(left, rank * w) + min(right, (n_model - 1 - rank) * w)
        return e * rows * channels * height * cols

    q = 1 if int8 else elem
    if isinstance(layout.backbone, EfficientNetBackbone):
        total = 0
        height, w = -(-pad_h // 2), WIDTH // 2 // n_model
        for block in layout.backbone.model._blocks:
            c = block._depthwise_conv
            s_ = c.stride[1]
            total += received(*same_halo(c.kernel_size[1], s_),
                              c.in_channels, height, w, elem)
            height, w = -(-height // s_), w // s_
    else:
        total = received(1, 0, 64, pad_h // 2, WIDTH // 2 // n_model, elem)
        height, w = pad_h // 4, WIDTH // 4 // n_model
        for stage in range(4):
            for block in getattr(layout.backbone, f"layer{stage + 1}"):
                c = block.conv2
                s_, d = c.stride[1], c.dilation[1]
                total += received(d, d - s_ + 1, c.in_channels, height, w,
                                  q)
                height //= s_
                w //= s_
    head = layout.classifier
    if not isinstance(head, DeepLabHead):
        return total + received(1, 1, head[0].in_channels, height, w, q)
    rates = [d for d in ASPP_RATES
             if d < w * n_model or (not int8 and d < height)]
    if rates:
        total += received(max(rates), max(rates), head.in_channels, height,
                          w, q)
    return total + received(1, 1, ASPP_CHANNELS, height, w, q)


def expected_reduced_bytes(model_name: str, rows: int, int8: bool) -> int:
    """The reductions over the model group in one launch of ``rows``
    images, in bytes of the full-width tensor each reduces: EfficientNet's
    squeeze-excite column sums [rows, C, W] float32 of every block (C its
    expanded channels, W the full width after its stride), and DeepLab's
    pooled branch, its column sums [rows, C, WIDTH / stride] float32 or
    its int8 map's sums [rows, C] int32."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        EfficientNetBackbone)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)
    import torch

    with torch.device("meta"):  # the layout only
        layout = MODEL_FACTORIES[model_name]()
    total = 0
    if isinstance(layout.backbone, EfficientNetBackbone):
        w = WIDTH // 2
        for block in layout.backbone.model._blocks:
            c = block._depthwise_conv
            w //= c.stride[1]
            total += rows * c.out_channels * w * 4
    if model_name.startswith("deeplabv3"):
        total += rows * layout.classifier.in_channels * 4 * (
            1 if int8 else WIDTH // layout.backbone.feature_stride)
    return total


def width_rank_child(torch, argv: list[str]) -> dict:
    """The width phases' child (``--width-rank RANK N_DATA N_MODEL PORT
    ROOT CKPT DTYPE MODEL INT8``): rank RANK of an N_DATA x N_MODEL mesh
    over gloo on the one card, the folder engine of MODEL (INT8 ``int8``:
    quantize_int8, calibrated by grid rank 0 in the first pass) under the
    mesh over ROOT (a warm-up pass, then a timed pass with every launch
    count, the halo counter and the reduction counter set to 0 just
    before it and read just after); then one launch batch's head logits
    under the mesh against the same engine's model on one process (on
    model rank 0), and for int8 a digest of the int8 weights and scales."""
    import copy

    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.models.quantize import state_digest
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed, make_mesh, shutdown_distributed,
        single_process)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        EXCHANGES, REDUCTIONS, stem_columns)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    rank, n_data, n_model, port = (int(a) for a in argv[:4])
    root, ckpt, dtype, model_name = argv[4:8]
    int8 = argv[8] == "int8"
    os.environ.update(torchrun_env(rank, n_data * n_model, port))
    world = initialize_distributed(backend="gloo")
    try:
        mesh = make_mesh(n_data, n_model, world)
        config = PredictConfig(model_path=ckpt, figure_dpi=DPI,
                               use_bfloat16=dtype == "bf16",
                               quantize_int8=int8)
        engine = NeuralBarkCalculator(ckpt, config=config, mesh=mesh,
                                      model_name=model_name)
        # warm-up: cuDNN's plans, and int8's calibration
        engine.predict(root, progress=False)
        world.barrier()
        counters = reset_counters()
        EXCHANGES.reset()
        REDUCTIONS.reset()
        t0 = time.perf_counter()
        csv = engine.predict(root, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: c.count for name, c in counters.items()}
        exchanges, halo_bytes = EXCHANGES.count, EXCHANGES.bytes
        reductions, reduced_bytes = REDUCTIONS.count, REDUCTIONS.bytes
        n = len(os.listdir(os.path.join(root, "processed", "samples",
                                        "sapin")))
        chunks = engine._plan_chunks(
            [(i, FOLDER_HEIGHTS[i % len(FOLDER_HEIGHTS)], WIDTH)
             for i in range(n)])
        elem = 2 if dtype == "bf16" else 4
        local_rows = [engine._padded_batch(len(idxs)) // n_data
                      for _, idxs in chunks]
        expected = sum(expected_halo_bytes(
            model_name, r, pad_h, n_model, mesh.model_rank, elem, int8)
            for r, (pad_h, _) in zip(local_rows, chunks))
        expected_reduced = sum(expected_reduced_bytes(model_name, r, int8)
                               for r in local_rows) if n_model > 1 else 0

        # one launch batch of BATCH images at PAD_H: this rank's rows and
        # strip under the mesh, against the same model on one process (the
        # exact-height path, EfficientNet's, without row masks)
        items = folder_items(root, range(BATCH))
        full = engine._pad_group(items, PAD_H, BATCH)
        heights = np.array([it.image.shape[0] for it in items], np.int32)
        rows = mesh.data.rank_slice(BATCH)
        vh = (None if engine._exact_heights
              else torch.from_numpy(heights[rows]).to(engine.device))
        backbone = engine.model.backbone
        strip = np.ascontiguousarray(full[rows][:, :, stem_columns(
            WIDTH, mesh.model, backbone.stem_halo,
            backbone.strip_multiple)])
        with torch.inference_mode():
            got = engine._logits(torch.from_numpy(strip).to(engine.device),
                                 vh)
            logit_err = logit_std = None
            if mesh.model_rank == 0:
                single = copy.copy(engine)
                single.mesh = make_mesh(world=single_process(engine.device))
                want = single._logits(torch.from_numpy(np.ascontiguousarray(
                    full[rows])).to(engine.device), vh)
                logit_err = float((got - want).abs().max())
                logit_std = float(want.std())
                del single, want
        digest = state_digest(engine.model).hex() if int8 else None
        world.barrier()
    finally:
        shutdown_distributed()
    return {"rank": rank, "mesh": [mesh.data_rank, mesh.model_rank],
            "csv": csv, "seconds": seconds, "launches": launches,
            "exchanges": exchanges, "halo_bytes": halo_bytes,
            "halo_bytes_expected": expected, "reductions": reductions,
            "reduced_bytes": reduced_bytes,
            "reduced_bytes_expected": expected_reduced,
            "logit_err": logit_err, "logit_std": logit_std,
            "int8_digest": digest,
            "launch_shapes": engine.cache_stats()["launch_shapes"]}


def width_run(torch, workdir: str, main_root: str, ckpt: str,
              model_name: str, int8: bool, n_data: int, n_model: int,
              dtype: str, n_images: int, single_rows: list[str],
              want_dual, against: str, card: str) -> list[int]:
    """One mesh's ranks as child processes of this script
    (``--width-rank``) sharing the one card over gloo, over a copy of the
    main path's folder (its first ``n_images`` images), the engine of
    ``model_name`` (``int8``: quantize_int8). Held: every rank exits 0 and
    launches upsample_argmax; each rank's halo bytes and pooled-reduction
    bytes equal the shapes' count; for int8 every rank's int8 weights and
    scales equal rank 0's bit for bit; grid rank 0 writes the CSV with
    ``single_rows``' names in their order and every artifact; the dual
    masks agree with ``want_dual(fname, wood)``'s (the ``against`` run's)
    on at least F32_AGREE_FLOOR of each image's pixels (float32 and int8)
    or WIDTH_BF16_FLOOR of all pixels (bf16 float). No speed is claimed:
    the ranks share one card and gloo goes through the host. Returns the
    upsample_argmax launches by rank."""
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    kind = "int8" if int8 else "float"
    label = f"{model_name} {kind} ({n_data}, {n_model}) {dtype}"
    root = os.path.join(workdir, f"width_{model_name}_{kind}_{n_data}x"
                        f"{n_model}_{dtype}")
    copy_folder(main_root, root, False)
    for i in range(n_images, N_IMAGES):
        os.remove(os.path.join(root, "processed", "samples", "sapin",
                               f"img{i:02d}.png"))
    port = free_port()
    size = n_data * n_model
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--width-rank",
         str(rank), str(n_data), str(n_model), str(port), root, ckpt, dtype,
         model_name, kind], cwd=REPO,
        env={**os.environ, **torchrun_env(rank, size, port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for rank, (p, (stdout, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"width {label}: rank {rank} exited "
                               f"{p.returncode}: {err[-3000:]}")
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    for r in ranks:
        logits = ("" if r["logit_err"] is None else
                  f"; one launch batch's logits vs one process: max abs "
                  f"diff {r['logit_err']:.6g}, "
                  f"{r['logit_err'] / r['logit_std']:.6g} of their std "
                  f"{r['logit_std']:.6g}")
        log(f"width {label} rank {r['rank']} (data, model) {r['mesh']}: "
            f"upsample_argmax launches {r['launches']['upsample_argmax']} "
            f"(all {r['launches']}); {r['exchanges']} halo exchanges, "
            f"{r['halo_bytes']} bytes received, the shapes give "
            f"{r['halo_bytes_expected']}; {r['reductions']} pooled "
            f"reductions of {r['reduced_bytes']} bytes, the shapes give "
            f"{r['reduced_bytes_expected']}{logits}; int8 digest "
            f"{r['int8_digest']}; timed pass {r['seconds']:.3f} s; launch "
            f"shapes {r['launch_shapes']}")
    results = os.path.join(root, "results")
    with open(os.path.join(results, "final_stats.csv")) as f:
        got_rows = f.read().splitlines()
    want_rows = single_rows[:1 + n_images]
    same_names = ([r.split("\t")[:2] for r in got_rows]
                  == [r.split("\t")[:2] for r in want_rows])
    float_bf16 = dtype == "bf16" and not int8
    floor = WIDTH_BF16_FLOOR if float_bf16 else F32_AGREE_FLOOR
    least, agree, total = 1.0, 0, 0
    for row in want_rows[1:]:
        fname, wood = row.split("\t")[:2]
        for sub in ("combined_images", "outputs"):
            if not os.path.isfile(os.path.join(results, sub, wood, fname)):
                raise AssertionError(f"width {label}: missing {sub}/{fname}")
        a = load_image_u8(os.path.join(results, "outputs", wood, fname),
                          grayscale=True)
        b = want_dual(fname, wood)
        same = int((a == b).sum())
        least = min(least, same / b.size)
        agree += same
        total += b.size
    digests = {r["int8_digest"] for r in ranks}
    log(f"width {label} ({card}): {size} processes on one card over gloo, "
        f"{n_images} images: wall {wall:.3f} s from launch to every exit "
        f"(process start, model load and a warm-up pass included); timed "
        f"passes {[round(r['seconds'], 3) for r in ranks]} s; CSV "
        f"{len(got_rows) - 1} rows, names and order equal {same_names}; "
        f"dual masks agree on {agree / total:.6f} of pixels against "
        f"{against}, least image {least:.6f} (floor {floor} "
        f"{'over the images' if float_bf16 else 'an image'}); "
        f"{len(digests)} distinct int8 digest(s) over the ranks")
    if not same_names:
        raise AssertionError(f"width {label}: the CSV's rows differ from "
                             f"the one process's")
    held = agree / total if float_bf16 else least
    if held < floor:
        raise AssertionError(f"width {label}: masks agree on {held:.6f} < "
                             f"{floor}")
    if int8 and len(digests) != 1:
        raise AssertionError(f"width {label}: the ranks hold different int8 "
                             f"weights or scales: {digests}")
    for r in ranks:
        if r["launches"]["upsample_argmax"] == 0 \
                or r["halo_bytes"] != r["halo_bytes_expected"] \
                or r["reduced_bytes"] != r["reduced_bytes_expected"] \
                or (r["csv"] is None) != (r["rank"] != 0):
            raise AssertionError(f"width {label} rank {r['rank']}: "
                                 f"launches, halo or reduced bytes, or CSV: "
                                 f"{r}")
    return [r["launches"]["upsample_argmax"] for r in ranks]


def _read_csv_rows(root: str) -> list[str]:
    with open(os.path.join(root, "results", "final_stats.csv")) as f:
        return f.read().splitlines()


def phase_width_partition(torch, workdir: str, main_root: str, ckpt: str,
                          sharded: dict, main_seconds: float, card: str
                          ) -> dict:
    """Width partitioning on the card (WIDTH_RUNS): fcn_resnet50 under
    each mesh (``width_run``) against the one-process float32 run of the
    sharded-predict phase; its warm pass of the 16 images, float32 and
    bf16, is logged beside. Returns each run's upsample_argmax launches
    by rank."""
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    single_root = sharded["single_root"]
    log(f"width: one process's warm pass of the {N_IMAGES} images, float32 "
        f"{sharded['single_s']:.3f} s and bf16 {main_seconds:.3f} s")

    def want_dual(fname, wood):
        return load_image_u8(os.path.join(single_root, "results", "outputs",
                                          wood, fname), grayscale=True)

    return {f"({n_data}, {n_model}) {dtype}": width_run(
        torch, workdir, main_root, ckpt, "fcn_resnet50", False, n_data,
        n_model, dtype, n_images, _read_csv_rows(single_root), want_dual,
        "the one-process float32 engine", card)
        for n_data, n_model, dtype, n_images in WIDTH_RUNS}


def phase_width_zoo(torch, workdir: str, main_root: str, ckpts: dict,
                    int8_runs: dict, single_root: str, card: str) -> dict:
    """Width partitioning of the rest of the ResNet zoo on the card
    (WIDTH_ZOO_RUNS, ``width_run``): deeplabv3_resnet50 in float32 and
    bf16 against a one-process float32 deeplabv3_resnet50 pass over the
    folder (made here), and int8 fcn_resnet50 and deeplabv3_resnet50
    against the int8 phase's one-process maps (``int8_runs``: model ->
    its "maps", fname -> class map, and the "digest" of its int8 state,
    which each run's is logged against). Returns each run's
    upsample_argmax launches by rank."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    name = "deeplabv3_resnet50"
    f32_root = os.path.join(workdir, "width_zoo_single_f32")
    copy_folder(main_root, f32_root, False)
    t0 = time.perf_counter()
    engine = NeuralBarkCalculator(
        ckpts[name], model_name=name, config=PredictConfig(
            model_path=ckpts[name], figure_dpi=DPI, use_bfloat16=False))
    engine.predict(f32_root, progress=False)
    del engine
    torch.cuda.empty_cache()
    log(f"width zoo: one-process float32 {name} over the {N_IMAGES} images "
        f"{time.perf_counter() - t0:.3f} s (load and cold pass)")
    single_rows = _read_csv_rows(single_root)

    def f32_dual(fname, wood):
        return load_image_u8(os.path.join(f32_root, "results", "outputs",
                                          wood, fname), grayscale=True)

    out = {}
    for model_name, int8, n_data, n_model, dtype, n_images in \
            WIDTH_ZOO_RUNS:
        if int8:
            maps = int8_runs[model_name]["maps"]

            def want_dual(fname, wood, maps=maps):
                return np.choose(maps[fname], [0, 127, 255]).astype(
                    np.uint8)
            against = (f"the int8 phase's one-process {model_name} engine "
                       f"(digest {int8_runs[model_name]['digest']})")
        else:
            want_dual = f32_dual
            against = f"the one-process float32 {name} engine"
        label = (f"{model_name} {'int8' if int8 else 'float'} "
                 f"({n_data}, {n_model}) {dtype}")
        out[label] = width_run(
            torch, workdir, main_root, ckpts[model_name], model_name, int8,
            n_data, n_model, dtype, n_images, single_rows, want_dual,
            against, card)
    return out


def phase_width_effnet(torch, workdir: str, main_root: str, ckpts: dict,
                       single_root: str, card: str) -> dict:
    """EfficientNet under the mesh's model axis on the card
    (WIDTH_EFFNET_RUNS, ``width_run``): the zoo phase's
    fcn_efficientnet_b0 and deeplabv3_efficientnet_b7 checkpoints
    (``ckpts``), each run against a one-process pass of the same model,
    dtype and images over a copy of the folder (made here). Returns each
    run's upsample_argmax launches by rank."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    single_rows = _read_csv_rows(single_root)
    refs = {}
    for model_name, _, _, dtype, n_images in WIDTH_EFFNET_RUNS:
        key = (model_name, dtype, n_images)
        if key in refs:
            continue
        root = os.path.join(workdir, f"width_effnet_single_{model_name}_"
                            f"{dtype}_{n_images}")
        copy_folder(main_root, root, False)
        for i in range(n_images, N_IMAGES):
            os.remove(os.path.join(root, "processed", "samples", "sapin",
                                   f"img{i:02d}.png"))
        t0 = time.perf_counter()
        engine = NeuralBarkCalculator(
            ckpts[model_name], model_name=model_name, config=PredictConfig(
                model_path=ckpts[model_name], figure_dpi=DPI,
                use_bfloat16=dtype == "bf16"))
        engine.predict(root, progress=False)
        del engine
        torch.cuda.empty_cache()
        log(f"width effnet: one-process {dtype} {model_name} over "
            f"{n_images} images {time.perf_counter() - t0:.3f} s (load and "
            f"cold pass; {card})")
        refs[key] = root
    out = {}
    for model_name, n_data, n_model, dtype, n_images in WIDTH_EFFNET_RUNS:
        ref_root = refs[(model_name, dtype, n_images)]

        def want_dual(fname, wood, ref_root=ref_root):
            return load_image_u8(os.path.join(ref_root, "results",
                                              "outputs", wood, fname),
                                 grayscale=True)
        out[f"{model_name} float ({n_data}, {n_model}) {dtype}"] = \
            width_run(torch, workdir, main_root, ckpts[model_name],
                      model_name, False, n_data, n_model, dtype, n_images,
                      single_rows, want_dual,
                      f"the one-process {dtype} {model_name} engine", card)
    return out


def mesh_rank_child(torch, argv: list[str]) -> dict:
    """The mesh stream and serve phase's child (``--mesh-rank RANK N_DATA
    N_MODEL PORT MODE ROOT CKPT``): rank RANK of an N_DATA x N_MODEL mesh
    over gloo on the one card, the float32 fcn_resnet50 of CKPT. MODE
    ``stream``: predict_streaming over ROOT's raw scans, grid rank 0
    reading Preprocessor(backend="host").preprocess_stream(ROOT). MODE
    ``serve``: grid rank 0 runs ``mesh_serve_main`` over ROOT's processed
    images, the other ranks ``BatchingPredictor.follow``. Every launch
    count is set to 0 just before and read just after."""
    from neuralbarkcalculator_tpu_torch.cli.serve import (build_parser,
                                                          make_engine)
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed, make_mesh, shutdown_distributed)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        Preprocessor)
    from neuralbarkcalculator_tpu_torch.pipeline.serving import (
        BatchingPredictor)

    rank, n_data, n_model, port = (int(a) for a in argv[:4])
    mode, root, ckpt = argv[4:7]
    os.environ.update(torchrun_env(rank, n_data * n_model, port))
    world = initialize_distributed(backend="gloo")
    try:
        mesh = make_mesh(n_data, n_model, world)
        if mode == "stream":
            engine = NeuralBarkCalculator(ckpt, mesh=mesh, config=PredictConfig(
                model_path=ckpt, figure_dpi=DPI, use_bfloat16=False))
            world.barrier()
            counters = reset_counters()
            t0 = time.perf_counter()
            csv = engine.predict_streaming(
                root, Preprocessor(backend="host").preprocess_stream(root)
                if world.is_main else None, progress=False)
            torch.cuda.synchronize()
            result = {"csv": csv, "seconds": time.perf_counter() - t0}
        else:
            args = build_parser().parse_args(
                [ckpt, "--port", "0", "--batch_size", str(SERVE_BATCH),
                 "--max_wait_ms", str(SERVE_WAIT_MS), "--fixed_height",
                 str(PAD_H), "--float32"])
            if world.is_main:
                counters, result = mesh_serve_main(torch, args, mesh, root)
            else:
                calc = make_engine(args, mesh)
                counters = reset_counters()
                t0 = time.perf_counter()
                BatchingPredictor.follow(calc)
                result = {"seconds": time.perf_counter() - t0}
        result.update(rank=rank, mesh=[mesh.data_rank, mesh.model_rank],
                      launches={k: c.count for k, c in counters.items()})
        world.barrier()
    finally:
        shutdown_distributed()
    return result


def mesh_serve_main(torch, args, mesh, root: str) -> tuple[dict, dict]:
    """Grid rank 0 of the mesh server: make_server under ``mesh``, the
    warm-up (every rank launches it), one request, serving_bench's
    sequential and concurrent phases over ROOT's processed images, then
    each image as a mask answer (written to ROOT/mesh_masks/), /v1/stats;
    ``close()`` stops the followers. Returns (the launch counters, set to
    0 before the warm-up; the numbers)."""
    from neuralbarkcalculator_tpu_torch.cli.serve import (make_server,
                                                          serve_in_thread)
    from neuralbarkcalculator_tpu_torch.tools import serving_bench

    srv = make_server(args, mesh=mesh)
    predictor = srv.state.predictor
    counters = reset_counters()
    t_start = t0 = time.perf_counter()
    predictor.warmup(PAD_H, WIDTH)
    warm_s = time.perf_counter() - t0
    thread = serve_in_thread(srv)
    port = srv.server_address[1]
    samples = os.path.join(root, "processed", "samples", "sapin")
    pngs = []
    for i in range(N_IMAGES):
        with open(os.path.join(samples, f"img{i:02d}.png"), "rb") as f:
            pngs.append(f.read())
    device = serving_bench.device_name(predictor.calc.device)
    masks = os.path.join(root, "mesh_masks")
    os.makedirs(masks)
    try:
        check_answer("warm", 200, serving_bench.one_request(port, pngs[0])[1])
        t0 = time.perf_counter()
        seq_row, seq_answers = serving_bench.sequential(
            port, pngs, SERVE_SEQ, "float32", device)
        seq_s = time.perf_counter() - t0
        conc_row, conc_answers = serving_bench.concurrent(
            port, pngs, SERVE_CLIENTS, SERVE_PER_CLIENT, "float32", device)
        for i, a in enumerate(seq_answers + conc_answers):
            check_answer(f"mesh request {i}", 200, a)
        with ThreadPoolExecutor(max_workers=SERVE_BATCH) as pool:
            answers = list(pool.map(lambda b: http_call(
                port, "POST", "/v1/predict?format=mask", b), pngs))
        for i, (status, _, data, _) in enumerate(answers):
            if status != 200:
                raise AssertionError(f"mesh mask {i}: HTTP {status}")
            with open(os.path.join(masks, f"img{i:02d}.png"), "wb") as f:
                f.write(data)
        stats = predictor.snapshot_stats()
    finally:
        stop_server(srv, thread)
    return counters, {"warm_s": warm_s, "seq": seq_row, "seq_s": seq_s,
                      "seconds": time.perf_counter() - t_start,
                      "conc": conc_row, "stats": stats,
                      "sent": 1 + SERVE_SEQ + SERVE_CLIENTS
                      * SERVE_PER_CLIENT + N_IMAGES}


def start_mesh_children(n_data: int, n_model: int, mode: str, root: str,
                        ckpt: str) -> list:
    """One mesh's ranks as ``--mesh-rank`` children of this script on the
    one card, started."""
    port = free_port()
    size = n_data * n_model
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank",
         str(rank), str(n_data), str(n_model), str(port), mode, root, ckpt],
        cwd=REPO, env={**os.environ, **torchrun_env(rank, size, port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(size)]


def finish_mesh_children(procs: list, label: str, t0: float
                         ) -> tuple[list[dict], float]:
    """Wait for a mesh's children; raises unless every rank exits 0.
    Returns (each rank's result, the wall time from ``t0`` to every
    exit)."""
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for rank, (p, (stdout, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{label}: rank {rank} exited "
                               f"{p.returncode}: {err[-3000:]}")
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    return ranks, wall


def scan_copy(scan_root: str, root: str) -> int:
    """Phase 5's raw scans (``scan_root``/samples) under a new predict
    root with empty processed/ and results/ folders; returns the count."""
    import shutil

    shutil.copytree(os.path.join(scan_root, "samples"),
                    os.path.join(root, "samples"))
    n = 0
    for wood in os.listdir(os.path.join(root, "samples")):
        n += len(os.listdir(os.path.join(root, "samples", wood)))
        for sub in ("processed/samples", "results/combined_images",
                    "results/outputs"):
            os.makedirs(os.path.join(root, sub, wood))
    return n


def dual_agreement(a_root: str, b_root: str, rows: list[str]
                   ) -> tuple[float, float]:
    """(share of equal pixels over ``rows``' dual masks, least image's)
    between two predict roots."""
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    least, same, total = 1.0, 0, 0
    for row in rows:
        fname, wood = row.split("\t")[:2]
        a, b = (load_image_u8(os.path.join(r, "results", "outputs", wood,
                                           fname), grayscale=True)
                for r in (a_root, b_root))
        n = int((a == b).sum())
        least = min(least, n / b.size)
        same += n
        total += b.size
    return same / total, least


def phase_mesh_stream_serve(torch, workdir: str, main_root: str, ckpt: str,
                            scan_root: str, card: str) -> dict:
    """predict_streaming and the server over a (data, model) grid of
    child processes on the one card (MESH_STREAMS, MESH_SERVE): every
    rank launches upsample_argmax; the streams' CSVs hold the one-process
    streaming run's rows in its order and masks >= F32_AGREE_FLOOR an
    image; every mask answer of the server >= F32_AGREE_FLOOR a direct
    one-process float32 predict_images call's. requests/s and p50 are
    logged, not held (the ranks take turns on one card). Returns the
    upsample_argmax launches by run and rank."""
    import io

    import numpy as np
    from PIL import Image

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage, Preprocessor)

    ref_root = os.path.join(workdir, "mesh_stream_single")
    n = scan_copy(scan_root, ref_root)
    t0 = time.perf_counter()
    engine = NeuralBarkCalculator(ckpt, config=PredictConfig(
        model_path=ckpt, figure_dpi=DPI, use_bfloat16=False))
    engine.predict_streaming(
        ref_root, Preprocessor(backend="host").preprocess_stream(ref_root),
        total=n, progress=False)
    del engine
    torch.cuda.empty_cache()
    ref_rows = _read_csv_rows(ref_root)
    log(f"mesh stream: one-process float32 predict_streaming over the {n} "
        f"raw scans {time.perf_counter() - t0:.3f} s (load, host "
        f"preprocess and cold pass; {card})")
    out = {}
    # the streaming meshes run at once (their times are logged, not held)
    t0 = time.perf_counter()
    jobs = []
    for n_data, n_model in MESH_STREAMS:
        root = os.path.join(workdir, f"mesh_stream_{n_data}x{n_model}")
        scan_copy(scan_root, root)
        jobs.append((n_data, n_model, root, start_mesh_children(
            n_data, n_model, "stream", root, ckpt)))
    results = []
    try:
        for n_data, n_model, root, procs in jobs:
            label = f"mesh stream ({n_data}, {n_model}) float32"
            results.append((n_data, n_model, root, label,
                            *finish_mesh_children(procs, label, t0)))
    finally:  # a failed mesh leaves none of the other's ranks running
        for *_, procs in jobs:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for n_data, n_model, root, label, ranks, wall in results:
        rows = _read_csv_rows(root)
        same_names = ([r.split("\t")[:2] for r in rows]
                      == [r.split("\t")[:2] for r in ref_rows])
        agree, least = dual_agreement(root, ref_root, ref_rows[1:])
        for r in ranks:
            log(f"{label} rank {r['rank']} (data, model) {r['mesh']}: "
                f"upsample_argmax launches {r['launches']['upsample_argmax']}"
                f" (all {r['launches']}); predict_streaming "
                f"{r['seconds']:.3f} s; CSV {r['csv']}")
        log(f"{label} ({card}): {n_data * n_model} processes on one card "
            f"over gloo beside the other streaming mesh's, {n} raw scans "
            f"read by grid rank 0: wall {wall:.3f} s from launch to every "
            f"exit; CSV {len(rows) - 1} rows, names "
            f"and order equal to the one-process stream's {same_names}; "
            f"dual masks agree on {agree:.6f} of pixels, least image "
            f"{least:.6f} (floor {F32_AGREE_FLOOR} an image)")
        if not same_names or least < F32_AGREE_FLOOR or any(
                r["launches"]["upsample_argmax"] == 0
                or (r["csv"] is None) != (r["rank"] != 0) for r in ranks):
            raise AssertionError(f"{label}: {ranks}")
        out[label] = [r["launches"]["upsample_argmax"] for r in ranks]

    n_data, n_model = MESH_SERVE
    label = f"mesh serve ({n_data}, {n_model}) float32"
    root = os.path.join(workdir, "mesh_serve")
    copy_folder(main_root, root, False)
    ranks, wall = finish_mesh_children(start_mesh_children(
        n_data, n_model, "serve", root, ckpt), label, time.perf_counter())
    main = ranks[0]
    pngs = []
    for i in range(N_IMAGES):
        with open(os.path.join(root, "processed", "samples", "sapin",
                               f"img{i:02d}.png"), "rb") as f:
            pngs.append(f.read())
    host_pre = Preprocessor(backend="host")
    items = [ProcessedImage(host_pre.preprocess_one(np.asarray(
        Image.open(io.BytesIO(b)).convert("RGB"))), f"d{i}", "serving")
        for i, b in enumerate(pngs)]
    direct = NeuralBarkCalculator(ckpt, config=PredictConfig(
        model_path=ckpt, use_bfloat16=False, batch_size=SERVE_BATCH,
        fixed_pad_height=PAD_H))
    want = {it.fname: m for it, m in direct.predict_images(items)}
    del direct
    torch.cuda.empty_cache()
    least = 1.0
    for i in range(N_IMAGES):
        dual = np.asarray(Image.open(os.path.join(root, "mesh_masks",
                                                  f"img{i:02d}.png")))
        got = np.select([dual == 127, dual == 255], [1, 2], 0)
        if got.shape != want[f"d{i}"].shape:
            raise AssertionError(f"{label}: mask {i} shape {got.shape}")
        least = min(least, float((got == want[f"d{i}"]).mean()))
    stats = main["stats"]
    for r in ranks:
        log(f"{label} rank {r['rank']} (data, model) {r['mesh']}: "
            f"upsample_argmax launches {r['launches']['upsample_argmax']} "
            f"(all {r['launches']}; the warm-up's included); "
            f"{'served' if r['rank'] == 0 else 'followed'} "
            f"{r['seconds']:.3f} s")
    log(f"serving_bench under {label}: {json.dumps(main['seq'])}")
    log(f"serving_bench under {label}: {json.dumps(main['conc'])}")
    log(f"{label} ({card}): {n_data * n_model} processes on one card over "
        f"gloo (grid rank 0 serves, the other ranks follow): warm-up "
        f"{main['warm_s']:.3f} s; sequential {SERVE_SEQ} requests "
        f"{SERVE_SEQ / main['seq_s']:.3f} requests/s, p50 "
        f"{main['seq']['p50_ms']:.3f} ms; {SERVE_CLIENTS} clients x "
        f"{SERVE_PER_CLIENT} {main['conc']['req_per_s']:.3f} requests/s, "
        f"p50 {main['conc']['p50_ms']:.3f} ms (logged, not held: the ranks "
        f"take turns on one card); stats {stats}; the {N_IMAGES} mask "
        f"answers against a direct one-process float32 predict_images "
        f"call, least image {least:.6f} (floor {F32_AGREE_FLOOR}); wall "
        f"{wall:.3f} s from launch to every exit")
    if least < F32_AGREE_FLOOR or stats["errors"] \
            or stats["served"] != main["sent"] or any(
                r["launches"]["upsample_argmax"] == 0 for r in ranks):
        raise AssertionError(f"{label}: {ranks}")
    out[label] = [r["launches"]["upsample_argmax"] for r in ranks]
    return out


def postprocess_seconds(stages: dict) -> float:
    """The predict postprocess's seconds in a profiling.report()."""
    return sum(row["total_s"] for name, row in stages.items()
               if name.startswith("predict/postprocess"))


def no_native_child(torch, argv: list[str]) -> dict:
    """The no-library predict child (``--no-native-predict ARGV``): the
    native runtime's build is made to fail here, before anything loads
    the library, then cli/predict.main runs on ARGV with every launch
    count set to 0 just before and read just after, and the warnings it
    issued recorded. Returns the counts, the warnings, the run's seconds
    and its postprocess's."""
    import warnings

    from neuralbarkcalculator_tpu_torch.utils import build, profiling

    def fail():
        raise RuntimeError("chip_smoke: the native build is made to fail "
                           "in this process")

    build.build_native = fail
    from neuralbarkcalculator_tpu_torch.cli.predict import build_parser, main
    from neuralbarkcalculator_tpu_torch.io import native

    counters = reset_counters()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        main(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if native.get_lib() is not None:
        raise AssertionError("the native library loaded in the no-library "
                             "child")
    return {"launches": {name: c.count for name, c in counters.items()},
            "seconds": seconds,
            "postprocess_s": postprocess_seconds(profiling.report()),
            "warnings": [str(w.message) for w in record
                         if issubclass(w.category, RuntimeWarning)]}


def phase_no_native_predict(torch, workdir: str, main_root: str, ckpt: str,
                            sharded: dict, card: str) -> int:
    """cli/predict --float32 over the main path's folder (as sources, with
    the host preprocess) in a child process of this script whose native
    build fails: PIL codecs, the scipy preprocess, the maps postprocessed
    by ops/ccl.remove_small_zones_ragged on the card. It must warn, launch
    ccl and upsample_argmax, write final_stats.csv byte for byte as the
    native single-process float32 run of the sharded-predict phase did,
    and dual masks equal to its as decoded arrays. Returns its ccl
    launches."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8

    root = os.path.join(workdir, "no_native")
    copy_folder(main_root, root, True)
    argv = [root, "--model_path", ckpt, "--float32", "--dpi", str(DPI),
            "--preprocess_backend", "host", "--pipeline", "sequential"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--no-native-predict",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the no-library predict child exited "
                           f"{proc.returncode}: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    single_root = sharded["single_root"]
    with open(os.path.join(root, "results", "final_stats.csv"), "rb") as f:
        got = f.read()
    with open(os.path.join(single_root, "results", "final_stats.csv"),
              "rb") as f:
        want = f.read()
    masks_equal = True
    for row in want.decode().splitlines()[1:]:
        fname, wood = row.split("\t")[:2]
        a, b = (load_image_u8(os.path.join(r, "results", "outputs", wood,
                                           fname), grayscale=True)
                for r in (root, single_root))
        masks_equal &= bool(np.array_equal(a, b))
        if not os.path.isfile(os.path.join(root, "results",
                                           "combined_images", wood, fname)):
            raise AssertionError(f"no-library predict: missing {fname}'s "
                                 f"figure")
    warned_build = any("could not be built" in w for w in child["warnings"])
    warned_post = any("make -C native" in w for w in child["warnings"])
    log(f"no-library predict ({card}): cli/predict --float32 "
        f"--preprocess_backend host over the {N_IMAGES}-image folder in a "
        f"child whose native build fails: wall {wall:.3f} s from launch to "
        f"exit, its CLI run {child['seconds']:.3f} s, its postprocess "
        f"(unpack, ccl on the card, remap) {child['postprocess_s']:.3f} s; "
        f"the native single-process float32 engine's warm pass "
        f"{sharded['single_s']:.3f} s, its postprocess "
        f"{sharded['single_postprocess_s']:.3f} s; launches "
        f"{child['launches']}; warnings: build {warned_build}, postprocess "
        f"{warned_post} ({len(child['warnings'])} RuntimeWarnings); "
        f"final_stats.csv byte-identical {got == want}; dual masks equal "
        f"{masks_equal}")
    if not (warned_build and warned_post) or got != want or not masks_equal \
            or child["launches"]["ccl"] == 0 \
            or child["launches"]["upsample_argmax"] == 0:
        raise AssertionError("no-library predict: no warning, no ccl or "
                             "upsample_argmax launch, or artifacts that "
                             "differ from the native run's")
    return child["launches"]["ccl"]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def recorded_train_run(torch, argv: list[str], env: dict,
                       backend: str | None = None, nudge: bool = False
                       ) -> dict:
    """cli/train.main on ARGV with ENV added to the environment and every
    launch count set to 0 just before and read just after. Records the
    flattened parameters before the first step and the gradients of the
    first; after each step the loss, the flattened parameters and the
    BatchNorms' running statistics; each fused_dropout_matmul call's
    (seed, element offset, shape); the collectives issued; the
    device-clock step times and the peak memory.
    BACKEND, when given, is the process group's backend in place of
    initialize_distributed's choice. NUDGE moves every weight one float32
    ulp up after recording them, before the first step: the same step from
    weights float32 cannot tell apart."""
    import functools

    import torch.distributed as dist

    from neuralbarkcalculator_tpu_torch.cli.train import (build_parser,
                                                          main as train_main)
    from neuralbarkcalculator_tpu_torch.models import heads
    from neuralbarkcalculator_tpu_torch.parallel import distributed
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import (
        CrossRankBatchNorm2d)
    from neuralbarkcalculator_tpu_torch.train import loop

    real = (loop.train_step, heads.fused_dropout_matmul, dist.all_gather,
            dist.all_reduce, distributed.initialize_distributed)
    rec = {"params": [], "bn": [], "losses": [], "masks": [],
           "backend": None, "collectives": {"all_gather": 0,
                                            "all_reduce": 0}}

    def flat(tensors):
        return torch.cat([t.detach().flatten().float() for t in tensors])

    def step(*args, **kwargs):
        model = args[0]
        first = not rec["params"]
        if first:
            rec["before"] = flat(model.parameters())
            rec["names"] = [n for n, _ in model.named_parameters()]
            rec["sizes"] = [p.numel() for p in model.parameters()]
            if nudge:
                with torch.no_grad():
                    for p in model.parameters():
                        p.copy_(torch.nextafter(p, torch.full_like(
                            p, float("inf"))))
        metrics = real[0](*args, **kwargs)
        if first:
            rec["grads"] = flat(p.grad for p in model.parameters())
        rec["params"].append(flat(model.parameters()))
        rec["bn"].append(flat(v for k, v in model.state_dict().items()
                              if ".running_" in k))
        rec["losses"].append(metrics["loss"].clone())
        if dist.is_initialized():
            rec["backend"] = dist.get_backend()
        return metrics

    def fdm(h, w, b, dseed, rate, offset=0):
        rec["masks"].append((dseed, offset, tuple(h.shape)))
        return real[1](h, w, b, dseed, rate, offset)

    def counted(name, fn):
        def call(*args, **kwargs):
            rec["collectives"][name] += 1
            return fn(*args, **kwargs)
        return call

    loop.train_step, heads.fused_dropout_matmul = step, fdm
    dist.all_gather = counted("all_gather", real[2])
    dist.all_reduce = counted("all_reduce", real[3])
    if backend is not None:
        distributed.initialize_distributed = functools.partial(
            real[4], backend=backend)
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    try:
        with step_clock(torch) as step_s:
            exp = train_main(build_parser().parse_args(argv))
        torch.cuda.synchronize()
    finally:
        for k in env:
            del os.environ[k]
        (loop.train_step, heads.fused_dropout_matmul, dist.all_gather,
         dist.all_reduce, distributed.initialize_distributed) = real
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {name: c.count for name, c in counters.items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["steps"] = exp.step_count
    rec["step_s"] = step_s
    rec["epoch"] = exp.history[0].as_dict()
    rec["cross_rank_bn"] = sum(isinstance(m, CrossRankBatchNorm2d)
                               for m in exp.model.modules())
    return rec


def torchrun_env(rank: int, size: int, port: int) -> dict:
    """torchrun's variables for rank RANK of SIZE on this machine's one
    card, with the env:// rendezvous at localhost:PORT."""
    return {"RANK": str(rank), "WORLD_SIZE": str(size), "LOCAL_RANK": "0",
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def train_argv(workdir: str, label: str, seed: int, *extra: str
               ) -> list[str]:
    """cli/train's arguments for one epoch on the train phase's dataset,
    without the report, into WORKDIR/train_LABEL."""
    return [os.path.join(workdir, f"train_{label}"), "--data_dir",
            os.path.join(workdir, "train_root", "Images", "1024_with_jedi"),
            "--seed", str(seed), "--epochs", "1", "--no_report", *extra]


def phase_train_nccl(torch, seed: int, workdir: str, train_step_ms: float,
                     card: str) -> dict:
    """Data-parallel training at world size 1 over NCCL: cli/train.main
    under torchrun's environment (RANK 0, WORLD_SIZE 1, LOCAL_RANK 0, a
    free MASTER_PORT) with --distributed, so the model's BatchNorms are
    cross-rank, the loss's inputs are gathered and the gradients
    all-reduced through NCCL on the card; then the same run without it.
    Phase 4's dataset, the full-width fcn_resnet50, batch 5 at crop 512,
    one epoch (24 train images / 5 = 4 steps), no report, cuDNN's
    deterministic algorithms on for both. The two runs' losses, parameters
    after each step and dropout masks (the kernel's seed, element offset
    and shape) must be equal bit for bit, fused_dropout_matmul forward and
    backward launched once a step in each, and the NCCL run must have
    issued its collectives. At one rank the cross-rank BatchNorm is torch's
    own and the collectives copy: the two-rank phase runs their arithmetic
    on the card."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {
            "nccl": recorded_train_run(
                torch, train_argv(workdir, "nccl", seed, "--samples_factor",
                                  "1", "--distributed"),
                torchrun_env(0, 1, free_port())),
            "plain": recorded_train_run(
                torch, train_argv(workdir, "plain", seed, "--samples_factor",
                                  "1"), {})}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    a, b = runs["nccl"], runs["plain"]
    steps = a["steps"]
    loss_diff = max(float((x - y).abs()) for x, y in zip(a["losses"],
                                                         b["losses"]))
    param_diff = max(float((x - y).abs().max()) for x, y in zip(a["params"],
                                                                b["params"]))
    bitwise = (len(a["params"]) == len(b["params"]) == steps
               and all(torch.equal(x, y) for x, y in zip(a["params"],
                                                        b["params"]))
               and all(torch.equal(x, y) for x, y in zip(a["losses"],
                                                        b["losses"])))
    warm = {k: statistics.median(r["step_s"][1:]) * 1e3
            for k, r in runs.items()}
    log(f"train NCCL world size 1 ({card}): backend {a['backend']}, "
        f"{a['cross_rank_bn']} cross-rank BatchNorms, collectives "
        f"{a['collectives']}; {steps} steps; losses "
        f"{[round(float(x), 6) for x in a['losses']]}; against the run "
        f"without a process group: losses and parameters after each step "
        f"bit for bit {bitwise} (largest differences: loss {loss_diff:.3g}, "
        f"parameter {param_diff:.3g}); masks (seed, element offset, shape) "
        f"equal {a['masks'] == b['masks']}; launches NCCL {a['launches']}, "
        f"plain {b['launches']}")
    log(f"train NCCL world size 1 ({card}): warm step (device clock, steps "
        f"2..{steps}) {warm['nccl']:.3f} ms with NCCL, {warm['plain']:.3f} ms "
        f"without; phase 4's {train_step_ms:.3f} ms; whole CLI runs "
        f"{a['seconds']:.3f} s / {b['seconds']:.3f} s")
    if a["backend"] != "nccl" or not a["cross_rank_bn"] \
            or not a["collectives"]["all_gather"] \
            or not a["collectives"]["all_reduce"] or b["cross_rank_bn"]:
        raise AssertionError("the NCCL run did not run the data-parallel "
                             "path through NCCL")
    if not bitwise or a["masks"] != b["masks"]:
        raise AssertionError("the world-size-1 NCCL step differs from the "
                             "single-process step")
    for r in runs.values():
        if r["launches"]["fused_dropout_matmul_fwd"] != steps \
                or r["launches"]["fused_dropout_matmul_bwd"] != steps:
            raise AssertionError(f"fused_dropout_matmul launches "
                                 f"{r['launches']} in {steps} steps")
    return {"launches": a["launches"], "step_ms": warm["nccl"]}


def cross_rank_bn_check(torch, world, seed: int) -> dict:
    """This rank's CrossRankBatchNorm2d over WORLD on its rows of a global
    BN_CHECK_SHAPE batch from SEED, in float32 and under bf16 autocast
    (its input bf16, as a conv's output is there): two train-mode forwards
    and the backward of the second, against the same on the whole batch
    in float64 (torch's own BN kernel) from the same values, the bf16 ones
    rounded as the cross-rank module receives them; and nn.BatchNorm2d
    (cuDNN) on the whole batch against the float64 one too. Returns per
    type each quantity's largest difference over the float64 one's
    largest value for both, and the peak memory above the input of the
    cross-rank module and of nn.BatchNorm2d on the same rows."""
    from neuralbarkcalculator_tpu_torch.parallel.sync_bn import (
        CrossRankBatchNorm2d)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    channels = BN_CHECK_SHAPE[1]
    x = torch.randn(BN_CHECK_SHAPE, generator=gen, device="cuda") * 2 + 1.5
    gy = torch.randn(BN_CHECK_SHAPE, generator=gen, device="cuda")
    weight = torch.rand(channels, generator=gen, device="cuda") + 0.5
    bias = torch.randn(channels, generator=gen, device="cuda") * 0.1
    rows = world.rank_slice(BN_CHECK_SHAPE[0])

    def run(bn, xs, gys, bf16: bool) -> dict:
        bn = bn.cuda().train()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xin = xs.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            with torch.no_grad():
                bn(xin)
            y = bn(xin)
        y.backward(gys.to(y.dtype))
        if isinstance(bn, CrossRankBatchNorm2d):
            world.all_reduce_grads(bn.parameters())
        torch.cuda.synchronize()
        return {"y": y.detach(), "dx": xin.grad, "dw": bn.weight.grad,
                "db": bn.bias.grad, "mean": bn.running_mean,
                "var": bn.running_var,
                "peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2 ** 30}

    def errors(got, want, mine) -> dict:
        return {k: float((got[k].double() - (want[k][rows] if mine and k in
                                             ("y", "dx") else want[k])
                          ).abs().max() / want[k].abs().max())
                for k in ("y", "dx", "dw", "db", "mean", "var")}

    out = {}
    for label, bf16 in (("float32", False), ("bf16", True)):
        xs, gys = (x.bfloat16(), gy.bfloat16()) if bf16 else (x, gy)
        exact = run(torch.nn.BatchNorm2d(channels).double(), xs.double(),
                    gys.double(), False)
        got = run(CrossRankBatchNorm2d(channels, world), xs[rows], gys[rows],
                  bf16)
        cudnn = run(torch.nn.BatchNorm2d(channels), xs, gys, bf16)
        plain_rows = run(torch.nn.BatchNorm2d(channels), xs[rows], gys[rows],
                         bf16)
        out[label] = {"cross_rank": errors(got, exact, True),
                      "cudnn": errors(cudnn, exact, False),
                      "peak_gib": got["peak_gib"],
                      "plain_peak_gib": plain_rows["peak_gib"]}
    return out


def train_rank_child(torch, rank: int, port: int, workdir: str, seed: int
                     ) -> dict:
    """The two-rank phase's child (``--train-rank``): rank RANK of
    TWO_RANKS on the one card, cli/train.main --distributed over gloo
    (NCCL refuses two ranks on one device), the recorded run saved to
    WORKDIR for the parent; returns its summary. First the cross-rank
    BatchNorm alone (cross_rank_bn_check), in the same process group."""
    from neuralbarkcalculator_tpu_torch.parallel.distributed import (
        initialize_distributed)

    env = torchrun_env(rank, TWO_RANKS, port)
    os.environ.update(env)
    try:
        bn_check = cross_rank_bn_check(
            torch, initialize_distributed(backend="gloo"), seed)
    finally:
        for k in env:
            del os.environ[k]
    torch.cuda.empty_cache()
    rec = recorded_train_run(
        torch, train_argv(workdir, "two_ranks", seed, *TWO_RANK_ARGS,
                          "--distributed"),
        env, backend="gloo")
    torch.save({k: v for k, v in rec.items() if k != "step_s"},
               os.path.join(workdir, f"two_ranks-{rank}.pt"))
    return {"bn_check": bn_check,
            **{k: rec[k] for k in ("launches", "collectives", "backend",
                                   "cross_rank_bn", "peak_gib", "steps",
                                   "step_s", "seconds", "epoch")}}


def worst_tensor(ref: dict, got, want) -> tuple[float, float, str]:
    """Over REF's parameter tensors, the lowest cosine between GOT's and
    WANT's flattened values and the largest L2 norm of their difference
    over WANT's, with the name of the tensor of the lowest cosine."""
    worst = (1.0, 0.0, "")
    for name, u, v in zip(ref["names"], got.double().split(ref["sizes"]),
                          want.double().split(ref["sizes"])):
        nv = float(v.norm())
        if nv == 0.0:
            continue
        cos = float(u @ v) / max(float(u.norm()) * nv, 1e-300)
        worst = (min(worst[0], cos), max(worst[1], float((u - v).norm()) / nv),
                 name if cos < worst[0] else worst[2])
    return worst


def stage_errors(ref: dict, got, want) -> dict[str, float]:
    """The L2 norm of GOT - WANT over WANT's per stage of the network
    (the first two parts of a parameter's name: backbone.layer1, ...,
    classifier.1), from the output back to the input."""
    sums: dict[str, list[float]] = {}
    for name, u, v in zip(ref["names"], got.double().split(ref["sizes"]),
                          want.double().split(ref["sizes"])):
        part = sums.setdefault(".".join(name.split(".")[:2]), [0.0, 0.0])
        part[0] += float((u - v).norm()) ** 2
        part[1] += float(v.norm()) ** 2
    return {k: round((d / w) ** 0.5, 9)
            for k, (d, w) in reversed(sums.items()) if w}


def first_update(r: dict):
    """The first step's change of the flattened parameters."""
    return r["params"][0] - r["before"]


def phase_train_two_ranks(torch, seed: int, workdir: str,
                          train_step_ms: float, card: str) -> list[dict]:
    """The cross-rank arithmetic on the card: two ranks of cli/train
    --distributed as child processes of this script sharing the one card
    over gloo (its collectives take CUDA tensors; NCCL refuses two ranks on
    one device), against cli/train without a process group at the same
    global batch. Phase 4's dataset, the full-width fcn_resnet50, float32,
    global batch TWO_RANK_BATCH at crop 512 (each rank the main path's
    [5, 512, 64, 64] head input), one epoch of 4 steps and its padded
    validation. The cross-rank BatchNorms take their statistics through two
    all-reduces each, the loss's inputs are gathered and the gradients
    summed. A third run, one process from weights moved one ulp (NUDGE),
    gives float32's reach. Held: the ranks' losses and parameters after each step equal bit for
    bit; each rank's masks the global batch's rows (the same seed, the
    element offset rank x 5 x 512 x 64 x 64); the first step, from equal
    weights, against the one-process step as the CPU tests hold two ranks
    to one process, its gradients within TWO_RANK_FLOOR_FACTOR of the
    nudged run's by stage (TWO_RANK_*); the cross-rank BN alone
    (cross_rank_bn_check, each rank) within BN_CHECK_TOL; the epoch's mean
    loss within
    TWO_RANK_EPOCH_LOSS_TOL; fused_dropout_matmul forward and backward once
    a step on each rank. Prints the first step's gradient error by stage
    and its Adam updates, and both runs' warm step times and peak memory.
    Returns each rank's launches."""
    import math

    port = free_port()
    ref = recorded_train_run(
        torch, train_argv(workdir, "one_process", seed, *TWO_RANK_ARGS), {})
    floor = recorded_train_run(
        torch, train_argv(workdir, "one_process_nudged", seed,
                          *TWO_RANK_ARGS), {}, nudge=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-rank",
         str(rank), str(port), workdir, str(seed)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(TWO_RANKS)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    summaries = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank}/{TWO_RANKS} exited "
                               f"{p.returncode}: {err[-3000:]}")
        summaries.append(json.loads(out.strip().splitlines()[-1]))
    ranks = [torch.load(os.path.join(workdir, f"two_ranks-{rank}.pt"),
                        map_location="cuda") for rank in range(TWO_RANKS)]
    steps = ref["steps"]
    r0 = ranks[0]
    ranks_equal = all(
        len(r["params"]) == steps
        and all(torch.equal(x, y) for x, y in zip(r["params"], r0["params"]))
        and all(torch.equal(x, y) for x, y in zip(r["losses"], r0["losses"]))
        for r in ranks)
    rows = ref["masks"][0][2][0] // TWO_RANKS
    masks_ok = all(
        len(r["masks"]) == len(ref["masks"]) == steps
        and all(m[0] == g[0] and m[1] == rank * rows * math.prod(g[2][1:])
                and m[2] == (rows, *g[2][1:])
                for m, g in zip(r["masks"], ref["masks"]))
        for rank, r in enumerate(ranks))

    def loss_rel(r):
        return [abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(r["losses"], ref["losses"])]

    def bn_beyond(r):
        diff = (r["bn"][0] - ref["bn"][0]).abs()
        bound = TWO_RANK_BN_RTOL * ref["bn"][0].abs() + TWO_RANK_BN_ATOL
        return float(diff.max()), int((diff > bound).sum())

    epoch_rel = abs(r0["epoch"]["loss"] - ref["epoch"]["loss"]) \
        / abs(ref["epoch"]["loss"])
    grads = worst_tensor(ref, r0["grads"], ref["grads"])
    update = worst_tensor(ref, first_update(r0), first_update(ref))
    stages = stage_errors(ref, r0["grads"], ref["grads"])
    floor_stages = stage_errors(ref, floor["grads"], ref["grads"])
    over = [k for k, e in stages.items()
            if e > TWO_RANK_FLOOR_FACTOR * floor_stages[k]]
    bn_checks = [s["bn_check"] for s in summaries]
    bn_fails = [(rank, label, k) for rank, c in enumerate(bn_checks)
                for label, tols in BN_CHECK_TOL.items()
                for k, tol in tols.items()
                if not c[label]["cross_rank"][k] <= tol]
    warm = [statistics.median(s["step_s"][1:]) * 1e3 for s in summaries]
    log(f"train two ranks on one card ({card}): backend "
        f"{[s['backend'] for s in summaries]}, "
        f"{summaries[0]['cross_rank_bn']} cross-rank BatchNorms, collectives "
        f"{summaries[0]['collectives']}; {steps} steps of global batch "
        f"{TWO_RANK_BATCH}; ranks bit for bit {ranks_equal}; masks the "
        f"global batch's rows {masks_ok}; launches "
        f"{[s['launches'] for s in summaries]}")
    log(f"train two ranks against one process: losses "
        f"{[round(float(x), 6) for x in r0['losses']]} / "
        f"{[round(float(x), 6) for x in ref['losses']]}, relative "
        f"differences {[f'{x:.3g}' for x in loss_rel(r0)]} (step 1 <= "
        f"{TWO_RANK_LOSS_TOL}); the epoch's mean loss {epoch_rel:.3g} (<= "
        f"{TWO_RANK_EPOCH_LOSS_TOL}); BN running statistics after step 1: "
        f"largest difference and count beyond rtol {TWO_RANK_BN_RTOL} / "
        f"atol {TWO_RANK_BN_ATOL} of {ref['bn'][0].numel()}: "
        f"{bn_beyond(r0)}")
    log(f"train two ranks against one process, step 1: gradients' relative "
        f"L2 by stage, output first, {stages}; the nudged one-process run's "
        f"{floor_stages} (stages beyond {TWO_RANK_FLOOR_FACTOR} x: {over}); "
        f"worst tensor (cosine, relative L2, tensor) {grads}, nudged "
        f"{worst_tensor(ref, floor['grads'], ref['grads'])}; Adam updates "
        f"{update}, nudged "
        f"{worst_tensor(ref, first_update(floor), first_update(ref))}; "
        f"nudged loss {loss_rel(floor)[0]:.3g}, BN {bn_beyond(floor)}")
    log(f"cross-rank BN alone on the card ({card}), "
        f"{list(BN_CHECK_SHAPE)} over {TWO_RANKS} ranks, and cuDNN's on the "
        f"whole batch, against float64 on the whole batch (largest "
        f"difference over the largest value), with the peak memory above "
        f"the input of the cross-rank module and of nn.BatchNorm2d on the "
        f"same rows in GiB: {bn_checks} (bounds {BN_CHECK_TOL}; beyond: "
        f"{bn_fails})")
    log(f"train two ranks ({card}): warm step (device clock, steps "
        f"2..{steps}, two ranks sharing one card over gloo) "
        f"{[round(w, 3) for w in warm]} ms, peak memory "
        f"{[round(s['peak_gib'], 3) for s in summaries]} GiB; one process at "
        f"batch {TWO_RANK_BATCH}: "
        f"{statistics.median(ref['step_s'][1:]) * 1e3:.3f} ms, "
        f"{ref['peak_gib']:.3f} GiB; phase 4's step at batch 5 "
        f"{train_step_ms:.3f} ms; wall from launch to both exits "
        f"{wall:.3f} s, the ranks' own CLI runs "
        f"{[round(s['seconds'], 3) for s in summaries]} s")
    if any(s["backend"] != "gloo" or not s["cross_rank_bn"]
           or not s["collectives"]["all_gather"]
           or not s["collectives"]["all_reduce"] for s in summaries) \
            or ref["cross_rank_bn"]:
        raise AssertionError("the two-rank run did not run the "
                             "data-parallel path")
    if not ranks_equal or not masks_ok:
        raise AssertionError("the two ranks' steps differ, or their masks "
                             "are not the global batch's rows")
    if loss_rel(r0)[0] > TWO_RANK_LOSS_TOL \
            or epoch_rel > TWO_RANK_EPOCH_LOSS_TOL or bn_beyond(r0)[1] \
            or over or bn_fails:
        raise AssertionError("the two-rank step differs from the "
                             "one-process step")
    for s in (*summaries, ref):
        if s["launches"]["fused_dropout_matmul_fwd"] != steps \
                or s["launches"]["fused_dropout_matmul_bwd"] != steps:
            raise AssertionError(f"fused_dropout_matmul launches "
                                 f"{s['launches']} in {steps} steps")
    return [s["launches"] for s in summaries]


def phase_zoo_train(torch, seed: int, workdir: str) -> dict:
    """The zoo train phase in a child process of this script, on the train
    phase's dataset: a fresh CUDA context, whose memory peaks and profiler
    sessions are its own (a process that had opened some twenty profiler
    sessions saw every later one record nothing). Streams the child's log
    and returns its last line's JSON."""
    cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
           "--zoo-train", os.path.join(workdir, "train_root"), workdir]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    try:
        last = ""
        for line in proc.stdout:
            print(line, end="", flush=True)
            last = line
        if proc.wait() != 0:
            raise RuntimeError(f"the zoo train phase exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    result = json.loads(last)
    log("zoo train: " + "; ".join(
        f"{name} step {r['step_ms']:.3f} ms, peak {r['peak_gib']:.3f} GiB"
        for name, r in result.items()))
    return result


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
    checkpoint (bf16): warm-up, one request, then serving_bench's phases
    over the cell's processed PNGs (SERVE_SEQ sequential JSON requests,
    SERVE_CLIENTS client threads x SERVE_PER_CLIENT requests; their JSON
    lines printed), one raw scan BMP, one request each of format=mask,
    format=combined and exclude_nodes=1, /healthz and /v1/stats. Every
    answer 200 with consistent numbers, no launch shape after warm-up,
    upsample_argmax launched and no training kernel, every request served.
    Then a --float32 server's mask answers against a direct float32
    predict_images call on the same preprocessed images. Returns the
    upsample_argmax launches of the bf16 server's traffic."""
    import io
    import numpy as np
    from PIL import Image

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage, Preprocessor)
    from neuralbarkcalculator_tpu_torch.tools import serving_bench
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
    device = serving_bench.device_name(calc.device)
    try:
        counters = reset_counters()
        check_answer("warm", 200, serving_bench.one_request(port, pngs[0])[1])
        profiling.report(reset=True)
        t0 = time.perf_counter()
        seq_row, seq_answers = serving_bench.sequential(
            port, pngs, SERVE_SEQ, "bf16", device)
        seq_s = time.perf_counter() - t0
        seq_server = [check_answer(f"sequential {i}", 200, a)
                      for i, a in enumerate(seq_answers)]
        sent = 1 + SERVE_SEQ
        after_seq = predictor.snapshot_stats()
        seq_stages = profiling.report(reset=True)

        conc_row, conc_answers = serving_bench.concurrent(
            port, pngs, SERVE_CLIENTS, SERVE_PER_CLIENT, "bf16", device)
        conc_server = [check_answer(f"concurrent {i}", 200, a)
                       for i, a in enumerate(conc_answers)]
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
    log(f"serving_bench: {json.dumps(seq_row)}")
    log(f"serving_bench: {json.dumps(conc_row)}")
    log(f"serving sequential ({card}): {SERVE_SEQ} requests in {seq_s:.3f} "
        f"s = {SERVE_SEQ / seq_s:.3f} requests/s; mean batch "
        f"{after_seq['mean_batch']:.3f}; {server_line(seq_server)}")
    n_conc = after_conc["served"] - after_seq["served"]
    conc_batches = after_conc["batches"] - after_seq["batches"]
    log(f"serving {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} ({card}): "
        f"mean batch {n_conc / conc_batches:.3f} over {conc_batches} "
        f"batches; {server_line(conc_server)}")
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
    return launches["upsample_argmax"]


def exact_height_case(torch, rng, stride: int, h: int, w: int) -> tuple:
    """A batch of BATCH random stride-``stride`` logits of h x w images and
    the exact-height path's operators on the card: (feat, rows, colt,
    col_win)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.ops.resize import (
        bicubic_resize_matrix, column_operator_t)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        column_windows)

    dev = torch.device("cuda")
    f, wf = -(-h // stride), -(-w // stride)
    feat = torch.from_numpy(rng.standard_normal(
        (BATCH, f, wf, 3), dtype=np.float32)).to(dev)
    rows = torch.from_numpy(bicubic_resize_matrix(f, h).astype(
        np.float32)).to(dev).expand(BATCH, -1, -1).contiguous()
    colt = torch.from_numpy(column_operator_t(wf, w)).to(dev)
    return feat, rows, colt, column_windows(colt)


def check_exact_height_case(torch, stride: int, case: tuple, h: int,
                            w: int) -> int:
    """The kernel against the plain version on one ``exact_height_case``
    (check_map at FLIP_MARGIN); returns the differing pixels."""
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax, upsample_argmax_plain)

    feat, rows, colt, col_win = case
    got = upsample_argmax(feat, rows, colt, col_win)
    torch.cuda.synchronize()
    n, _ = check_map(torch, f"stride {stride} [{BATCH}x{h}x{w}, "
                     f"F={feat.shape[1]}, Wf={feat.shape[2]}] vs plain", got,
                     upsample_argmax_plain(feat, rows, colt), feat, rows,
                     colt, FLIP_MARGIN)
    return n


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

    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax, upsample_argmax_plain)

    rng = np.random.default_rng(seed + 32)
    flips = sum(check_exact_height_case(
        torch, 32, exact_height_case(torch, rng, 32, h, w), h, w)
        for h, w in STRIDE32_CASES)
    # the last 1024 x 1024 case is timed: a uniform batch, so one
    # F.interpolate + argmax call computes the same function
    h, w = STRIDE32_TIMED
    f, wf = h // 32, w // 32
    feat, rows, colt, col_win = exact_height_case(torch, rng, 32, h, w)
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


def phase_kernel_stride4(torch, seed: int) -> dict:
    """upsample_argmax on SegFormer's path: stride-4 logits at exact
    heights (a batch of 8 at each STRIDE4_CASES height, F = h / 4, Wf =
    256) held against the plain version (equal but for float32 near-ties
    within FLIP_MARGIN), the 1024^2 batch also against one F.interpolate +
    argmax call; then each case timed by device time (the kernel, the plain
    version) in FDM_TIMING_ROUNDS rounds beside its byte bound."""
    import numpy as np
    import torch.nn.functional as F

    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax, upsample_argmax_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 4)
    flips, cases = 0, []
    for h, w in STRIDE4_CASES:
        case = exact_height_case(torch, rng, 4, h, w)
        flips += check_exact_height_case(torch, 4, case, h, w)
        cases.append((h, w, *case))
    h, w, feat, rows, colt, col_win = cases[-1]
    check_map(torch, f"stride 4 [{BATCH}x{h}x{w}] vs F.interpolate + argmax",
              upsample_argmax(feat, rows, colt, col_win),
              F.interpolate(feat.permute(0, 3, 1, 2), size=(h, w),
                            mode="bicubic", align_corners=False).argmax(
                                1).to(torch.uint8), feat, rows, colt,
              INTERP_MARGIN)
    fns = []
    for _, _, feat, rows, colt, col_win in cases:
        fns += [lambda a=(feat, rows, colt, col_win): upsample_argmax(*a),
                lambda a=(feat, rows, colt): upsample_argmax_plain(*a)]
    one = {"upsample_argmax_kernel": 1}
    rounds, counts = [], []
    for r in range(FDM_TIMING_ROUNDS):
        times, n = device_times(torch, fns, [one, None] * len(cases))
        rounds.append([sum(t.values()) for t in times])
        counts.append(n)
        log(f"upsample_argmax stride 4 timing round {r + 1} (device ms per "
            f"call, kernel / plain by height): " + ", ".join(
                f"{c[0]}: {rounds[-1][2 * i]:.4f} / "
                f"{rounds[-1][2 * i + 1]:.4f}" for i, c in enumerate(cases))
            + f"; clocks.sm, clocks.mem, power.draw after it: "
            f"{card_clocks()}")
    same_counts("upsample_argmax stride 4", counts)
    medians = [statistics.median(col) for col in zip(*rounds)]
    out = {"stride4_flips": flips}
    for i, (h, w, feat, rows, colt, _) in enumerate(cases):
        ms, plain_ms = medians[2 * i], medians[2 * i + 1]
        ops = band_ops(torch, rows, colt)
        nbytes = (4 * (feat.numel() + rows.numel() + colt.numel())
                  + 4 * 2 * w + BATCH * h * w)
        op_ms = ops / H100_F32_FLOPS * 1e3
        byte_ms = nbytes / H100_HBM_BYTES * 1e3
        bound = max(op_ms, byte_ms)
        log(f"upsample_argmax stride 4 [{BATCH}x{h}x{w}, F={h // 4}, "
            f"Wf={w // 4}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({ops / 1e9:.4f} GFLOP over the windows, "
            f"{nbytes / 1e6:.3f} MB; {100 * bound / ms:.2f} % of it, bound "
            f"by {'operations' if op_ms >= byte_ms else 'bytes'})")
        out[f"stride4_{h}"] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound,
                               "roofline_pct": 100 * bound / ms}
    return out


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
    return zoo_step_runner(torch, engine)()


def zoo_step_runner(torch, engine):
    """A function timing ``zoo_step_ms``'s step, its inputs made once."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    img = np.random.default_rng(0).integers(0, 256, (PAD_H, WIDTH, 3),
                                            np.uint8)
    batch, valid_h, rows = step_inputs(
        torch, engine, [ProcessedImage(img, "step", "zoo")] * BATCH)

    def run() -> float:
        with torch.inference_mode():
            return time_ms(torch, lambda: engine._device_step(
                batch, valid_h, rows, pack=True), reps=3, runs=3)
    return run


def squeeze_pool_step_ms(torch, engine) -> tuple[float, float]:
    """An EfficientNet engine's device step alone (``zoo_step_ms``) with
    squeeze-excite's pool as one process takes it (the float32 mean) and,
    in turns with it, as a rank of a split takes it (the column sums of
    parallel/spatial.sum_width_f32, here without the gather): mean, column
    sums, column sums, mean. Returns the two times, each the mean of its
    two turns."""
    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        MBConvBlock)
    from neuralbarkcalculator_tpu_torch.parallel.spatial import (
        sum_width_f32)

    def column_sums(block, h, width):
        total = sum_width_f32(h, None)[:, :, None, None]
        return (total / (h.shape[2] * h.shape[3])).to(h.dtype)

    mean_pool = MBConvBlock._squeeze
    run = zoo_step_runner(torch, engine)
    times: dict = {"mean": [], "column sums": []}
    for turn in ("mean", "column sums", "column sums", "mean"):
        MBConvBlock._squeeze = (column_sums if turn == "column sums"
                                else mean_pool)
        try:
            times[turn].append(run())
        finally:
            MBConvBlock._squeeze = mean_pool
    return (statistics.mean(times["mean"]),
            statistics.mean(times["column sums"]))


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
        if name.startswith(("fcn_efficientnet", "deeplabv3_efficientnet")):
            mean_ms, cols_ms = squeeze_pool_step_ms(torch, engine)
            log(f"zoo {name}: device step alone in turns, squeeze-excite's "
                f"pool the one process's mean {mean_ms:.3f} ms, a split "
                f"rank's column sums (no gather) {cols_ms:.3f} ms")
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


def int8_step_profile(torch, engine, label: str) -> dict:
    """The int8 engine's device step on BATCH random 1024 x 1024 images
    under torch.profiler: device ms by kernel group (INT8_STEP_GROUPS:
    cuBLAS's int8 GEMMs, the im2col / concat / pad copies, the float32
    epilogues and masks as elementwise kernels, the stem conv,
    upsample_argmax) and the largest kernels."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    img = np.random.default_rng(0).integers(0, 256, (PAD_H, WIDTH, 3),
                                            np.uint8)
    batch, valid_h, rows = step_inputs(
        torch, engine, [ProcessedImage(img, "step", "int8")] * BATCH)
    with torch.inference_mode():
        engine._device_step(batch, valid_h, rows, pack=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine._device_step(batch, valid_h, rows, pack=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(event_device_us(e) for e in events) / 1e3
    if busy == 0:
        log(f"{label} profile: the profiler recorded no device time (not "
            f"measured)")
        return {}
    groups: dict[str, float] = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in INT8_STEP_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + event_device_us(e) / 1e3
    log(f"{label} profile: one device step, busy {busy:.3f} ms in "
        f"{wall_ms:.3f} ms wall, {sum(e.count for e in events)} device "
        f"events")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{label} profile: {group:26s} {ms:9.3f} ms ({ms / busy:.4f})")
    for e in sorted(events, key=event_device_us, reverse=True)[:12]:
        log(f"{label} profile: {event_device_us(e) / 1e3:9.3f} ms "
            f"{e.count:5d}x {e.key[:110]}")
    return groups


def int8_card_vs_cpu(torch, engine, item, label: str) -> None:
    """From one post-stem int8 tensor of `item` (a 1024-wide image, made on
    the card), the int8 blocks and head on the card against a CPU copy of
    the same model: the features and the FCN logits bit for bit (integer
    sums are exact, the epilogues separate float32 operations). The
    DeepLab pooled branch's float32 product [1, 2048] x [2048, 256] may sum
    in another order: its int8 result may move by 1 LSB, and with the
    card's pooled branch given to the CPU the logits must be equal."""
    import copy

    qm = engine.model
    cpu = copy.deepcopy(qm).cpu()
    x = torch.from_numpy(item.image).to(engine.device)[None]
    with torch.inference_mode():
        x_q = qm.backbone.stem(engine._normalize(x, None).to(engine.dtype))
        feat = qm.backbone.blocks(x_q)
        logits = qm.classifier(feat)
        t0 = time.perf_counter()
        feat_c = cpu.backbone.blocks(x_q.cpu())
        note = ""
        if hasattr(cpu.classifier, "aspp"):
            pooled = qm.classifier.aspp.pooled(feat)
            pooled_c = cpu.classifier.aspp.pooled(feat_c)
            lsb = int((pooled.cpu().int() - pooled_c.int()).abs().max())
            note = f"; pooled branch max |diff| {lsb} LSB"
            if lsb > 1:
                raise AssertionError(f"{label}: the pooled branch differs "
                                     f"by {lsb} LSB on the CPU")
            cpu.classifier.aspp.pooled = lambda *a: pooled.cpu()
        logits_c = cpu.classifier(feat_c)
        cpu_s = time.perf_counter() - t0
    same_feat = torch.equal(feat.cpu(), feat_c)
    same = torch.equal(logits.cpu(), logits_c)
    log(f"{label} card vs CPU from one post-stem int8 tensor "
        f"{tuple(x_q.shape)} ({item.fname}): features equal {same_feat}, "
        f"logits equal {same} (max |diff| "
        f"{float((logits.cpu() - logits_c).abs().max()):.3g}){note}; the "
        f"CPU's blocks and head took {cpu_s:.3f} s")
    if not (same_feat and same):
        raise AssertionError(f"{label}: int8 card and CPU differ")


def int8_cli(torch, workdir: str, root: str, ckpt: str, name: str) -> None:
    """The offline path: cli/quantize_checkpoint --n 1 over a folder of
    the first INT8_CLI_IMAGES processed images (it calibrates on img00,
    alone), then cli/predict.main on the .int8.pt at batch 1, against a
    lazy engine at batch 1 (its first chunk is img00 alone, 896 rows, on
    the 128-row bucket, so its calibration batch is unpadded too): the
    same calibration, so the dual masks must equal the lazy maps.""" 
    import shutil

    import numpy as np

    from neuralbarkcalculator_tpu_torch.cli import predict as cli_predict
    from neuralbarkcalculator_tpu_torch.cli import quantize_checkpoint
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io.native import load_image_u8
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    cli_root = os.path.join(workdir, f"int8_cli_{name}")
    src = os.path.join(root, "processed", "samples", "sapin")
    dst = os.path.join(cli_root, "processed", "samples", "sapin")
    os.makedirs(dst)
    os.makedirs(os.path.join(cli_root, "samples", "sapin"))
    items = folder_items(root, range(INT8_CLI_IMAGES))
    for it in items:
        shutil.copy(os.path.join(src, it.fname), dst)
    lazy = NeuralBarkCalculator(
        ckpt, model_name=name, device="cuda", config=PredictConfig(
            model_path=ckpt, batch_size=1, quantize_int8=True))
    want = {it.fname: m for it, m in lazy.predict_images(items)}
    del lazy
    t0 = time.perf_counter()
    out = quantize_checkpoint.main(quantize_checkpoint.build_parser(
        ).parse_args([os.path.join(cli_root, "processed"), "--model_path",
                      ckpt, "--model", name, "--n", "1", "--out",
                      os.path.join(workdir, f"{name}.cli.int8.pt")]))
    export_s = time.perf_counter() - t0
    counters = reset_counters()
    t0 = time.perf_counter()
    cli_predict.main(cli_predict.build_parser().parse_args(
        [cli_root, "--model_path", out, "--model", name, "--resume",
         "--batch_size", "1", "--dpi", str(DPI)]))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = counters["upsample_argmax"].count
    equal = 0
    for it in items:
        dual = load_image_u8(os.path.join(cli_root, "results", "outputs",
                                          "sapin", it.fname), grayscale=True)
        equal += int(np.array_equal(
            dual, np.choose(want[it.fname], [0, 127, 255]).astype(np.uint8)))
    log(f"int8 {name} offline path: cli/quantize_checkpoint --n 1 "
        f"{export_s:.3f} s ({os.path.getsize(out) / 1e6:.1f} MB), "
        f"cli/predict.main on it at batch 1 {predict_s:.3f} s, "
        f"{launches} upsample_argmax launches; {equal} of {len(items)} "
        f"dual masks equal the lazy engine's maps")
    if equal != len(items) or launches == 0:
        raise AssertionError(f"int8 {name}: the offline path's maps differ "
                             f"from the lazy run's, or no launch")


def phase_int8(torch, workdir: str, root: str, ckpts: dict,
               card: str) -> dict:
    """int8 inference on the card, for each of INT8_MODELS (full width and
    depth, the random_checkpoint weights of phase 3 and the zoo phase):
    the folder engine with quantize_int8 (bf16 stem, batch 8) over phase
    3's 16 images, its first pass calibrating lazily on the first chunk
    (the calibration's ms), then a warm pass (images/s) with every launch
    count set to 0 just before it and read just after; class-map agreement
    with the bf16 and float32 engines; the int8 device step alone against
    bf16's, in turns, with their peak memory; a profiled int8 step by
    kernel group; the card against the CPU from one post-stem int8 tensor
    (int8_card_vs_cpu); the calibrated model saved with save_quantized and
    loaded by a new engine: maps bit for bit; and one request through a
    --int8 server. For fcn_resnet50 also the cli/quantize_checkpoint ->
    cli/predict path (int8_cli). Returns each model's numbers."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        save_quantized, state_digest)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        QuantizedSegmentationModel)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    from neuralbarkcalculator_tpu_torch.utils import profiling

    items = folder_items(root, range(N_IMAGES))
    out: dict = {}
    for name in INT8_MODELS:
        t0 = time.perf_counter()
        ckpt = ckpts[name]
        label = f"int8 {name}"

        def engine(path=ckpt, **config):
            return NeuralBarkCalculator(
                path, model_name=name, device="cuda", config=PredictConfig(
                    model_path=path, figure_dpi=DPI, **config))

        int8 = engine(quantize_int8=True)
        profiling.report(reset=True)
        counters = reset_counters()
        t1 = time.perf_counter()
        int8.predict(root, progress=False)  # calibrates on the first chunk
        first_s = time.perf_counter() - t1
        first_launches = counters["upsample_argmax"].count
        calib_ms = profiling.report(reset=True)[
            "predict/quantize_calibration"]["total_s"] * 1e3
        if not isinstance(int8.model, QuantizedSegmentationModel) \
                or first_launches == 0:
            raise AssertionError(f"{label}: model {type(int8.model)}, "
                                 f"{first_launches} launches")
        digest = state_digest(int8.model).hex()
        counters = reset_counters()
        t1 = time.perf_counter()
        csv = int8.predict(root, progress=False)
        seconds = time.perf_counter() - t1
        counts = {k: c.count for k, c in counters.items()}
        with open(csv) as f:
            rows = len(f.read().splitlines()) - 1
        if rows != N_IMAGES or counts["upsample_argmax"] == 0 \
                or counts["fused_dropout_matmul_fwd"] \
                or counts["fused_dropout_matmul_bwd"]:
            raise AssertionError(f"{label}: {rows} CSV rows, launches "
                                 f"{counts}")
        log(f"{label}: {N_IMAGES} images (heights {FOLDER_HEIGHTS}, width "
            f"{WIDTH}, batch {int8.config.batch_size}, bf16 stem) first "
            f"pass {first_s:.3f} s with the lazy calibration "
            f"{calib_ms:.3f} ms and {first_launches} upsample_argmax "
            f"launches; warm pass {seconds:.3f} s = "
            f"{N_IMAGES / seconds:.3f} images/s, launches {counts}")

        maps = {it.fname: m for it, m in int8.predict_images(items)}
        total = sum(m.size for m in maps.values())
        bf16 = engine()
        agree = {}
        for kind, eng in (("bf16", bf16),
                          ("float32", engine(use_bfloat16=False))):
            got = {it.fname: m for it, m in eng.predict_images(items)}
            agree[kind] = sum(int((got[k] == maps[k]).sum())
                              for k in maps) / total
        log(f"{label}: class-map agreement with the bf16 engine "
            f"{agree['bf16']:.6f}, with the float32 engine "
            f"{agree['float32']:.6f} over {N_IMAGES} images (random "
            f"weights; floor {INT8_AGREE_FLOOR})")
        if min(agree.values()) <= INT8_AGREE_FLOOR:
            raise AssertionError(f"{label}: agreement {agree}")

        steps: dict[str, list[float]] = {"int8": [], "bf16": []}
        peaks: dict[str, float] = {}
        for kind in ("int8", "bf16", "bf16", "int8"):
            eng = int8 if kind == "int8" else bf16
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps[kind].append(zoo_step_ms(torch, eng))
            peaks[kind] = max(peaks.get(kind, 0.0),
                              torch.cuda.max_memory_allocated() / 2 ** 30)
        int8_ms = statistics.median(steps["int8"])
        bf16_ms = statistics.median(steps["bf16"])
        log(f"{label}: device step alone per batch of {BATCH} at {PAD_H}x"
            f"{WIDTH} (int8, bf16, bf16, int8): int8 "
            f"{', '.join(f'{v:.3f}' for v in steps['int8'])} ms, bf16 "
            f"{', '.join(f'{v:.3f}' for v in steps['bf16'])} ms; int8 / "
            f"bf16 {int8_ms / bf16_ms:.3f}; peak memory int8 "
            f"{peaks['int8']:.3f} GiB, bf16 {peaks['bf16']:.3f} GiB")
        del bf16
        torch.cuda.empty_cache()
        groups = int8_step_profile(torch, int8, label)
        int8_card_vs_cpu(torch, int8, items[0], label)

        qpath = os.path.join(workdir, f"{name}.int8.pt")
        save_quantized(qpath, int8.model, name)
        offline = engine(qpath)
        got = {it.fname: m for it, m in offline.predict_images(items)}
        same = sum(int((got[k] == maps[k]).all()) for k in maps)
        log(f"{label}: save_quantized -> {os.path.getsize(qpath) / 1e6:.1f} "
            f"MB; a new engine on it equals the lazy maps on {same} of "
            f"{N_IMAGES} images")
        if same != N_IMAGES:
            raise AssertionError(f"{label}: the offline export's maps "
                                 f"differ")
        del offline

        srv, thread, warm_s = start_server(torch, ckpt, "--model", name,
                                           "--int8")
        try:
            with open(os.path.join(root, "processed", "samples", "sapin",
                                   items[0].fname), "rb") as f:
                body = f.read()
            counters = reset_counters()
            status, _, data, dt = http_call(srv.server_address[1], "POST",
                                            "/v1/predict", body)
            answer = check_answer(f"{label} request", status, data)
            launches = counters["upsample_argmax"].count
            served_int8 = isinstance(srv.state.predictor.calc.model,
                                     QuantizedSegmentationModel)
        finally:
            stop_server(srv, thread)
        log(f"{label} --int8 server ({card}): warm-up with the calibration "
            f"{warm_s:.3f} s, one request in {dt * 1e3:.3f} ms, class "
            f"pixels {answer['class_pixels']}, {launches} upsample_argmax "
            f"launches, int8 model {served_int8}")
        if not served_int8 or launches == 0 or answer["width"] != WIDTH:
            raise AssertionError(f"{label} server: answer {answer}, "
                                 f"{launches} launches")
        if name == "fcn_resnet50":
            del int8
            torch.cuda.empty_cache()
            int8_cli(torch, workdir, root, ckpt, name)
        out[name] = {"images_per_s": N_IMAGES / seconds,
                     "launches": counts["upsample_argmax"], "maps": maps,
                     "digest": digest,
                     "step_ms": int8_ms, "bf16_step_ms": bf16_ms,
                     "calibration_ms": calib_ms, "agreement": agree,
                     "groups": groups}
        torch.cuda.empty_cache()
        log(f"{label}: {time.perf_counter() - t0:.3f} s")
    return out


def phase_trace(torch, engine, root: str, workdir: str) -> int:
    """utils.device_trace around one warm folder pass of the main path's
    engine: one Chrome trace in its directory, naming upsample_argmax's
    kernel among its device events. Returns the pass's upsample_argmax
    launches (counts set to 0 just before, read just after)."""
    from neuralbarkcalculator_tpu_torch.utils import device_trace

    log_dir = os.path.join(workdir, "trace")
    counters = reset_counters()
    t0 = time.perf_counter()
    with device_trace(log_dir):
        engine.predict(root, progress=False)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters["upsample_argmax"].count
    files = os.listdir(log_dir)
    if len(files) != 1:
        raise AssertionError(f"device_trace wrote {files}, not one trace")
    path = os.path.join(log_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels
            if "upsample_argmax_kernel" in e.get("name", "")]
    log(f"trace: device_trace around one warm pass ({seconds:.3f} s with "
        f"the trace's export): {files[0]}, {os.path.getsize(path)} bytes, "
        f"{len(events)} events, {len(kernels)} kernels, "
        f"{len(ours)} upsample_argmax_kernel; launches {launches}")
    if not ours or launches == 0 or len(ours) != launches:
        raise AssertionError(f"trace: {len(ours)} upsample_argmax kernels "
                             f"in the trace for {launches} launches")
    return launches


def phase_f32_batch(torch, ckpt: str, main_root: str, card: str) -> int:
    """Float32 class maps across launch batches, the invariant's scope on
    the card: the predict cell's images through the float32 engine (TF32
    off, cuDNN's default algorithm choice, no cuDNN flag touched) at each
    launch batch of F32_BATCHES. Each image's maps must agree on at least
    F32_AGREE_FLOOR of its pixels between the batches; the pixels that
    differ are printed. Returns the upsample_argmax launches (counts set to
    0 just before, read just after)."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    items = folder_items(main_root, range(N_IMAGES))
    total = sum(it.image.shape[0] * it.image.shape[1] for it in items)
    engine = NeuralBarkCalculator(
        ckpt, config=PredictConfig(model_path=ckpt, use_bfloat16=False))
    counters = reset_counters()
    maps = {}
    for b in F32_BATCHES:
        engine.config.batch_size = b
        maps[b] = {it.fname: m for it, m in engine.predict_images(items)}
    launches = counters["upsample_argmax"].count
    first, last = F32_BATCHES[0], F32_BATCHES[-1]
    per_image = {f: (int((maps[last][f] != m).sum()), m.size)
                 for f, m in maps[first].items()}
    worst = min(1 - n / size for n, size in per_image.values())
    differ = sum(n for n, _ in per_image.values())
    log(f"float32 batch ({card}; cuDNN's defaults): maps at launch batch "
        f"{first} and {last} over {N_IMAGES} images ({total} pixels): "
        f"{differ} pixels differ ({differ / total:.3g}) in "
        f"{sum(n > 0 for n, _ in per_image.values())} images, per image "
        f"{[n for n, _ in per_image.values()]}; the least agreement of an "
        f"image {worst:.6f} (floor {F32_AGREE_FLOOR})")
    if worst < F32_AGREE_FLOOR:
        raise AssertionError(f"float32 batch: an image's maps agree on "
                             f"{worst:.6f} < {F32_AGREE_FLOOR} between "
                             f"launch batch {first} and {last}")
    if launches == 0:
        raise AssertionError("float32 batch: upsample_argmax never launched")
    return launches


def entrypoint_child(torch, argv: list[str]) -> dict:
    """The entry-points phase's child (``--entrypoint CLI ARGV``): the
    console script ``bark-CLI-torch`` (cli/CLI.entrypoint) on ARGV, with
    every launch count set to 0 just before and read just after."""
    import importlib

    cli, args = argv[0], argv[1:]
    module = importlib.import_module(f"neuralbarkcalculator_tpu_torch.cli."
                                     f"{cli}")
    counters = reset_counters()
    sys.argv = [f"bark-{cli}-torch", *args]
    t0 = time.perf_counter()
    module.entrypoint()
    torch.cuda.synchronize()
    return {"launches": {name: c.count for name, c in counters.items()},
            "seconds": time.perf_counter() - t0}


def phase_entry_points(torch, seed: int, workdir: str, main_root: str,
                       ckpt: str, train_data: str, card: str) -> dict:
    """The console scripts on the card, with their default device:
    ``bark-predict-torch`` over a copy of the main path's folder (as its
    sources) and ``bark-train-torch`` for one epoch over phase 4's dataset
    (samples factor 1, no report), each entrypoint() in a child process of
    this script, both at once. The predict run must write the folder's
    artifacts and launch upsample_argmax, the train run its checkpoints
    and launch fused_dropout_matmul forward and backward. Returns each
    child's launch counts."""
    root = os.path.join(workdir, "entry_predict")
    copy_folder(main_root, root, True)
    train_root = os.path.join(workdir, "entry_train")
    children = {
        "predict": [root, "--model_path", ckpt, "--dpi", str(DPI)],
        "train": [train_root, "--data_dir", train_data, "--seed",
                  str(seed), "--epochs", "1", "--samples_factor", "1",
                  "--no_report"]}
    t0 = time.perf_counter()
    procs = {cli: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--entrypoint", cli,
         *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for cli, argv in children.items()}
    try:
        outs = {cli: p.communicate(timeout=900) for cli, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    runs = {}
    for cli, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"bark-{cli}-torch exited {p.returncode}: "
                               f"{outs[cli][1][-3000:]}")
        runs[cli] = json.loads(outs[cli][0].strip().splitlines()[-1])
    with open(os.path.join(root, "results", "final_stats.csv")) as f:
        rows = len(f.read().splitlines()) - 1
    moar = os.path.join(train_root, "moar")
    saved = sorted(os.listdir(moar)) if os.path.isdir(moar) else []
    log(f"entry points ({card}): bark-predict-torch and bark-train-torch "
        f"as two child processes at once, wall {wall:.3f} s; predict "
        f"{runs['predict']['seconds']:.3f} s, {rows} CSV rows, launches "
        f"{runs['predict']['launches']}; train "
        f"{runs['train']['seconds']:.3f} s, wrote {saved}, launches "
        f"{runs['train']['launches']}")
    if rows != N_IMAGES or runs["predict"]["launches"]["upsample_argmax"] \
            == 0:
        raise AssertionError("bark-predict-torch: its artifacts or its "
                             "upsample_argmax launches are missing")
    train_counts = runs["train"]["launches"]
    if "best_model.pt" not in saved or not all(
            train_counts[f"fused_dropout_matmul_{d}"] for d in ("fwd",
                                                                "bwd")):
        raise AssertionError("bark-train-torch: its checkpoint or its "
                             "fused_dropout_matmul launches are missing")
    return {cli: run["launches"] for cli, run in runs.items()}


def soak_summary(report: dict) -> dict:
    """The soak's report without its sample series."""
    return {k: v for k, v in report.items()
            if k not in ("rss_mb", "rss_resid_mb")} | {
        "rss_first_mb": report["rss_mb"]["first_third_mean"],
        "rss_last_mb": report["rss_mb"]["last_third_mean"],
        "rss_resid_first_mb": report["rss_resid_mb"]["first_third_mean"],
        "rss_resid_last_mb": report["rss_resid_mb"]["last_third_mean"]}


def phase_serving_tools(torch, ckpt: str, workdir: str, card: str) -> int:
    """The port's serving tools on the card with the predict path's
    checkpoint, beside phase 7's run of serving_bench's request phases:
    serving_bench's cold start (a child server, bf16, batch 8, from its
    start to its first answer) and a SOAK_SECONDS-long serving_soak
    through its command line (8 clients, heights 896/960/1024, the report
    to a file), whose checks must pass. Each JSON line is printed. Returns
    the soak's upsample_argmax launches (counts set to 0 just before, read
    just after)."""
    from neuralbarkcalculator_tpu_torch.tools import (serving_bench,
                                                      serving_soak)

    cold = serving_bench.run_cold_start(
        serving_bench.serve_argv(ckpt, False, "cuda"))
    log(f"serving_bench: {json.dumps(cold)}")
    out = os.path.join(workdir, "serving_soak.json")
    counters = reset_counters()
    report = serving_soak.main(
        ["--model_path", ckpt, "--minutes", str(SOAK_SECONDS / 60.0),
         "--clients", str(SOAK_CLIENTS), "--out", out])
    soak = counters["upsample_argmax"].count
    log(f"serving_soak ({card}): {json.dumps(soak_summary(report))}")
    if soak == 0:
        raise AssertionError("serving_soak: upsample_argmax never launched")
    if report["served"] == 0 or report["requests"] != report["served"]:
        raise AssertionError(f"serving_soak served {report['served']} of "
                             f"{report['requests']} requests")
    return soak


def phase_curation(torch, seed: int, workdir: str, card: str) -> int:
    """tools/curation.py fine-tune of CURATION_DUALS structured 1024²
    duals (bench_data: blobs, node islands, speckles under 150 pixels)
    through its command line on the card (the ccl kernels), a warm-up run
    and a timed one, against the same run on the CPU (the plain version):
    every output file byte for byte, and not the input. Returns the timed
    run's ccl launches (counts set to 0 just before, read just after)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.io.native import (load_image_u8,
                                                          save_image_u8)
    from neuralbarkcalculator_tpu_torch.tools import curation
    from neuralbarkcalculator_tpu_torch.tools.bench_data import (
        structured_dual_mask)

    base = os.path.join(workdir, "curation")
    duals = os.path.join(base, "duals", "sapin")
    os.makedirs(duals)
    rng = np.random.default_rng(seed)
    for i in range(CURATION_DUALS):
        mask = structured_dual_mask(rng, 1024, 1024)
        save_image_u8(os.path.join(duals, f"d{i}.png"), np.select(
            [mask == 1, mask == 2], [127, 255], 0).astype(np.uint8))

    def fine_tune(out: str, device: str) -> float:
        t0 = time.perf_counter()
        curation.main(["fine-tune", "--duals_dir", os.path.dirname(duals),
                       "--output_dir", os.path.join(base, out), "--device",
                       device])
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    fine_tune("warm", "cuda")
    counters = reset_counters()
    card_s = fine_tune("card", "cuda")
    launches = counters["ccl"].count
    cpu_s = fine_tune("cpu", "cpu")
    differ = changed = 0
    for name in sorted(os.listdir(duals)):
        got, want = (open(os.path.join(base, d, "sapin", name), "rb").read()
                     for d in ("card", "cpu"))
        differ += got != want
        changed += not np.array_equal(*(load_image_u8(
            os.path.join(d, name), grayscale=True) for d in (
                duals, os.path.join(base, "card", "sapin"))))
    log(f"curation ({card}): fine-tune of {CURATION_DUALS} 1024² duals on "
        f"the card {card_s:.3f} s = {CURATION_DUALS / card_s:.3f} images/s "
        f"(PIL decode and encode included), on the CPU (plain version) "
        f"{cpu_s:.3f} s = {CURATION_DUALS / cpu_s:.3f} images/s; files "
        f"different card vs CPU {differ}, changed from the input {changed}; "
        f"ccl launches {launches}")
    if differ or changed != CURATION_DUALS or launches == 0:
        raise AssertionError(f"curation fine-tune: {differ} files differ "
                             f"card vs CPU, {changed} cleaned, {launches} "
                             f"ccl launches")
    return launches


def leaf_digests(tree, prefix: str = "") -> dict:
    """{'params/conv/kernel': {'shape', 'dtype', 'sha256'}} of a tree of
    numpy leaves (sha256 of the C-order bytes), as the orbax fixture's
    JSON holds them."""
    import hashlib

    import numpy as np

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(leaf_digests(v, path))
        else:
            arr = np.ascontiguousarray(v)
            out[path] = {"shape": list(arr.shape), "dtype": arr.dtype.name,
                         "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def run_predict_cli(torch, argv: list[str]) -> float:
    """bark-predict-torch (cli/predict.entrypoint) on ARGV in this
    process; returns its seconds."""
    from neuralbarkcalculator_tpu_torch.cli import predict as cli_predict

    saved = sys.argv
    sys.argv = ["bark-predict-torch", *argv]
    try:
        t0 = time.perf_counter()
        cli_predict.entrypoint()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        sys.argv = saved


def jax_int8_files(torch, workdir: str, root: str, state: dict
                   ) -> tuple[str, str]:
    """The port's quantize_variables tree of ``state`` (fcn_resnet50,
    folded, calibrated in float32 on the folder's first
    JAX_INT8_CALIBRATION_IMAGES images) written as the JAX package's
    .int8.msgpack and as the port's .int8.pt of the same int8 model."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import (DEFAULT_MEAN,
                                                       DEFAULT_STD)
    from neuralbarkcalculator_tpu_torch.io import flax_msgpack
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, quantized_variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        JAX_QCKPT_MAGIC, calibrate, quantize_variables, quantized_twin,
        save_quantized)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    model = MODEL_FACTORIES["fcn_resnet50"]()
    load_state_dict_into(model, state)
    model = fold_model(model).to("cuda").eval()
    batches = [torch.from_numpy(((it.image.astype(np.float32) / 255.0
                                  - np.float32(DEFAULT_MEAN))
                                 / np.float32(DEFAULT_STD))[None]).cuda()
               for it in folder_items(root, range(
                   JAX_INT8_CALIBRATION_IMAGES))]
    stats = calibrate(model, batches)
    folded = {k: v.detach().float().cpu()
              for k, v in model.state_dict().items()}
    qvars = quantize_variables(folded, stats, model.backbone.stage_sizes,
                               "fcn")
    twin = quantized_twin(model.cpu())
    twin.load_state_dict(quantized_variables_to_state_dict(qvars))
    pt = os.path.join(workdir, "jax_ckpt.int8.pt")
    save_quantized(pt, twin, "fcn_resnet50")
    msgpack = os.path.join(workdir, "jax_ckpt.int8.msgpack")
    with open(msgpack, "wb") as f:
        f.write(JAX_QCKPT_MAGIC + flax_msgpack.to_bytes(qvars))
    return pt, msgpack


def load_times(torch, paths: dict) -> dict:
    """Each checkpoint form's load, LOAD_REPS times: seconds to its state
    dict on the host, then to a new engine's model on the card (BN folded
    for the float forms; no calibration for the int8 ones)."""
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io import flax_msgpack
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_jax_checkpoint, load_torch_checkpoint,
        quantized_variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        JAX_QCKPT_MAGIC)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    host = {
        ".pt": lambda p: load_torch_checkpoint(p),
        ".msgpack": lambda p: load_jax_checkpoint(p, "fcn_resnet50"),
        ".int8.pt": lambda p: torch.load(p, map_location="cpu",
                                         weights_only=True)["state_dict"],
        ".int8.msgpack": lambda p: quantized_variables_to_state_dict(
            flax_msgpack.load(p, len(JAX_QCKPT_MAGIC)))}
    out = {}
    for form, path in paths.items():
        rows = []
        for _ in range(LOAD_REPS):
            t0 = time.perf_counter()
            host[form](path)
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine = NeuralBarkCalculator(path, config=PredictConfig(
                model_path=path), device="cuda")
            torch.cuda.synchronize()
            rows.append((host_s, time.perf_counter() - t0))
            del engine
        out[form] = {"mb": os.path.getsize(path) / 1e6,
                     "host_s": [r[0] for r in rows],
                     "cuda_s": [r[1] for r in rows]}
    return out


def phase_jax_checkpoints(torch, workdir: str, main_root: str, ckpt: str,
                          card: str) -> dict:
    """The JAX package's checkpoint forms through the port on the card,
    with none of jax, flax, orbax or msgpack: the main path's weights as a
    flax .msgpack through bark-predict-torch (CSV and masks byte for byte
    the .pt run's), as the JAX .int8.msgpack (maps bit for bit the
    .int8.pt's), the orbax fixture's sha256s, and the load times. Returns
    the upsample_argmax launches of the .msgpack CLI run and of the
    .int8.msgpack engine's pass (counts set to 0 just before each, read
    just after)."""
    import numpy as np

    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.io import flax_msgpack, orbax
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_torch_checkpoint, state_dict_to_variables)
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    bad = sorted(m for m in ("jax", "flax", "orbax", "tensorstore",
                             "msgpack") if m in sys.modules)
    if bad:
        raise AssertionError(f"imported {bad}")
    state = load_torch_checkpoint(ckpt)
    msgpack = os.path.join(workdir, "jax_ckpt.msgpack")
    with open(msgpack, "wb") as f:
        f.write(flax_msgpack.to_bytes(state_dict_to_variables(state)))

    roots = {}
    seconds = {}
    launches = {}
    for form, path in ((".pt", ckpt), (".msgpack", msgpack)):
        roots[form] = os.path.join(workdir, f"jax_ckpt_cli{form}")
        copy_folder(main_root, roots[form], True)
        counters = reset_counters()
        seconds[form] = run_predict_cli(torch, [
            roots[form], "--model_path", path, "--dpi", str(DPI)])
        launches[form] = counters["upsample_argmax"].count
    outputs = os.path.join("results", "outputs", "sapin")
    names = sorted(os.listdir(os.path.join(roots[".pt"], outputs)))
    csv, masks = (
        [open(os.path.join(roots[form], "results", "final_stats.csv"),
              "rb").read() for form in roots],
        [[open(os.path.join(roots[form], outputs, name), "rb").read()
          for form in roots] for name in names])
    masks_equal = sum(a == b for a, b in masks)

    int8_pt, int8_msgpack = jax_int8_files(torch, workdir, main_root, state)
    engines = {form: NeuralBarkCalculator(path, config=PredictConfig(
        model_path=path), device="cuda") for form, path in (
            (".int8.pt", int8_pt), (".int8.msgpack", int8_msgpack))}
    states = [e.model.state_dict() for e in engines.values()]
    state_equal = sorted(states[0]) == sorted(states[1]) and all(
        torch.equal(states[0][k], states[1][k]) for k in states[0])
    items = folder_items(main_root, range(N_IMAGES))
    maps = {}
    for form, engine in engines.items():
        counters = reset_counters()
        maps[form] = {it.fname: m for it, m in engine.predict_images(items)}
        launches[form] = counters["upsample_argmax"].count
    del engines
    int8_equal = sum(np.array_equal(maps[".int8.pt"][k],
                                    maps[".int8.msgpack"][k])
                     for k in maps[".int8.pt"])

    with open(ORBAX_FIXTURE + ".json") as f:
        want = json.load(f)["leaves"]
    t0 = time.perf_counter()
    fixture = orbax.load(ORBAX_FIXTURE)
    fixture_s = time.perf_counter() - t0
    got = leaf_digests(fixture)
    digests_equal = sum(got.get(k) == v for k, v in want.items())

    times = load_times(torch, {".pt": ckpt, ".msgpack": msgpack,
                               ".int8.pt": int8_pt,
                               ".int8.msgpack": int8_msgpack})
    for form, row in times.items():
        log(f"jax checkpoints load ({card}): fcn_resnet50 {form} "
            f"{row['mb']:.3f} MB: to a state dict on the host "
            f"{row['host_s']} s, to the engine's model on the card "
            f"{row['cuda_s']} s ({LOAD_REPS} loads each)")
    log(f"jax checkpoints ({card}): bark-predict-torch on {N_IMAGES} images "
        f"with the .pt {seconds['.pt']:.3f} s, with the .msgpack "
        f"{seconds['.msgpack']:.3f} s; final_stats.csv equal "
        f"{csv[0] == csv[1]}, dual masks equal {masks_equal} of "
        f"{len(names)}; the int8 engines' state dicts equal {state_equal}, "
        f"maps equal {int8_equal} of {len(items)}; orbax fixture read in "
        f"{fixture_s:.4f} s, sha256 equal {digests_equal} of {len(want)}; "
        f"upsample_argmax launches {launches}")
    if csv[0] != csv[1] or masks_equal != len(names) or \
            len(names) != N_IMAGES:
        raise AssertionError("the .msgpack run's CSV or masks differ from "
                             "the .pt run's")
    if not state_equal or int8_equal != len(items):
        raise AssertionError("the .int8.msgpack engine differs from the "
                             ".int8.pt engine")
    if digests_equal != len(want) or len(got) != len(want):
        raise AssertionError(f"orbax fixture: {digests_equal} of "
                             f"{len(want)} leaves match")
    if not all(launches.values()):
        raise AssertionError(f"upsample_argmax not launched: {launches}")
    return {"msgpack": launches[".msgpack"],
            "int8_msgpack": launches[".int8.msgpack"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--zoo-train", dest="zoo_train", nargs=2,
                        metavar=("TRAIN_ROOT", "WORKDIR"), default=None,
                        help=argparse.SUPPRESS)  # the zoo train phase's child
    parser.add_argument("--predict-shard", dest="predict_shard",
                        nargs=argparse.REMAINDER, default=None,
                        help=argparse.SUPPRESS)  # a sharded-predict child
    parser.add_argument("--no-native-predict", dest="no_native_predict",
                        nargs=argparse.REMAINDER, default=None,
                        help=argparse.SUPPRESS)  # the no-library child
    parser.add_argument("--entrypoint", dest="entrypoint",
                        nargs=argparse.REMAINDER, default=None,
                        help=argparse.SUPPRESS)  # an entry-points child
    parser.add_argument("--width-rank", dest="width_rank", nargs=9,
                        metavar=("RANK", "N_DATA", "N_MODEL", "PORT", "ROOT",
                                 "CKPT", "DTYPE", "MODEL", "INT8"),
                        default=None,
                        help=argparse.SUPPRESS)  # a width-phase child
    parser.add_argument("--mesh-rank", dest="mesh_rank", nargs=7,
                        metavar=("RANK", "N_DATA", "N_MODEL", "PORT", "MODE",
                                 "ROOT", "CKPT"),
                        default=None,
                        help=argparse.SUPPRESS)  # a mesh stream/serve child
    parser.add_argument("--train-rank", dest="train_rank", nargs=4,
                        metavar=("RANK", "PORT", "WORKDIR", "SEED"),
                        default=None,
                        help=argparse.SUPPRESS)  # a two-rank phase child
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
    if args.zoo_train:
        result = zoo_train(torch, args.seed, *args.zoo_train)
        print(json.dumps(result), flush=True)
        return 0
    if args.predict_shard:
        print(json.dumps(predict_shard_child(torch, args.predict_shard)),
              flush=True)
        return 0
    if args.no_native_predict:
        print(json.dumps(no_native_child(torch, args.no_native_predict)),
              flush=True)
        return 0
    if args.entrypoint:
        print(json.dumps(entrypoint_child(torch, args.entrypoint)),
              flush=True)
        return 0
    if args.width_rank:
        print(json.dumps(width_rank_child(torch, args.width_rank)),
              flush=True)
        return 0
    if args.mesh_rank:
        print(json.dumps(mesh_rank_child(torch, args.mesh_rank)),
              flush=True)
        return 0
    if args.train_rank:
        rank, port, workdir, seed = args.train_rank
        print(json.dumps(train_rank_child(torch, int(rank), int(port),
                                          workdir, int(seed))), flush=True)
        return 0

    def timed(label: str, fn, *fn_args):
        t0 = time.perf_counter()
        result = fn(*fn_args)
        log(f"phase {label}: {time.perf_counter() - t0:.3f} s")
        return result

    card = timed("build", phase_build)
    kernel = timed("upsample_argmax", phase_kernel, torch, args.seed)
    kernel.update(timed("upsample_argmax stride 32", phase_kernel_stride32,
                        torch, args.seed))
    kernel.update(timed("upsample_argmax stride 4", phase_kernel_stride4,
                        torch, args.seed))
    fdm = timed("fused_dropout_matmul", phase_fdm_kernel, torch, args.seed)
    ccl_row = timed("ccl", phase_ccl, torch, args.seed, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_path = timed("main path", phase_main_path, torch, args.seed,
                          workdir)
        kernel["launches"] = main_path["launches"]
        timed("profile", phase_profile, torch, main_path)
        kernel["trace_launches"] = timed(
            "trace", phase_trace, torch, main_path["engine"],
            main_path["root"], workdir)
        timed("reference", phase_reference, torch, main_path["engine"],
              main_path["ckpt"], folder_items(main_path["root"], range(4)))
        ckpt, main_root = main_path["ckpt"], main_path["root"]
        main_seconds = main_path["seconds"]
        del main_path
        kernel["f32_batch_launches"] = timed(
            "float32 batch", phase_f32_batch, torch, ckpt, main_root, card)
        sharded = timed(
            "sharded predict", phase_sharded_predict, torch, workdir,
            main_root, ckpt, main_seconds, card)
        kernel["shard_launches"] = sharded["launches"]
        kernel["width_launches"] = timed(
            "width partition", phase_width_partition, torch, workdir,
            main_root, ckpt, sharded, main_seconds, card)
        ccl_row["no_native_launches"] = timed(
            "no-library predict", phase_no_native_predict, torch, workdir,
            main_root, ckpt, sharded, card)
        scans = timed("preprocess", phase_preprocess, torch, args.seed,
                      workdir, card)
        timed("cli resume", phase_cli_resume, torch, scans["root"], ckpt,
              len(scans["paths"]))
        kernel["serving_launches"] = timed(
            "serving", phase_serving, torch, main_root, ckpt,
            scans["paths"][0], card)
        kernel["soak_launches"] = timed(
            "serving tools", phase_serving_tools, torch, ckpt, workdir, card)
        ccl_row["curation_launches"] = timed(
            "curation", phase_curation, torch, args.seed, workdir, card)
        zoo = timed("zoo", phase_zoo, torch, args.seed, workdir, main_root)
        kernel["zoo_launches"] = {name: zoo[name]["launches"] for name in ZOO}
        timed("zoo serving", phase_zoo_serving, torch, main_root, zoo, card)
        int8 = timed("int8", phase_int8, torch, workdir, main_root,
                     {"fcn_resnet50": ckpt,
                      "deeplabv3_resnet50": zoo["deeplabv3_resnet50"]["ckpt"]},
                     card)
        kernel["int8_launches"] = {name: int8[name]["launches"]
                                   for name in INT8_MODELS}
        kernel["width_zoo_launches"] = timed(
            "width zoo", phase_width_zoo, torch, workdir, main_root,
            {"fcn_resnet50": ckpt,
             "deeplabv3_resnet50": zoo["deeplabv3_resnet50"]["ckpt"]},
            int8, sharded["single_root"], card)
        del int8
        kernel["width_effnet_launches"] = timed(
            "width effnet", phase_width_effnet, torch, workdir, main_root,
            {name: zoo[name]["ckpt"] for name in (
                "fcn_efficientnet_b0", "deeplabv3_efficientnet_b7")},
            sharded["single_root"], card)
        kernel["mesh_launches"] = timed(
            "mesh stream and serve", phase_mesh_stream_serve, torch,
            workdir, main_root, ckpt, scans["root"], card)
        kernel["jax_checkpoint_launches"] = timed(
            "jax checkpoints", phase_jax_checkpoints, torch, workdir,
            main_root, ckpt, card)
        train = timed("train", phase_train, torch, args.seed, workdir)
        ccl_row["launches"] = train["launches"]["ccl"]
        entry = timed("entry points", phase_entry_points, torch, args.seed,
                      workdir, main_root, ckpt, os.path.join(
                          workdir, "train_root", "Images", "1024_with_jedi"),
                      card)
        kernel["entrypoint_launches"] = entry["predict"]["upsample_argmax"]
        nccl = timed("train nccl", phase_train_nccl, torch, args.seed,
                     workdir, train["step_ms"], card)
        two_ranks = timed("train two ranks", phase_train_two_ranks, torch,
                          args.seed, workdir, train["step_ms"], card)
        zoo_train_runs = timed("zoo train", phase_zoo_train, torch,
                               args.seed, workdir)
        for row in fdm:
            direction = row["name"][len("fused_dropout_matmul_"):][:3]
            counts = (train["launches"] if tuple(row["shape"]) == FDM_SHAPE
                      else zoo_train_runs[FDM_EFFNET_MODELS[
                          tuple(row["shape"])]]["launches"])
            row["launches"] = counts[f"fused_dropout_matmul_{direction}"]
            if tuple(row["shape"]) == FDM_SHAPE:
                row["nccl_launches"] = nccl["launches"][
                    f"fused_dropout_matmul_{direction}"]
                row["two_rank_launches"] = [
                    r[f"fused_dropout_matmul_{direction}"]
                    for r in two_ranks]
                row["entrypoint_launches"] = entry["train"][
                    f"fused_dropout_matmul_{direction}"]
    timed("train vs cpu", phase_train_vs_cpu, torch, args.seed)
    print(json.dumps({"kernels": [kernel, *fdm, ccl_row]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
