"""Post-training per-image evaluation report (reference __main__.py:
294-437; neuralbarkcalculator_tpu/train/evaluate.py), in PyTorch.

Renders, for every image across the train/valid/test splits, a 3-panel
Input/Target/Generated figure with per-class IoU/F1 in its suptitle, the
dual mask PNG, and a 15-column tab-delimited final_stats.csv, under
``root_dir/Images/results/moar/...`` as the reference does
(generate_output_folders, __main__.py:30-54). Figures go through the
port's compositor, or with ``renderer="mpl"`` through matplotlib Agg (the
train CLI's ``--mpl``; ImportError where matplotlib is missing).

Reference quirk kept: the eval loop calls remove_small_zones on the
*logits* (__main__.py:324), which is a no-op on float logits, so metrics
and figures use the raw argmax; PixelWiseF1 still postprocesses inside.

In a data-parallel run each batch of 8 is padded to a multiple of the
world size with repeats of its last image, every rank runs the forward of
its rows, and rank 0 gathers the logits and writes the report, once; the
other ranks wait for it.
"""
from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import CLASS_NAMES, NUM_CLASSES, WOOD_TYPES
from ..io.native import save_image_u8
from ..ops.metrics import confusion_matrix, iou_from_confusion, pixelwise_f1
from ..pipeline.compositor import render_figure_fast
from ..pipeline.report import (display_subsample, render_figure_mpl,
                               require_matplotlib)

EVAL_CSV_HEADER = [
    "Name", "Type", "Split", "iou_nothing", "iou_bark", "iou_node",
    "iou_mean", "f1_nothing", "f1_bark", "f1_node", "f1_mean",
    "Output Bark %", "Output Node %", "Target Bark %", "Target Node %",
]


def generate_output_folders(root_dir: str) -> str:
    """Reference generate_output_folders parity (__main__.py:30-54)."""
    results_dir = os.path.join(root_dir, "Images", "results", "moar")
    for folder in ("combined_images", "outputs"):
        for wood_type in WOOD_TYPES:
            for child in ("train", "valid", "test"):
                os.makedirs(os.path.join(results_dir, folder, wood_type,
                                         child), exist_ok=True)
    return results_dir


def eval_image_metrics(logits: torch.Tensor, target: torch.Tensor
                       ) -> dict[str, np.ndarray]:
    """One image's metrics: per-class IoU x100 of the raw argmax and
    PixelWiseF1 x100 (postprocessed inside), plus the uint8 argmax."""
    preds = logits.argmax(dim=-1)
    cm = confusion_matrix(preds, target, NUM_CLASSES)
    return {"iou": iou_from_confusion(cm).cpu().numpy(),
            "f1": (pixelwise_f1(logits, target) * 100.0).cpu().numpy(),
            "preds": preds.to(torch.uint8).cpu().numpy()}


def render_eval_image(input_img, target, preds, fname, wood_type, split,
                      ious, f1s, results_dir, dpi: int = 200,
                      renderer: str = "fast") -> list[str]:
    """One image's figure and dual PNG; returns its CSV row. ``renderer``
    as in pipeline/report.py: ``"fast"`` (the compositor) or ``"mpl"``
    (matplotlib Agg)."""
    names = ["Input", "Target", "Generated image"]
    values = np.unique(preds.ravel())

    row = [fname, wood_type, split]
    suptitle = "Mean iou : {:.3f}\n".format(float(np.mean(ious)))
    for c, c_acc in zip(CLASS_NAMES, ious):
        suptitle += "{} : {:.3f};  ".format("iou_" + c, c_acc)
        row.append("{:.3f}".format(c_acc))
    row.append("{:.3f}".format(float(np.mean(ious))))
    suptitle += "\nMean f1 : {:.3f}\n".format(float(np.mean(f1s)))
    for c, c_f1 in zip(CLASS_NAMES, f1s):
        suptitle += "{} : {:.3f};  ".format("f1_" + c, c_f1)
        row.append("{:.3f}".format(c_f1))
    row.append("{:.3f}".format(float(np.mean(f1s))))
    for class_idx in (1, 2):
        row.append("{:.5f}".format(100.0 * float(np.mean(
            preds == class_idx))))
    for class_idx in (1, 2):
        row.append("{:.5f}".format(100.0 * float(np.mean(
            target == class_idx))))

    fig_path = os.path.join(results_dir, "combined_images", wood_type,
                            split, fname)
    if renderer == "fast":
        render_figure_fast((input_img, target, preds), names,
                           suptitle.rstrip("\n"), [int(v) for v in values],
                           fig_path, dpi)
    else:
        render_figure_mpl([display_subsample(x, dpi)
                           for x in (input_img, target, preds)],
                          names, values, suptitle, fig_path, dpi)
    dual = np.zeros(preds.shape, np.uint8)
    dual[preds == 1] = 127
    dual[preds == 2] = 255
    save_image_u8(os.path.join(results_dir, "outputs", wood_type, split,
                               fname), dual)
    return row


def evaluation_report(experiment, root_dir: str, dpi: int = 200,
                      workers: int = 8, renderer: str = "fast") -> str:
    """Render the report over all splits with the experiment's current
    weights, from its (pad_resized) dataset: forwards of 8 images in eval
    mode (under bf16 autocast when the experiment trains so; split across
    the ranks of a data-parallel run), metrics per image, figures on a
    thread pool, by ``renderer`` (``"fast"`` or ``"mpl"``). Returns the
    CSV's path."""
    if renderer not in ("fast", "mpl"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if renderer == "mpl":
        require_matplotlib()
    batch = 8
    world = experiment.world
    results_dir = generate_output_folders(root_dir)
    csv_file = os.path.join(results_dir, "final_stats.csv")
    split_of = {}
    for idxs, name in [(experiment.train_split, "train"),
                       (experiment.valid_split, "valid"),
                       (experiment.test_split, "test")]:
        for i in idxs:
            split_of[int(i)] = name

    model = experiment.model.eval()
    n = len(experiment.fnames)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        for start in range(0, n, batch):
            rows = np.arange(start, min(n, start + batch))
            padded = world.pad_rows(rows)
            images, labels, idx = experiment.batch_inputs(
                padded[world.rank_slice(len(padded))])
            with torch.no_grad(), torch.autocast(
                    experiment.device.type, dtype=torch.bfloat16,
                    enabled=experiment.config.use_bfloat16):
                x = ((images[idx].float() / 255.0
                      - experiment._mean) / experiment._std)
                logits = world.gather_rows(model(x))
            if not world.is_main:
                continue
            if world.size > 1:  # the images of every rank's rows
                images, labels, idx = experiment.batch_inputs(rows)
            for k, i in enumerate(rows.tolist()):
                target = labels[idx[k]].long()
                m = eval_image_metrics(logits[k], target)
                futures.append(pool.submit(
                    render_eval_image,
                    images[idx[k]].cpu().numpy(),
                    target.to(torch.int32).cpu().numpy(), m["preds"],
                    experiment.fnames[i], experiment.wood_types[i],
                    split_of[i], m["iou"], m["f1"], results_dir, dpi,
                    renderer))
        rows = [f.result() for f in futures]

    if world.is_main:
        with open(csv_file, "w") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(EVAL_CSV_HEADER)
            writer.writerows(rows)
    world.barrier()
    return csv_file
