"""Training CLI of the PyTorch port (reference __main__.py:467-494).

Usage: ``bark-train-torch ROOT_DIR`` (or ``python -m
neuralbarkcalculator_tpu_torch.cli.train ROOT_DIR``) ``[--device
{cuda,cpu}] [--seed N] [--model NAME] [--loss NAME] [--bf16]
[--backbone_ckpt FILE] [--resume] [--tpu-native-recipe] [--mpl]``

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` runs the same path on the CPU. The reference flow
(__main__.py:199-311): dataset at ROOT_DIR/Images/1024_with_jedi,
checkpoints under ROOT_DIR/moar, fcn_resnet50(dropout=0.8) trained for 30
epochs, the test split, then the evaluation report. The sizing flags
shrink a run; their defaults are the reference recipe's. Every option of
the JAX package's CLI is here; ``--mpl`` draws the report's figures with
matplotlib Agg and raises ImportError, before training, where matplotlib
is not installed.

Several cards: one process per card, ``torchrun --nproc_per_node N -m
neuralbarkcalculator_tpu_torch.cli.train ROOT_DIR ...``. Under torchrun
(``WORLD_SIZE`` > 1), or with ``--distributed``, each process joins the
process group (parallel/distributed.py: NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``) and trains data-parallel: ``--batch_size`` is the
global batch, split evenly over the ranks, and each step equals the
single-process step on it. Rank 0 writes the checkpoints and the report.
"""
from __future__ import annotations

import argparse
import os

from ..models.segmentation import MODEL_FACTORIES
from ..train.step import LOSS_NAMES


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="bark calculator training (PyTorch / CUDA)")
    parser.add_argument("root_dir", type=str, help="root directory path.")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="train on the CUDA card (default; fails "
                             "without one) or on the CPU")
    parser.add_argument("--seed", type=int, default=42,
                        help="Which random seed to use.")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="dataset dir (default "
                             "ROOT_DIR/Images/1024_with_jedi, "
                             "__main__.py:200-202)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--crop_size", type=int, default=None)
    parser.add_argument("--pad_size", type=int, default=None,
                        help="pad_resize target (reference: 1024)")
    parser.add_argument("--samples_factor", type=int, default=None,
                        help="sampler num_samples = len(train) * factor "
                             "(reference: 12)")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="continue after the last epoch checkpoint "
                             "under ROOT_DIR/moar")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="run the forward under bf16 autocast "
                             "(parameters, optimizer state and the loss "
                             "stay float32); the reference recipe trains "
                             "in float32")
    parser.add_argument("--model", type=str, default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES),
                        help="the zoo model to train (the reference's is "
                             "fcn_resnet50); EfficientNets by their "
                             "variant-bound names, *_efficientnet_b0..b7")
    parser.add_argument("--backbone_ckpt", type=str, default=None,
                        help="start from an ImageNet backbone: a local "
                             "torchvision ResNet-50/101 or "
                             "efficientnet_pytorch state dict "
                             "(.pt/.pth/.npz), bare or in a segmentation "
                             "checkpoint; the reference's pretrained=True "
                             "(models.py:127-130)")
    parser.add_argument("--loss", type=str, default=None,
                        choices=list(LOSS_NAMES),
                        help="lovasz: exact Lovász-Softmax, the reference's "
                             "and the default; lovasz_hist: its sort-free "
                             "histogram form (1024 bins, within ~1/bins of "
                             "it); cwe: weighted cross-entropy; mixed: "
                             "cwe / 4 + Lovász; jaccard: soft Jaccard. An "
                             "explicit choice overrides "
                             "--tpu-native-recipe")
    parser.add_argument("--tpu-native-recipe", dest="tpu_native_recipe",
                        action="store_true", default=False,
                        help="the JAX package's fast recipe, kept as an "
                             "alias: lovasz_hist and the bf16 forward; "
                             "explicit --loss / --bf16 flags win")
    parser.add_argument("--monitor", type=str, default=None,
                        help="val_miou (code default, __main__.py:241) or "
                             "val_f1 (README-described selection)")
    parser.add_argument("--no_report", action="store_true", default=False,
                        help="skip the per-image evaluation report")
    parser.add_argument("--report_dpi", type=int, default=200)
    parser.add_argument("--mpl", action="store_true", default=False,
                        help="render report figures with matplotlib Agg "
                             "instead of the port's compositor; needs "
                             "matplotlib")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="join the process group from torchrun's "
                             "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                             "MASTER_ADDR, MASTER_PORT) even at WORLD_SIZE "
                             "1; implied when WORLD_SIZE > 1")
    return parser


def main(args: argparse.Namespace):
    """Train, test and report; returns the Experiment."""
    from ..config import TrainConfig
    from ..parallel.distributed import (initialize_distributed,
                                        shutdown_distributed)
    from ..pipeline.report import require_matplotlib
    from ..train.evaluate import evaluation_report
    from ..train.loop import Experiment

    if args.mpl:
        require_matplotlib()  # before training: no fallback
    config = TrainConfig(seed=args.seed)
    for flag, field in (("epochs", "epochs"), ("batch_size", "batch_size"),
                        ("crop_size", "crop_size"),
                        ("pad_size", "pad_resize_size"),
                        ("samples_factor", "samples_per_epoch_factor")):
        value = getattr(args, flag)
        if value is not None:
            setattr(config, field, value)

    if args.backbone_ckpt is not None:
        config.backbone_ckpt = args.backbone_ckpt
    config.use_bfloat16 = args.bf16 or args.tpu_native_recipe
    loss_name = args.loss or (
        "lovasz_hist" if args.tpu_native_recipe else "lovasz")

    data_dir = args.data_dir or os.path.join(args.root_dir, "Images",
                                             "1024_with_jedi")
    distributed = (args.distributed
                   or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    world = initialize_distributed(device=args.device) if distributed \
        else None
    try:
        exp = Experiment(data_dir, os.path.join(args.root_dir, "moar"),
                         config=config, model_name=args.model,
                         loss_name=loss_name, monitor=args.monitor,
                         device=args.device, world=world)
        exp.train(resume=args.resume)
        exp.test()
        if exp.ckpts.best_epoch is not None:
            exp.load_best()
        if not args.no_report:
            evaluation_report(exp, args.root_dir, dpi=args.report_dpi,
                              renderer="mpl" if args.mpl else "fast")
    finally:
        if distributed:
            shutdown_distributed()
    return exp


def entrypoint() -> None:
    """console_scripts entry (pyproject: bark-train-torch)."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    entrypoint()
