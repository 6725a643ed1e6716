"""Training CLI of the PyTorch port (reference __main__.py:467-494).

Usage: ``python -m neuralbarkcalculator_tpu_torch.cli.train ROOT_DIR
[--device {cuda,cpu}] [--seed N]``

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` runs the same path on the CPU. The reference flow
(__main__.py:199-311): dataset at ROOT_DIR/Images/1024_with_jedi,
checkpoints under ROOT_DIR/moar, fcn_resnet50(dropout=0.8) trained for 30
epochs, the test split, then the evaluation report. The sizing flags
shrink a run; their defaults are the reference recipe's.
"""
from __future__ import annotations

import argparse
import os

from ..models.segmentation import MODEL_FACTORIES


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
    parser.add_argument("--model", type=str, default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES),
                        help="only fcn_resnet50 trains in the port yet; the "
                             "other names raise NotImplementedError")
    parser.add_argument("--loss", type=str, default="lovasz",
                        choices=["lovasz"],
                        help="exact Lovász-Softmax, the reference's loss")
    parser.add_argument("--monitor", type=str, default=None,
                        help="val_miou (code default, __main__.py:241) or "
                             "val_f1 (README-described selection)")
    parser.add_argument("--no_report", action="store_true", default=False,
                        help="skip the per-image evaluation report")
    parser.add_argument("--report_dpi", type=int, default=200)
    return parser


def main(args: argparse.Namespace):
    """Train, test and report; returns the Experiment."""
    from ..config import TrainConfig
    from ..train.evaluate import evaluation_report
    from ..train.loop import Experiment

    config = TrainConfig(seed=args.seed)
    for flag, field in (("epochs", "epochs"), ("batch_size", "batch_size"),
                        ("crop_size", "crop_size"),
                        ("pad_size", "pad_resize_size"),
                        ("samples_factor", "samples_per_epoch_factor")):
        value = getattr(args, flag)
        if value is not None:
            setattr(config, field, value)

    data_dir = args.data_dir or os.path.join(args.root_dir, "Images",
                                             "1024_with_jedi")
    exp = Experiment(data_dir, os.path.join(args.root_dir, "moar"),
                     config=config, model_name=args.model,
                     loss_name=args.loss, monitor=args.monitor,
                     device=args.device)
    exp.train()
    exp.test()
    if exp.ckpts.best_epoch is not None:
        exp.load_best()
    if not args.no_report:
        evaluation_report(exp, args.root_dir, dpi=args.report_dpi)
    return exp


if __name__ == "__main__":
    main(build_parser().parse_args())
