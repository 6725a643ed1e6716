"""Production inference CLI of the PyTorch port (reference predict.py:61-81
parity).

Usage: ``python -m neuralbarkcalculator_tpu_torch.cli.predict ROOT_DIR
[--device {cuda,cpu}] [--exclude_nodes] [--only_preprocess] [--resume]
[--preprocess_backend {auto,device,host}] [--watch SECS] [--int8]``

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` runs the same path on the CPU. It creates the
output folders, preprocesses ROOT/samples (on the device or the host) and
predicts, streaming (preprocess overlapped with prediction) or
sequentially. ``--resume`` skips images already processed and predicted;
``--watch SECS`` rescans ROOT every SECS seconds and handles only new
images, until interrupted. ``--int8`` quantizes the model on the first
batch (models/quantize.py); an offline int8 checkpoint as
``--model_path`` runs int8 without it.
"""
from __future__ import annotations

import argparse

from ..models.segmentation import MODEL_FACTORIES


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="bark calculator inference (PyTorch / CUDA)")
    parser.add_argument("root_path", type=str, help="root directory path.")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="run on the CUDA card (default; fails without "
                             "one) or on the CPU")
    parser.add_argument("--exclude_nodes", action="store_true",
                        default=False)
    parser.add_argument("--only_preprocess", action="store_true",
                        default=False)
    parser.add_argument("--model_path", type=str, default="./best_model.pt",
                        help="reference best_model.pt (torchvision-named "
                             "state dict; reference predict.py:57), or an "
                             "offline int8 checkpoint (*.int8.pt, "
                             "cli/quantize_checkpoint)")
    parser.add_argument("--model", type=str, default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES),
                        help="model zoo entry (fcn_resnet50 is the "
                             "reference production model, models.py:221)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="images per device step (default from "
                             "PredictConfig)")
    parser.add_argument("--dpi", type=int, default=None,
                        help="combined-figure dpi (reference hardcodes "
                             "900, models.py:346)")
    parser.add_argument("--float32", action="store_true", default=False,
                        help="run the conv stack in float32 (TF32 off) "
                             "instead of bfloat16")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 inference: post-training quantization "
                             "calibrated on the first batch "
                             "(models/quantize.py); approximate, ResNet "
                             "models only")
    parser.add_argument("--profile", action="store_true", default=False,
                        help="print per-stage wall-time report at the end")
    parser.add_argument("--pipeline", type=str, default="streaming",
                        choices=("streaming", "sequential"),
                        help="'streaming' (the default) feeds preprocessed "
                             "images to the predict pump as they finish; "
                             "'sequential' runs the two stages back to back")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="skip images whose processed PNG and results/ "
                             "artifacts already exist (resumable folder "
                             "runs)")
    parser.add_argument("--preprocess_backend", type=str, default="auto",
                        choices=["auto", "device", "host"],
                        help="resize and trim on the device (matrix "
                             "products) or on the host (native pass, same "
                             "math); auto measures the upload rate once "
                             "and picks")
    parser.add_argument("--watch", type=float, default=None, metavar="SECS",
                        help="rescan ROOT every SECS seconds, preprocessing "
                             "and predicting only new images (incremental "
                             "resume); Ctrl-C to stop")
    return parser


def main(args: argparse.Namespace) -> None:
    import time

    from ..config import PredictConfig
    from ..data.dataset import make_dataset
    from ..pipeline.folders import generate_folders
    from ..pipeline.predict import NeuralBarkCalculator
    from ..pipeline.preprocess import Preprocessor

    config = PredictConfig(model_path=args.model_path)
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    if args.dpi is not None:
        config.figure_dpi = args.dpi
    if args.float32:
        config.use_bfloat16 = False
    if args.int8:
        config.quantize_int8 = True

    model = None

    def engine() -> NeuralBarkCalculator:
        nonlocal model  # built once, reused by every watch scan
        if model is None:
            model = NeuralBarkCalculator(args.model_path, config=config,
                                         model_name=args.model,
                                         device=args.device)
        return model

    def run_once(resume: bool) -> None:
        generate_folders(args.root_path, args.only_preprocess)
        pre = Preprocessor(backend=args.preprocess_backend,
                           device=args.device)
        if args.only_preprocess:
            pre.preprocess_images(args.root_path, resume=resume)
        elif resume:
            # the incremental preprocess writes only new images; predict
            # then reads processed/ from disk and skips the done ones
            pre.preprocess_images(args.root_path, resume=True)
            engine().predict(args.root_path, args.exclude_nodes,
                             resume=True)
        elif args.pipeline == "streaming":
            engine().predict_streaming(
                args.root_path, pre.preprocess_stream(args.root_path),
                exclude_nodes=args.exclude_nodes,
                total=len(make_dataset(args.root_path)))
        else:
            images = pre.preprocess_images(args.root_path)
            engine().predict(args.root_path, args.exclude_nodes,
                             images=images)

    if args.watch is None:
        run_once(args.resume)
    else:
        print(f"watching {args.root_path} every {args.watch:g}s "
              f"(Ctrl-C to stop)", flush=True)
        while True:
            try:
                run_once(resume=True)
                time.sleep(args.watch)
            except KeyboardInterrupt:
                break
    if args.profile:
        from ..utils.profiling import print_report
        print_report()


if __name__ == "__main__":
    main(build_parser().parse_args())
