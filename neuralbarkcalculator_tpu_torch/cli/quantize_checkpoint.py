"""Offline int8 checkpoint export of the PyTorch port (the JAX package's
``tools/quantize_checkpoint.py``).

Calibrates post-training int8 quantization (models/quantize.py) on a few
representative processed images and writes the port's offline int8
checkpoint, which ``cli/predict`` and ``cli/serve`` load directly: no
BatchNorm folding and no first-chunk calibration at start-up::

    python -m neuralbarkcalculator_tpu_torch.cli.quantize_checkpoint \\
        IMAGES_DIR --model_path best_model.pt [--model fcn_resnet50] \\
        [--out best_model.int8.pt] [--n 4] [--device cuda|cpu] [--float32]
    python -m neuralbarkcalculator_tpu_torch.cli.predict ROOT \\
        --model_path best_model.int8.pt

IMAGES_DIR is searched recursively for images (a ROOT/processed/samples
tree, or any folder of representative inputs); up to ``--n`` of them,
spread across the folder, calibrate one image per batch, through the
predict engine on ``--device`` at the engine's dtype (bf16, or float32
with ``--float32``), which should be the dtype the checkpoint will serve
at: the stem runs at it and the scales follow it. ``--model_path`` takes
any float checkpoint the engine loads: a reference ``.pt``, or the JAX
package's flax ``.msgpack`` or orbax directory.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..models.segmentation import MODEL_FACTORIES

IMAGE_EXTS = (".png", ".bmp", ".jpg", ".jpeg")


def find_images(root: str, limit: int) -> list[str]:
    """Up to ``limit`` image paths under ``root``, spread across the sorted
    listing rather than its head."""
    paths = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for fname in sorted(fnames):
            if fname.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(dirpath, fname))
    if not paths:
        raise SystemExit(f"no images under {root!r} (looked for "
                         f"{'/'.join(IMAGE_EXTS)})")
    step = max(1, len(paths) // limit)
    return paths[::step][:limit]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="offline int8 checkpoint export (PyTorch / CUDA)")
    parser.add_argument("images", help="directory of representative "
                                       "processed images (searched "
                                       "recursively)")
    parser.add_argument("--model_path", required=True,
                        help=".pt / .msgpack / orbax checkpoint to "
                             "quantize")
    parser.add_argument("--model", default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES),
                        help="model zoo entry (must match the checkpoint; "
                             "ResNet models only)")
    parser.add_argument("--out", default=None,
                        help="output path (default: <model_path without "
                             "extension>.int8.pt)")
    parser.add_argument("--n", type=int, default=4,
                        help="calibration images (max|x| settles fast; 4 "
                             "is plenty)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="calibrate on the CUDA card (default; fails "
                             "without one) or on the CPU")
    parser.add_argument("--float32", action="store_true", default=False,
                        help="calibrate in float32 (TF32 off) instead of "
                             "bfloat16")
    return parser


def main(args: argparse.Namespace) -> str:
    from ..config import PredictConfig
    from ..io.native import load_image_u8
    from ..models.quantize import save_quantized
    from ..pipeline.predict import NeuralBarkCalculator
    from ..pipeline.preprocess import ProcessedImage

    config = PredictConfig(model_path=args.model_path, quantize_int8=True,
                           use_bfloat16=not args.float32)
    engine = NeuralBarkCalculator(args.model_path, config=config,
                                  model_name=args.model, device=args.device)
    items = []
    for path in find_images(args.images, args.n):
        items.append(ProcessedImage(load_image_u8(path),
                                    os.path.basename(path), "calibration"))
        print(f"calibrating on {path} {items[-1].image.shape}",
              file=sys.stderr)
    engine.quantize([[it] for it in items])
    out = args.out or os.path.splitext(args.model_path)[0] + ".int8.pt"
    save_quantized(out, engine.model, args.model)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"{type(engine.model.classifier).__name__})", file=sys.stderr)
    return out


def entrypoint() -> None:
    """console_scripts entry (pyproject: bark-quantize-torch)."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    entrypoint()
