"""Label-preparation and data-curation utilities (reference C13), on the
port.

    python -m neuralbarkcalculator_tpu_torch.tools.curation <subcommand> \
        --help

Reusable forms of the reference's one-off scripts (which hardcode the
author's paths; __main__.py:57-150, 440-464), over directories the
caller names:

- ``make-duals``: merge binary bark and node masks into 0/127/255 dual
  PNGs (__main__.py:57-78; bark 127, node 255, node wins on overlap);
- ``fine-tune``: apply remove_small_zones to dual label masks
  (__main__.py:81-107), with ops/ccl's union-find kernels on the card
  (``--device cuda``, the default; it fails without one) or the plain
  version on the CPU (``--device cpu``);
- ``adjust``: nearest-resize duals to their sample's size
  (__main__.py:110-123);
- ``fix-image``: shave 1 (bottom) or 2 (top and bottom) rows off an image
  (__main__.py:440-464);
- ``preview-augment``: a PNG grid of augmented sample / label crops
  (__main__.py:126-150 shows them in a window), drawn with the training
  augmentation (data/augment.gather_augment_batch, one torch.Generator
  seeded by ``--seed``) on ``--device``; it needs matplotlib.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import WOOD_TYPES


def _load_gray(path: str) -> np.ndarray:
    from PIL import Image

    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("L"))


def _save_gray(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img, mode="L").save(path)


def make_duals(barks_dir: str, nodes_dir: str, duals_dir: str) -> None:
    os.makedirs(duals_dir, exist_ok=True)
    for _, _, fnames in sorted(os.walk(barks_dir)):
        for fname in sorted(fnames):
            bark = _load_gray(os.path.join(barks_dir, fname)) / 255.0
            node = _load_gray(os.path.join(nodes_dir, fname)) / 255.0
            dual = np.zeros(bark.shape, np.uint8)
            dual[bark == 1.0] = 127
            dual[node == 1.0] = 255  # node overrides bark (reference order)
            _save_gray(os.path.join(duals_dir, fname.replace("bmp", "png")),
                       dual)


def fine_tune(duals_dir: str, output_dir: str,
              device: str = "cuda") -> None:
    """remove_small_zones over every dual of duals_dir/<wood type>/, one
    image at a time on `device`, written to output_dir/<wood type>/."""
    import torch

    from ..ops.ccl import remove_small_zones
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    for wood_type in WOOD_TYPES:
        src = os.path.join(duals_dir, wood_type)
        dst = os.path.join(output_dir, wood_type)
        if not os.path.isdir(src):
            continue
        os.makedirs(dst, exist_ok=True)
        for _, _, fnames in sorted(os.walk(src)):
            for fname in sorted(fnames):
                print(fname)
                # /127 integer classes {0,1,2} (255//127 == 2), as the
                # reference's numpy divide + .long() does
                classes = (_load_gray(os.path.join(src, fname))
                           // 127).astype(np.int32)
                cleaned = remove_small_zones(
                    torch.from_numpy(classes).to(dev)).cpu().numpy()
                cleaned = cleaned.astype(np.uint8)
                cleaned[cleaned == 1] = 127
                cleaned[cleaned == 2] = 255
                _save_gray(os.path.join(dst, fname), cleaned)


def adjust(duals_folder: str, samples_folder: str, out_folder: str) -> None:
    from PIL import Image

    os.makedirs(out_folder, exist_ok=True)
    for _, _, fnames in sorted(os.walk(duals_folder)):
        for fname in sorted(fnames):
            sample_path = os.path.join(samples_folder,
                                       fname.replace(".png", ".bmp"))
            with open(sample_path, "rb") as f:
                sample_size = Image.open(f).size  # (W, H)
            dual = Image.open(os.path.join(duals_folder, fname))
            # order=0 (nearest) resize to the sample's H, W
            dual = dual.resize(sample_size, resample=Image.NEAREST)
            try:
                dual.convert("L").save(os.path.join(out_folder, fname))
            except ValueError:
                print(fname)


def fix_image(path: str, n_pixels_to_fix: int) -> None:
    from PIL import Image

    with open(path, "rb") as f:
        img = np.asarray(Image.open(f))
    if n_pixels_to_fix == 1:
        img = img[:-1]
    elif n_pixels_to_fix == 2:
        img = img[1:-1]
    else:
        raise ValueError(f"n_pixels_to_fix must be 1 or 2, got "
                         f"{n_pixels_to_fix}")
    Image.fromarray(img).save(path)


def preview_augment(root_dir: str, out_path: str, n: int = 6,
                    crop: int = 256, seed: int = 0,
                    device: str = "cuda") -> None:
    """A 2 x n grid (augmented crops over their labels), 3 x 6 inches a
    column at 120 dpi, of the first n samples of root_dir padded and
    resized to max(crop, 512), augmented as training does without the
    normalization."""
    import torch

    from ..data.augment import gather_augment_batch, pad_resize_pair
    from ..data.dataset import BarkDataset
    from ..pipeline.report import require_matplotlib
    from ..utils.device import resolve_device

    require_matplotlib()
    import matplotlib
    matplotlib.use("Agg", force=False)
    from matplotlib.figure import Figure

    dev = resolve_device(device)
    size = max(crop, 512)
    dataset = BarkDataset(root_dir)
    n = min(n, len(dataset))
    images = np.zeros((n, size, size, 3), np.uint8)
    labels = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        sample, target = pad_resize_pair(*dataset[i][:2], size)
        images[i] = np.rint(np.clip(sample, 0.0, 1.0) * 255.0)
        labels[i] = target
    generator = torch.Generator(dev).manual_seed(seed)
    out_imgs, out_labs = gather_augment_batch(
        torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev),
        torch.arange(n, device=dev), crop,
        torch.zeros(3, device=dev), torch.ones(3, device=dev),  # identity
        generator)
    out_imgs, out_labs = out_imgs.cpu().numpy(), out_labs.cpu().numpy()
    fig = Figure(figsize=(3 * n, 6))
    axs = fig.subplots(2, n, squeeze=False)
    for i in range(n):
        axs[0][i].imshow(np.clip(out_imgs[i], 0, 1))
        axs[0][i].axis("off")
        axs[1][i].imshow(out_labs[i], vmax=2)
        axs[1][i].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print("wrote", out_path)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("make-duals")
    p.add_argument("--barks_dir", required=True)
    p.add_argument("--nodes_dir", required=True)
    p.add_argument("--duals_dir", required=True)

    p = sub.add_parser("fine-tune")
    p.add_argument("--duals_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run remove_small_zones on the CUDA card (default; "
                        "fails without one) or on the CPU")

    p = sub.add_parser("adjust")
    p.add_argument("--duals_folder", required=True)
    p.add_argument("--samples_folder", required=True)
    p.add_argument("--out_folder", required=True)

    p = sub.add_parser("fix-image")
    p.add_argument("path")
    p.add_argument("--n_pixels", type=int, choices=(1, 2), required=True)

    p = sub.add_parser("preview-augment")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=6)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="augment on the CUDA card (default; fails without "
                        "one) or on the CPU")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.cmd == "make-duals":
        make_duals(args.barks_dir, args.nodes_dir, args.duals_dir)
    elif args.cmd == "fine-tune":
        fine_tune(args.duals_dir, args.output_dir, args.device)
    elif args.cmd == "adjust":
        adjust(args.duals_folder, args.samples_folder, args.out_folder)
    elif args.cmd == "fix-image":
        fix_image(args.path, args.n_pixels)
    else:
        preview_augment(args.root_dir, args.out, args.n, args.crop,
                        args.seed, args.device)


if __name__ == "__main__":
    main()
