"""Folder manifest scan, the training dataset, and the PIL image helpers.

``make_dataset`` walks ``root/samples/<wood_type>/`` and pairs each sample
with ``root/duals/<wood_type>/<name .bmp->.png>`` when present, as the
reference ``make_dataset`` (dataset.py:41-74) does. ``BarkDataset`` loads
(sample, label) pairs for training (reference RegressionDatasetFolder,
dataset.py:93-212). BMP and PNG go through the native codecs
(io/native.py); the PIL helpers below serve the other formats, and import
PIL only when called.

Label decoding (dataset.py:188-198): dual PNGs store {0, 127, 255}; after
/255 scaling, ``round(target * 2)`` gives the classes {0, 1, 2}. A missing
target is an all-zero map (dataset.py:199-200).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from ..config import IMG_EXTENSIONS, WOOD_TYPES


def has_file_allowed_extension(filename: str,
                               extensions: Sequence[str]) -> bool:
    """Reference dataset.py:19-28 parity (note: 'webp' has no dot there)."""
    filename_lower = filename.lower()
    return any(filename_lower.endswith(ext) for ext in extensions)


@dataclasses.dataclass(frozen=True)
class Record:
    sample_path: str
    target_path: str  # "" when absent
    fname: str  # sample name with bmp -> png
    wood_type: str


def make_dataset(root: str,
                 extensions: Sequence[str] = IMG_EXTENSIONS) -> list[Record]:
    """Scan root/samples/<wood_type> (+ optional root/duals), sorted.

    Parity with reference make_dataset_for_dir (dataset.py:41-68), including
    the IOError when 'samples' is missing and the bmp->png target rename.
    """
    root = os.path.expanduser(root)
    samples_dir = os.path.join(root, "samples")
    targets_dir = os.path.join(root, "duals")
    if not os.path.isdir(samples_dir):
        raise IOError("Root folder should have a 'samples' subfolder !")

    records = []
    for wood_type in WOOD_TYPES:
        samples_type_dir = os.path.join(samples_dir, wood_type)
        targets_type_dir = os.path.join(targets_dir, wood_type)
        for _, _, fnames in sorted(os.walk(samples_type_dir)):
            for fname in sorted(fnames):
                if not has_file_allowed_extension(fname, extensions):
                    continue
                sample_path = os.path.join(samples_type_dir, fname)
                out_name = fname.replace("bmp", "png")
                target_path = os.path.join(targets_type_dir, out_name)
                if not os.path.isfile(target_path):
                    target_path = ""
                records.append(Record(sample_path, target_path, out_name,
                                      wood_type))
    return records


def load_image(path: str, grayscale: bool = False) -> np.ndarray | None:
    """Decode to float32 [0, 1]: RGB -> [H, W, 3], L -> [H, W]; None for an
    empty or missing path (reference pil_loader + ToTensor scaling)."""
    from ..io.native import load_image_u8

    if not path or not os.path.isfile(path):
        return None
    return load_image_u8(path, grayscale=grayscale).astype(np.float32) / 255.0


def decode_label(target: np.ndarray | None,
                 shape: tuple[int, int]) -> np.ndarray:
    """Float [0, 1] dual image -> int32 class map {0, 1, 2}
    (dataset.py:188-200)."""
    if target is None:
        return np.zeros(shape, dtype=np.int32)
    t = target
    if t.max() > 200:  # raw 0..255 input (never for /255-scaled floats)
        t = t / 255.0
    return np.rint(t * 2.0).astype(np.int32)


class BarkDataset:
    """Indexed dataset over a manifest: item i is (float32 sample
    [H, W, 3], int32 labels [H, W], fname, wood_type)."""

    def __init__(self, root: str):
        self.records = make_dataset(root)
        if not self.records:
            raise RuntimeError(
                "Found 0 files in subfolders of: " + root + "\n"
                "Supported extensions are: " + ",".join(IMG_EXTENSIONS))

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        rec = self.records[index]
        sample = load_image(rec.sample_path)
        target = decode_label(load_image(rec.target_path, grayscale=True),
                              sample.shape[:2])
        return sample, target, rec.fname, rec.wood_type


def load_image_u8_pil(path: str, grayscale: bool = False) -> np.ndarray:
    """PIL decode to uint8; RGB -> [H,W,3], L -> [H,W] (reference
    pil_loader, dataset.py:82-90)."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        img = img.convert("L" if grayscale else "RGB")
        return np.asarray(img, dtype=np.uint8)


def save_image_u8_pil(path: str, img: np.ndarray) -> None:
    """Save a uint8 HWC or HW array with PIL (format from the extension)."""
    from PIL import Image

    Image.fromarray(img, mode="L" if img.ndim == 2 else "RGB").save(path)
