"""Output directory scaffolding (reference predict.py:10-48 parity)."""
from __future__ import annotations

import os

from ..config import WOOD_TYPES


def generate_folders(root_path: str, only_preprocess: bool) -> list[str]:
    """Create processed/ and results/ trees for the wood types present.

    Parity with reference generate_folders (predict.py:10-48): only the
    intersection of ``samples/`` subdirectories with the three known wood
    types gets folders. Returns the wood types found.
    """
    present = os.listdir(os.path.join(root_path, "samples"))
    wood_types = [t for t in WOOD_TYPES if t in set(present)]

    processed_dir = os.path.join(root_path, "processed")
    for folder in ["samples"]:
        for wood_type in wood_types:
            os.makedirs(os.path.join(processed_dir, folder, wood_type),
                        exist_ok=True)

    if not only_preprocess:
        results_dir = os.path.join(root_path, "results")
        for folder in ["combined_images", "outputs"]:
            for wood_type in wood_types:
                os.makedirs(os.path.join(results_dir, folder, wood_type),
                            exist_ok=True)
    return wood_types
