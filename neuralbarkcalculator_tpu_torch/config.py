"""Configuration of the PyTorch port.

The constants are pinned to the reference implementation (citations are
file:line into the reference NeuralBarkCalculator) and are the same values
the JAX package carries in neuralbarkcalculator_tpu/config.py; the port
keeps its own copy so it imports nothing of that package.

- normalization (inference): models.py:208-209
- mm^2 per pixel calibration: models.py:210
- small-zone removal threshold + connectivity: utils.py:140-143
- preprocess target size: models.py:170
- trim_black thresholds: models.py:157-166
- wood types: dataset.py:50, predict.py:15
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

WOOD_TYPES = ("epinette_gelee", "epinette_non_gelee", "sapin")
CLASS_NAMES = ("Nothing", "Bark", "Node")
NUM_CLASSES = 3

# Inference-time normalization constants (reference models.py:208-209).
DEFAULT_MEAN = (0.7399, 0.6139, 0.4401)
DEFAULT_STD = (0.1068, 0.1272, 0.1271)

# Area of one pixel in mm^2 at the calibrated capture scale (models.py:210).
DEFAULT_MM_PER_PIXEL = 3.6 * 3.6

# Connected-component postprocess (utils.py:140-143). NB: README says 100 but
# the code uses 150; the code wins.
SMALL_ZONE_THRESHOLD = 150
SMALL_ZONE_CONNECTIVITY = 2  # 8-connectivity

# Preprocessing (models.py:157-201).
PREPROCESS_TARGET_SIZE = 1024
TRIM_PIXEL_THRESHOLD = 1e-3  # channel-sum > this counts as non-black
TRIM_ROW_FRACTION = 0.85  # row kept if > this fraction of pixels non-black

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", "webp",
)


@dataclasses.dataclass
class PredictConfig:
    """Inference configuration, defaults pinned to models.py:206-228."""

    model_path: str = "./best_model.pt"
    mean: Sequence[float] = DEFAULT_MEAN
    std: Sequence[float] = DEFAULT_STD
    mm_per_pix: float = DEFAULT_MM_PER_PIXEL
    # Additions that do not change reference-visible semantics:
    batch_size: int = 8  # images per device step (reference is 1)
    height_bucket: int = 128  # pad trimmed heights up to a multiple of this
    figure_dpi: int = 200  # reference hardcodes 900 (models.py:346)
    use_bfloat16: bool = True  # run the conv stack in bf16, channels_last;
    # False runs it in float32 with TF32 off
