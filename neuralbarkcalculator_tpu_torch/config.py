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
- training recipe: __main__.py:234-269
- splits: utils.py:76-115
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
class TrainConfig:
    """Training hyperparameters, defaults pinned to __main__.py:234-269.

    By default the recipe trains in float32 (TF32 off on a card), with the
    dataset resident on the device and a randomly initialized model."""

    seed: int = 42
    lr: float = 5e-4
    weight_decay: float = 2e-3  # torch-Adam style L2 (added to grads)
    crop_size: int = 512
    batch_size: int = 5
    epochs: int = 30
    dropout: float = 0.8  # __main__.py:231
    # Sampling: WeightedRandomSampler num_samples = len(train)*12
    # (__main__.py:168-171), drop_last=True.
    samples_per_epoch_factor: int = 12
    # ReduceLROnPlateau (__main__.py:245-250)
    plateau_factor: float = 0.2
    plateau_patience: int = 3
    plateau_threshold: float = 1e-1  # absolute threshold mode
    # EarlyStopping (__main__.py:253-257)
    early_stop_min_delta: float = 1e-1
    early_stop_patience: int = 8
    monitor: str = "val_miou"  # __main__.py:241
    monitor_mode: str = "max"
    # Augmentation (__main__.py:155-166)
    jitter_saturation: float = 0.2
    jitter_brightness: float = 0.1
    pad_resize_size: int = 1024
    # Splits (utils.py:77-79)
    train_percent: float = 0.8
    valid_percent: float = 0.1
    # The per-train-batch F1 skips the metric's connected-component
    # postprocess by default (display only; validation and test F1 always
    # run it); True gives the reference's exact batch logs.
    train_f1_postprocess: bool = False
    # Run the forward under bf16 autocast; parameters, Adam state, the
    # loss and the metrics stay float32. The reference recipe trains in
    # float32.
    use_bfloat16: bool = False
    # Keep the whole uint8 dataset on the device (steps take indices);
    # False keeps it on the host and uploads each step's gathered batch,
    # for a corpus larger than the card's memory.
    device_resident_data: bool = True
    # An ImageNet backbone to start from, the reference's pretrained=True
    # (models.py:127-130 via __main__.py:231): a local torchvision
    # ResNet-50/101 or efficientnet_pytorch state dict (.pt/.pth/.npz),
    # bare or inside a segmentation checkpoint (models/convert.py).
    backbone_ckpt: str | None = None


# Inverse-frequency class weights of the weighted cross-entropy loss
# (utils.py:73).
CLASS_WEIGHTS = (0.4004, 2.0334, 93.1921)


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
    fixed_pad_height: int | None = None  # pin every launch of an image at
    # most this tall to this pad height (a multiple of 8); serving sets
    # 1024, so a content-dependent trimmed height never selects a launch
    # shape the warmup did not run. Exact: rows past each image's height
    # are masked
    figure_dpi: int = 200  # reference hardcodes 900 (models.py:346)
    use_bfloat16: bool = True  # run the conv stack in bf16, channels_last;
    # False runs it in float32 with TF32 off
    effnet_bucket_heights: bool = False  # EfficientNet backbones cannot
    # run masked ragged batches exactly (the TF-SAME stride phase,
    # models/efficientnet.py), so by default every distinct trimmed height
    # is its own launch shape. This opt-in pads their inputs up to the
    # height bucket (a multiple of the feature stride) with the last row
    # replicated instead, for at most one shape per (bucket, batch). It is
    # APPROXIMATE everywhere, not only near the trim edge: squeeze-excite
    # pools the whole feature map, so the pad rows move every pixel's SE
    # scale a little and near-tie pixels flip; exact where heights already
    # sit on the bucket. ResNet backbones ignore it (their ragged batches
    # are exact).
    quantize_int8: bool = False  # opt-in int8 inference: post-training
    # per-channel weight + static activation quantization calibrated on
    # the first chunk (models/quantize.py), the convs as cuBLAS int8
    # GEMMs. APPROXIMATE: class maps can differ from float on pixels near
    # a class boundary; ResNet backbones only (EfficientNet raises)
