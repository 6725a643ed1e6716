"""ctypes binding to the native IO runtime (native/barkio.cc).

The library is compiled from the checkout at first use, into build/
(utils/build.py). It provides the BMP/PNG codecs, the threaded
resize+trim preprocess and the fused union-find postprocess. Formats it
does not decode (JPEG, TIFF, ...) go through PIL, imported only then.

Without the library the port still runs, as the JAX package does: when
the build fails (no g++, no zlib), ``get_lib()`` issues one RuntimeWarning
for the process, carrying the compiler's message, and returns None from
then on, without building again. Every function here then behaves as its
JAX counterpart: ``image_info``, ``preprocess_image_native``,
``remove_small_zones_batch`` and ``remove_small_zones_host2`` return None
(their callers take the scipy resize and the device CCL instead), and
``load_image_u8`` / ``save_image_u8`` go through PIL. This holds for the
host runtime only: a CUDA kernel whose build fails still raises
(ops/kernels.py).
"""
from __future__ import annotations

import ctypes
import os
import threading
import warnings

import numpy as np

from ..utils import build

_lib = None
_tried = False  # a build was attempted in this process (it may have failed)
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_PI32 = ctypes.POINTER(ctypes.c_int32)


def get_lib() -> ctypes.CDLL | None:
    """The loaded library (built on the first call), or None when it
    cannot be built."""
    global _lib, _tried
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build.build_native())
        except (RuntimeError, OSError) as e:
            warnings.warn(
                f"the native IO runtime (native/barkio.cc) could not be "
                f"built or loaded; images decode and encode through PIL, "
                f"the host preprocess runs in scipy and the predict "
                f"postprocess in ops/ccl instead:\n{e}", RuntimeWarning,
                stacklevel=3)
            return None
        sigs = {
            "bmp_info": [ctypes.c_char_p, _PI32, _PI32],
            "bmp_decode_rgb": [ctypes.c_char_p, _P, ctypes.c_int64],
            "png_info": [ctypes.c_char_p, _PI32, _PI32, _PI32],
            "png_decode": [ctypes.c_char_p, _P, ctypes.c_int64],
            "png_encode": [ctypes.c_char_p, _P, _I32, _I32, _I32, _I32],
            "remove_small_zones_batch": [
                _P, _I32, _I32, _I32, _P, _I32, _P, _I32],
            "remove_small_zones_batch2": [
                _P, _I32, _I32, _I32, _I32, _P, _I32, _I32, _P, _P,
                _I32],
            "preprocess_image_u8": [
                _P, _I32, _I32, _I32, ctypes.c_double, ctypes.c_double,
                _P, _PI32, _PI32, _I32],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def image_info(path: str) -> tuple[int, int, int] | None:
    """(height, width, channels) of a BMP/PNG from its header, or None for
    other formats, an unreadable header or no library."""
    lib = get_lib()
    if lib is None:
        return None
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    lower = path.lower()
    if lower.endswith(".bmp"):
        if lib.bmp_info(path.encode(), ctypes.byref(w), ctypes.byref(h)) == 0:
            return int(h.value), int(w.value), 3
    elif lower.endswith(".png"):
        if lib.png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c)) == 0:
            return int(h.value), int(w.value), int(c.value)
    return None


def _convert_mode(img: np.ndarray, grayscale: bool) -> np.ndarray:
    """PIL convert('RGB'/'L') semantics for the decoded channels."""
    if grayscale:
        if img.ndim == 2:
            return img
        rgb = img[..., :3].astype(np.float32)
        # ITU-R 601-2 luma, rounded as PIL rounds it
        lum = rgb[..., 0] * 299 / 1000 + rgb[..., 1] * 587 / 1000 \
            + rgb[..., 2] * 114 / 1000
        return np.floor(lum + 0.5).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_image_u8(path: str, grayscale: bool = False) -> np.ndarray:
    """Decode to uint8 ([H,W,3] RGB or [H,W] L): native BMP/PNG, PIL for
    other formats and without the library."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    info = image_info(path)
    if info is None:
        from ..data.dataset import load_image_u8_pil
        return load_image_u8_pil(path, grayscale=grayscale)
    h, w, c = info
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    lib = get_lib()
    fn = lib.bmp_decode_rgb if path.lower().endswith(".bmp") \
        else lib.png_decode
    rc = fn(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise OSError(f"native decode of {path!r} failed (barkio rc={rc})")
    return _convert_mode(out, grayscale)


def save_image_u8(path: str, img: np.ndarray, zlevel: int = 6) -> None:
    """Native PNG encode of a uint8 HW / HWC array (float [0,1] arrays are
    quantized first); PIL for other extensions and without the library."""
    if img.dtype != np.uint8:
        img = np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    lib = get_lib()
    if lib is None or not path.lower().endswith(".png"):
        from ..data.dataset import save_image_u8_pil
        save_image_u8_pil(path, img)
        return
    c = 1 if img.ndim == 2 else img.shape[2]
    img = np.ascontiguousarray(img)
    rc = lib.png_encode(path.encode(), img.ctypes.data_as(ctypes.c_void_p),
                        img.shape[1], img.shape[0], c, zlevel)
    if rc != 0:
        raise OSError(f"native PNG encode of {path!r} failed (barkio "
                      f"rc={rc})")


def preprocess_image_native(img: np.ndarray, target: int, trim_thr: float,
                            trim_frac: float, threads: int = 1
                            ) -> tuple[np.ndarray, int, int] | None:
    """Native resize+trim+quantize of one decoded uint8 [H, W, 3] image
    (reference models.py:191-203 semantics).

    Returns (out_u8, first, last): out_u8 is [target, target, 3] when the
    image was resized (max(H, W) > target) else [H, W, 3]; (first, last)
    is the kept row range when the trim applied, else (-1, -1). None
    without the library.
    """
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [h, w, 3], got {img.dtype} "
                         f"{img.shape}")
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    do_resize = max(h, w) > target
    out = np.empty((target, target, 3) if do_resize else (h, w, 3),
                   np.uint8)
    first, last = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.preprocess_image_u8(
        img.ctypes.data_as(ctypes.c_void_p), h, w, target, float(trim_thr),
        float(trim_frac), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(first), ctypes.byref(last), threads)
    if rc != 0:
        raise RuntimeError(f"native preprocess failed (barkio rc={rc})")
    return out, int(first.value), int(last.value)


def remove_small_zones_batch(class_maps: np.ndarray,
                             valid_h: np.ndarray | None = None,
                             min_size: int = 150, threads: int = 8
                             ) -> np.ndarray | None:
    """Union-find remove_small_zones (reference utils.py:135-148:
    8-connectivity, strict < threshold, islands -> bark, holes -> 0) on a
    uint8 class-map batch [B, H, W], each image on its own. ``valid_h``
    restricts each image to its first rows; padded rows come back 0. None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    class_maps = np.ascontiguousarray(class_maps, dtype=np.uint8)
    if class_maps.ndim != 3:
        raise ValueError(f"expected [B, H, W] class maps, got "
                         f"{class_maps.shape}")
    b, h, w = class_maps.shape
    out = np.empty_like(class_maps)
    vh_ptr = None
    if valid_h is not None:
        valid_h = np.ascontiguousarray(valid_h, dtype=np.int32)
        vh_ptr = valid_h.ctypes.data_as(ctypes.c_void_p)
    rc = lib.remove_small_zones_batch(
        class_maps.ctypes.data_as(ctypes.c_void_p), b, h, w, vh_ptr,
        min_size, out.ctypes.data_as(ctypes.c_void_p), threads)
    if rc != 0:
        raise RuntimeError(
            f"native remove_small_zones_batch failed (barkio rc={rc}; "
            f"out-of-memory or image beyond the int32 run-capacity guard)")
    return out


def remove_small_zones_host2(class_maps: np.ndarray, w: int,
                             valid_h: np.ndarray | None = None,
                             packed: bool = False,
                             exclude_nodes: bool = False,
                             min_size: int = 150, threads: int = 8
                             ) -> tuple[np.ndarray, np.ndarray] | None:
    """The predict engine's whole postprocess in one native pass: optional
    2-bit-packed input ([B, H, W/4], w % 4 == 0), union-find
    remove_small_zones (reference utils.py:135-148: 8-connectivity, strict
    < threshold, islands -> bark), the exclude_nodes 2->1 remap
    (models.py:273-276) and per-image class counts over the valid rows.

    Returns (cleaned [B, H, W] uint8, counts [B, 3] int64), or None
    without the library.
    """
    lib = get_lib()
    if lib is None:
        return None
    class_maps = np.ascontiguousarray(class_maps, dtype=np.uint8)
    b, h = class_maps.shape[:2]
    if class_maps.shape[2] != (w // 4 if packed else w) or \
            (packed and w % 4):
        raise ValueError(f"class maps {class_maps.shape} do not match "
                         f"width {w} (packed={packed})")
    out = np.empty((b, h, w), np.uint8)
    counts = np.zeros((b, 3), np.int64)
    vh_ptr = None
    if valid_h is not None:
        valid_h = np.ascontiguousarray(valid_h, dtype=np.int32)
        vh_ptr = valid_h.ctypes.data_as(ctypes.c_void_p)
    rc = lib.remove_small_zones_batch2(
        class_maps.ctypes.data_as(ctypes.c_void_p), int(packed), b, h, w,
        vh_ptr, min_size, int(exclude_nodes),
        out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p), threads)
    if rc != 0:
        raise RuntimeError(
            f"native remove_small_zones_batch2 failed (barkio rc={rc}; "
            f"out-of-memory or image beyond the int32 run-capacity guard)")
    return out, counts
