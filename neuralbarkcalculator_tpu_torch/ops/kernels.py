"""The CUDA kernel libraries (one shared object per ``csrc/<name>.cu``)
and the launch counters of the kernels' wrappers.

A library is built at first use (utils/build.build_kernel) and loaded
once per process through ctypes, with the argument types of every entry
point declared here. Pointers and the stream travel as ``c_void_p``; a
kernel's C entry returns ``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import threading

from ..utils.build import build_kernel


class LaunchCounter:
    """A thread-safe count of kernel launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "upsample_argmax": {
        "upsample_argmax_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P], _I),
        "upsample_argmax_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    },
    "fused_dropout_matmul": {
        "fdm_forward_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _U64, _U64, _U64, ctypes.c_float, _P], _I),
        "fdm_backward_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _U64, _U64, _U64,
                                 ctypes.c_float, _P], _I),
        "fdm_partial_rows": ([_I, _I], _I),
        "fdm_max_classes": ([], _I),
    },
    "ccl": {
        "ccl_scratch_ints": ([_I, _I, _I], ctypes.c_int64),
        "ccl_label_launch": ([_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P], _I),
        "ccl_label_filled_launch": ([_P, _P, _P, _I, _P, _P, _P, _I, _I,
                                     _I, _P], _I),
        "ccl_area_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
        "ccl_keep_launch": ([_P, _P, _I, _I, _P, _I, _I, _I, _P], _I),
        "ccl_writeback_launch": ([_P, _I, _P, _P, _P, _I, _P, _I, _I, _I,
                                  _P], _I),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on the first
    call)."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_kernel(name))
            for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return _libs[name]


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
