"""Build the port's native pieces at first use, into ``<repo>/build/``.

Shared libraries with plain C interfaces, loaded through ctypes:

- one per CUDA kernel source ``neuralbarkcalculator_tpu_torch/csrc/*.cu``
  (nvcc, ``sm_90a``), built only where a caller hands that kernel a CUDA
  tensor;
- the host IO runtime ``native/barkio.cc`` (g++, zlib, pthreads).

Each library is named by a digest of its sources and flags, so an edited
source never loads a stale build. A build writes a private temporary file
and renames it into place, so concurrent processes and threads never load
a half-written library. A failed build raises with the compiler's own
message.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build")
CSRC_DIR = os.path.join(REPO_ROOT, "neuralbarkcalculator_tpu_torch", "csrc")
NATIVE_SRC = os.path.join(REPO_ROOT, "native", "barkio.cc")

# native/Makefile's flags without -march=native (the library must run on
# whatever host builds it); -ffp-contract=off keeps the preprocess resize
# bit-equal to numpy's unfused float32 multiply-add.
HOST_CXXFLAGS = ["-O3", "-fPIC", "-Wall", "-shared", "-ffp-contract=off"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _digest(sources: list[str], flags: list[str]) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def _build(name: str, compiler: list[str], sources: list[str],
           flags: list[str], libs: list[str]) -> str:
    """Compile ``sources`` into build/<name>-<digest>.so unless it exists;
    returns its path. The compiler's output is kept beside it as .log."""
    out = os.path.join(BUILD_DIR, f"{name}-{_digest(sources, flags)}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*compiler, *flags, "-o", tmp, *sources, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", out[:-3] + ".log")
    os.replace(tmp, out)
    return out


def build_log(path: str) -> str:
    """The compiler's output for a library built by this module."""
    with open(path[:-3] + ".log") as f:
        return f.read()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the CUDA kernels are compiled at first use and need the CUDA "
            "toolkit")
    return nvcc


def kernel_names() -> list[str]:
    """The kernel sources, ``csrc/<name>.cu``, by name."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_kernel(name: str) -> str:
    """The CUDA library of one kernel source, ``csrc/<name>.cu``."""
    return _build(f"lib{name}", [find_nvcc()],
                  [os.path.join(CSRC_DIR, f"{name}.cu")], NVCC_FLAGS, [])


def build_native() -> str:
    """The host IO runtime from native/barkio.cc."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    return _build("libbarkio", [cxx], [NATIVE_SRC], HOST_CXXFLAGS,
                  ["-lz", "-lpthread"])
