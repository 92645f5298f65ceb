"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the earlier build.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_LOG = ""  # nvcc's output of the build this process made, if any


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"brt_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
                cmd += [str(s) for s in _sources()]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                BUILD_LOG = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
                os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.brt_raster_tile.restype = i
    lib.brt_raster_tile.argtypes = [
        p, p, i64,  # records, frecords, pair stride
        p, p, i,  # tile_start, tile_count, num_tiles
        p, p, p, p, p,  # init tri_id, depth_q, b0, b1, b2 (or null)
        p, p,  # out ints (2, H, W), out floats (4 + K, H, W)
        i, i, i, i, i,  # width, height, tile_w, tile_h, num_tx
        i, i, i, i, i,  # depth test, compare, write, clip mode, clear depth_q
        i,  # num_channels
        i, i, i, i, i,  # has_scissor, sx0, sy0, sx1, sy1
        p,  # cudaStream_t
    ]
