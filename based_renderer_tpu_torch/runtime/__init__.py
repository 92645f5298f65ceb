"""Native host runtime bindings (ctypes over the C++ brt_runtime library).

The compute path is PyTorch and CUDA; the host-side runtime around it (the
f32 -> u8 converters, the PNG encoder and the background present ring) is
C++ (``runtime/native/brt_runtime.cpp``, this package's own copy of those
parts of the JAX package's runtime, with the same C ABI).  The swapchain's
staging, one page-locked block, and the frame pacer are Python, in
``present.py``.

The library is built with g++ at first use (no pybind11: a plain C ABI and
ctypes) into ``build/torch_runtime/`` at the root of the checkout, named
by a hash of the source and flags, as ``ops/_build.py`` names the kernel
library.  The build lands under a temporary name and is moved into place
with ``os.replace``, so processes that build at the same time never load
half a file.  Nothing builds at import.  ``available()`` reports whether
the library loaded; the classes raise with the build's error when it did
not.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..utils import profiling

SRC = Path(__file__).resolve().parent / "native" / "brt_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_runtime"
# -ffp-contract=off keeps f32_to_u8's v * 255 + 0.5 two roundings (no FMA),
# as numpy computes it, in its SSE2 body and its scalar tail alike.
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
LIBS = ("-lz", "-lpthread")

_lib = None
_error: str | None = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libbrt_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native runtime unless this source's build exists;
    raise RuntimeError with g++'s output if it fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime needs a C++ compiler to build")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        out = Path(tmp) / path.name
        proc = subprocess.run([gxx, *CXX_FLAGS, str(SRC), "-o", str(out), *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC.name}:\n{proc.stderr}")
        os.replace(out, path)  # atomic: a concurrent build never sees half a file
    return path


def _declare(lib):
    c = ctypes
    lib.brt_f32_to_u8.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.brt_f32_to_u8_srgb.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.brt_write_png.restype = c.c_int32
    lib.brt_write_png.argtypes = [c.c_char_p, c.c_void_p, c.c_int32, c.c_int32, c.c_int32]
    lib.brt_present_create.restype = c.c_void_p
    lib.brt_present_create.argtypes = [c.c_int32, c.c_int32, c.c_int32, c.c_char_p, c.c_int32]
    lib.brt_present_submit.restype = c.c_uint64
    lib.brt_present_submit.argtypes = [c.c_void_p, c.c_void_p]
    lib.brt_present_flush.argtypes = [c.c_void_p]
    lib.brt_present_records.restype = c.c_int32
    lib.brt_present_records.argtypes = [c.c_void_p, c.c_void_p, c.c_int32]
    lib.brt_present_count.restype = c.c_uint64
    lib.brt_present_count.argtypes = [c.c_void_p]
    lib.brt_present_destroy.argtypes = [c.c_void_p]


def _load():
    """The loaded library, or None with the reason kept for ``require``."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                _error = str(e)
            else:
                _declare(lib)
                _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require():
    """The library, or RuntimeError with the reason it did not build or load."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_error}")
    return lib


#: Records the native ring keeps per ring (kPresentRecords), and read at once.
PRESENT_RECORDS = 4096
_ring_serials = itertools.count()


class PresentRing:
    """Background present thread and bounded frame ring (swapchain analog).

    ``submit`` reads a float32 (H, W, 4) numpy array once, converting it
    to u8 (``f32_to_u8``'s bytes, sRGB-encoded on an ``srgb`` ring) into
    one of ``depth + 1`` slots pooled at creation, so the caller's array
    is free again on return.  PNGs ``frame_%06d.png`` are written (or
    frames dropped, without ``out_dir``) off the Python thread; submit
    blocks only while ``depth`` frames wait.

    Each frame's phases are stamped on both threads.  A submit made while
    a torch profiler records drains the stamps of the frames presented so
    far into ``utils.profiling.ring_records``; after one has, ``flush``
    and ``close`` drain the rest."""

    def __init__(self, width: int, height: int, depth: int = 2, out_dir: str | None = None, srgb: bool = False):
        self._lib = require()
        self.width, self.height = width, height
        self.serial = next(_ring_serials)
        self._traced = False
        self._h = self._lib.brt_present_create(
            width, height, depth, os.fsencode(out_dir) if out_dir else None, 1 if srgb else 0
        )

    def submit(self, rgba_f32: np.ndarray) -> int:
        from ..utils.errors import PresentError

        with profiling.span("brt.ring.submit"):
            a = np.ascontiguousarray(rgba_f32, np.float32)
            if a.shape != (self.height, self.width, 4):
                raise PresentError(f"present expects ({self.height}, {self.width}, 4), got {a.shape}")
            index = self._lib.brt_present_submit(self._h, a.ctypes.data)
        if profiling.recording():
            self._traced = True
            self._drain()
        return index

    def _drain(self):
        """Hand the stamps of the frames presented since the last drain to
        utils.profiling."""
        out = np.empty((PRESENT_RECORDS, 8), np.uint64)
        n = self._lib.brt_present_records(self._h, out.ctypes.data, PRESENT_RECORDS)
        profiling.keep_ring_records(self.serial, out[:n].tolist())

    def flush(self):
        self._lib.brt_present_flush(self._h)
        if self._traced:
            self._drain()

    @property
    def presented(self) -> int:
        return self._lib.brt_present_count(self._h)

    def close(self):
        if getattr(self, "_h", None):
            if self._traced:
                self.flush()
            self._lib.brt_present_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def write_png(path, img_u8: np.ndarray) -> None:
    """Write an (H, W[, 1|3|4]) uint8 image as PNG with the native encoder."""
    lib = require()
    a = np.ascontiguousarray(img_u8, np.uint8)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    rc = lib.brt_write_png(os.fsencode(path), a.ctypes.data, w, h, c)
    if rc != 0:
        from ..utils.errors import PresentError

        raise PresentError(f"brt_write_png failed: {rc}")


def f32_to_u8(img: np.ndarray, srgb: bool = False) -> np.ndarray:
    """f32 [0, 1] -> u8; ``srgb`` applies the transfer function to RGB (the
    flat buffer is read as RGBA quads: alpha stays linear)."""
    lib = require()
    a = np.ascontiguousarray(img, np.float32)
    out = np.empty(a.shape, np.uint8)
    fn = lib.brt_f32_to_u8_srgb if srgb else lib.brt_f32_to_u8
    fn(a.ctypes.data, out.ctypes.data, a.size)
    return out
