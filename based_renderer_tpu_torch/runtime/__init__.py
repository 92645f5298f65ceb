"""Native host runtime bindings (ctypes over the C++ brt_runtime library).

The compute path is PyTorch and CUDA; the host-side runtime around it (the
batched staging allocator, frame pacer, image encoders and the background
present ring) is C++ (``runtime/native/brt_runtime.cpp``, this package's
own copy of the JAX package's runtime, with the same C ABI).

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
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "brt_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_runtime"
# -ffp-contract=off keeps f32_to_u8's v * 255 + 0.5 two roundings (no FMA),
# as numpy computes it, on hosts whose baseline ISA has FMA.
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
    lib.brt_arena_create.restype = c.c_void_p
    lib.brt_arena_request_ex.restype = c.c_int32
    lib.brt_arena_request_ex.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64, c.c_int32]
    lib.brt_arena_set_dedicated_threshold.argtypes = [c.c_void_p, c.c_uint64]
    lib.brt_arena_num_dedicated.restype = c.c_int32
    lib.brt_arena_num_dedicated.argtypes = [c.c_void_p]
    lib.brt_arena_finalize.restype = c.c_int32
    lib.brt_arena_finalize.argtypes = [c.c_void_p]
    lib.brt_arena_ptr.restype = c.c_void_p
    lib.brt_arena_ptr.argtypes = [c.c_void_p, c.c_int32]
    lib.brt_arena_total_bytes.restype = c.c_uint64
    lib.brt_arena_total_bytes.argtypes = [c.c_void_p]
    lib.brt_arena_num_groups.restype = c.c_int32
    lib.brt_arena_num_groups.argtypes = [c.c_void_p]
    lib.brt_arena_destroy.argtypes = [c.c_void_p]
    lib.brt_pacer_create.restype = c.c_void_p
    lib.brt_pacer_create.argtypes = [c.c_double, c.c_int32]
    lib.brt_pacer_tick.restype = c.c_double
    lib.brt_pacer_tick.argtypes = [c.c_void_p]
    lib.brt_pacer_fps.restype = c.c_double
    lib.brt_pacer_fps.argtypes = [c.c_void_p]
    lib.brt_pacer_destroy.argtypes = [c.c_void_p]
    lib.brt_f32_to_u8.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.brt_f32_to_u8_srgb.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.brt_write_png.restype = c.c_int32
    lib.brt_write_png.argtypes = [c.c_char_p, c.c_void_p, c.c_int32, c.c_int32, c.c_int32]
    lib.brt_present_create.restype = c.c_void_p
    lib.brt_present_create.argtypes = [c.c_int32, c.c_int32, c.c_int32, c.c_char_p, c.c_int32]
    lib.brt_present_submit.restype = c.c_uint64
    lib.brt_present_submit.argtypes = [c.c_void_p, c.c_void_p]
    lib.brt_present_flush.argtypes = [c.c_void_p]
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


class Arena:
    """Batched, alignment-grouped host buffer allocator (the
    vulkan_allocate analog: request everything, finalize once).  Views of
    its buffers keep the arena alive."""

    def __init__(self):
        self._lib = require()
        self._h = self._lib.brt_arena_create()

    def request(self, size: int, alignment: int = 64, dedicated: bool = False) -> int:
        """Request a buffer.  ``dedicated`` forces the request onto its
        own backing block; requests at or above the arena's dedicated
        threshold (default 32 MiB) are promoted automatically."""
        idx = self._lib.brt_arena_request_ex(self._h, size, alignment, 1 if dedicated else 0)
        if idx < 0:
            raise ValueError("bad arena request (finalized? non-pow2 alignment?)")
        return idx

    def set_dedicated_threshold(self, bytes_: int):
        """Auto-promotion size threshold; 0 disables auto-promotion."""
        self._lib.brt_arena_set_dedicated_threshold(self._h, bytes_)

    def finalize(self):
        if self._lib.brt_arena_finalize(self._h) != 0:
            raise MemoryError("arena finalize failed")

    def view(self, index: int, shape, dtype=np.uint8) -> np.ndarray:
        """numpy view of a bound buffer (zero copy)."""
        ptr = self._lib.brt_arena_ptr(self._h, index)
        if not ptr:
            raise ValueError("unbound buffer (finalize first)")
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        buf._arena = self  # the view's base holds the arena
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    @property
    def total_bytes(self) -> int:
        return self._lib.brt_arena_total_bytes(self._h)

    @property
    def num_groups(self) -> int:
        return self._lib.brt_arena_num_groups(self._h)

    @property
    def num_dedicated(self) -> int:
        return self._lib.brt_arena_num_dedicated(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.brt_arena_destroy(self._h)
            self._h = None


class NativePacer:
    """C++ frame pacer (fixed dt and FPS), the native twin of
    present.FramePacer."""

    def __init__(self, fixed_dt: float = 1 / 60, vsync: bool = False):
        self._lib = require()
        self._h = self._lib.brt_pacer_create(fixed_dt, 1 if vsync else 0)
        self.fixed_dt = fixed_dt

    def tick(self) -> float:
        return self._lib.brt_pacer_tick(self._h)

    @property
    def fps(self) -> float:
        return self._lib.brt_pacer_fps(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.brt_pacer_destroy(self._h)
            self._h = None


class PresentRing:
    """Background present thread and bounded frame ring (swapchain analog).

    Frames submitted as float32 (H, W, 4) numpy arrays are copied, then
    converted and written as PNGs ``frame_%06d.png`` (or dropped, without
    ``out_dir``) off the Python thread; submit blocks only while ``depth``
    frames wait."""

    def __init__(self, width: int, height: int, depth: int = 2, out_dir: str | None = None, srgb: bool = False):
        self._lib = require()
        self.width, self.height = width, height
        self._h = self._lib.brt_present_create(
            width, height, depth, os.fsencode(out_dir) if out_dir else None, 1 if srgb else 0
        )

    def submit(self, rgba_f32: np.ndarray) -> int:
        from ..utils.errors import PresentError

        a = np.ascontiguousarray(rgba_f32, np.float32)
        if a.shape != (self.height, self.width, 4):
            raise PresentError(f"present expects ({self.height}, {self.width}, 4), got {a.shape}")
        return self._lib.brt_present_submit(self._h, a.ctypes.data)

    def flush(self):
        self._lib.brt_present_flush(self._h)

    @property
    def presented(self) -> int:
        return self._lib.brt_present_count(self._h)

    def close(self):
        if getattr(self, "_h", None):
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
