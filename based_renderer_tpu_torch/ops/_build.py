"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` source of the package is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/torch_kernels/`` at the root of the checkout, named by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the earlier build.

``ROUTES`` is the one table of the hand-written kernel routes: each name
maps to its C entry and the device kernel it launches (two routes may
share one kernel).  The kernel wrappers check their operands and launch
through ``launch``, which appends the current stream, raises on a failed
launch and counts the route in ``utils.profiling.ROUTES_TAKEN``.  Nothing
here runs at import.
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
from typing import NamedTuple

from ..utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


class Route(NamedTuple):
    entry: str  # the C entry point in csrc/*.cu
    symbol: str  # the __global__ kernel it launches


#: Every hand-written kernel route, by the name it is counted and reported
#: under.  The two-pass and batched routes schedule the sequential and the
#: sublane raster's computation on the TPU and map onto their kernels.
ROUTES = {
    "raster_tile": Route("brt_raster_tile", "raster_tile_kernel"),
    "raster_sublane": Route("brt_raster_sublane", "raster_sublane_kernel"),
    "assemble_records": Route("brt_assemble_records", "assemble_records_kernel"),
    "raster_msaa4": Route("brt_raster_msaa4", "raster_msaa4_kernel"),
    "raster_msaa4_sublane": Route("brt_raster_msaa4_sublane", "raster_msaa4_sublane_kernel"),
    "raster_two_pass": Route("brt_raster_tile", "raster_tile_kernel"),
    "raster_batched": Route("brt_raster_sublane", "raster_sublane_kernel"),
    "transpose_templates": Route("brt_transpose_templates", "transpose_templates_kernel"),
    "assemble_records_rows": Route("brt_assemble_records_rows", "assemble_records_rows_kernel"),
    "shade_blinn_phong": Route("brt_shade_blinn_phong", "shade_blinn_phong_kernel"),
    "triangle_templates": Route("brt_triangle_templates", "triangle_templates_kernel"),
    "transform_points": Route("brt_transform_points", "transform_points_kernel"),
}

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
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                BUILD_LOG = _compile_and_link(_nvcc(), Path(tmp), path)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
        return lib


def ptr(t) -> ctypes.c_void_p | None:
    """A tensor's data pointer for a C entry point (None for null)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``dev``, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def launch(route: str, *args, dev):
    """Launch ``route``'s kernel: its C entry with ``args`` and the current
    stream on ``dev``.  A failed launch raises and counts nothing; else the
    route counts one in ``profiling.ROUTES_TAKEN`` (eager frames and graph
    captures: a replay calls no wrapper)."""
    rc = getattr(load(), ROUTES[route].entry)(*args, stream(dev))
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: cudaError {rc}")
    profiling.ROUTES_TAKEN[route] += 1


def check_operand(name, t, dtype, shape, dev):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``dev`` of
    ``shape`` (None matches any extent)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _run(cmds: list[list[str]]) -> str:
    """Run commands concurrently; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}")
    return log


def _compile_and_link(nvcc: str, tmp: Path, path: Path) -> str:
    objs = [tmp / (src.stem + ".o") for src in _sources()]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(o)] for src, o in zip(_sources(), objs)])
    so = tmp / path.name
    log += _run([[nvcc, "-shared", "-o", str(so), *map(str, objs)]])
    os.replace(so, path)  # atomic: a concurrent build never sees half a file
    return log


def _declare(lib: ctypes.CDLL):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    i32s = ctypes.POINTER(ctypes.c_int32)
    lib.brt_raster_tile.restype = i
    lib.brt_raster_tile.argtypes = [
        p, p, i64,  # records, frecords, pair stride
        p, p, i,  # tile_start, tile_count, num_tiles
        p, p, p, p, p, p,  # init tri_id, depth_q, b0, b1, b2, stencil (or null)
        p, p,  # out ints (2 or 3 with the stencil, H, W), out floats (4 + K, H, W)
        i, i, i, i, i,  # width, height, tile_w, tile_h, num_tx
        i, i, i, i, i,  # depth test, compare, write, clip mode, clear depth_q
        i,  # num_channels
        i, i, i, i, i,  # has_scissor, sx0, sy0, sx1, sy1
        i, i, i, i, i,  # stencil on, compare, ref, compare_mask, write_mask
        i, i, i, i,  # stencil fail_op, depth_fail_op, pass_op, clear value
        p,  # cudaStream_t
    ]
    lib.brt_raster_sublane.restype = i
    lib.brt_raster_sublane.argtypes = [
        p, p, i64,  # records, frecords, pair stride
        p, p,  # tile_start, tile_count (one per bin)
        p, p, p, p,  # init tri_id, depth_q, b0, b1 (or null)
        p, p,  # out ints (2, H, W), out floats (4 + K, H, W)
        i, i, i, i, i, i,  # width, height, tile_w, tile_h, num_tx, num_ty
        i, i,  # banded, band_rows
        i, i, i,  # depth compare, clip mode, clear depth_q
        i,  # num_channels
        i, i, i, i, i,  # has_scissor, sx0, sy0, sx1, sy1
        p,  # cudaStream_t
    ]
    lib.brt_raster_msaa4.restype = i
    lib.brt_raster_msaa4.argtypes = [
        p, p, i64,  # records (24 rows), frecords, pair stride
        p, p, i,  # tile_start, tile_count, num_tiles
        p, p, p, p, p, p,  # init tri_id, depth_q, b0, b1, b2, stencil, each (4, H, W) (or null)
        p, p,  # out ints (2 or 3 with the stencil, 4, H, W), out floats (4 + K, 4, H, W)
        i, i, i, i, i,  # width, height, tile_w, tile_h, num_tx
        i, i, i, i, i,  # depth test, compare, write, clip mode, clear depth_q
        i,  # num_channels
        i, i, i, i, i,  # has_scissor, sx0, sy0, sx1, sy1
        i, i, i, i, i,  # stencil on, compare, ref, compare_mask, write_mask
        i, i, i, i,  # stencil fail_op, depth_fail_op, pass_op, clear value
        i32s,  # (ddx, ddy) of the 4 samples (host memory)
        p,  # cudaStream_t
    ]
    lib.brt_raster_msaa4_sublane.restype = i
    lib.brt_raster_msaa4_sublane.argtypes = [
        p, p, i64,  # records (24 rows), frecords, pair stride
        p, p,  # tile_start, tile_count (one per tile)
        p, p, p, p,  # init tri_id, depth_q, b0, b1, each (4, H, W) (or null)
        p, p,  # out ints (2, 4, H, W), out floats (4 + K, 4, H, W)
        i, i, i, i, i, i,  # width, height, tile_w, tile_h, num_tx, num_ty
        i, i, i,  # depth compare, clip mode, clear depth_q
        i,  # num_channels
        i, i, i, i, i,  # has_scissor, sx0, sy0, sx1, sy1
        i32s,  # (ddx, ddy) of the 4 samples (host memory)
        p,  # cudaStream_t
    ]
    lib.brt_assemble_records.restype = i
    lib.brt_assemble_records.argtypes = [
        p, p, p,  # a, b, e
        p, p, p,  # dzdx, dzdy, zshift
        p, p, p,  # zq, xf, yf
        p, p,  # gx, gy
        p, i,  # planes, num_planes
        p, p, p, p,  # t_slot, ox, oy, total
        p, i64,  # per-triangle int32 ids (or null), id_offset when null
        p, p, i64, i, i,  # records, frecords, num_slots, rw (16 or 24), fw
        p,  # cudaStream_t
    ]
    lib.brt_assemble_records_rows.restype = i
    lib.brt_assemble_records_rows.argtypes = [
        p, i, i,  # template rows (T, row_width), row_width, num_planes
        p, p, p, p,  # t_slot, ox, oy, total
        p, p, i64, i, i,  # records, frecords, num_slots, rw (16 or 24), fw
        p,  # cudaStream_t
    ]
    lib.brt_assemble_records_rows_smem.restype = i64
    lib.brt_assemble_records_rows_smem.argtypes = [i]  # num_planes
    lib.brt_transpose_templates.restype = i
    lib.brt_transpose_templates.argtypes = [
        p, p,  # fused_t (W8, T), out (T, out_width)
        i, i64, i,  # W8, T, out_width
        p,  # cudaStream_t
    ]
    lib.brt_shade_blinn_phong.restype = i
    lib.brt_shade_blinn_phong.argtypes = [
        p, p, p,  # interp (K, S, H, W), invw (S, H, W), tri_id (S, H, W)
        i64, i64,  # the draw's tri_id range [lo, hi)
        p, i,  # colour so far (S, 4, H, W), or the (4,) clear colour when the flag is set
        p, i, p, i, p, i,  # light_pos, eye_pos, base_color, each with its stride (0: one value)
        p, p,  # shininess, ambient
        p,  # out (4, H, W) when resolved, else (S, 4, H, W)
        i, i64, i, i,  # samples, H * W, num_channels (6 or 9), resolve
        p,  # cudaStream_t
    ]
    lib.brt_triangle_templates.restype = i
    lib.brt_triangle_templates.argtypes = [
        p, p, p,  # e (T, 3) int64, a, b (T, 3) int32
        p, p, p,  # inv_area (T,), inv_w (T, 3), channels (T, 3, K) (or null)
        i, i,  # num_channels, perspective
        p, i64,  # out planes (T, 3 * (3 + K)), T
        p,  # cudaStream_t
    ]
    lib.brt_transform_points.restype = i
    lib.brt_transform_points.argtypes = [
        p, i64,  # matrix (R, C) or (N, R, C), its stride a point (0: one matrix)
        p, p, i64,  # points (N, P), out (N, R), N
        i, i, i,  # R, C, P
        p,  # cudaStream_t
    ]
