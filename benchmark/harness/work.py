"""The yardstick for kernels: the chip's peaks and the least work a stage needs.

The table of peaks is the one ``chip_smoke.py`` uses (copied, so that a
later edit of that script cannot move it): HBM3 at 3.35 TB/s on the H100
SXM, and the int32 instruction rate of 132 SMs x 64 INT32 lanes at the 1980 MHz
boost clock (Hopper white paper).  A kernel's least time is the larger of
its bytes over the first and its integer operations over the second.

The raster stage's work is counted from what the frame's inputs need,
whatever implements the raster, never from the program's binner: each
plane of the spec's visibility buffer (tri_id and depth_q, int32) written
once per sample, and each triangle that reaches the raster read once as
its three snapped vertices and quantized depths (9 int32).  Its integer
work is one edge-and-depth test per sample of each such triangle's
bounding box, at RASTER_OPS_PER_TEST operations: three edge steps and
three sign tests, and one depth step and compare.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

VIS_PLANE_BYTES = 2 * 4  # tri_id and depth_q per sample
TRIANGLE_BYTES = 9 * 4  # three snapped (x, y) and three quantized depths
RASTER_OPS_PER_TEST = 8


def least_seconds(bytes_: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time and what binds it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def raster_work(samples: int, triangles: int, bbox_samples: int) -> tuple[float, float]:
    """(bytes, integer operations) the raster stage of one frame needs:
    ``samples`` samples in the framebuffer (pixels x samples per pixel),
    ``triangles`` triangles reaching the raster, whose bounding boxes hold
    ``bbox_samples`` samples."""
    return samples * VIS_PLANE_BYTES + triangles * TRIANGLE_BYTES, bbox_samples * RASTER_OPS_PER_TEST
