"""Fixed-point rasterization arithmetic spec, in PyTorch.

The numerical contract of ``based_renderer_tpu/ops/fixedpoint.py``,
restated on native ``torch.int64``: the JAX package emulates 64-bit
integers with int32 pairs because the TPU has none, and the results here
are bit-identical to those pairs.  See that module's docstring for the
spec itself (snap grid, edge functions, fill rule, anchored int32
stepping, and the quantized-depth plane with its exactness proofs).

Every float step is a single IEEE operation issued as its own PyTorch
op, so no compiler can contract a multiply-add into an FMA.
"""

from __future__ import annotations

import torch

SUBPIXEL_BITS = 4
SUBPIXEL_SCALE = 1 << SUBPIXEL_BITS  # 16
HALF_PIXEL = SUBPIXEL_SCALE // 2  # 8: offset of a pixel center on the snap grid
GUARD_BAND_PIX = 8192
GUARD_LO = -GUARD_BAND_PIX * SUBPIXEL_SCALE  # -2^17
GUARD_HI = GUARD_BAND_PIX * SUBPIXEL_SCALE - 1
ANCHOR_CLAMP = (1 << 30) - 1  # tile-anchor clamp window

DEPTH_LSB_BITS = 24
DEPTH_FRAC_BITS = 6
DEPTH_ONE_Q = 1 << (DEPTH_LSB_BITS + DEPTH_FRAC_BITS)  # == 2^30 == depth 1.0
DEPTH_VERTEX_CLAMP = 1 << 29  # clamp on per-vertex quantized z
DEPTH_GRAD_CLAMP = (1 << 21) - 1
DEPTH_TILE = 128  # canonical anchor grid for quantized-plane evaluation
DEPTH_Q_TO_F32 = 1.0 / DEPTH_ONE_Q

# f32 -> int conversions are preceded by a clamp to this window, so the
# cast never sees an out-of-range value (the JAX package clamps the same
# way, or its values are clipped right after a saturating convert).
_F32_INT_LIM = float(1 << 30)


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device (keeps ops in f32)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def rint_i32(x: torch.Tensor) -> torch.Tensor:
    """Round half-even to int32 after clamping to +/-2^30."""
    return torch.round(x.clamp(-_F32_INT_LIM, _F32_INT_LIM)).to(torch.int32)


def snap_fixed(coord_f32: torch.Tensor) -> torch.Tensor:
    """Snap float screen coords (in pixels) to the 1/16-px integer grid,
    rounding half-even (``torch.round``, like ``jnp.rint``)."""
    scaled = coord_f32 * f32(SUBPIXEL_SCALE, coord_f32)
    return rint_i32(scaled).clamp(GUARD_LO, GUARD_HI)


def recip_f32_exact(x: torch.Tensor) -> torch.Tensor:
    """Deterministic, exactly-specified f32 reciprocal of positive normals.

        x = mw * 2^(e-150)  with mw in [2^23, 2^24), e = biased exponent
        q = floor(2^47 / mw)            (exact integer, in [2^23, 2^24])
        recip(x) := f32(q) * 2^(103-e)  (both factors exact in f32)

    The JAX package seeds q with a hardware division and fixes it up with
    emulated 64-bit compares; native int64 computes the floor directly,
    as the numpy oracle does.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    e = (bits >> 23) & 0xFF
    mw = ((bits & 0x7FFFFF) | 0x800000).to(torch.int64)
    q = torch.div(torch.full_like(mw, 1 << 47), mw, rounding_mode="floor")
    exp_s = (230 - e).clamp(1, 254)
    scale = (exp_s << 23).to(torch.int32).view(torch.float32)
    return q.to(torch.float32) * scale


def i64_to_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 value of an int64, by the JAX package's two-step rule.

    The TPU path converts an (hi, lo) int32 pair as
    f32(hi + (lo < 0)) * 2^32 + f32(int32(lo)): exact below 2^31 in
    magnitude, and a double rounding above it.  Bit-identity needs the
    same double rounding, not a direct int64 -> f32 conversion.
    """
    v = v.to(torch.int64)
    lo = ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # low word as signed int32
    hi_adj = (v - lo) >> 32
    return hi_adj.to(torch.float32) * f32(4294967296.0, v) + lo.to(torch.float32)


def edge_coeffs(xf: torch.Tensor, yf: torch.Tensor):
    """Per-triangle edge coefficients from snapped coords.

    Args:
      xf, yf: int32 (..., 3) snapped fixed-point vertex coords.
    Returns:
      A, B: int32 (..., 3) with A_i = y_i - y_j, B_i = x_j - x_i
        (j = i+1 mod 3); area2: exact twice-signed-area, int64 (...,).
    """
    xj = torch.roll(xf, -1, dims=-1)
    yj = torch.roll(yf, -1, dims=-1)
    a = yf - yj
    b = xj - xf
    x64 = xf.to(torch.int64)
    y64 = yf.to(torch.int64)
    d1x = x64[..., 1] - x64[..., 0]
    d1y = y64[..., 1] - y64[..., 0]
    d2x = x64[..., 2] - x64[..., 0]
    d2y = y64[..., 2] - y64[..., 0]
    return a, b, d1x * d2y - d1y * d2x


def edge_at_point_exact(xf, yf, a, b, px_fp, py_fp) -> torch.Tensor:
    """Exact E_i at a fixed-point point, int64."""
    dx = (px_fp - xf).to(torch.int64)
    dy = (py_fp - yf).to(torch.int64)
    return a.to(torch.int64) * dx + b.to(torch.int64) * dy


def topleft_bias(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fill-rule bias per edge: 0 if boundary included, -1 otherwise.
    Included iff (A < 0) or (A == 0 and B < 0)."""
    included = (a < 0) | ((a == 0) & (b < 0))
    return torch.where(included, 0, -1).to(torch.int32)


def pixel_center_fp(px: torch.Tensor, py: torch.Tensor):
    """Pixel indices -> fixed-point pixel-center coordinates."""
    return px * SUBPIXEL_SCALE + HALF_PIXEL, py * SUBPIXEL_SCALE + HALF_PIXEL

