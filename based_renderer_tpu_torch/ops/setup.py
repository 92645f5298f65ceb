"""Triangle setup: clip-space vertices -> per-triangle raster records.

The PyTorch counterpart of ``based_renderer_tpu/ops/setup.py``, vectorized
over triangles.  Conventions (see ops/fixedpoint.py for the integer spec):
  * input: clip-space positions (T, 3, 4) float32 (w > 0 in front).
  * NDC y is down; the viewport maps NDC [-1,1]^2 onto [0,W]x[0,H] pixels.
  * depth = ndc z in [0, 1], quantized per the integer depth spec.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fixedpoint as fp


class TriSetup(NamedTuple):
    """Struct-of-arrays per-triangle raster record (all leading dim T).

    ``area2`` is one int64 field where the JAX package keeps the
    (area2_hi, area2_lo) int32 pair.
    """

    valid: torch.Tensor  # bool (T,) survives cull/degenerate/offscreen tests
    xf: torch.Tensor  # int32 (T, 3) snapped fixed-point x
    yf: torch.Tensor  # int32 (T, 3) snapped fixed-point y
    a: torch.Tensor  # int32 (T, 3) edge A coeffs, winding-normalized
    b: torch.Tensor  # int32 (T, 3) edge B coeffs, winding-normalized
    bias: torch.Tensor  # int32 (T, 3) fill-rule bias (0 or -1)
    area2: torch.Tensor  # int64 (T,) |twice signed area|
    inv_area: torch.Tensor  # f32 (T,) 1 / |area2|
    z: torch.Tensor  # f32 (T, 3) per-vertex NDC depth
    inv_w: torch.Tensor  # f32 (T, 3) per-vertex 1/clip_w
    bbox: torch.Tensor  # int32 (T, 4) pixel bbox x0,y0,x1,y1 (x1/y1 exclusive)
    zq: torch.Tensor  # int32 (T, 3) per-vertex quantized depth (24.0 LSB)
    gx: torch.Tensor  # f32 (T,) depth LSB per +1 fp unit in x
    gy: torch.Tensor  # f32 (T,)
    dzdx_q: torch.Tensor  # int32 (T,) depth units (2^(6-zshift) LSB) per px
    dzdy_q: torch.Tensor  # int32 (T,)
    zshift: torch.Tensor  # int32 (T,) adaptive exponent of the depth plane


def _unit_scale(zshift: torch.Tensor) -> torch.Tensor:
    """f32 2^(6 - zshift), built from its bits (exact)."""
    return ((133 - zshift.to(torch.int32)) << 23).view(torch.float32)


def setup_triangles(
    clip_pos: torch.Tensor,
    width: int,
    height: int,
    cull_mode: str = "none",
    front_face: str = "ccw",
    w_eps: float = 1e-6,
    scissor=None,
    bbox_pad_fp: int = 0,
    depth_bias=None,
) -> TriSetup:
    """Vectorized triangle setup.

    Args:
      clip_pos: (T, 3, 4) float32 clip-space positions.
      width, height: framebuffer extent in pixels.
      cull_mode: "none" | "back" | "front".
      front_face: "ccw" | "cw" (conventional y-up orientation).
      w_eps: triangles with any vertex w <= w_eps are dropped (near-plane
        clipping proper is ops.clip.clip_near, applied before setup).
      scissor: optional (x0, y0, x1, y1) pixel rect; bboxes are clamped
        into it (the rasterizer masks coverage to it as well).
      bbox_pad_fp: widen the pixel bbox by this many subpixel (1/16-px)
        units on every side: fp.MSAA4_BBOX_PAD_FP for coverage-sample
        MSAA, whose samples lie up to 6/16 px from the pixel center.
      depth_bias: optional (constant, slope, clamp), the depthBiasEnable
        state: a per-triangle offset o = rint(constant) + rint(slope * m)
        quantized-LSB units on the three vertex depths, m the triangle's
        max f32 depth slope per pixel, bounded by ``clamp`` (depth units,
        0 = none).  The edge coefficients sum to zero, so the gradients
        stay as they are and only the plane's base value moves.
    """
    if cull_mode not in ("none", "back", "front"):
        raise ValueError(f"bad cull_mode {cull_mode!r}")
    clip_pos = clip_pos.to(torch.float32)
    x, y, z, w = clip_pos.unbind(-1)
    eps = fp.f32(w_eps, w)
    w_ok = torch.all(w > eps, dim=-1)
    safe_w = torch.where(w > eps, w, fp.f32(1.0, w))
    # Deterministic reciprocal: inv_w feeds the snapped coordinates.
    inv_w = fp.recip_f32_exact(safe_w)
    ndc_x = x * inv_w
    ndc_y = y * inv_w
    ndc_z = z * inv_w

    # Viewport transform + snap, FMA-proof: xf = rint(ndc_x * 8W) + 8W.
    xf = fp.rint_i32(ndc_x * fp.f32(8 * width, w)) + 8 * width
    yf = fp.rint_i32(ndc_y * fp.f32(8 * height, w)) + 8 * height
    xf = xf.clamp(fp.GUARD_LO, fp.GUARD_HI)
    yf = yf.clamp(fp.GUARD_LO, fp.GUARD_HI)

    a, b, area2 = fp.edge_coeffs(xf, yf)
    is_neg = area2 < 0
    is_zero = area2 == 0

    # Facing: screen space is y-down, so visually-CCW triangles have
    # negative area2 here.
    is_front = is_neg if front_face == "ccw" else (~is_neg & ~is_zero)
    if cull_mode == "none":
        cull_ok = torch.ones_like(is_zero)
    elif cull_mode == "back":
        cull_ok = is_front
    else:
        cull_ok = ~is_front

    # Winding normalization: make area positive, interior = all E >= 0.
    neg = is_neg[..., None]
    a = torch.where(neg, -a, a)
    b = torch.where(neg, -b, b)
    area2 = area2.abs()
    bias = fp.topleft_bias(a, b)

    area_f = fp.i64_to_f32(area2)
    inv_area = fp.recip_f32_exact(torch.where(is_zero, fp.f32(1.0, area_f), area_f))

    # Pixel bbox: first candidate px = ceil((min_fp - pad - 8) / 16), last
    # = floor((max_fp + pad - 8) / 16), clamped to the framebuffer or scissor.
    sc, hp, pad = fp.SUBPIXEL_SCALE, fp.HALF_PIXEL, int(bbox_pad_fp)
    x0 = torch.div(xf.amin(-1) - pad - hp + (sc - 1), sc, rounding_mode="floor")
    y0 = torch.div(yf.amin(-1) - pad - hp + (sc - 1), sc, rounding_mode="floor")
    x1 = torch.div(xf.amax(-1) + pad - hp, sc, rounding_mode="floor") + 1
    y1 = torch.div(yf.amax(-1) + pad - hp, sc, rounding_mode="floor") + 1
    sx0, sy0, sx1, sy1 = (0, 0, width, height) if scissor is None else scissor
    x0 = x0.clamp(sx0, sx1)
    y0 = y0.clamp(sy0, sy1)
    x1 = x1.clamp(sx0, sx1)
    y1 = y1.clamp(sy0, sy1)
    nonempty = (x1 > x0) & (y1 > y0)

    valid = w_ok & cull_ok & ~is_zero & nonempty
    bbox = torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32)

    # Integer quantized-depth plane: every f32 step is a single
    # multiplication; all accumulation is integer.
    zq = fp.rint_i32(ndc_z * fp.f32(1 << fp.DEPTH_LSB_BITS, w)).clamp(
        -fp.DEPTH_VERTEX_CLAMP, fp.DEPTH_VERTEX_CLAMP
    )
    # Weight of v0 <- edge 1, v1 <- edge 2, v2 <- edge 0.
    a64, b64, zq64 = a.to(torch.int64), b.to(torch.int64), zq.to(torch.int64)
    num_x = a64[..., 1] * zq64[..., 0] + a64[..., 2] * zq64[..., 1] + a64[..., 0] * zq64[..., 2]
    num_y = b64[..., 1] * zq64[..., 0] + b64[..., 2] * zq64[..., 1] + b64[..., 0] * zq64[..., 2]
    gx = fp.i64_to_f32(num_x) * inv_area
    gy = fp.i64_to_f32(num_y) * inv_area
    # Adaptive exponent from the slope's f32 exponent (all exact ops).
    slope = torch.maximum(gx.abs(), gy.abs()) * fp.f32(fp.SUBPIXEL_SCALE, gx)
    eb = (slope.contiguous().view(torch.int32) >> 23) & 0xFF
    zshift = (eb - 141).clamp(0, 24).to(torch.int32)
    unit_scale = _unit_scale(zshift)
    gclamp = float(fp.DEPTH_GRAD_CLAMP)
    gx16 = gx * fp.f32(fp.SUBPIXEL_SCALE, gx)
    gy16 = gy * fp.f32(fp.SUBPIXEL_SCALE, gy)
    dzdx_q = torch.round((gx16 * unit_scale).clamp(-gclamp, gclamp)).to(torch.int32)
    dzdy_q = torch.round((gy16 * unit_scale).clamp(-gclamp, gclamp)).to(torch.int32)

    if depth_bias is not None:
        # The JAX package's steps (setup.py:223-243): one f32 multiply,
        # the +/-2^29 clip, half-even rint; the constant and the clamp
        # through Python's (half-even) round.
        bias_c, bias_s, bias_cl = depth_bias
        blim = float(1 << 29)
        m_slope = torch.maximum(gx16.abs(), gy16.abs())
        o = torch.round((m_slope * fp.f32(bias_s, m_slope)).clamp(-blim, blim)).to(torch.int32)
        o = o + int(round(float(bias_c)))
        cl = int(round(float(bias_cl) * (1 << fp.DEPTH_LSB_BITS)))
        if bias_cl > 0:
            o = torch.clamp_max(o, cl)
        elif bias_cl < 0:
            o = torch.clamp_min(o, cl)
        zq = (zq + o[:, None]).clamp(-fp.DEPTH_VERTEX_CLAMP, fp.DEPTH_VERTEX_CLAMP)

    return TriSetup(
        valid=valid,
        xf=xf,
        yf=yf,
        a=a,
        b=b,
        bias=bias,
        area2=area2,
        inv_area=inv_area,
        z=ndc_z,
        inv_w=inv_w,
        bbox=bbox,
        zq=zq,
        gx=gx,
        gy=gy,
        dzdx_q=dzdx_q,
        dzdy_q=dzdy_q,
        zshift=zshift,
    )


def depth_tile_anchor(zq0, x0f, y0f, gx, gy, zshift, ax, ay) -> torch.Tensor:
    """Quantized plane value (2^(6-zshift) LSB units) at a tile anchor.

    zq0: quantized depth of vertex 0; x0f/y0f its fixed-point coords;
    gx, gy: f32 depth gradients; zshift: adaptive exponent; ax, ay:
    anchor pixel indices (multiples of fp.DEPTH_TILE).  All broadcast
    together.  Returns the clamped value as int64.
    """
    ax_fp, ay_fp = fp.pixel_center_fp(ax, ay)
    unit_scale = _unit_scale(zshift)
    dxf = (ax_fp - x0f).to(torch.float32)
    dyf = (ay_fp - y0f).to(torch.float32)
    tx = fp.rint_i32(gx * dxf * unit_scale).to(torch.int64)
    ty = fp.rint_i32(gy * dyf * unit_scale).to(torch.int64)
    zshift = zshift.to(torch.int64)
    # base = (zq0 >> max(0, s-6)) * 2^max(0, 6-s) - mid_u, exact.
    rsh = (zshift - fp.DEPTH_FRAC_BITS).clamp(0, 24)
    pow_l = torch.ones_like(zshift) << (fp.DEPTH_FRAC_BITS - zshift).clamp(0, 6)
    mid_u = torch.full_like(zshift, 1 << 29) >> zshift
    base = (zq0.to(torch.int64) >> rsh) * pow_l - mid_u
    s = (base + tx) + ty
    # Clamp with headroom: only planes fully out of range in this tile can
    # clamp (value-exactness proof in the JAX package's fixedpoint.py).
    clamp_hi = mid_u + (1 << 29)
    s = s.clamp(-(1 << 30), 1 << 30)
    return torch.maximum(torch.minimum(s, clamp_hi), -clamp_hi)


def depth_at_pixel(z_tile, dzdx_q, dzdy_q, zshift, dx, dy) -> torch.Tensor:
    """Per-pixel quantized depth: int32-exact step from the tile anchor,
    then unbias/rescale to global LSB*2^6 units (int32 result).

    dx, dy are pixel offsets from the canonical tile anchor (< 128).
    """
    zshift = zshift.to(torch.int64)
    z_u = z_tile.to(torch.int64) + dzdx_q.to(torch.int64) * dx + dzdy_q.to(torch.int64) * dy
    hi = (torch.full_like(zshift, 1 << 29) >> zshift) + 1
    z_c = torch.maximum(torch.minimum(z_u, hi), -hi)
    return (z_c * (torch.ones_like(zshift) << zshift) + (1 << 29)).to(torch.int32)
