"""The rasterization spec of ``oracle.py``, vectorised in plain torch.

``oracle.py`` walks the triangles one by one in numpy, which takes minutes
for a million triangles at 4K with four samples.  This module computes the
same visibility buffer over all triangles at once: setup for every
triangle, then every (triangle, pixel) pair of each triangle's bounding
box, in chunks of at most ``max_pairs`` pairs, on whatever device its
inputs are on.  Every step of the oracle's arithmetic is kept as it is:
exact int64 edge functions, the exactly specified reciprocal, single
float32 multiplications for the depth plane, and the quantized depth.

Only what the benchmark's pipelines use is implemented: the depth test
``less`` with depth writes, per-fragment depth clipping on or off
(``depth_clip``: on discards a sample whose quantized depth lies outside
[0, 1], off keeps it), no stencil and no depth bias.  Under those the
sequential oracle keeps, per sample, the covered fragment of least
quantized depth and, among equal depths, the earliest triangle (a later
equal fragment fails the strict test).  So the winner is the minimum of
``depth << 32 | triangle``, taken with one ``scatter_reduce``; the order in
which pairs are visited does not matter.  Without the clip a depth may be
negative: the key stays ordered, since the triangle fills only its low 32
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SUBPIXEL_SCALE = 16
HALF_PIXEL = 8
GUARD_LO = -8192 * SUBPIXEL_SCALE
GUARD_HI = 8192 * SUBPIXEL_SCALE - 1
DEPTH_LSB_BITS = 24
DEPTH_FRAC_BITS = 6
DEPTH_ONE_Q = 1 << 30
DEPTH_VERTEX_CLAMP = 1 << 29
DEPTH_GRAD_CLAMP = (1 << 21) - 1
DEPTH_TILE = 128
MSAA4_OFFSETS = ((-2, -6), (6, -2), (-6, 2), (2, 6))
CENTER = ((0, 0),)

I64 = torch.int64
I32 = torch.int32
F32 = torch.float32


def recip_exact(x: torch.Tensor) -> torch.Tensor:
    """The oracle's exactly specified float32 reciprocal of positive ``x``."""
    bits = x.to(F32).contiguous().view(I32)
    e = (bits >> 23) & 0xFF
    mw = ((bits & 0x7FFFFF) | 0x800000).to(I64)
    q = torch.div(torch.full_like(mw, 1 << 47), mw, rounding_mode="floor").to(F32)
    exp_s = torch.clamp(230 - e, 1, 254).to(I32)
    return q * (exp_s << 23).view(F32)


def i64_to_f32(v: torch.Tensor) -> torch.Tensor:
    """The oracle's int64 -> float32 conversion (exact below 2^31)."""
    lo = v & 0xFFFFFFFF
    lo_s = torch.where(lo >= (1 << 31), lo - (1 << 32), lo)
    hi_adj = ((v >> 32) + (lo_s < 0).to(I64)).to(F32)
    return hi_adj * 4294967296.0 + lo_s.to(F32)


class Setup(NamedTuple):
    """Per-triangle setup of the triangles that reach the raster."""

    index: torch.Tensor  # (R,) the triangle's position in the input
    xf: torch.Tensor  # (R, 3) snapped x, 1/16 px
    yf: torch.Tensor
    a: torch.Tensor  # (R, 3) edge coefficients, interior >= 0
    b: torch.Tensor
    bias: torch.Tensor  # (R, 3) fill rule
    inv_area: torch.Tensor  # (R,) f32
    zq0: torch.Tensor  # (R,) quantized depth of vertex 0
    gx: torch.Tensor  # (R,) f32 depth gradient
    gy: torch.Tensor
    zshift: torch.Tensor  # (R,)
    unit_scale: torch.Tensor  # (R,) f32
    dzdx_q: torch.Tensor  # (R,)
    dzdy_q: torch.Tensor
    x0: torch.Tensor  # (R,) pixel bbox [x0, x1) x [y0, y1)
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor


def setup(clip: torch.Tensor, width: int, height: int, samples=CENTER, cull_mode: str = "none",
          front_face: str = "ccw", w_eps: float = 1e-6) -> Setup:
    """The oracle's per-triangle front end for (T, 3, 4) float32 clip
    positions, keeping the triangles it would rasterize: every w above
    ``w_eps``, a non-zero area, not culled, and a bbox on the screen."""
    clip = clip.to(F32)
    dev = clip.device
    x, y, z, w = clip.unbind(-1)
    keep = (w > w_eps).all(dim=1)
    inv_w = recip_exact(torch.where(w > w_eps, w, torch.ones((), dtype=F32, device=dev)))
    ndc_x, ndc_y, ndc_z = x * inv_w, y * inv_w, z * inv_w
    lim = float(1 << 30)
    xf = torch.round(torch.clamp(ndc_x * float(8 * width), -lim, lim)).to(I64) + 8 * width
    yf = torch.round(torch.clamp(ndc_y * float(8 * height), -lim, lim)).to(I64) + 8 * height
    xf = torch.clamp(xf, GUARD_LO, GUARD_HI)
    yf = torch.clamp(yf, GUARD_LO, GUARD_HI)
    a = yf - torch.roll(yf, -1, dims=1)
    b = torch.roll(xf, -1, dims=1) - xf
    area2 = (xf[:, 1] - xf[:, 0]) * (yf[:, 2] - yf[:, 0]) - (yf[:, 1] - yf[:, 0]) * (xf[:, 2] - xf[:, 0])
    keep &= area2 != 0
    is_front = area2 < 0 if front_face == "ccw" else area2 > 0
    if cull_mode == "back":
        keep &= is_front
    elif cull_mode == "front":
        keep &= ~is_front
    neg = area2 < 0
    a = torch.where(neg[:, None], -a, a)
    b = torch.where(neg[:, None], -b, b)
    area2 = area2.abs()
    pad = max(max(abs(dx), abs(dy)) for dx, dy in samples)

    def floor16(v):
        return torch.div(v, SUBPIXEL_SCALE, rounding_mode="floor")

    # pixel px is in the bbox iff px * 16 + 8 lies within pad of the snapped extent
    x0 = torch.clamp(-floor16(pad + HALF_PIXEL - xf.min(dim=1).values), min=0)
    y0 = torch.clamp(-floor16(pad + HALF_PIXEL - yf.min(dim=1).values), min=0)
    x1 = torch.clamp(floor16(xf.max(dim=1).values + pad - HALF_PIXEL) + 1, max=width)
    y1 = torch.clamp(floor16(yf.max(dim=1).values + pad - HALF_PIXEL) + 1, max=height)
    keep &= (x1 > x0) & (y1 > y0)

    idx = torch.nonzero(keep).squeeze(1)
    xf, yf, a, b, area2, ndc_z = xf[idx], yf[idx], a[idx], b[idx], area2[idx], ndc_z[idx]
    x0, x1, y0, y1 = x0[idx], x1[idx], y0[idx], y1[idx]
    bias = torch.where((a < 0) | ((a == 0) & (b < 0)), 0, -1).to(I64)
    inv_area = recip_exact(i64_to_f32(area2))
    zq = torch.clamp(torch.round(ndc_z * float(1 << DEPTH_LSB_BITS)).to(I64), -DEPTH_VERTEX_CLAMP,
                     DEPTH_VERTEX_CLAMP)
    num_x = a[:, 1] * zq[:, 0] + a[:, 2] * zq[:, 1] + a[:, 0] * zq[:, 2]
    num_y = b[:, 1] * zq[:, 0] + b[:, 2] * zq[:, 1] + b[:, 0] * zq[:, 2]
    gx = i64_to_f32(num_x) * inv_area
    gy = i64_to_f32(num_y) * inv_area
    slope = torch.maximum(gx.abs(), gy.abs()) * float(SUBPIXEL_SCALE)
    eb = (slope.contiguous().view(I32) >> 23) & 0xFF
    zshift = torch.clamp(eb - 141, 0, 24).to(I64)
    unit_scale = ((133 - zshift) << 23).to(I32).view(F32)
    gclamp = float(DEPTH_GRAD_CLAMP)
    dzdx_q = torch.round(torch.clamp((gx * float(SUBPIXEL_SCALE)) * unit_scale, -gclamp, gclamp)).to(I64)
    dzdy_q = torch.round(torch.clamp((gy * float(SUBPIXEL_SCALE)) * unit_scale, -gclamp, gclamp)).to(I64)
    return Setup(idx, xf, yf, a, b, bias, inv_area, zq[:, 0], gx, gy, zshift, unit_scale, dzdx_q, dzdy_q,
                 x0, x1, y0, y1)


def _pairs(s: Setup, lo: int, hi: int):
    """Every (triangle, pixel) pair of the bboxes of triangles lo..hi-1."""
    bw = s.x1[lo:hi] - s.x0[lo:hi]
    n = bw * (s.y1[lo:hi] - s.y0[lo:hi])
    t = torch.repeat_interleave(torch.arange(lo, hi, device=bw.device), n)
    start = torch.cumsum(n, 0) - n
    local = torch.arange(t.numel(), device=bw.device) - start[t - lo]
    bwt = bw[t - lo]
    return t, s.x0[t] + local % bwt, s.y0[t] + torch.div(local, bwt, rounding_mode="floor")


def _fragments(s: Setup, t, px, py, samples, depth_clip: bool = True):
    """Per pair: the pixel-centre edge values (3, P) and, per sample, the
    coverage and the quantized depth (S, P); under ``depth_clip`` a sample
    whose depth lies outside [0, 1] is not covered."""
    cx = px * SUBPIXEL_SCALE + HALF_PIXEL
    cy = py * SUBPIXEL_SCALE + HALF_PIXEL
    a, b = s.a[t], s.b[t]
    e = a * (cx[:, None] - s.xf[t]) + b * (cy[:, None] - s.yf[t])  # (P, 3)
    bias = s.bias[t]
    zshift = s.zshift[t]
    anchor_x = torch.div(px, DEPTH_TILE, rounding_mode="floor") * DEPTH_TILE
    anchor_y = torch.div(py, DEPTH_TILE, rounding_mode="floor") * DEPTH_TILE
    lim = float(1 << 30)
    dxf = (anchor_x * SUBPIXEL_SCALE + HALF_PIXEL - s.xf[t, 0]).to(F32)
    dyf = (anchor_y * SUBPIXEL_SCALE + HALF_PIXEL - s.yf[t, 0]).to(F32)
    us = s.unit_scale[t]
    tx = torch.round(torch.clamp((s.gx[t] * dxf) * us, -lim, lim)).to(I64)
    ty = torch.round(torch.clamp((s.gy[t] * dyf) * us, -lim, lim)).to(I64)
    mid_u = (1 << 29) >> zshift
    down = torch.clamp(zshift - DEPTH_FRAC_BITS, min=0)
    up = torch.clamp(DEPTH_FRAC_BITS - zshift, min=0)
    base = (s.zq0[t] >> down) * (1 << up) - mid_u
    clampv = mid_u + (1 << 29)
    z_tile = torch.minimum(torch.maximum(base + tx + ty, -clampv), clampv)
    dzdx, dzdy = s.dzdx_q[t], s.dzdy_q[t]
    z_u = z_tile + dzdx * (px - anchor_x) + dzdy * (py - anchor_y)
    hi_c = mid_u + 1
    cov, zpix = [], []
    for ddx, ddy in samples:
        c = ((e + (a * ddx + b * ddy) + bias) >= 0).all(dim=1)
        dz = (dzdx * ddx + dzdy * ddy) >> 4
        z = (torch.minimum(torch.maximum(z_u + dz, -hi_c), hi_c) << zshift) + (1 << 29)
        cov.append(c & (z >= 0) & (z <= DEPTH_ONE_Q) if depth_clip else c)
        zpix.append(z)
    return e.T, torch.stack(cov), torch.stack(zpix)


class Visibility(NamedTuple):
    tri: torch.Tensor  # (S, H, W) int64 input triangle index of the winner, -1 where none
    depth_q: torch.Tensor  # (S, H, W) int32
    bary: torch.Tensor  # (S, H, W, 3) f32 barycentrics at the pixel centre of the winner


def rasterize(clip: torch.Tensor, width: int, height: int, samples=CENTER, cull_mode: str = "none",
              front_face: str = "ccw", depth_clear: float = 1.0, max_pairs: int = 1 << 24,
              depth_clip: bool = True) -> Visibility:
    """The visibility buffer of (T, 3, 4) clip positions drawn in order
    under the depth test ``less`` with writes, with or without depth
    clipping."""
    dev = clip.device
    ns = len(samples)
    s = setup(clip, width, height, samples, cull_mode, front_face)
    clear_q = int(round(depth_clear * DEPTH_ONE_Q))
    npx = height * width
    clear_key = (clear_q << 32) | 0xFFFFFFFF
    best = torch.full((ns * npx,), clear_key, dtype=I64, device=dev)
    n = (s.x1 - s.x0) * (s.y1 - s.y0)
    ends = torch.cumsum(n, 0)
    lo = 0
    r = n.numel()
    while lo < r:
        # the largest hi with pairs(lo..hi) <= max_pairs, and at least one triangle
        before = int(ends[lo - 1]) if lo else 0
        hi = max(int(torch.searchsorted(ends, before + max_pairs, right=True)), lo + 1)
        t, px, py = _pairs(s, lo, hi)
        _, cov, zpix = _fragments(s, t, px, py, samples, depth_clip)
        pix = py * width + px
        for k in range(ns):
            ok = cov[k] & (zpix[k] < clear_q)
            key = (zpix[k][ok] << 32) | t[ok]
            best.scatter_reduce_(0, pix[ok] + k * npx, key, reduce="amin")
        lo = hi
    won = best != clear_key
    local = torch.where(won, best & 0xFFFFFFFF, -1)
    depth_q = torch.where(won, best >> 32, clear_q).to(I32)
    # Barycentrics of each winner at its pixel centre (the oracle's bary).
    bary = torch.zeros((ns * npx, 3), dtype=F32, device=dev)
    where = torch.nonzero(won).squeeze(1)
    if where.numel():
        t = local[where]
        p = where % npx
        e, _, _ = _fragments(s, t, p % width, torch.div(p, width, rounding_mode="floor"), CENTER)
        e_f = i64_to_f32(e)
        ia = s.inv_area[t]
        bary[where] = torch.stack([e_f[1] * ia, e_f[2] * ia, e_f[0] * ia], dim=1)
    tri = torch.where(won, s.index[local.clamp(min=0)], -1)
    return Visibility(tri.reshape(ns, height, width), depth_q.reshape(ns, height, width),
                      bary.reshape(ns, height, width, 3))
