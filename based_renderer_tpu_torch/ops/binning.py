"""Triangle-to-tile binning for the tile rasterizer.

The PyTorch counterpart of ``based_renderer_tpu/ops/binning.py`` with its
``assemble="xla"``, ``tmpl="xla"`` semantics: expand each triangle into
(tile, triangle) pairs over its clipped tile bounding box (a triangle's
first tile directly, its extra tiles through a searchsorted expansion),
order the pairs by (tile, triangle), and emit a field-major record stream
re-anchored at each tile's origin.  The stream is bit-identical to the
JAX binner's, tail slots included.

int records (int32, RECORD_WIDTH rows), per (tile, tri) pair:
  0..2   eb0..eb2   edge values at the tile-origin pixel center, clamped
                    to +/-ANCHOR_CLAMP, fill-rule bias folded in
  3..5   ax0..ax2   per-pixel x-step of each edge (A * 16)
  6..8   ay0..ay2   per-pixel y-step of each edge (B * 16)
  9      zo         quantized depth plane at the tile origin (biased units)
  10,11  dzx, dzy   per-pixel depth steps (units)
  12     zshift     per-triangle depth exponent
  13     tri_id     global triangle id (draw order)
  14..15 zero
float records (f32, frecord_width(K) rows): planes q_o, dq_dx, dq_dy
anchored at the tile origin for b0 (0..2), b1 (3..5), invw (6..8) and the
K channels (9..9+3K), then tri_id as f32, then zero padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.errors import FeatureNotPresentError
from . import fixedpoint as fp
from .setup import TriSetup, depth_tile_anchor

RECORD_WIDTH = 16
FRECORD_BASE = 9  # b0 plane, b1 plane, invw plane
SEGMENT_ALIGN = 128  # zero tail appended to both record arrays


def frecord_width(num_channels: int) -> int:
    """Float record rows: planes + the f32 tri-id column, rounded to 8."""
    w = FRECORD_BASE + 3 * num_channels + 1
    return (w + 7) // 8 * 8


def ftid_col(num_channels: int) -> int:
    """Row of the f32 triangle id in the float records."""
    return FRECORD_BASE + 3 * num_channels


class BinnedTriangles(NamedTuple):
    records: torch.Tensor  # (RECORD_WIDTH, P + SEGMENT_ALIGN) int32
    frecords: torch.Tensor  # (frecord_width(K), P + SEGMENT_ALIGN) float32
    tile_start: torch.Tensor  # (num_tiles,) int32 first sorted slot of the tile
    tile_count: torch.Tensor  # (num_tiles,) int32 records of the tile
    num_pairs: torch.Tensor  # () int32 true pair count (pre-truncation)
    overflowed: torch.Tensor  # () bool true pair count exceeded the budget


def _check_modes(assemble: str, tmpl: str):
    for knob, value, step in (("assemble", assemble, "B3"), ("tmpl", tmpl, "B8")):
        if value == "pallas":
            raise FeatureNotPresentError(
                f"{knob}='pallas' is a TPU kernel not ported yet (ROADMAP queue B, {step})"
            )
        if value != "xla":
            raise ValueError(f"{knob} must be 'xla' or 'pallas', got {value!r}")


def bin_triangles(
    ts: TriSetup,
    width: int,
    height: int,
    tile_w: int = 128,
    tile_h: int = 32,
    max_pairs: int | None = None,
    id_offset: int = 0,
    channels: torch.Tensor | None = None,
    perspective: bool = True,
    slots: int | None = None,
    assemble: str = "xla",
    tmpl: str = "xla",
) -> BinnedTriangles:
    """Bin triangles into screen tiles (tile dims must divide 128).

    ``max_pairs`` bounds the expansion stream (default max(4T, 1024)):
    the first tile of every live triangle always has a slot, and extra
    tiles beyond ``max_pairs - T`` are dropped with ``overflowed`` set.
    ``slots`` cuts the sorted stream to a static budget (rounded up to a
    multiple of 128); a cut that drops live pairs sets ``overflowed`` too.
    ``channels`` are (T, 3, K) per-vertex varyings interpolated as planes
    (divided by w first when ``perspective``).
    """
    _check_modes(assemble, tmpl)
    for d in (tile_w, tile_h):
        if d <= 0 or 128 % d:
            raise ValueError(f"tile dims must divide 128, got {(tile_w, tile_h)}")
    dev = ts.valid.device
    i64 = torch.int64
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    num_tiles = num_tx * num_ty
    num_tris = ts.valid.shape[0]
    nch = 0 if channels is None else channels.shape[-1]
    if max_pairs is None:
        max_pairs = max(4 * num_tris, 1024)
    fw = frecord_width(nch)
    if num_tris == 0:
        padded = max_pairs + SEGMENT_ALIGN
        zeros_i = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
        return BinnedTriangles(
            records=torch.zeros((RECORD_WIDTH, padded), dtype=torch.int32, device=dev),
            frecords=torch.zeros((fw, padded), dtype=torch.float32, device=dev),
            tile_start=zeros_i,
            tile_count=zeros_i.clone(),
            num_pairs=torch.zeros((), dtype=torch.int32, device=dev),
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
        )

    # ---- pair expansion (first-tile / extras split) ----------------------
    bbox = ts.bbox.to(i64)
    bx0 = bbox[:, 0].clamp_min(0)
    by0 = bbox[:, 1].clamp_min(0)
    bx1 = bbox[:, 2].clamp_max(width)
    by1 = bbox[:, 3].clamp_max(height)
    nonempty = (bx1 > bx0) & (by1 > by0)
    x0 = torch.div(bx0, tile_w, rounding_mode="floor")
    y0 = torch.div(by0, tile_h, rounding_mode="floor")
    x1 = torch.div(bx1 - 1, tile_w, rounding_mode="floor")
    y1 = torch.div(by1 - 1, tile_h, rounding_mode="floor")
    live = ts.valid & nonempty
    bw = torch.where(live, x1 - x0 + 1, 0)
    bh = torch.where(live, y1 - y0 + 1, 0)
    k = bw * bh

    num_valid_pairs = live.sum()
    first_tile = torch.where(live, y0 * num_tx + x0, num_tiles)
    tri_ids = torch.arange(num_tris, dtype=i64, device=dev)

    extra_budget = max(max_pairs - num_tris, 0)
    ke = (k - 1).clamp_min(0)  # extra tiles per triangle
    eends = torch.cumsum(ke, 0)
    estarts = eends - ke
    total_extra = eends[-1]
    overflowed = total_extra > extra_budget
    true_pairs = num_valid_pairs + total_extra
    total = num_valid_pairs + total_extra.clamp_max(extra_budget)

    # The owning triangle of extra slot j is searchsorted(ends, j, right).
    extra_idx = torch.arange(extra_budget, dtype=i64, device=dev)
    owner = torch.searchsorted(eends, extra_idx, right=True).clamp_max(num_tris - 1)
    seq = extra_idx - estarts[owner] + 1  # skip the first tile (row-major)
    bw_o = bw.clamp_min(1)[owner]
    e_tile_y = y0[owner] + torch.div(seq, bw_o, rounding_mode="floor")
    e_tile_x = x0[owner] + torch.remainder(seq, bw_o)
    e_tile = torch.where(extra_idx < total_extra, e_tile_y * num_tx + e_tile_x, num_tiles)

    # One sort on the int64 key (tile << 32) | tri: tri is the draw order,
    # and live keys are unique, so the order comes from the keys alone.
    # Dead slots (sentinel tile == num_tiles) sort to the tail; equal dead
    # keys are identical, so they need no tie-break either.
    tile_all = torch.cat([first_tile, e_tile])
    tri_all = torch.cat([tri_ids, owner])
    key, _ = torch.sort((tile_all << 32) | tri_all)
    stream_len = num_tris + extra_budget
    if slots is not None and slots < stream_len:
        slots = max(-(-slots // SEGMENT_ALIGN) * SEGMENT_ALIGN, SEGMENT_ALIGN)
        if slots < stream_len:
            key = key[:slots]
            overflowed = overflowed | (true_pairs > slots)
            total = total.clamp_max(slots)
            stream_len = slots
    tile_sorted = key >> 32
    t_slot = key & 0xFFFFFFFF

    tile_range = torch.arange(num_tiles, dtype=i64, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tile_range)
    tile_end = torch.searchsorted(tile_sorted, tile_range, right=True)
    count = tile_end - tile_start

    invalid = torch.arange(stream_len, dtype=i64, device=dev) >= total
    slot_tile = tile_sorted.clamp(0, num_tiles - 1)
    ox = torch.remainder(slot_tile, num_tx) * tile_w  # tile-origin pixel
    oy = torch.div(slot_tile, num_tx, rounding_mode="floor") * tile_h

    # ---- per-slot record assembly from per-triangle templates ------------
    a = ts.a.to(i64)
    b = ts.b.to(i64)
    origin = torch.full((num_tris, 1), fp.HALF_PIXEL, dtype=torch.int32, device=dev)
    # Exact biased edge values at the pixel-(0, 0) center.
    e = fp.edge_at_point_exact(ts.xf, ts.yf, a, b, origin, origin) + ts.bias.to(i64)
    a_s, b_s, e_s = a[t_slot], b[t_slot], e[t_slot]
    eb = (e_s + a_s * (ox * fp.SUBPIXEL_SCALE)[:, None] + b_s * (oy * fp.SUBPIXEL_SCALE)[:, None])
    eb = eb.clamp(-fp.ANCHOR_CLAMP, fp.ANCHOR_CLAMP)

    dzx = ts.dzdx_q[t_slot].to(i64)
    dzy = ts.dzdy_q[t_slot].to(i64)
    zshift = ts.zshift[t_slot]
    can_x = torch.div(ox, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    can_y = torch.div(oy, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    z_can = depth_tile_anchor(
        ts.zq[t_slot, 0],
        ts.xf[t_slot, 0].to(i64),
        ts.yf[t_slot, 0].to(i64),
        ts.gx[t_slot],
        ts.gy[t_slot],
        zshift,
        can_x,
        can_y,
    )
    zo = z_can + dzx * (ox - can_x) + dzy * (oy - can_y)
    tid = t_slot + int(id_offset)

    # Invalid slots: coverage impossible (edge very negative, steps 0).
    inv = invalid[:, None]
    scale = fp.SUBPIXEL_SCALE
    rec = torch.cat(
        [
            torch.where(inv, -(1 << 30), eb),
            torch.where(inv, 0, a_s * scale),
            torch.where(inv, 0, b_s * scale),
            torch.stack([zo, dzx, dzy, zshift.to(i64), tid], dim=1),
        ],
        dim=1,
    )
    records = torch.zeros((RECORD_WIDTH, stream_len + SEGMENT_ALIGN), dtype=torch.int32, device=dev)
    records[:14, :stream_len] = rec.T.to(torch.int32)

    # Barycentric planes anchored at the pixel-(0, 0) center, from the
    # exact origin edge values; then re-anchored at the tile origin.
    inv_area = ts.inv_area
    ef = fp.i64_to_f32(e)
    af = ts.a.to(torch.float32)
    bf = ts.b.to(torch.float32)
    sc = fp.f32(fp.SUBPIXEL_SCALE, inv_area)
    b0p = (ef[:, 1] * inv_area, af[:, 1] * sc * inv_area, bf[:, 1] * sc * inv_area)
    b1p = (ef[:, 2] * inv_area, af[:, 2] * sc * inv_area, bf[:, 2] * sc * inv_area)
    b2p = (1.0 - (b0p[0] + b1p[0]), -(b0p[1] + b1p[1]), -(b0p[2] + b1p[2]))

    def plane_of(q):  # (T, 3) per-vertex values -> plane triple
        return [q[:, 0] * b0p[i] + q[:, 1] * b1p[i] + q[:, 2] * b2p[i] for i in range(3)]

    iw = ts.inv_w
    planes = list(b0p) + list(b1p) + plane_of(iw)
    if channels is not None:
        ch = channels * iw[:, :, None] if perspective else channels
        for kk in range(nch):
            planes += plane_of(ch[:, :, kk])
    tmpl_f = torch.stack(planes, dim=0)[:, t_slot]  # (9 + 3K, stream)
    oxf = ox.to(torch.float32)
    oyf = oy.to(torch.float32)
    frecords = torch.zeros((fw, stream_len + SEGMENT_ALIGN), dtype=torch.float32, device=dev)
    for p in range(3 + nch):  # b0, b1, invw, channels...
        p00, pdx, pdy = tmpl_f[3 * p], tmpl_f[3 * p + 1], tmpl_f[3 * p + 2]
        frecords[3 * p, :stream_len] = p00 + pdx * oxf + pdy * oyf
        frecords[3 * p + 1, :stream_len] = pdx
        frecords[3 * p + 2, :stream_len] = pdy
    frecords[ftid_col(nch), :stream_len] = tid.to(torch.float32)

    return BinnedTriangles(
        records=records,
        frecords=frecords,
        tile_start=tile_start.to(torch.int32),
        tile_count=count.to(torch.int32),
        num_pairs=true_pairs.to(torch.int32),
        overflowed=overflowed,
    )
