"""Triangle-to-tile binning for the tile rasterizer.

The PyTorch counterpart of ``based_renderer_tpu/ops/binning.py``: expand
each triangle into (tile, triangle) pairs over its clipped tile bounding
box (a triangle's first tile directly, its extra tiles through a
searchsorted expansion), order the pairs by (tile, triangle), and emit a
field-major record stream re-anchored at each tile's origin.  The stream
is bit-identical to the JAX binner's, tail slots included, under both
assemblies: ``assemble="xla"`` (the plain assembly, a zero tail of
SEGMENT_ALIGN slots) and ``assemble="pallas"`` (the CUDA kernel of
``ops/binassem.py`` on CUDA tensors, over a stream padded to a multiple
of 128 whose tail slots are assembled as invalid records).

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
  16..21 A0..A2, B0..B2 raw per-subpixel edge coefficients (msaa4 only:
                    RECORD_WIDTH_MSAA rows; 0 on invalid slots)
  22..23 zero (msaa4 only)
float records (f32, frecord_width(K) rows): planes q_o, dq_dx, dq_dy
anchored at the tile origin for b0 (0..2), b1 (3..5), invw (6..8) and the
K channels (9..9+3K), then tri_id as f32, then zero padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import binassem
from . import fixedpoint as fp
from .binassem import RECORD_WIDTH, Templates, record_width  # noqa: F401 (RECORD_WIDTH re-exported)
from .templates import template_planes

FRECORD_BASE = 9  # b0 plane, b1 plane, invw plane
SEGMENT_ALIGN = 128  # zero tail appended to both record arrays


def frecord_width(num_channels: int) -> int:
    """Float record rows: planes + the f32 tri-id column, rounded to 8."""
    w = FRECORD_BASE + 3 * num_channels + 1
    return (w + 7) // 8 * 8


def ftid_col(num_channels: int) -> int:
    """Row of the f32 triangle id in the float records."""
    return FRECORD_BASE + 3 * num_channels


def pallas_assembly_fits(num_channels: int) -> bool:
    """Whether ``assemble="pallas"`` takes the kernel assembly for K channels.

    The JAX package gathers a template row of 19 int and 2 + 3 * (3 + K)
    float columns padded to a multiple of 64, and its Pallas assembly
    takes rows of at most 128 (JAX binning.py:476); wider rows fall back
    to the XLA layout there, and so they do here.
    """
    width = 19 + 2 + 3 * (3 + num_channels)
    return -(-width // 64) * 64 <= 128


class BinnedTriangles(NamedTuple):
    records: torch.Tensor  # (record_width(msaa4), P_pad) int32
    frecords: torch.Tensor  # (frecord_width(K), P_pad) float32
    tile_start: torch.Tensor  # (num_tiles,) int32 first sorted slot of the tile
    tile_count: torch.Tensor  # (num_tiles,) int32 records of the tile
    num_pairs: torch.Tensor  # () int32 true pair count (pre-truncation)
    overflowed: torch.Tensor  # () bool true pair count exceeded the budget
    pair_budget_use: torch.Tensor  # () float64 share of the budget the true stream needs (> 1: overflowed)


class PairStream(NamedTuple):
    """The sorted pair stream before record assembly (the kernel's inputs)."""

    tmpl: Templates
    t_slot: torch.Tensor  # (P,) int64 triangle of each sorted slot
    ox: torch.Tensor  # (P,) int64 tile-origin pixel x of each slot
    oy: torch.Tensor  # (P,) int64
    total: torch.Tensor  # () int64 live slots
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_count: torch.Tensor  # (num_tiles,) int32
    num_pairs: torch.Tensor  # () int32
    overflowed: torch.Tensor  # () bool
    pair_budget_use: torch.Tensor  # () float64


def _budget_use(count: torch.Tensor, budget: int) -> torch.Tensor:
    """``count / budget`` as a () float64 tensor, in one kernel; a zero
    budget reads 0 when nothing wants it and inf when something does.

    The budget goes in as a float64 host scalar, so the quotient is float64
    in that one kernel.  It is above 1 exactly when ``count > budget`` for
    every budget below about 2^50, whether computed as a division (the CPU)
    or as a product with the reciprocal of ``budget`` (CUDA's division by a
    host scalar): budget * fl(1 / budget) rounds to at most 1, and
    (budget + 1) / budget lies more than an ulp above 1."""
    if budget == 0:
        return torch.where(count > 0, float("inf"), 0.0).to(torch.float64)
    return count / torch.tensor(float(budget), dtype=torch.float64)


def _check_modes(assemble: str, tmpl: str):
    for knob, value in (("assemble", assemble), ("tmpl", tmpl)):
        if value not in ("xla", "pallas"):
            raise ValueError(f"{knob} must be 'xla' or 'pallas', got {value!r}")


def _templates(ts, id_offset, channels, perspective) -> Templates:
    """Per-triangle templates, anchored at the pixel-(0, 0) centre.

    ``id_offset``: an int offsets the draw-order ids (triangle index +
    id_offset); a (T,) int tensor gives each triangle its id (a culled
    draw's original ids, JAX binning.py:143-153).  Either way the (tile,
    triangle) sort key uses the local stream index, so keys stay unique.
    """
    dev = ts.valid.device
    num_tris = ts.valid.shape[0]
    i64 = torch.int64
    origin = torch.full((num_tris, 1), fp.HALF_PIXEL, dtype=torch.int32, device=dev)
    # Exact biased edge values at the pixel-(0, 0) center.
    e = fp.edge_at_point_exact(ts.xf, ts.yf, ts.a, ts.b, origin, origin) + ts.bias.to(i64)

    return Templates(
        a=ts.a.contiguous(),
        b=ts.b.contiguous(),
        e=e.contiguous(),
        dzdx=ts.dzdx_q.contiguous(),
        dzdy=ts.dzdy_q.contiguous(),
        zshift=ts.zshift.contiguous(),
        zq=ts.zq.contiguous(),
        xf=ts.xf.contiguous(),
        yf=ts.yf.contiguous(),
        gx=ts.gx.contiguous(),
        gy=ts.gy.contiguous(),
        planes=template_planes(e, ts.a, ts.b, ts.inv_area, ts.inv_w, channels, perspective),
        id_offset=id_offset.to(torch.int32).contiguous() if isinstance(id_offset, torch.Tensor) else int(id_offset),
    )


def templates_field_major(tmpl: Templates) -> tuple[torch.Tensor, int]:
    """The field-major template matrix of ``tmpl="pallas"`` and its row width.

    The counterpart of the JAX package's ``_triangle_templates(...,
    transposed=True)`` and the concatenation and padding after it
    (binning.py:427-448): (W8, T) int32, one row per template column in
    the layout of binassem.TEMPLATE_COLUMNS (float rows bitcast), zero rows
    up to W8 = ceil8(n_all); the gathered row width is ceil64(n_all).
    """
    i32 = torch.int32
    num_tris = tmpl.a.shape[0]
    hi = tmpl.e >> 32
    lo = tmpl.e - (hi << 32)  # the low word in [0, 2^32)
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)  # ... as int32
    if isinstance(tmpl.id_offset, torch.Tensor):
        tri_ids = tmpl.id_offset
    else:
        tri_ids = torch.arange(num_tris, dtype=i32, device=tmpl.a.device) + tmpl.id_offset
    ints = [tmpl.a[:, i] for i in range(3)] + [tmpl.b[:, i] for i in range(3)]
    for i in range(3):
        ints += [hi[:, i].to(i32), lo[:, i].to(i32)]
    ints += [tmpl.dzdx, tmpl.dzdy, tmpl.zshift, tri_ids, tmpl.zq[:, 0], tmpl.xf[:, 0], tmpl.yf[:, 0]]
    floats = torch.cat([tmpl.gx[None], tmpl.gy[None], tmpl.planes.T], dim=0).view(i32)
    n_all = len(ints) + floats.shape[0]
    w8 = -(-n_all // 8) * 8
    fused_t = torch.cat([torch.stack(ints), floats, floats.new_zeros((w8 - n_all, num_tris))])
    return fused_t, -(-n_all // 64) * 64


def pair_stream(
    ts,
    width: int,
    height: int,
    tile_w: int = 128,
    tile_h: int = 32,
    max_pairs: int | None = None,
    id_offset: int | torch.Tensor = 0,
    channels: torch.Tensor | None = None,
    perspective: bool = True,
    slots: int | None = None,
    col_major_ids: bool = False,
    anchor_rows: int | None = None,
    origin: tuple[int, int] = (0, 0),
) -> PairStream:
    """Expand, sort and cut the (tile, triangle) pairs; see bin_triangles.

    Needs at least one triangle.
    """
    dev = ts.valid.device
    i64 = torch.int64
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    num_tiles = num_tx * num_ty
    num_tris = ts.valid.shape[0]
    if max_pairs is None:
        max_pairs = max(4 * num_tris, 1024)

    # ---- pair expansion (first-tile / extras split) ----------------------
    # Bboxes are global: clip them to this window, so tile indices are
    # local to its grid.
    org_x, org_y = (int(v) for v in origin)
    bbox = ts.bbox.to(i64)
    bx0 = (bbox[:, 0] - org_x).clamp_min(0)
    by0 = (bbox[:, 1] - org_y).clamp_min(0)
    bx1 = (bbox[:, 2] - org_x).clamp_max(width)
    by1 = (bbox[:, 3] - org_y).clamp_max(height)
    nonempty = (bx1 > bx0) & (by1 > by0)
    x0 = torch.div(bx0, tile_w, rounding_mode="floor")
    y0 = torch.div(by0, tile_h, rounding_mode="floor")
    x1 = torch.div(bx1 - 1, tile_w, rounding_mode="floor")
    y1 = torch.div(by1 - 1, tile_h, rounding_mode="floor")
    live = ts.valid & nonempty
    bw = torch.where(live, x1 - x0 + 1, 0)
    bh = torch.where(live, y1 - y0 + 1, 0)
    k = bw * bh

    def tile_id(tx, ty):
        # Column-major ids keep the bands of one raster tile contiguous
        # in the sorted stream (band binning); row-major otherwise.
        return tx * num_ty + ty if col_major_ids else ty * num_tx + tx

    num_valid_pairs = live.sum()
    first_tile = torch.where(live, tile_id(x0, y0), num_tiles)
    tri_ids = torch.arange(num_tris, dtype=i64, device=dev)

    extra_budget = max(max_pairs - num_tris, 0)
    ke = (k - 1).clamp_min(0)  # extra tiles per triangle
    eends = torch.cumsum(ke, 0)
    estarts = eends - ke
    total_extra = eends[-1]
    true_pairs = num_valid_pairs + total_extra
    total = num_valid_pairs + total_extra.clamp_max(extra_budget)
    # The share of the budget the true stream needs: the extras' share,
    # and below the slot cut that of the slots.  The overflow flag is read
    # off it, so the count costs one kernel a draw.
    use = _budget_use(total_extra, extra_budget)

    # The owning triangle of extra slot j is searchsorted(ends, j, right).
    extra_idx = torch.arange(extra_budget, dtype=i64, device=dev)
    owner = torch.searchsorted(eends, extra_idx, right=True).clamp_max(num_tris - 1)
    seq = extra_idx - estarts[owner] + 1  # skip the first tile (row-major)
    bw_o = bw.clamp_min(1)[owner]
    e_tile_y = y0[owner] + torch.div(seq, bw_o, rounding_mode="floor")
    e_tile_x = x0[owner] + torch.remainder(seq, bw_o)
    e_tile = torch.where(extra_idx < total_extra, tile_id(e_tile_x, e_tile_y), num_tiles)

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
            use = torch.maximum(use, _budget_use(true_pairs, slots))
            total = total.clamp_max(slots)
    overflowed = use > 1
    tile_sorted = key >> 32
    t_slot = key & 0xFFFFFFFF

    tile_range = torch.arange(num_tiles, dtype=i64, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tile_range)
    tile_end = torch.searchsorted(tile_sorted, tile_range, right=True)

    slot_tile = tile_sorted.clamp(0, num_tiles - 1)
    if col_major_ids:
        s_tile_x = torch.div(slot_tile, num_ty, rounding_mode="floor")
        s_tile_y = torch.remainder(slot_tile, num_ty)
    else:
        s_tile_x = torch.remainder(slot_tile, num_tx)
        s_tile_y = torch.div(slot_tile, num_tx, rounding_mode="floor")
    ox = s_tile_x * tile_w + org_x  # tile-origin pixel, global
    if anchor_rows is not None:
        # Anchor at the OUTPUT tile holding this band, so band-binned record
        # contents (f32 planes included) equal the unbanded stream's.
        if anchor_rows % tile_h:
            raise ValueError(f"anchor_rows {anchor_rows} must be a multiple of tile_h {tile_h}")
        oy = torch.div(s_tile_y, anchor_rows // tile_h, rounding_mode="floor") * anchor_rows + org_y
    else:
        oy = s_tile_y * tile_h + org_y

    return PairStream(
        tmpl=_templates(ts, id_offset, channels, perspective),
        t_slot=t_slot,
        ox=ox,
        oy=oy,
        total=total,
        tile_start=tile_start.to(torch.int32),
        tile_count=(tile_end - tile_start).to(torch.int32),
        num_pairs=true_pairs.to(torch.int32),
        overflowed=overflowed,
        pair_budget_use=use,
    )


def padded_slots(ps: PairStream):
    """(t_slot, ox, oy) zero-padded to the kernel assembly's stream length,
    a multiple of 128 with at least SEGMENT_ALIGN tail slots."""
    n = ps.t_slot.shape[0]
    pad = -(-(n + SEGMENT_ALIGN) // 128) * 128 - n
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in (ps.t_slot, ps.ox, ps.oy))


def bin_triangles(
    ts,
    width: int,
    height: int,
    tile_w: int = 128,
    tile_h: int = 32,
    max_pairs: int | None = None,
    id_offset: int | torch.Tensor = 0,
    channels: torch.Tensor | None = None,
    perspective: bool = True,
    slots: int | None = None,
    assemble: str = "xla",
    tmpl: str = "xla",
    col_major_ids: bool = False,
    anchor_rows: int | None = None,
    msaa4: bool = False,
    origin: tuple[int, int] = (0, 0),
) -> BinnedTriangles:
    """Bin triangles into screen tiles (tile dims must divide 128).

    ``max_pairs`` bounds the expansion stream (default max(4T, 1024)):
    the first tile of every live triangle always has a slot, and extra
    tiles beyond ``max_pairs - T`` are dropped with ``overflowed`` set.
    ``slots`` cuts the sorted stream to a static budget (rounded up to a
    multiple of 128); a cut that drops live pairs sets ``overflowed`` too.
    ``pair_budget_use`` is the largest share of either budget that the
    true stream needs, max(extras / (max_pairs - T), true pairs / slots),
    the second only where the cut applies: above 1 exactly when
    ``overflowed``, and how close a draw came to it otherwise.
    ``channels`` are (T, 3, K) per-vertex varyings interpolated as planes
    (divided by w first when ``perspective``).  ``id_offset`` is an int
    added to each triangle's index, or a (T,) int32 tensor of per-triangle
    ids, which the records carry in place of index + offset (both
    assemblies, both template layouts).  ``col_major_ids`` and
    ``anchor_rows`` serve band binning (see the JAX package's binner):
    column-major tile ids, and records anchored at the enclosing output
    tile of ``anchor_rows`` pixel rows.  ``msaa4`` gives the 24-row
    records of coverage MSAA-4x (raw edge coefficients in rows 16-21).
    ``tmpl="pallas"`` builds the templates field-major, transposes them to
    one row per triangle (binassem.transpose_templates) and assembles from
    those rows; the records are the same bit for bit.
    ``origin`` is the global pixel of this framebuffer's top-left corner:
    (0, 0) on one device, a window's corner under parallel.TiledRenderer.
    ``width`` and ``height`` are then the window's extent, bboxes are
    clipped to it, and every record is anchored at its tile's global
    origin, so a window's records equal the whole frame's for the same
    tiles.  The depth-anchor proofs need the origin to be a multiple of
    the tile dims (JAX binning.py:232-241).
    """
    _check_modes(assemble, tmpl)
    for d in (tile_w, tile_h):
        if d <= 0 or 128 % d:
            raise ValueError(f"tile dims must divide 128, got {(tile_w, tile_h)}")
    dev = ts.valid.device
    num_tiles = -(-width // tile_w) * -(-height // tile_h)
    num_tris = ts.valid.shape[0]
    nch = 0 if channels is None else channels.shape[-1]
    if max_pairs is None:
        max_pairs = max(4 * num_tris, 1024)
    fw = frecord_width(nch)
    if num_tris == 0:
        padded = max_pairs + SEGMENT_ALIGN
        zeros_i = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
        return BinnedTriangles(
            records=torch.zeros((record_width(msaa4), padded), dtype=torch.int32, device=dev),
            frecords=torch.zeros((fw, padded), dtype=torch.float32, device=dev),
            tile_start=zeros_i,
            tile_count=zeros_i.clone(),
            num_pairs=torch.zeros((), dtype=torch.int32, device=dev),
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
            pair_budget_use=torch.zeros((), dtype=torch.float64, device=dev),
        )

    ps = pair_stream(
        ts, width, height, tile_w, tile_h, max_pairs, id_offset, channels, perspective,
        slots, col_major_ids, anchor_rows, origin,
    )
    kernel_assembly = assemble == "pallas" and pallas_assembly_fits(nch)
    if tmpl == "pallas":
        fused_t, row_width = templates_field_major(ps.tmpl)
        fused = binassem.transpose_templates(fused_t, row_width)
        if kernel_assembly:
            records, frecords = binassem.assemble_records_rows(
                fused, *padded_slots(ps), ps.total, fw, nch, msaa4
            )
        else:
            records, frecords = binassem.assemble_records_rows_reference(
                fused, ps.t_slot, ps.ox, ps.oy, ps.total, fw, nch, msaa4
            )
    elif kernel_assembly:
        records, frecords = binassem.assemble_records(ps.tmpl, *padded_slots(ps), ps.total, fw, msaa4)
    else:
        records, frecords = binassem.assemble_records_reference(
            ps.tmpl, ps.t_slot, ps.ox, ps.oy, ps.total, fw, msaa4
        )
    if not kernel_assembly:
        tail = (0, SEGMENT_ALIGN)
        records = torch.nn.functional.pad(records, tail)
        frecords = torch.nn.functional.pad(frecords, tail)
    return BinnedTriangles(
        records=records,
        frecords=frecords,
        tile_start=ps.tile_start,
        tile_count=ps.tile_count,
        num_pairs=ps.num_pairs,
        overflowed=ps.overflowed,
        pair_budget_use=ps.pair_budget_use,
    )
