"""Post-sort record assembly and the template transpose: CUDA kernels and
their plain versions.

The PyTorch counterpart of ``based_renderer_tpu/ops/binassem.py``.

``assemble_records`` (the Pallas ``_assemble_kernel``): given the sorted
(tile, triangle) pair stream, every slot of the record stream is
assembled from its triangle's per-triangle template: the three edge
values stepped from the pixel-(0, 0) centre to the slot's tile origin in
int64 and clamped to +/-ANCHOR_CLAMP, the quantized depth plane anchored
on the canonical 128-px grid and stepped to the tile origin, the f32
planes re-anchored as (p00 + pdx*ox) + pdy*oy, and the triangle id.
Slots at or past ``total`` get impossible edges (-2^30, zero steps); their
other fields are still assembled from the slot's triangle, as the TPU
kernel does.

Under ``msaa4`` the records are RECORD_WIDTH_MSAA rows wide: rows 16-21
carry the raw (per-subpixel) edge coefficients A0..A2, B0..B2, zero on
invalid slots, so the MSAA rasters can step the pixel-center edge values
to the four sample positions; rows 22-23 are zero.

Two template layouts feed the assembly.  The default (``tmpl="xla"``)
reads each field straight from the per-triangle tensors of ``Templates``.
Under ``tmpl="pallas"`` the binner builds the templates field-major, one
(W8, T) int32 matrix in the JAX column layout (see TEMPLATE_COLUMNS),
``transpose_templates`` (the Pallas ``_transpose_kernel``) turns it into
one row per triangle, and ``assemble_records_rows`` reads every slot's
fields from its triangle's row.

Each wrapper launches its kernel (``csrc/assemble_records.cu``,
``csrc/transpose_templates.cu``) on CUDA tensors and runs its plain
version on CPU tensors.  The plain versions are also the binner's
``assemble="xla"`` assembly under either layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from . import fixedpoint as fp
from .setup import depth_tile_anchor

RECORD_WIDTH = 16
RECORD_WIDTH_MSAA = 24  # + raw A0..A2, B0..B2 (rows 16-21) and two zero rows
INVALID_EDGE = -(1 << 30)  # edge value that no pixel of a tile can reach

# The JAX column layout of a template row (based_renderer_tpu/ops/binassem.py):
#   int   0..2 A0..A2   3..5 B0..B2   6..11 origin edge values as (hi, lo)
#         int32 pairs, value = hi * 2^32 + (lo as uint32)   12, 13 dzdx_q,
#         dzdy_q   14 zshift   15 tri_id   16 zq0   17 x0f   18 y0f
#   float (bitcast to int32) 19, 20 gx, gy   21.. the (p00, pdx, pdy)
#         planes of b0, b1, invw and each channel
N_TI = 19  # int columns
TEMPLATE_COLUMNS = N_TI + 2  # + the float columns before the planes


class Templates(NamedTuple):
    """Per-triangle inputs of the record assembly (all leading dim T)."""

    a: torch.Tensor  # int32 (T, 3) edge A coefficients
    b: torch.Tensor  # int32 (T, 3) edge B coefficients
    e: torch.Tensor  # int64 (T, 3) exact biased edge values at the pixel-(0, 0) centre
    dzdx: torch.Tensor  # int32 (T,) depth units per pixel
    dzdy: torch.Tensor  # int32 (T,)
    zshift: torch.Tensor  # int32 (T,)
    zq: torch.Tensor  # int32 (T, 3) per-vertex quantized depth (vertex 0 is read)
    xf: torch.Tensor  # int32 (T, 3) snapped x (vertex 0 is read)
    yf: torch.Tensor  # int32 (T, 3) snapped y (vertex 0 is read)
    gx: torch.Tensor  # f32 (T,) depth gradients
    gy: torch.Tensor  # f32 (T,)
    planes: torch.Tensor  # f32 (T, 3 * (3 + K)) (p00, pdx, pdy) at the pixel-(0, 0) centre
    # int: tri_id = triangle index + id_offset; or an int32 (T,) tensor
    # giving each triangle its id (a culled draw's original ids).
    id_offset: int | torch.Tensor


class _SlotFields(NamedTuple):
    """One template's fields gathered per slot (all leading dim P)."""

    a: torch.Tensor  # int64 (P, 3)
    b: torch.Tensor  # int64 (P, 3)
    e: torch.Tensor  # int64 (P, 3)
    dzdx: torch.Tensor  # (P,)
    dzdy: torch.Tensor  # (P,)
    zshift: torch.Tensor  # int32 (P,)
    tid: torch.Tensor  # int64 (P,)
    zq0: torch.Tensor  # int32 (P,)
    x0f: torch.Tensor  # (P,)
    y0f: torch.Tensor  # (P,)
    gx: torch.Tensor  # f32 (P,)
    gy: torch.Tensor  # f32 (P,)
    planes: torch.Tensor  # f32 (P, 3 * (3 + K))


def record_width(msaa4: bool) -> int:
    return RECORD_WIDTH_MSAA if msaa4 else RECORD_WIDTH


def assemble_records(tmpl: Templates, t_slot, ox, oy, total, fw: int, msaa4: bool = False):
    """Field-major (records (record_width(msaa4), P) int32, frecords (fw, P) f32).

    ``t_slot``, ``ox``, ``oy`` are (P,) int64: each slot's triangle and
    tile-origin pixel; ``total`` is the () int64 count of live slots.
    CUDA tensors launch the kernel, CPU tensors take the plain version.
    """
    dev = t_slot.device
    if dev.type == "cuda":
        return _assemble_kernel(tmpl, t_slot, ox, oy, total, fw, msaa4)
    if dev.type == "cpu":
        return assemble_records_reference(tmpl, t_slot, ox, oy, total, fw, msaa4)
    raise ValueError(f"no record assembly for device {dev}")


def assemble_records_reference(tmpl: Templates, t_slot, ox, oy, total, fw: int, msaa4: bool = False):
    """The plain PyTorch version of assemble_records, on any device."""
    i64 = torch.int64
    fields = _SlotFields(
        a=tmpl.a[t_slot].to(i64),
        b=tmpl.b[t_slot].to(i64),
        e=tmpl.e[t_slot],
        dzdx=tmpl.dzdx[t_slot],
        dzdy=tmpl.dzdy[t_slot],
        zshift=tmpl.zshift[t_slot],
        tid=_slot_ids(tmpl.id_offset, t_slot),
        zq0=tmpl.zq[t_slot, 0],
        x0f=tmpl.xf[t_slot, 0],
        y0f=tmpl.yf[t_slot, 0],
        gx=tmpl.gx[t_slot],
        gy=tmpl.gy[t_slot],
        planes=tmpl.planes[t_slot],
    )
    return _assemble_reference(fields, ox, oy, total, fw, msaa4)


def _slot_ids(id_offset, t_slot):
    """Each slot's triangle id: t_slot + id_offset, or id_offset[t_slot]
    for per-triangle ids."""
    if isinstance(id_offset, torch.Tensor):
        return id_offset[t_slot].to(torch.int64)
    return t_slot + int(id_offset)


def _assemble_reference(f: _SlotFields, ox, oy, total, fw: int, msaa4: bool):
    """The record arithmetic of both plain assemblies."""
    dev = ox.device
    i64 = torch.int64
    n = ox.shape[0]
    invalid = (torch.arange(n, dtype=i64, device=dev) >= total)[:, None]
    eb = f.e + f.a * (ox * fp.SUBPIXEL_SCALE)[:, None] + f.b * (oy * fp.SUBPIXEL_SCALE)[:, None]
    eb = eb.clamp(-fp.ANCHOR_CLAMP, fp.ANCHOR_CLAMP)

    dzx = f.dzdx.to(i64)
    dzy = f.dzdy.to(i64)
    can_x = torch.div(ox, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    can_y = torch.div(oy, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    z_can = depth_tile_anchor(f.zq0, f.x0f.to(i64), f.y0f.to(i64), f.gx, f.gy, f.zshift, can_x, can_y)
    zo = z_can + dzx * (ox - can_x) + dzy * (oy - can_y)

    scale = fp.SUBPIXEL_SCALE
    rec = torch.cat(
        [
            torch.where(invalid, INVALID_EDGE, eb),
            torch.where(invalid, 0, f.a * scale),
            torch.where(invalid, 0, f.b * scale),
            torch.stack([zo, dzx, dzy, f.zshift.to(i64), f.tid], dim=1),
        ],
        dim=1,
    )
    records = torch.zeros((record_width(msaa4), n), dtype=torch.int32, device=dev)
    records[:14] = rec.T.to(torch.int32)
    if msaa4:
        raw = torch.cat([f.a, f.b], dim=1)  # (P, 6) A0..A2, B0..B2
        records[16:22] = torch.where(invalid, 0, raw).T.to(torch.int32)

    pl = f.planes  # (P, 3 * (3 + K))
    oxf = ox.to(torch.float32)
    oyf = oy.to(torch.float32)
    frecords = torch.zeros((fw, n), dtype=torch.float32, device=dev)
    num_planes = pl.shape[1]
    for r in range(0, num_planes, 3):  # b0, b1, invw, channels...
        p00, pdx, pdy = pl[:, r], pl[:, r + 1], pl[:, r + 2]
        frecords[r] = p00 + pdx * oxf + pdy * oyf
        frecords[r + 1] = pdx
        frecords[r + 2] = pdy
    frecords[num_planes] = f.tid.to(torch.float32)  # binning.ftid_col(K)
    return records, frecords


def _assemble_kernel(tmpl: Templates, t_slot, ox, oy, total, fw: int, msaa4: bool = False):
    """Launch csrc/assemble_records.cu, per-field entry."""
    dev = t_slot.device
    n = t_slot.shape[0]
    t = tmpl.a.shape[0]
    num_planes = tmpl.planes.shape[1]
    if num_planes % 3 or fw < num_planes + 1:
        raise ValueError(f"{num_planes} plane rows do not fit frecords of width {fw}")
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    per_tri_ids = isinstance(tmpl.id_offset, torch.Tensor)
    for name, x, dtype, shape in (
        ("a", tmpl.a, i32, (t, 3)),
        ("b", tmpl.b, i32, (t, 3)),
        ("e", tmpl.e, i64, (t, 3)),
        ("dzdx", tmpl.dzdx, i32, (t,)),
        ("dzdy", tmpl.dzdy, i32, (t,)),
        ("zshift", tmpl.zshift, i32, (t,)),
        ("zq", tmpl.zq, i32, (t, 3)),
        ("xf", tmpl.xf, i32, (t, 3)),
        ("yf", tmpl.yf, i32, (t, 3)),
        ("gx", tmpl.gx, f32, (t,)),
        ("gy", tmpl.gy, f32, (t,)),
        ("planes", tmpl.planes, f32, (t, num_planes)),
        *((("tri_ids", tmpl.id_offset, i32, (t,)),) if per_tri_ids else ()),
        ("t_slot", t_slot, i64, (n,)),
        ("ox", ox, i64, (n,)),
        ("oy", oy, i64, (n,)),
        ("total", total, i64, ()),
    ):
        _build.check_operand(name, x, dtype, shape, dev)
    rw = record_width(msaa4)
    records = torch.empty((rw, n), dtype=i32, device=dev)
    frecords = torch.empty((fw, n), dtype=f32, device=dev)
    p = _build.ptr
    _build.launch(
        "assemble_records",
        p(tmpl.a), p(tmpl.b), p(tmpl.e),
        p(tmpl.dzdx), p(tmpl.dzdy), p(tmpl.zshift),
        p(tmpl.zq), p(tmpl.xf), p(tmpl.yf),
        p(tmpl.gx), p(tmpl.gy),
        p(tmpl.planes), num_planes,
        p(t_slot), p(ox), p(oy), p(total),
        p(tmpl.id_offset) if per_tri_ids else None, 0 if per_tri_ids else int(tmpl.id_offset),
        p(records), p(frecords), n, rw, fw,
        dev=dev,
    )
    return records, frecords


# ---------------------------------------------------------------------------
# tmpl="pallas": the template transpose and the assembly from template rows
# ---------------------------------------------------------------------------


def _check_transpose_shape(w8: int, out_width: int):
    if w8 <= 0 or w8 % 8 or out_width % 64 or w8 > out_width:
        raise ValueError(
            f"templates of {w8} rows need a multiple of 8 rows, at most out_width {out_width}, "
            "which must be a multiple of 64"
        )


def transpose_templates(fused_t: torch.Tensor, out_width: int) -> torch.Tensor:
    """Field-major templates (W8, T) int32 -> row-major (T, out_width) int32.

    Lanes W8..out_width of every row are zero.  W8 must be a multiple of 8
    and at most ``out_width``, a multiple of 64.  T is not padded: only
    rows below T are ever read, since every ``t_slot`` is below T.  CUDA
    tensors launch csrc/transpose_templates.cu, CPU tensors take the plain
    version.
    """
    dev = fused_t.device
    if dev.type == "cuda":
        return _transpose_kernel(fused_t, out_width)
    if dev.type == "cpu":
        return transpose_templates_reference(fused_t, out_width)
    raise ValueError(f"no template transpose for device {dev}")


def transpose_templates_reference(fused_t: torch.Tensor, out_width: int) -> torch.Tensor:
    """The plain PyTorch version of transpose_templates, on any device."""
    w8 = fused_t.shape[0]
    _check_transpose_shape(w8, out_width)
    return torch.nn.functional.pad(fused_t.T, (0, out_width - w8))


def _transpose_kernel(fused_t: torch.Tensor, out_width: int) -> torch.Tensor:
    """Launch csrc/transpose_templates.cu."""
    dev = fused_t.device
    w8, t = fused_t.shape
    _check_transpose_shape(w8, out_width)
    _build.check_operand("fused_t", fused_t, torch.int32, (w8, t), dev)
    out = torch.empty((t, out_width), dtype=torch.int32, device=dev)
    _build.launch("transpose_templates", _build.ptr(fused_t), _build.ptr(out), w8, t, out_width, dev=dev)
    return out


def assemble_records_rows(fused, t_slot, ox, oy, total, fw: int, num_channels: int, msaa4: bool = False):
    """assemble_records reading each slot's template from row ``t_slot`` of
    ``fused`` (T, out_width) int32 (transpose_templates' output).

    ``num_channels`` is K: the row holds 3 * (3 + K) plane floats.  Every
    ``t_slot`` must be below T, and out_width must be a multiple of 4 (on
    the card ``fused`` must also start 16-byte aligned).  CUDA tensors
    launch the kernel's row entry, CPU tensors take the plain version.
    """
    dev = t_slot.device
    if dev.type == "cuda":
        return _assemble_rows_kernel(fused, t_slot, ox, oy, total, fw, num_channels, msaa4)
    if dev.type == "cpu":
        return assemble_records_rows_reference(fused, t_slot, ox, oy, total, fw, num_channels, msaa4)
    raise ValueError(f"no record assembly for device {dev}")


def _num_planes(fused, fw: int, num_channels: int) -> int:
    num_planes = 3 * (3 + num_channels)
    if TEMPLATE_COLUMNS + num_planes > fused.shape[1] or fw < num_planes + 1:
        raise ValueError(
            f"{num_channels} channels do not fit template rows of width {fused.shape[1]} "
            f"or frecords of width {fw}"
        )
    if fused.shape[1] % 4:
        raise ValueError(f"template rows of width {fused.shape[1]}: the width must be a multiple of 4")
    return num_planes


def assemble_records_rows_reference(fused, t_slot, ox, oy, total, fw: int, num_channels: int,
                                    msaa4: bool = False):
    """The plain PyTorch version of assemble_records_rows, on any device:
    one row gather, the columns decoded, then the plain assembly."""
    num_planes = _num_planes(fused, fw, num_channels)
    i64 = torch.int64
    g = fused[t_slot]  # (P, out_width)
    hi = g[:, 6:12:2].to(i64)
    lo = g[:, 7:12:2].to(i64) & 0xFFFFFFFF
    floats = g[:, N_TI : TEMPLATE_COLUMNS + num_planes].contiguous().view(torch.float32)
    fields = _SlotFields(
        a=g[:, 0:3].to(i64),
        b=g[:, 3:6].to(i64),
        e=(hi << 32) | lo,
        dzdx=g[:, 12],
        dzdy=g[:, 13],
        zshift=g[:, 14],
        tid=g[:, 15].to(i64),
        zq0=g[:, 16],
        x0f=g[:, 17],
        y0f=g[:, 18],
        gx=floats[:, 0],
        gy=floats[:, 1],
        planes=floats[:, 2:],
    )
    return _assemble_reference(fields, ox, oy, total, fw, msaa4)


def _assemble_rows_kernel(fused, t_slot, ox, oy, total, fw: int, num_channels: int, msaa4: bool):
    """Launch csrc/assemble_records.cu, template-row entry."""
    dev = t_slot.device
    n = t_slot.shape[0]
    num_planes = _num_planes(fused, fw, num_channels)
    i64 = torch.int64
    for name, x, dtype, shape in (
        ("fused", fused, torch.int32, (None, fused.shape[1])),
        ("t_slot", t_slot, i64, (n,)),
        ("ox", ox, i64, (n,)),
        ("oy", oy, i64, (n,)),
        ("total", total, i64, ()),
    ):
        _build.check_operand(name, x, dtype, shape, dev)
    # The kernel copies rows in 16-byte chunks through shared memory.
    if fused.data_ptr() % 16:
        raise ValueError("template rows must start 16-byte aligned")
    smem = _build.load().brt_assemble_records_rows_smem(num_planes)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{num_channels} channels need {smem} bytes of shared memory a block, over {limit}")
    rw = record_width(msaa4)
    records = torch.empty((rw, n), dtype=torch.int32, device=dev)
    frecords = torch.empty((fw, n), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "assemble_records_rows",
        p(fused), fused.shape[1], num_planes,
        p(t_slot), p(ox), p(oy), p(total),
        p(records), p(frecords), n, rw, fw,
        dev=dev,
    )
    return records, frecords
