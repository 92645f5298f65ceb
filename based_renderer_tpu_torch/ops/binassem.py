"""Post-sort record assembly: the CUDA kernel and its plain version.

The PyTorch counterpart of ``based_renderer_tpu/ops/binassem.py``
(``assemble_records``, which runs the Pallas ``_assemble_kernel``).  Given
the sorted (tile, triangle) pair stream, every slot of the record stream
is assembled from its triangle's per-triangle template: the three edge
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

``assemble_records`` launches ``csrc/assemble_records.cu`` on CUDA tensors
and runs ``assemble_records_reference`` on CPU tensors.  The reference is
also the binner's ``assemble="xla"`` assembly.  The TPU gathers one fused
64-wide template row per slot (a TPU gather workaround); here the kernel
reads each field straight from the per-triangle tensors of ``Templates``.
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

#: Launches of the CUDA assembly kernel in this process (main-path proof).
LAUNCHES = 0


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
    id_offset: int  # tri_id = triangle index + id_offset


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
    dev = t_slot.device
    i64 = torch.int64
    n = t_slot.shape[0]
    invalid = (torch.arange(n, dtype=i64, device=dev) >= total)[:, None]
    a_s = tmpl.a[t_slot].to(i64)
    b_s = tmpl.b[t_slot].to(i64)
    eb = tmpl.e[t_slot] + a_s * (ox * fp.SUBPIXEL_SCALE)[:, None] + b_s * (oy * fp.SUBPIXEL_SCALE)[:, None]
    eb = eb.clamp(-fp.ANCHOR_CLAMP, fp.ANCHOR_CLAMP)

    dzx = tmpl.dzdx[t_slot].to(i64)
    dzy = tmpl.dzdy[t_slot].to(i64)
    zshift = tmpl.zshift[t_slot]
    can_x = torch.div(ox, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    can_y = torch.div(oy, fp.DEPTH_TILE, rounding_mode="floor") * fp.DEPTH_TILE
    z_can = depth_tile_anchor(
        tmpl.zq[t_slot, 0],
        tmpl.xf[t_slot, 0].to(i64),
        tmpl.yf[t_slot, 0].to(i64),
        tmpl.gx[t_slot],
        tmpl.gy[t_slot],
        zshift,
        can_x,
        can_y,
    )
    zo = z_can + dzx * (ox - can_x) + dzy * (oy - can_y)
    tid = t_slot + int(tmpl.id_offset)

    scale = fp.SUBPIXEL_SCALE
    rec = torch.cat(
        [
            torch.where(invalid, INVALID_EDGE, eb),
            torch.where(invalid, 0, a_s * scale),
            torch.where(invalid, 0, b_s * scale),
            torch.stack([zo, dzx, dzy, zshift.to(i64), tid], dim=1),
        ],
        dim=1,
    )
    records = torch.zeros((record_width(msaa4), n), dtype=torch.int32, device=dev)
    records[:14] = rec.T.to(torch.int32)
    if msaa4:
        raw = torch.cat([a_s, b_s], dim=1)  # (P, 6) A0..A2, B0..B2
        records[16:22] = torch.where(invalid, 0, raw).T.to(torch.int32)

    pl = tmpl.planes[t_slot]  # (P, 3 * (3 + K))
    oxf = ox.to(torch.float32)
    oyf = oy.to(torch.float32)
    frecords = torch.zeros((fw, n), dtype=torch.float32, device=dev)
    num_planes = pl.shape[1]
    for r in range(0, num_planes, 3):  # b0, b1, invw, channels...
        p00, pdx, pdy = pl[:, r], pl[:, r + 1], pl[:, r + 2]
        frecords[r] = p00 + pdx * oxf + pdy * oyf
        frecords[r + 1] = pdx
        frecords[r + 2] = pdy
    frecords[num_planes] = tid.to(torch.float32)  # binning.ftid_col(K)
    return records, frecords


def _assemble_kernel(tmpl: Templates, t_slot, ox, oy, total, fw: int, msaa4: bool = False):
    """Launch csrc/assemble_records.cu."""
    global LAUNCHES
    dev = t_slot.device
    n = t_slot.shape[0]
    t = tmpl.a.shape[0]
    num_planes = tmpl.planes.shape[1]
    if num_planes % 3 or fw < num_planes + 1:
        raise ValueError(f"{num_planes} plane rows do not fit frecords of width {fw}")
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
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
    rc = _build.load().brt_assemble_records(
        p(tmpl.a), p(tmpl.b), p(tmpl.e),
        p(tmpl.dzdx), p(tmpl.dzdy), p(tmpl.zshift),
        p(tmpl.zq), p(tmpl.xf), p(tmpl.yf),
        p(tmpl.gx), p(tmpl.gy),
        p(tmpl.planes), num_planes,
        p(t_slot), p(ox), p(oy), p(total), int(tmpl.id_offset),
        p(records), p(frecords), n, rw, fw,
        _build.stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"assemble_records kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return records, frecords
