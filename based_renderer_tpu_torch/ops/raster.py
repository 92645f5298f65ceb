"""Tile-binned visibility rasterizers: the CUDA kernels and their plain versions.

The PyTorch counterpart of ``based_renderer_tpu/ops/raster_pallas.py``
(``rasterize_vis_pallas`` / ``rasterize_binned``) and of
``raster_xla.VisBuffer``.  Four kernels serve ``rasterize_binned``:
  * the sequential per-tile raster (``_raster_kernel`` on the TPU,
    ``csrc/raster_tile.cu`` here): per pixel, the winner is the last record
    of the tile, in draw order, that covers the pixel and passes the depth
    test; its plain version is ``rasterize_binned_reference``;
  * the order-independent sublane raster (``_raster_kernel_sublane``,
    ``csrc/raster_sublane.cu``), for depth test + write with an ordered
    compare: per pixel, the nearest covering record, ties to the earliest
    record under strict compares and the latest under the ``*_equal``
    ones, then held against the init depth; its plain version is
    ``rasterize_binned_sublane_reference``, written as a per-pixel
    reduction over (record, pixel) keys;
  * their coverage MSAA-4x forms (``msaa4``): ``_raster_kernel_msaa4``
    (``csrc/raster_msaa4.cu``) and ``_raster_kernel_msaa4_sublane``
    (``csrc/raster_msaa4_sublane.cu``).  Coverage and the depth test run
    per sample at the four positions of ``fp.MSAA4_OFFSETS``, each sample
    stepped from the pixel-center edge and depth values by per-record
    offsets; every plane of a sample's winner is evaluated at the pixel
    CENTER.  Every output gains a leading sample axis of 4.  Their plain
    versions are ``rasterize_binned_msaa4_reference`` (the sequential plain
    raster with a sample axis) and ``rasterize_binned_msaa4_sublane_reference``
    (the per-(pixel, sample) key reduction).
Two more TPU kernels schedule one of these computations differently and
map onto its CUDA kernel, each a route of its own in ``_build.ROUTES``
(``raster_two_pass`` and ``raster_batched``), counted apart in
``utils.profiling.ROUTES_TAKEN``:
  * the two-pass raster (``_raster_kernel_two_pass``, ``two_pass``) keeps
    the last passing record per pixel and evaluates its planes once,
    which is what csrc/raster_tile.cu does: the same output bit for bit;
  * the batched raster (``_raster_kernel_batched``, ``batch``) is the
    per-pixel reduction of the sublane raster under an ordered compare,
    at any tile that divides 128: csrc/raster_sublane.cu.
Stencil (``stencil``, a pipeline.StencilState) runs in the sequential
kernels and their MSAA form, per sample: every covered fragment updates
the 8-bit stencil value with fail_op, depth_fail_op or pass_op, and only
fragments passing both tests win (the JAX package's raster_xla
stencil_test / stencil_update, copied here as plain tensor functions).
CUDA tensors launch the kernels, CPU tensors take the plain versions.
Each pair returns the same planes bit for bit: tri_id, depth_q and the
stencil are integer arithmetic, and every float plane of the winner is
evaluated once as (p0 + pdx*ix) + pdy*iy in single IEEE operations.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.errors import FeatureNotPresentError
from . import _build
from . import fixedpoint as fp
from .binning import bin_triangles
from .setup import TriSetup

NUM_SAMPLES = 4

_COMPARE_OPS = (
    "never",
    "less",
    "equal",
    "less_equal",
    "greater",
    "not_equal",
    "greater_equal",
    "always",
)
_ORDERED_OPS = ("less", "less_equal", "greater", "greater_equal")
# VkStencilOp; the index is the kernels' op code.
_STENCIL_OPS = (
    "keep",
    "zero",
    "replace",
    "increment_clamp",
    "decrement_clamp",
    "invert",
    "increment_wrap",
    "decrement_wrap",
)


class VisBuffer(NamedTuple):
    """Per-pixel visibility: which triangle won, at what depth, where.

    Under coverage MSAA-4x every plane is (4, H, W), one layer per sample.
    """

    tri_id: torch.Tensor  # int32 (H, W), -1 = background
    depth_q: torch.Tensor  # int32 (H, W) quantized depth (1.0 == 2^30)
    b0: torch.Tensor  # f32 (H, W) barycentric weight of v0
    b1: torch.Tensor  # f32 (H, W)
    b2: torch.Tensor  # f32 (H, W)
    stencil: torch.Tensor | None = None  # int32 (H, W) 8-bit values, when stencil is on

    @property
    def depth(self) -> torch.Tensor:
        """Depth as float32 in [0, 1]."""
        return self.depth_q.to(torch.float32) * fp.f32(fp.DEPTH_Q_TO_F32, self.depth_q)


def _clip_mode(depth_clip) -> int:
    # "clamp" is truthy, so test it before the boolean reading.
    if isinstance(depth_clip, str):
        if depth_clip != "clamp":
            raise ValueError(f"depth_clip must be True, False or 'clamp', got {depth_clip!r}")
        return 2
    return 1 if depth_clip else 0


def _stencil_on(stencil) -> bool:
    return stencil is not None and stencil.enable


def stencil_apply_op(op: str, sbuf: torch.Tensor, ref: int) -> torch.Tensor:
    """New 8-bit stencil value under ``op`` (before the write-mask merge);
    the JAX package's raster_xla.stencil_apply_op (VkStencilOp)."""
    if op == "keep":
        return sbuf
    if op == "zero":
        return torch.zeros_like(sbuf)
    if op == "replace":
        return torch.full_like(sbuf, ref)
    if op == "increment_clamp":
        return torch.clamp_max(sbuf + 1, 255)
    if op == "decrement_clamp":
        return torch.clamp_min(sbuf - 1, 0)
    if op == "invert":
        return ~sbuf & 0xFF
    if op == "increment_wrap":
        return (sbuf + 1) & 0xFF
    if op == "decrement_wrap":
        return (sbuf - 1) & 0xFF
    raise ValueError(op)


def stencil_update(state, sbuf, covered, s_pass, d_pass) -> torch.Tensor:
    """Post-fragment stencil buffer (raster_xla.stencil_update): fail_op
    where the stencil test fails, depth_fail_op where it passes and the
    depth test (True where off) fails, pass_op where both pass; merged
    under write_mask, on covered fragments only."""
    new_fail = stencil_apply_op(state.fail_op, sbuf, state.ref)
    new_dfail = stencil_apply_op(state.depth_fail_op, sbuf, state.ref)
    new_pass = stencil_apply_op(state.pass_op, sbuf, state.ref)
    nv = torch.where(s_pass, torch.where(d_pass, new_pass, new_dfail), new_fail)
    wm = state.write_mask
    return torch.where(covered, (sbuf & ~wm) | (nv & wm), sbuf)


def stencil_test(state, sbuf) -> torch.Tensor:
    """compare(ref & compare_mask, stencil & compare_mask) (raster_xla.stencil_test)."""
    cm = state.compare_mask
    return _compare(state.compare, torch.full_like(sbuf, state.ref & cm), sbuf & cm)


def _check_modes(sublane, sublane_group, bin_rows, tile_w, tile_h, depth_test, depth_write,
                 depth_compare, stencil, two_pass, batch, msaa4):
    """The JAX package's ValueErrors for the sublane and batched routes, in
    its order (raster_pallas.py:1945-2011)."""
    if bin_rows is not None and not sublane:
        raise ValueError("bin_rows (sub-tile band binning) requires the sublane kernel")
    ordered = depth_test and depth_write and depth_compare in _ORDERED_OPS
    if not sublane:
        if batch > 0:
            if not (ordered and not _stencil_on(stencil) and not msaa4 and not two_pass):
                raise ValueError(
                    "batch rasterization requires depth test+write with an "
                    "ordered compare and no stencil/msaa/two_pass"
                )
            if 128 % batch:
                raise ValueError("batch must divide 128")
        return
    if not (ordered and not _stencil_on(stencil) and not two_pass and not batch > 0):
        raise ValueError(
            "sublane rasterization requires depth test+write with an "
            "ordered compare and no stencil/two_pass/batch"
        )
    if tile_w != 128:
        raise ValueError("sublane rasterization requires tile_w == 128")
    if sublane_group % 8 or 128 % sublane_group:
        raise ValueError(f"sublane_group must be a multiple of 8 dividing 128, got {sublane_group}")
    if bin_rows is not None and msaa4:
        raise ValueError("bin_rows is not supported with msaa4 yet")
    if bin_rows is not None and (bin_rows <= 0 or tile_h % bin_rows):
        raise ValueError(f"bin_rows {bin_rows} must divide tile_h {tile_h}")


def _check_tile(tile_w: int, tile_h: int):
    # The anchored int32 stepping is exact only for tile dims dividing 128.
    for d in (tile_w, tile_h):
        if d <= 0 or 128 % d:
            raise ValueError(f"raster tile dims must divide 128, got {(tile_w, tile_h)}")


def _package(ints: torch.Tensor, floats: torch.Tensor, num_channels: int):
    """ints (2 or 3 with stencil, [4,] H, W), floats (4 + K, [4,] H, W)."""
    vis = VisBuffer(
        tri_id=ints[0], depth_q=ints[1], b0=floats[0], b1=floats[1], b2=floats[2],
        stencil=ints[2] if ints.shape[0] > 2 else None,
    )
    if num_channels == 0:
        return vis
    return vis, floats[4:], floats[3]


def _raster_planes_reference(
    binned,
    width,
    height,
    tile_w,
    tile_h,
    depth_test,
    depth_compare,
    depth_write,
    clip_mode,
    clear_q,
    init,
    num_channels,
    scissor,
    msaa4=False,
    stencil=None,
    stencil_clear=0,
):
    """Plain PyTorch raster over all tiles at once.

    Each tile's record list is padded to the largest count; a loop over
    the record index updates the (S, num_tiles, th, tw) state with
    torch.where, S = 4 sample layers under ``msaa4`` and 1 otherwise.
    With stencil on, every covered sample updates its stencil value and
    only samples passing both tests win.  Returns (ints (2, or 3 with the
    stencil, [S,] H, W), floats (4 + K, [S,] H, W)).
    """
    dev = binned.records.device
    i32 = torch.int32
    S = NUM_SAMPLES if msaa4 else 1
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    nt = num_tx * num_ty
    pad_h, pad_w = num_ty * tile_h, num_tx * tile_w

    def to_tiles(x, fill):  # (S, H, W) -> (S, nt, th, tw), padded with ``fill``
        x = torch.nn.functional.pad(x.reshape(S, height, width), (0, pad_w - width, 0, pad_h - height), value=fill)
        return x.reshape(S, num_ty, tile_h, num_tx, tile_w).transpose(2, 3).reshape(S, nt, tile_h, tile_w)

    ix = torch.arange(tile_w, dtype=i32, device=dev)[None, None, :]
    iy = torch.arange(tile_h, dtype=i32, device=dev)[None, :, None]
    tile_ids = torch.arange(nt, device=dev)
    gx_pix = (tile_ids % num_tx).to(i32)[:, None, None] * tile_w + ix
    gy_pix = (tile_ids // num_tx).to(i32)[:, None, None] * tile_h + iy
    if scissor is not None:
        sx0, sy0, sx1, sy1 = scissor
        in_sc = (gx_pix >= sx0) & (gx_pix < sx1) & (gy_pix >= sy0) & (gy_pix < sy1)
    else:
        in_sc = torch.ones((nt, tile_h, tile_w), dtype=torch.bool, device=dev)

    if init is not None:
        zbuf = to_tiles(init.depth_q, clear_q)
        ids = to_tiles(init.tri_id, -1)
    else:
        zbuf = torch.full((S, nt, tile_h, tile_w), clear_q, dtype=i32, device=dev)
        ids = torch.full((S, nt, tile_h, tile_w), -1, dtype=i32, device=dev)
    use_stencil = _stencil_on(stencil)
    if use_stencil:
        # From init.stencil, or the clear value (raster_pallas.py:2060-2066).
        st_clear = stencil_clear & 0xFF
        if init is not None and init.stencil is not None:
            st = to_tiles(init.stencil, st_clear)
        else:
            st = torch.full((S, nt, tile_h, tile_w), st_clear, dtype=i32, device=dev)
    win = torch.full((S, nt, tile_h, tile_w), -1, dtype=torch.int64, device=dev)

    start = binned.tile_start.to(torch.int64)
    count = binned.tile_count.to(torch.int64)
    max_count = int(count.max()) if nt else 0
    if max_count:
        r_idx = torch.arange(max_count, device=dev)
        slot = start[:, None] + r_idx[None, :]  # (nt, max_count)
        in_tile = r_idx[None, :] < count[:, None]
        slot = torch.where(in_tile, slot, 0)
        rec = binned.records[: 22 if msaa4 else 14][:, slot]  # (rows, nt, max_count) int32
        one_q = fp.DEPTH_ONE_Q
        for r in range(max_count):
            f = rec[:, :, r][:, :, None, None]  # (rows, nt, 1, 1)
            e0 = f[0] + f[3] * ix + f[6] * iy
            e1 = f[1] + f[4] * ix + f[7] * iy
            e2 = f[2] + f[5] * ix + f[8] * iy
            live = in_sc & in_tile[:, r][:, None, None]
            zshift = f[12].to(torch.int64)
            z_u = f[9] + f[10] * ix + f[11] * iy  # int32, as the TPU lanes wrap
            hi = (torch.full_like(zshift, 1 << 29) >> zshift) + 1
            for s in range(S):
                if msaa4:
                    # Per-record scalar offsets to sample s (fp.MSAA4_OFFSETS bounds).
                    ddx, ddy = fp.MSAA4_OFFSETS[s]
                    o0 = f[16] * ddx + f[19] * ddy
                    o1 = f[17] * ddx + f[20] * ddy
                    o2 = f[18] * ddx + f[21] * ddy
                    passes = (e0 + o0 >= 0) & (e1 + o1 >= 0) & (e2 + o2 >= 0) & live
                    z_s = z_u + ((f[10] * ddx + f[11] * ddy) >> 4)  # arithmetic shift: floor
                else:
                    passes = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & live
                    z_s = z_u
                z_c = torch.maximum(torch.minimum(z_s.to(torch.int64), hi), -hi)
                z = (z_c * (torch.ones_like(zshift) << zshift) + (1 << 29)).to(i32)
                if clip_mode == 2:
                    z = z.clamp(0, one_q)
                elif clip_mode == 1:
                    passes &= (z >= 0) & (z <= one_q)
                d_pass = _compare(depth_compare if depth_test else "always", z, zbuf[s])
                if use_stencil:
                    s_pass = stencil_test(stencil, st[s])
                    st[s] = stencil_update(stencil, st[s], passes, s_pass, d_pass)
                    passes &= s_pass
                passes &= d_pass
                if depth_write:
                    zbuf[s] = torch.where(passes, z, zbuf[s])
                ids[s] = torch.where(passes, f[13], ids[s])
                win[s] = torch.where(passes, slot[:, r][:, None, None], win[s])

    # Float planes of each sample's winner, evaluated once at the pixel center.
    won = win >= 0
    w_slot = win.clamp_min(0)
    ixf = ix.to(torch.float32)
    iyf = iy.to(torch.float32)
    fr = binned.frecords

    def plane(row):
        p0, pdx, pdy = fr[row][w_slot], fr[row + 1][w_slot], fr[row + 2][w_slot]
        return (p0 + pdx * ixf) + pdy * iyf

    zeros = torch.zeros((S, nt, tile_h, tile_w), dtype=torch.float32, device=dev)
    if init is not None:
        base = [to_tiles(init.b0, 0.0), to_tiles(init.b1, 0.0), to_tiles(init.b2, 0.0)]
    else:
        base = [zeros, zeros, zeros]
    b0 = torch.where(won, plane(0), base[0])
    b1 = torch.where(won, plane(3), base[1])
    b2 = torch.where(won, (1.0 - b0) - b1, base[2])
    invw = torch.where(won, plane(6), torch.ones_like(zeros))
    chans = [torch.where(won, plane(9 + 3 * c), zeros) for c in range(num_channels)]

    def untile(x):  # (n, S, nt, th, tw) -> (n, [S,] H, W)
        n = x.shape[0]
        x = x.reshape(n, S, num_ty, num_tx, tile_h, tile_w).transpose(3, 4)
        x = x.reshape(n, S, pad_h, pad_w)[..., :height, :width]
        return (x if msaa4 else x[:, 0]).contiguous()

    ints = untile(torch.stack([ids, zbuf, st] if use_stencil else [ids, zbuf]))
    floats = untile(torch.stack([b0, b1, b2, invw, *chans]))
    return ints, floats


def _compare(op: str, z, zbuf):
    if op == "never":
        return torch.zeros_like(z, dtype=torch.bool)
    if op == "always":
        return torch.ones_like(z, dtype=torch.bool)
    return {
        "less": torch.lt,
        "equal": torch.eq,
        "less_equal": torch.le,
        "greater": torch.gt,
        "not_equal": torch.ne,
        "greater_equal": torch.ge,
    }[op](z, zbuf)


def _kernel_operands(binned, width, height, num_bins, num_channels, init, msaa4=False, stencil_on=False):
    """Check what a raster kernel reads; returns the init planes tri_id,
    depth_q, b0, b1, b2 and stencil (None where absent or unused)."""
    records, frecords = binned.records, binned.frecords
    dev = records.device
    stride = records.shape[1]
    for name, t, dtype, shape in (
        ("records", records, torch.int32, (None, stride)),
        ("frecords", frecords, torch.float32, (None, stride)),
        ("tile_start", binned.tile_start, torch.int32, (num_bins,)),
        ("tile_count", binned.tile_count, torch.int32, (num_bins,)),
    ):
        _build.check_operand(name, t, dtype, shape, dev)
    need_rows = 22 if msaa4 else 14
    if records.shape[0] < need_rows:
        raise ValueError(f"records need at least {need_rows} rows, got {records.shape[0]}")
    if frecords.shape[0] < 9 + 3 * num_channels:
        raise ValueError(
            f"frecords have {frecords.shape[0]} rows; {num_channels} channels need {9 + 3 * num_channels}"
        )
    if init is None:
        return [None] * 6
    init_t = [init.tri_id, init.depth_q, init.b0, init.b1, init.b2]
    init_t.append(init.stencil if stencil_on else None)
    plane = (NUM_SAMPLES, height, width) if msaa4 else (height, width)
    dtypes = (torch.int32,) * 2 + (torch.float32,) * 3 + (torch.int32,)
    for name, t, dtype in zip(("tri_id", "depth_q", "b0", "b1", "b2", "stencil"), init_t, dtypes):
        if t is not None:
            _build.check_operand("init." + name, t, dtype, plane, dev)
    return init_t


def _outputs(width, height, num_channels, dev, msaa4=False, int_planes=2):
    plane = (NUM_SAMPLES, height, width) if msaa4 else (height, width)
    ints = torch.empty((int_planes, *plane), dtype=torch.int32, device=dev)
    floats = torch.empty((4 + num_channels, *plane), dtype=torch.float32, device=dev)
    return ints, floats


def _stencil_args(stencil, stencil_clear):
    """The sequential kernels' stencil parameters: on, compare, ref,
    compare_mask, write_mask, fail_op, depth_fail_op, pass_op, clear."""
    if not _stencil_on(stencil):
        return (0,) * 9
    ops = (stencil.fail_op, stencil.depth_fail_op, stencil.pass_op)
    return (
        1, _COMPARE_OPS.index(stencil.compare), stencil.ref, stencil.compare_mask, stencil.write_mask,
        *(_STENCIL_OPS.index(op) for op in ops), stencil_clear & 0xFF,
    )


def _sample_offsets(msaa4):
    """The MSAA kernels' trailing argument: fp.MSAA4_OFFSETS as 8 int32s."""
    if not msaa4:
        return ()
    return ((ctypes.c_int32 * 8)(*(v for o in fp.MSAA4_OFFSETS for v in o)),)


def _raster_planes_kernel(
    binned,
    width,
    height,
    tile_w,
    tile_h,
    depth_test,
    depth_compare,
    depth_write,
    clip_mode,
    clear_q,
    init,
    num_channels,
    scissor,
    msaa4=False,
    stencil=None,
    stencil_clear=0,
    *,
    route,
):
    """Launch ``route``: csrc/raster_tile.cu, or csrc/raster_msaa4.cu
    under ``msaa4``; returns (ints (2, or 3 with the stencil, [4,] H, W),
    floats (4 + K, [4,] H, W))."""
    dev = binned.records.device
    num_tx = -(-width // tile_w)
    num_tiles = num_tx * -(-height // tile_h)
    use_stencil = _stencil_on(stencil)
    init_t = _kernel_operands(binned, width, height, num_tiles, num_channels, init, msaa4, use_stencil)
    ints, floats = _outputs(width, height, num_channels, dev, msaa4, 3 if use_stencil else 2)
    sc = (0, 0, 0, 0) if scissor is None else tuple(int(v) for v in scissor)
    _build.launch(
        route,
        _build.ptr(binned.records),
        _build.ptr(binned.frecords),
        binned.records.shape[1],
        _build.ptr(binned.tile_start),
        _build.ptr(binned.tile_count),
        num_tiles,
        *[_build.ptr(t) for t in init_t],
        _build.ptr(ints),
        _build.ptr(floats),
        width,
        height,
        tile_w,
        tile_h,
        num_tx,
        int(bool(depth_test)),
        _COMPARE_OPS.index(depth_compare),
        int(bool(depth_write)),
        clip_mode,
        clear_q,
        num_channels,
        int(scissor is not None),
        *sc,
        *_stencil_args(stencil, stencil_clear),
        *_sample_offsets(msaa4),
        dev=dev,
    )
    return ints, floats


def _sublane_planes_kernel(
    binned, width, height, tile_w, tile_h, depth_compare, clip_mode, clear_q, init, num_channels,
    scissor, bin_rows, msaa4=False, *, route,
):
    """Launch ``route``: csrc/raster_sublane.cu, or
    csrc/raster_msaa4_sublane.cu under ``msaa4`` (which has no band
    binning); returns (ints (2, [4,] H, W), floats (4 + K, [4,] H, W))."""
    dev = binned.records.device
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    band_rows = tile_h if bin_rows is None else bin_rows
    num_bins = num_tx * num_ty * (tile_h // band_rows)
    init_t = _kernel_operands(binned, width, height, num_bins, num_channels, init, msaa4)
    ints, floats = _outputs(width, height, num_channels, dev, msaa4)
    sc = (0, 0, 0, 0) if scissor is None else tuple(int(v) for v in scissor)
    band = () if msaa4 else (int(bin_rows is not None), band_rows)
    _build.launch(
        route,
        _build.ptr(binned.records),
        _build.ptr(binned.frecords),
        binned.records.shape[1],
        _build.ptr(binned.tile_start),
        _build.ptr(binned.tile_count),
        *[_build.ptr(t) for t in init_t[:4]],  # b2 is derived from b0, b1
        _build.ptr(ints),
        _build.ptr(floats),
        width,
        height,
        tile_w,
        tile_h,
        num_tx,
        num_ty,
        *band,
        _COMPARE_OPS.index(depth_compare),
        clip_mode,
        clear_q,
        num_channels,
        int(scissor is not None),
        *sc,
        *_sample_offsets(msaa4),
        dev=dev,
    )
    return ints, floats


_INT64_MAX = (1 << 63) - 1
_WORD = (1 << 32) - 1


def _sublane_planes_reference(
    binned, width, height, tile_w, tile_h, depth_compare, clip_mode, clear_q, init, num_channels,
    scissor, bin_rows, msaa4=False,
):
    """Plain PyTorch sublane raster, written as a per-(pixel, sample) reduction.

    Every (record, pixel, sample) triple of the record's bin (its tile, or
    its band of tile rows under band binning) that is covered, inside the
    scissor and not clipped gives one int64 key, depth * 2^32 + word: the
    depth is negated under the greater compares, and the word is the
    record's slot (complemented under the *_equal compares).  Under
    ``msaa4`` each of the 4 sample layers has its own keys, its coverage
    and depth stepped from the pixel center by the record's per-sample
    offsets.  scatter_reduce keeps each (pixel, sample)'s smallest key,
    which is its winner; the winner is then held against the init or clear
    depth.  Slots go in chunks to bound memory.
    Returns (ints (2, [S,] H, W), floats (4 + K, [S,] H, W)).
    """
    dev = binned.records.device
    i32, i64 = torch.int32, torch.int64
    S = NUM_SAMPLES if msaa4 else 1
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    pad_w, pad_h = num_tx * tile_w, num_ty * tile_h
    band = tile_h if bin_rows is None else bin_rows
    bands = tile_h // band
    greater = depth_compare.startswith("greater")
    strict = depth_compare in ("less", "greater")
    start = binned.tile_start.to(i64)
    ends = start + binned.tile_count.to(i64)
    num_bins = start.shape[0]
    keys = torch.full((S, pad_h * pad_w), _INT64_MAX, dtype=i64, device=dev)
    ix = torch.arange(tile_w, dtype=i32, device=dev)[None, None, :]
    rows = torch.arange(band, dtype=i64, device=dev)[None, :]
    n_slots = int(ends.max()) if num_bins else 0
    chunk = max(1, (1 << 22) // (band * tile_w * S))
    for s0 in range(0, n_slots, chunk):
        slot = torch.arange(s0, min(s0 + chunk, n_slots), dtype=i64, device=dev)
        b = torch.searchsorted(ends, slot, right=True).clamp_max(num_bins - 1)
        keep = (slot >= start[b]) & (slot < ends[b])
        slot, b = slot[keep], b[keep]
        if bin_rows is None:
            tx, ty, row0 = b % num_tx, torch.div(b, num_tx, rounding_mode="floor"), 0 * b
        else:  # column-major band bins (binning col_major_ids)
            num_by = num_ty * bands
            tx, rem = torch.div(b, num_by, rounding_mode="floor"), b % num_by
            ty, row0 = torch.div(rem, bands, rounding_mode="floor"), (rem % bands) * band
        iy = (row0[:, None] + rows).to(i32)[:, :, None]  # (C, band, 1) rows of the tile
        f = binned.records[: 22 if msaa4 else 13, slot][:, :, None, None]  # (rows, C, 1, 1)
        e0 = f[0] + f[3] * ix + f[6] * iy
        e1 = f[1] + f[4] * ix + f[7] * iy
        e2 = f[2] + f[5] * ix + f[8] * iy
        gx = (tx * tile_w).to(i32)[:, None, None] + ix
        gy = (ty * tile_h).to(i32)[:, None, None] + iy
        if scissor is not None:
            sx0, sy0, sx1, sy1 = scissor
            in_sc = (gx >= sx0) & (gx < sx1) & (gy >= sy0) & (gy < sy1)
        zshift = f[12].to(i64)
        z_u = f[9] + f[10] * ix + f[11] * iy  # int32, as the TPU lanes wrap
        hi = (torch.full_like(zshift, 1 << 29) >> zshift) + 1
        word = slot if strict else _WORD - slot
        pix = gy.to(i64) * pad_w + gx.to(i64)
        for s in range(S):
            if msaa4:
                ddx, ddy = fp.MSAA4_OFFSETS[s]
                ok = (e0 + (f[16] * ddx + f[19] * ddy) >= 0) & (e1 + (f[17] * ddx + f[20] * ddy) >= 0)
                ok &= e2 + (f[18] * ddx + f[21] * ddy) >= 0
                z_s = z_u + ((f[10] * ddx + f[11] * ddy) >> 4)  # arithmetic shift: floor
            else:
                ok = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                z_s = z_u
            if scissor is not None:
                ok &= in_sc
            z_c = torch.maximum(torch.minimum(z_s.to(i64), hi), -hi)
            z = (z_c * (torch.ones_like(zshift) << zshift) + (1 << 29)).to(i32)
            if clip_mode == 2:
                z = z.clamp(0, fp.DEPTH_ONE_Q)
            elif clip_mode == 1:
                ok &= (z >= 0) & (z <= fp.DEPTH_ONE_Q)
            key = (-z if greater else z).to(i64) * (1 << 32) + word[:, None, None]
            key = torch.where(ok, key, _INT64_MAX)
            keys[s].scatter_reduce_(0, pix.expand_as(key).reshape(-1), key.reshape(-1), "amin")

    keys = keys.reshape(S, pad_h, pad_w)
    has = keys != _INT64_MAX
    zk = keys >> 32
    z = (-zk if greater else zk).to(i32)
    word = keys & _WORD
    slot = torch.where(has, word if strict else _WORD - word, 0)

    def padded(x, fill):
        x = x.reshape(S, height, width)
        return torch.nn.functional.pad(x, (0, pad_w - width, 0, pad_h - height), value=fill)

    if init is not None:
        zbuf, base_id = padded(init.depth_q, clear_q), padded(init.tri_id, -1)
        base_b0, base_b1 = padded(init.b0, 0.0), padded(init.b1, 0.0)
    else:
        zbuf = torch.full((S, pad_h, pad_w), clear_q, dtype=i32, device=dev)
        base_id = torch.full_like(zbuf, -1)
        base_b0 = base_b1 = torch.zeros((S, pad_h, pad_w), dtype=torch.float32, device=dev)
    take = has & _compare(depth_compare, z, zbuf)
    depth = torch.where(take, z, zbuf)
    ids = torch.where(take, binned.records[13][slot], base_id)

    ixf = (torch.arange(pad_w, device=dev) % tile_w).to(torch.float32)[None, :]
    iyf = (torch.arange(pad_h, device=dev) % tile_h).to(torch.float32)[:, None]
    fr = binned.frecords

    def plane(row):
        p0, pdx, pdy = fr[row][slot], fr[row + 1][slot], fr[row + 2][slot]
        return (p0 + pdx * ixf) + pdy * iyf

    zeros = torch.zeros((S, pad_h, pad_w), dtype=torch.float32, device=dev)
    b0 = torch.where(take, plane(0), base_b0)
    b1 = torch.where(take, plane(3), base_b1)
    b2 = torch.where(ids >= 0, (1.0 - b0) - b1, zeros)
    invw = torch.where(take, plane(6), torch.ones_like(zeros))
    chans = [torch.where(take, plane(9 + 3 * c), zeros) for c in range(num_channels)]

    def crop(x):  # (n, S, pad_h, pad_w) -> (n, [S,] H, W)
        x = x[..., :height, :width]
        return (x if msaa4 else x[:, 0]).contiguous()

    return crop(torch.stack([ids, depth])), crop(torch.stack([b0, b1, b2, invw, *chans]))


def _rasterize(
    use_kernel: bool,
    binned,
    width: int,
    height: int,
    tile_w: int = 128,
    tile_h: int = 32,
    depth_test: bool = True,
    depth_compare: str = "less",
    depth_write: bool = True,
    depth_clip=True,
    depth_clear: float = 1.0,
    init: VisBuffer | None = None,
    num_channels: int = 0,
    scissor=None,
    skip_losers: bool = False,
    two_pass: bool = False,
    msaa4: bool = False,
    stencil=None,
    stencil_clear: int = 0,
    batch: int = 0,
    unroll: int = 1,
    sublane: bool = False,
    sublane_group: int = 8,
    bin_rows: int | None = None,
):
    if depth_compare not in _COMPARE_OPS:
        raise ValueError(f"bad depth compare {depth_compare!r}; one of {_COMPARE_OPS}")
    _check_modes(sublane, sublane_group, bin_rows, tile_w, tile_h, depth_test, depth_write,
                 depth_compare, stencil, two_pass, batch, msaa4)
    _check_tile(tile_w, tile_h)
    clip_mode = _clip_mode(depth_clip)
    clear_q = int(round(depth_clear * fp.DEPTH_ONE_Q))
    args = (binned, width, height, tile_w, tile_h)
    if sublane or batch > 0:
        # The batched route is the sublane raster without band bins.
        route = "raster_msaa4_sublane" if msaa4 else "raster_sublane" if sublane else "raster_batched"
        args += (depth_compare, clip_mode, clear_q, init, num_channels, scissor, bin_rows)
        kw = dict(msaa4=msaa4)
        kernel, plain = _sublane_planes_kernel, _sublane_planes_reference
    else:
        # The JAX package takes the MSAA kernel before two_pass
        # (raster_pallas.py:2025-2028); two_pass maps onto raster_tile.cu.
        route = "raster_msaa4" if msaa4 else "raster_two_pass" if two_pass else "raster_tile"
        args += (depth_test, depth_compare, depth_write, clip_mode, clear_q, init, num_channels, scissor)
        kw = dict(msaa4=msaa4, stencil=stencil, stencil_clear=stencil_clear)
        kernel, plain = _raster_planes_kernel, _raster_planes_reference
    ints, floats = kernel(*args, route=route, **kw) if use_kernel else plain(*args, **kw)
    return _package(ints, floats, num_channels)


def rasterize_binned(binned, *args, **kwargs):
    """Rasterize an already-binned record stream (see bin_triangles).

    Arguments as in the JAX package's raster_pallas.rasterize_binned: (binned,
    width, height, tile_w=128, tile_h=32, depth_test=True,
    depth_compare="less", depth_write=True, depth_clip=True,
    depth_clear=1.0, init=None, num_channels=0, scissor=None, ...,
    sublane=False, sublane_group=8, bin_rows=None).  ``sublane`` takes the
    order-independent raster, with the JAX package's ValueErrors on
    ineligible modes; ``bin_rows`` reads a band-binned stream (see
    rasterize_vis).  ``msaa4`` reads 24-row MSAA records (bin_triangles
    with ``msaa4``) and rasterizes coverage MSAA-4x: every output gains a
    leading sample axis of 4.  ``stencil`` (a StencilState) runs the
    stencil test and update in the sequential rasters, starting from
    ``init.stencil`` or ``stencil_clear``; the VisBuffer then carries the
    stencil plane.  ``two_pass`` takes the sequential raster (the route
    ``raster_two_pass``), and ``batch`` the sublane raster at any tile that
    divides 128 (``raster_batched``), with the JAX package's ValueErrors on
    ineligible modes.  CUDA tensors launch the Hopper kernels; CPU tensors
    take the plain PyTorch versions.  Returns a VisBuffer when
    ``num_channels`` is 0, else (vis, interp (K, [4,] H, W), invw
    ([4,] H, W)).  ``skip_losers``, ``unroll`` and ``sublane_group`` only
    schedule work on a TPU: they are accepted and change nothing; so is
    ``two_pass`` under ``msaa4``, which the MSAA kernel serves, as in the
    JAX package.
    """
    dev = binned.records.device
    if dev.type not in ("cuda", "cpu"):
        raise FeatureNotPresentError(f"no raster path for device {dev}")
    return _rasterize(dev.type == "cuda", binned, *args, **kwargs)


def rasterize_binned_reference(binned, *args, **kwargs):
    """The plain PyTorch version of rasterize_binned, on any device."""
    return _rasterize(False, binned, *args, **kwargs)


def rasterize_binned_sublane_reference(binned, *args, **kwargs):
    """The plain PyTorch version of the sublane raster, on any device."""
    return _rasterize(False, binned, *args, sublane=True, **kwargs)


def rasterize_binned_msaa4_reference(binned, *args, **kwargs):
    """The plain PyTorch version of the MSAA-4x raster, on any device."""
    return _rasterize(False, binned, *args, msaa4=True, **kwargs)


def rasterize_binned_msaa4_sublane_reference(binned, *args, **kwargs):
    """The plain PyTorch version of the MSAA-4x sublane raster, on any device."""
    return _rasterize(False, binned, *args, msaa4=True, sublane=True, **kwargs)


def rasterize_vis(
    ts: TriSetup,
    width: int,
    height: int,
    tile_w: int = 128,
    tile_h: int = 32,
    depth_test: bool = True,
    depth_compare: str = "less",
    depth_write: bool = True,
    depth_clip=True,
    depth_clear: float = 1.0,
    max_pairs: int | None = None,
    slots: int | None = None,
    init: VisBuffer | None = None,
    id_offset: int | torch.Tensor = 0,
    channels: torch.Tensor | None = None,
    perspective: bool = True,
    scissor=None,
    skip_losers: bool = False,
    return_overflow: bool = False,
    two_pass: bool = False,
    msaa4: bool = False,
    stencil=None,
    stencil_clear: int = 0,
    batch: int = 0,
    unroll: int = 1,
    sublane: bool = False,
    sublane_group: int = 8,
    assemble: str = "xla",
    bin_rows: int | None = None,
    tmpl: str = "xla",
    origin: tuple[int, int] = (0, 0),
    return_pairs: bool = False,
):
    """Bin and rasterize: the counterpart of rasterize_vis_pallas.

    Tiles past the framebuffer edge are rasterized as padding and cropped
    (the kernels simply skip pixels outside the extent).  ``channels``
    (T, 3, K) are interpolated in-raster; the result is then (vis, interp
    (K, H, W), invw (H, W)) instead of vis.  ``return_overflow`` appends
    the binner's overflow flag and its ``pair_budget_use``
    (bin_triangles), and ``return_pairs`` after them the binner's () int32
    true (tile, triangle) pair count.  ``bin_rows`` (sublane only) bins at
    (tile_w x bin_rows) bands with column-major bin ids over a height
    padded to the tile grid, each record anchored at its output tile, so
    every band of a tile reads only its own records.  ``msaa4`` bins
    24-row MSAA records and rasterizes coverage MSAA-4x (per-sample planes
    (4, H, W); set up with bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP).  ``stencil``,
    ``two_pass`` and ``batch`` as in rasterize_binned.  ``id_offset`` is
    the draw's first triangle id, or a (T,) int32 tensor of per-triangle
    ids (a culled instanced draw's original ids): the binner writes them
    into the records, so every route's tri_id plane carries them.
    ``origin`` is the global pixel of the framebuffer's top-left corner
    (bin_triangles): ``width`` and ``height`` are then a window's extent,
    every route reads records anchored at global tile origins, and
    ``scissor`` is in the window's pixels.
    """
    _check_modes(sublane, sublane_group, bin_rows, tile_w, tile_h, depth_test, depth_write,
                 depth_compare, stencil, two_pass, batch, msaa4)
    num_ch = 0 if channels is None else channels.shape[-1]
    bin_kw = dict(
        max_pairs=max_pairs,
        id_offset=id_offset,
        channels=channels,
        perspective=perspective,
        slots=slots,
        assemble=assemble,
        tmpl=tmpl,
        msaa4=msaa4,
        origin=origin,
    )
    if bin_rows is None:
        binned = bin_triangles(ts, width, height, tile_w, tile_h, **bin_kw)
    else:
        bin_h = -(-height // tile_h) * tile_h
        binned = bin_triangles(
            ts, width, bin_h, tile_w, bin_rows, col_major_ids=True, anchor_rows=tile_h, **bin_kw
        )
    out = rasterize_binned(
        binned,
        width,
        height,
        tile_w=tile_w,
        tile_h=tile_h,
        depth_test=depth_test,
        depth_compare=depth_compare,
        depth_write=depth_write,
        depth_clip=depth_clip,
        depth_clear=depth_clear,
        init=init,
        num_channels=num_ch,
        scissor=scissor,
        skip_losers=skip_losers,
        unroll=unroll,
        sublane=sublane,
        sublane_group=sublane_group,
        bin_rows=bin_rows,
        two_pass=two_pass,
        msaa4=msaa4,
        stencil=stencil,
        stencil_clear=stencil_clear,
        batch=batch,
    )
    flags = (binned.overflowed, binned.pair_budget_use) if return_overflow else ()
    flags += (binned.num_pairs,) if return_pairs else ()
    if not flags:
        return out
    return (out, *flags) if num_ch == 0 else (*out, *flags)
