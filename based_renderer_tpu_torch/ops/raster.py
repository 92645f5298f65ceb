"""Tile-binned visibility rasterizer: the CUDA kernel and its plain version.

The PyTorch counterpart of ``based_renderer_tpu/ops/raster_pallas.py``
(``rasterize_vis_pallas`` / ``rasterize_binned`` with the sequential
``_raster_kernel``) and of ``raster_xla.VisBuffer``.  ``rasterize_binned``
launches the hand-written Hopper kernel (``csrc/raster_tile.cu``) on CUDA
tensors and runs the plain PyTorch version, ``rasterize_binned_reference``,
on CPU tensors.  Both return the same planes bit for bit: tri_id and
depth_q are integer arithmetic, and every float plane is evaluated as
(p0 + pdx*ix) + pdy*iy in single IEEE operations.

Per pixel, the winner is the last record of the tile (in draw order)
that covers the pixel and passes the depth test; its planes are
evaluated once at the end (see the kernel's header note).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.errors import FeatureNotPresentError
from . import fixedpoint as fp
from .binning import bin_triangles
from .setup import TriSetup

#: Launches of the CUDA raster kernel in this process (main-path proof).
KERNEL_LAUNCHES = 0

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


class VisBuffer(NamedTuple):
    """Per-pixel visibility: which triangle won, at what depth, where."""

    tri_id: torch.Tensor  # int32 (H, W), -1 = background
    depth_q: torch.Tensor  # int32 (H, W) quantized depth (1.0 == 2^30)
    b0: torch.Tensor  # f32 (H, W) barycentric weight of v0
    b1: torch.Tensor  # f32 (H, W)
    b2: torch.Tensor  # f32 (H, W)
    stencil: torch.Tensor | None = None  # not produced by this slice

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


def _check_slice(stencil, two_pass, msaa4, batch, sublane, bin_rows):
    for knob, on, step in (
        ("stencil", stencil is not None and getattr(stencil, "enable", True), "A.10"),
        ("msaa4", msaa4, "A.9 and queue B4/B5"),
        ("two_pass", two_pass, "queue B6"),
        ("batch", batch, "queue B7"),
        ("sublane", sublane, "A.8 and queue B2"),
        ("bin_rows", bin_rows is not None, "A.8 and queue B2"),
    ):
        if on:
            raise FeatureNotPresentError(f"{knob} rasterization is not ported yet (ROADMAP {step})")


def _check_tile(tile_w: int, tile_h: int):
    # The anchored int32 stepping is exact only for tile dims dividing 128.
    for d in (tile_w, tile_h):
        if d <= 0 or 128 % d:
            raise ValueError(f"raster tile dims must divide 128, got {(tile_w, tile_h)}")


def _package(ints: torch.Tensor, floats: torch.Tensor, num_channels: int):
    vis = VisBuffer(tri_id=ints[0], depth_q=ints[1], b0=floats[0], b1=floats[1], b2=floats[2])
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
):
    """Plain PyTorch raster over all tiles at once.

    Each tile's record list is padded to the largest count; a loop over
    the record index updates the (num_tiles, th, tw) state with
    torch.where.  Returns (ints (2, H, W), floats (4 + K, H, W)).
    """
    dev = binned.records.device
    i32 = torch.int32
    num_tx = -(-width // tile_w)
    num_ty = -(-height // tile_h)
    nt = num_tx * num_ty
    pad_h, pad_w = num_ty * tile_h, num_tx * tile_w

    def to_tiles(x, fill):  # (H, W) -> (nt, th, tw), padded with ``fill``
        x = torch.nn.functional.pad(x, (0, pad_w - width, 0, pad_h - height), value=fill)
        return x.reshape(num_ty, tile_h, num_tx, tile_w).permute(0, 2, 1, 3).reshape(nt, tile_h, tile_w)

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
        zbuf = torch.full((nt, tile_h, tile_w), clear_q, dtype=i32, device=dev)
        ids = torch.full((nt, tile_h, tile_w), -1, dtype=i32, device=dev)
    win = torch.full((nt, tile_h, tile_w), -1, dtype=torch.int64, device=dev)

    start = binned.tile_start.to(torch.int64)
    count = binned.tile_count.to(torch.int64)
    max_count = int(count.max()) if nt else 0
    if max_count:
        r_idx = torch.arange(max_count, device=dev)
        slot = start[:, None] + r_idx[None, :]  # (nt, max_count)
        in_tile = r_idx[None, :] < count[:, None]
        slot = torch.where(in_tile, slot, 0)
        rec = binned.records[:14][:, slot]  # (14, nt, max_count) int32
        one_q = fp.DEPTH_ONE_Q
        for r in range(max_count):
            f = rec[:, :, r][:, :, None, None]  # (14, nt, 1, 1)
            e0 = f[0] + f[3] * ix + f[6] * iy
            e1 = f[1] + f[4] * ix + f[7] * iy
            e2 = f[2] + f[5] * ix + f[8] * iy
            passes = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & in_sc
            passes &= in_tile[:, r][:, None, None]
            zshift = f[12].to(torch.int64)
            z_u = (f[9] + f[10] * ix + f[11] * iy).to(torch.int64)
            hi = (torch.full_like(zshift, 1 << 29) >> zshift) + 1
            z_c = torch.maximum(torch.minimum(z_u, hi), -hi)
            z = (z_c * (torch.ones_like(zshift) << zshift) + (1 << 29)).to(i32)
            if clip_mode == 2:
                z = z.clamp(0, one_q)
            elif clip_mode == 1:
                passes &= (z >= 0) & (z <= one_q)
            if depth_test:
                passes &= _compare(depth_compare, z, zbuf)
            if depth_write:
                zbuf = torch.where(passes, z, zbuf)
            ids = torch.where(passes, f[13], ids)
            win = torch.where(passes, slot[:, r][:, None, None], win)

    # Float planes of the winner, evaluated once.
    won = win >= 0
    w_slot = win.clamp_min(0)
    ixf = ix.to(torch.float32)
    iyf = iy.to(torch.float32)
    fr = binned.frecords

    def plane(row):
        p0, pdx, pdy = fr[row][w_slot], fr[row + 1][w_slot], fr[row + 2][w_slot]
        return (p0 + pdx * ixf) + pdy * iyf

    zeros = torch.zeros((nt, tile_h, tile_w), dtype=torch.float32, device=dev)
    if init is not None:
        base = [to_tiles(init.b0, 0.0), to_tiles(init.b1, 0.0), to_tiles(init.b2, 0.0)]
    else:
        base = [zeros, zeros, zeros]
    b0 = torch.where(won, plane(0), base[0])
    b1 = torch.where(won, plane(3), base[1])
    b2 = torch.where(won, (1.0 - b0) - b1, base[2])
    invw = torch.where(won, plane(6), torch.ones_like(zeros))
    chans = [torch.where(won, plane(9 + 3 * c), zeros) for c in range(num_channels)]

    def untile(x):  # (n, nt, th, tw) -> (n, H, W)
        n = x.shape[0]
        x = x.reshape(n, num_ty, num_tx, tile_h, tile_w).permute(0, 1, 3, 2, 4)
        return x.reshape(n, pad_h, pad_w)[:, :height, :width].contiguous()

    ints = untile(torch.stack([ids, zbuf]))
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


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


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
):
    """Launch csrc/raster_tile.cu; returns (ints (2, H, W), floats (4 + K, H, W))."""
    global KERNEL_LAUNCHES
    from . import _build

    records, frecords = binned.records, binned.frecords
    dev = records.device
    stride = records.shape[1]
    num_tx = -(-width // tile_w)
    num_tiles = num_tx * -(-height // tile_h)
    for name, t, dtype, shape in (
        ("records", records, torch.int32, (None, stride)),
        ("frecords", frecords, torch.float32, (None, stride)),
        ("tile_start", binned.tile_start, torch.int32, (num_tiles,)),
        ("tile_count", binned.tile_count, torch.int32, (num_tiles,)),
    ):
        _check_operand(name, t, dtype, shape, dev)
    if records.shape[0] < 14:
        raise ValueError(f"records need at least 14 rows, got {records.shape[0]}")
    if frecords.shape[0] < 9 + 3 * num_channels:
        raise ValueError(
            f"frecords have {frecords.shape[0]} rows; {num_channels} channels need {9 + 3 * num_channels}"
        )
    init_t = [None] * 5
    if init is not None:
        init_t = [init.tri_id, init.depth_q, init.b0, init.b1, init.b2]
        for name, t, dtype in zip(
            ("tri_id", "depth_q", "b0", "b1", "b2"), init_t, (torch.int32,) * 2 + (torch.float32,) * 3
        ):
            _check_operand("init." + name, t, dtype, (height, width), dev)
    ints = torch.empty((2, height, width), dtype=torch.int32, device=dev)
    floats = torch.empty((4 + num_channels, height, width), dtype=torch.float32, device=dev)
    sc = (0, 0, 0, 0) if scissor is None else tuple(int(v) for v in scissor)
    lib = _build.load()
    rc = lib.brt_raster_tile(
        _ptr(records),
        _ptr(frecords),
        stride,
        _ptr(binned.tile_start),
        _ptr(binned.tile_count),
        num_tiles,
        *[_ptr(t) for t in init_t],
        _ptr(ints),
        _ptr(floats),
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
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"raster_tile kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return ints, floats


def _check_operand(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _rasterize(
    planes_fn,
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
    _check_slice(stencil, two_pass, msaa4, batch, sublane, bin_rows)
    if depth_compare not in _COMPARE_OPS:
        raise ValueError(f"bad depth compare {depth_compare!r}; one of {_COMPARE_OPS}")
    _check_tile(tile_w, tile_h)
    ints, floats = planes_fn(
        binned,
        width,
        height,
        tile_w,
        tile_h,
        depth_test,
        depth_compare,
        depth_write,
        _clip_mode(depth_clip),
        int(round(depth_clear * fp.DEPTH_ONE_Q)),
        init,
        num_channels,
        scissor,
    )
    return _package(ints, floats, num_channels)


def rasterize_binned(binned, *args, **kwargs):
    """Rasterize an already-binned record stream (see bin_triangles).

    Arguments as in the JAX package's raster_pallas.rasterize_binned: (binned,
    width, height, tile_w=128, tile_h=32, depth_test=True,
    depth_compare="less", depth_write=True, depth_clip=True,
    depth_clear=1.0, init=None, num_channels=0, scissor=None, ...).
    CUDA tensors launch the Hopper kernel; CPU tensors take the plain
    PyTorch version.  Returns a VisBuffer when ``num_channels`` is 0, else
    (vis, interp (K, H, W), invw (H, W)).  ``skip_losers``, ``unroll`` and
    ``sublane_group`` only schedule work on a TPU: they are accepted and
    change nothing.  Stencil, MSAA, two-pass, batched, sublane and band
    rasterization raise FeatureNotPresentError.
    """
    dev = binned.records.device
    if dev.type == "cuda":
        return _rasterize(_raster_planes_kernel, binned, *args, **kwargs)
    if dev.type == "cpu":
        return _rasterize(_raster_planes_reference, binned, *args, **kwargs)
    raise FeatureNotPresentError(f"no raster path for device {dev}")


def rasterize_binned_reference(binned, *args, **kwargs):
    """The plain PyTorch version of rasterize_binned, on any device."""
    return _rasterize(_raster_planes_reference, binned, *args, **kwargs)


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
    id_offset: int = 0,
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
):
    """Bin and rasterize: the counterpart of rasterize_vis_pallas.

    Tiles past the framebuffer edge are rasterized as padding and cropped
    (the kernel simply skips pixels outside the extent).  ``channels``
    (T, 3, K) are interpolated in-raster; the result is then (vis, interp
    (K, H, W), invw (H, W)) instead of vis.  ``return_overflow`` appends
    the binner's overflow flag.
    """
    _check_slice(stencil, two_pass, msaa4, batch, sublane, bin_rows)
    num_ch = 0 if channels is None else channels.shape[-1]
    binned = bin_triangles(
        ts,
        width,
        height,
        tile_w,
        tile_h,
        max_pairs,
        id_offset,
        channels=channels,
        perspective=perspective,
        slots=slots,
        assemble=assemble,
        tmpl=tmpl,
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
        sublane_group=sublane_group,
    )
    if not return_overflow:
        return out
    if num_ch == 0:
        return out, binned.overflowed
    return (*out, binned.overflowed)
