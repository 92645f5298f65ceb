"""Texture sampling (the fixed-function sampler analog).

The PyTorch counterpart of ``based_renderer_tpu/ops/texture.py``, with the
same semantics: texel centers at (i + 0.5) / size, u right and v down,
"repeat" and "clamp" address modes ("mirror" for the raw-array samplers),
box-filtered mip chains with the LOD from screen-space UV differences.

Two tiers:
  * raw-array samplers (sample_nearest / sample_bilinear) build the 2x2
    neighborhood on the fly;
  * scene.Texture samplers (sample_texture / sample_trilinear /
    sample_anisotropic) read the patch rows prebuilt at upload (one flat
    gather per tap) at a per-pixel mip level, picked from the static
    level extents with a short ``where`` chain.

Every sampler takes any leading axes: a full (H, W, 2) field, a batch of
sample layers (4, H, W, 2) or a batch of tiles (B, 8, 128, 2).  The screen
axes, where lod_from_uv and sample_anisotropic take their differences,
are the two before the last, (-3, -2).

``sample_separable`` is the JAX package's one-hot-matmul resampler for
screen-axis-aligned UV fields.  A one-hot matmul only fetches texels, and
here the same texels come from one gather (row select x column select),
so no TF32 or matmul rounding can reach them.
"""

from __future__ import annotations

import torch

from ..scene import Texture
from . import fixedpoint as fp

_I32 = torch.int32
_F32 = torch.float32


def _wrap_coord(c: torch.Tensor, size, mode: str) -> torch.Tensor:
    if mode == "repeat":
        return torch.remainder(c, size)
    if mode == "clamp":
        return c.clamp(0, size - 1)
    if mode == "mirror":
        period = 2 * size
        m = torch.remainder(c, period)
        return torch.where(m >= size, period - 1 - m, m)
    raise ValueError(f"bad wrap mode {mode!r}")


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(_I32)


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor, wrap: str = "repeat") -> torch.Tensor:
    """Nearest-neighbor sample.  uv: (..., 2) in [0,1] texture space."""
    th, tw = tex.shape[0], tex.shape[1]
    x = _wrap_coord(_floor_i32(uv[..., 0] * tw), tw, wrap)
    y = _wrap_coord(_floor_i32(uv[..., 1] * th), th, wrap)
    return tex.reshape(th * tw, -1)[(y * tw + x).long()]


def _shift_clamped(tex: torch.Tensor, axis: int) -> torch.Tensor:
    """tex shifted by -1 along axis with edge-clamp semantics."""
    n = tex.shape[axis]
    return torch.cat([tex.narrow(axis, 1, n - 1), tex.narrow(axis, n - 1, 1)], dim=axis)


def _lerp_patch(p: torch.Tensor, c: int, ax: torch.Tensor, ay: torch.Tensor) -> torch.Tensor:
    """Bilinear blend of a gathered (..., 4*C) patch row."""
    t00, t01, t10, t11 = p[..., :c], p[..., c : 2 * c], p[..., 2 * c : 3 * c], p[..., 3 * c :]
    top = t00 * (1.0 - ax) + t01 * ax
    bot = t10 * (1.0 - ax) + t11 * ax
    return top * (1.0 - ay) + bot * ay


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor, wrap: str = "repeat") -> torch.Tensor:
    """Bilinear sample with texel centers at (i + 0.5) / size.

    For "repeat" and "clamp" each texel's 2x2 neighborhood is packed into
    one row, so a tap is one flat gather; "mirror" takes four.
    """
    th, tw = tex.shape[0], tex.shape[1]
    fx = uv[..., 0] * tw - 0.5
    fy = uv[..., 1] * th - 0.5
    x0 = _floor_i32(fx)
    y0 = _floor_i32(fy)
    ax = (fx - x0.to(_F32))[..., None]
    ay = (fy - y0.to(_F32))[..., None]
    x0w = _wrap_coord(x0, tw, wrap)
    y0w = _wrap_coord(y0, th, wrap)
    c = tex.shape[-1]
    if wrap == "clamp":
        # Below the low edge both taps clamp to texel 0, but the packed
        # patch's +1 neighbor is texel 1: neutralize the blend there.
        ax = torch.where((x0 < 0)[..., None], 0.0, ax)
        ay = torch.where((y0 < 0)[..., None], 0.0, ay)
    if wrap in ("repeat", "clamp"):
        if wrap == "repeat":
            tx1 = torch.roll(tex, -1, dims=1)
            ty1 = torch.roll(tex, -1, dims=0)
            txy = torch.roll(tx1, -1, dims=0)
        else:
            tx1 = _shift_clamped(tex, 1)
            ty1 = _shift_clamped(tex, 0)
            txy = _shift_clamped(tx1, 0)
        patch = torch.cat([tex, tx1, ty1, txy], dim=-1).reshape(th * tw, 4 * c)
        return _lerp_patch(patch[(y0w * tw + x0w).long()], c, ax, ay)
    flat = tex.reshape(th * tw, -1)  # mirror: four flat gathers
    x1w = _wrap_coord(x0 + 1, tw, wrap)
    y1w = _wrap_coord(y0 + 1, th, wrap)
    p = torch.cat(
        [flat[(y0w * tw + x0w).long()], flat[(y0w * tw + x1w).long()],
         flat[(y1w * tw + x0w).long()], flat[(y1w * tw + x1w).long()]],
        dim=-1,
    )
    return _lerp_patch(p, c, ax, ay)


# ---------------------------------------------------------------------------
# scene.Texture samplers (prebuilt patch rows + mip chain)
# ---------------------------------------------------------------------------


def _select_by_level(lvl: torch.Tensor, values) -> torch.Tensor:
    """Per-pixel select from a short static list (a where chain)."""
    out = torch.full(lvl.shape, int(values[0]), dtype=_I32, device=lvl.device)
    for i, v in enumerate(values[1:], start=1):
        out = torch.where(lvl == i, int(v), out)
    return out


def _level_offsets(sizes) -> list[int]:
    offs = [0]
    for h, w in sizes:
        offs.append(offs[-1] + h * w)
    return offs[:-1]


def _wrap_axis(tex: Texture, c0: torch.Tensor, size: torch.Tensor, a: torch.Tensor):
    """Wrapped first texel index along one axis at per-pixel level extents
    ``size``, and the blend weight ``a`` (..., 1) of the +1 neighbor."""
    wrap, _c, sizes = tex.meta[:3]
    if wrap == "repeat":
        if all(h & (h - 1) == 0 and w & (w - 1) == 0 for h, w in sizes):
            return c0 & (size - 1), a  # the exact mod for powers of two
        return torch.remainder(c0, size), a
    # clamp: below the low edge the packed +1 neighbor is texel 1, so the
    # blend toward it is neutralized there.
    return torch.minimum(torch.clamp_min(c0, 0), size - 1), torch.where((c0 < 0)[..., None], 0.0, a)


def _sample_packed_level(tex: Texture, uv: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """Bilinear tap from the packed patch rows at a per-pixel mip level.

    uv: (..., 2); lvl: (...) int in [0, L).  One flat gather.
    """
    _wrap, c, sizes = tex.meta[:3]
    w_v = _select_by_level(lvl, [w for _h, w in sizes])
    h_v = _select_by_level(lvl, [h for h, _w in sizes])
    off_v = _select_by_level(lvl, _level_offsets(sizes))
    fx = uv[..., 0] * w_v.to(_F32) - 0.5
    fy = uv[..., 1] * h_v.to(_F32) - 0.5
    x0 = _floor_i32(fx)
    y0 = _floor_i32(fy)
    ax = (fx - x0.to(_F32))[..., None]
    ay = (fy - y0.to(_F32))[..., None]
    x0w, ax = _wrap_axis(tex, x0, w_v, ax)
    y0w, ay = _wrap_axis(tex, y0, h_v, ay)
    return _lerp_patch(tex.packed[(off_v + y0w * w_v + x0w).long()], c, ax, ay)


def _screen_diffs(uv: torch.Tensor):
    """Forward differences of a (..., H, W, 2) field along x and y, the
    last column/row clamped (a zero difference there)."""
    du_dx = torch.diff(uv, dim=-2, append=uv[..., -1:, :])
    du_dy = torch.diff(uv, dim=-3, append=uv[..., -1:, :, :])
    return du_dx, du_dy


def lod_from_uv(uv: torch.Tensor, tex_h: int, tex_w: int) -> torch.Tensor:
    """Mip LOD from screen-space forward differences of the UV field.

    uv: (..., H, W, 2).  Differences run over the two screen axes (-3, -2)
    with the last row/column clamped, so object edges (and, under
    compacted shading, tile edges) inherit their neighbor's LOD, the
    artifact 2x2-quad derivatives have on a GPU.
    """
    du_dx, du_dy = _screen_diffs(uv)
    scale = fp.consts([tex_w, tex_h], uv.device)
    rho = torch.maximum((du_dx.abs() * scale).amax(dim=-1), (du_dy.abs() * scale).amax(dim=-1))
    return torch.log2(torch.clamp_min(rho, 1e-12))


def sample_texture(tex, uv: torch.Tensor, lod: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a scene.Texture honoring its sampler state: bilinear (single
    level or no LOD), nearest-mip (one tap at the rounded LOD) or
    trilinear.  A raw (H, W, C) tensor takes sample_bilinear."""
    if not isinstance(tex, Texture):
        return sample_bilinear(tex, uv)
    if tex.num_levels == 1 or lod is None:
        return _sample_packed_level(tex, uv, torch.zeros(uv.shape[:-1], dtype=_I32, device=uv.device))
    if tex.mip_filter == "nearest":
        lvl = torch.clamp(torch.round(lod).to(_I32), 0, tex.num_levels - 1)
        return _sample_packed_level(tex, uv, lvl)
    return sample_trilinear(tex, uv, lod)


def sample_trilinear(tex: Texture, uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Trilinear mip sample: bilinear taps at the floor/ceil levels, lerped."""
    lodc = torch.clamp(lod, 0.0, float(tex.num_levels - 1))
    l0 = torch.floor(lodc).to(_I32)
    l1 = torch.clamp_max(l0 + 1, tex.num_levels - 1)
    frac = (lodc - l0.to(_F32))[..., None]
    s0 = _sample_packed_level(tex, uv, l0)
    s1 = _sample_packed_level(tex, uv, l1)
    return s0 * (1.0 - frac) + s1 * frac


def _sep_level(tex: Texture, u_row: torch.Tensor, v_col: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """Separable bilinear tap at one mip level per layer: lvl (...) int,
    u_row (..., W), v_col (..., H) -> (..., H, W, C).

    The row and column coordinates, blend weights and wrap are computed
    once per column and once per row, as the JAX package's one-hot
    matmuls do; the fetch is one gather of each pixel's patch row."""
    _wrap, c, sizes = tex.meta[:3]
    ws = _select_by_level(lvl, [w for _h, w in sizes])  # (...)
    hs = _select_by_level(lvl, [h for h, _w in sizes])
    off = _select_by_level(lvl, _level_offsets(sizes))
    fx = u_row * ws[..., None].to(_F32) - 0.5  # (..., W)
    fy = v_col * hs[..., None].to(_F32) - 0.5  # (..., H)
    x0 = _floor_i32(fx)
    y0 = _floor_i32(fy)
    ax = (fx - x0.to(_F32))[..., None]  # (..., W, 1)
    ay = (fy - y0.to(_F32))[..., None]  # (..., H, 1)
    x0w, ax = _wrap_axis(tex, x0, ws[..., None], ax)
    y0w, ay = _wrap_axis(tex, y0, hs[..., None], ay)
    idx = (off[..., None, None] + y0w[..., :, None] * ws[..., None, None] + x0w[..., None, :]).long()
    return _lerp_patch(tex.packed[idx], c, ax[..., None, :, :], ay[..., :, None, :])


def sample_separable(tex: Texture, u_row: torch.Tensor, v_col: torch.Tensor, lod=None) -> torch.Tensor:
    """Separable resampling for screen-axis-aligned UV fields.

    When u depends only on pixel x and v only on pixel y (full-screen
    quads, blits, sprites, skies) the per-pixel tap factors into a row
    select and a column select.  Sampling semantics (wrap, texel centers,
    mip dispatch) mirror sample_texture with a CONSTANT LOD per layer: for
    an affine mapping the UV derivative is constant, so the scalar LOD is
    the analytic one (the per-pixel path differs only at the last
    row/column, where its clamped forward differences bend).

    u_row (..., W), v_col (..., H) f32; lod None or (...) f32 (one per
    layer).  Returns (..., H, W, C).
    """
    if not isinstance(tex, Texture):
        raise ValueError("sample_separable requires a scene.Texture")
    lead = u_row.shape[:-1]
    if tex.num_levels == 1 or lod is None:
        return _sep_level(tex, u_row, v_col, torch.zeros(lead, dtype=torch.long, device=u_row.device))
    if not isinstance(lod, torch.Tensor):
        lod = torch.full((), lod, dtype=_F32, device=u_row.device)
    lod = lod.to(_F32).expand(lead)
    last = tex.num_levels - 1
    if tex.mip_filter == "nearest":
        return _sep_level(tex, u_row, v_col, torch.clamp(torch.round(lod).to(_I32), 0, last).long())
    lodc = torch.clamp(lod, 0.0, float(last))
    l0 = torch.floor(lodc).to(_I32)
    l1 = torch.clamp_max(l0 + 1, last)
    frac = (lodc - l0.to(_F32))[..., None, None, None]
    s0 = _sep_level(tex, u_row, v_col, l0.long())
    s1 = _sep_level(tex, u_row, v_col, l1.long())
    return s0 * (1.0 - frac) + s1 * frac


def sample_anisotropic(tex: Texture, uv: torch.Tensor, max_aniso: int = 4) -> torch.Tensor:
    """Anisotropic filtering (VkSamplerCreateInfo.maxAnisotropy analog).

    uv: (..., H, W, 2) screen-space field.  Takes ``max_aniso`` bilinear
    taps spaced along the major footprint axis at the LOD of the footprint
    divided across the taps, box-averaged.  max_aniso=1 degenerates to a
    single nearest-mip tap.
    """
    if max_aniso < 1:
        raise ValueError("max_aniso must be >= 1")
    th, tw = tex.meta[2][0]
    scale = fp.consts([tw, th], uv.device)
    du_dx, du_dy = _screen_diffs(uv)
    du_dx = du_dx * scale
    du_dy = du_dy * scale
    lx = torch.sqrt((du_dx * du_dx).sum(-1))
    ly = torch.sqrt((du_dy * du_dy).sum(-1))
    major_is_x = lx >= ly
    rho_maj = torch.clamp_min(torch.maximum(lx, ly), 1e-12)
    rho_min = torch.clamp_min(torch.minimum(lx, ly), 1e-12)
    # Taps the footprint wants, capped by the sampler state; the LOD comes
    # from the footprint divided across the taps.
    n = torch.clamp(torch.ceil(rho_maj / rho_min), 1.0, float(max_aniso))
    lod = torch.log2(torch.clamp_min(rho_maj / n, 1e-12))
    lvl = torch.clamp(torch.round(lod).to(_I32), 0, tex.num_levels - 1)
    axis = torch.where(major_is_x[..., None], du_dx, du_dy) / scale  # major-axis step in uv units
    acc = wsum = None
    for i in range(max_aniso):
        # Tap positions (i + 0.5)/n - 0.5 along the axis; taps past the
        # per-pixel count fold onto the last valid position with zero weight.
        t = (i + 0.5) / n - 0.5
        w = (i < n).to(_F32)
        s = _sample_packed_level(tex, uv + (t * w)[..., None] * axis, lvl)
        acc = s * w[..., None] if acc is None else acc + s * w[..., None]
        wsum = w if wsum is None else wsum + w
    return acc / wsum[..., None]
