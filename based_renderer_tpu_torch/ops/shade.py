"""Deferred Blinn-Phong shading of one draw, its opaque composite and the
MSAA resolve, in one pass: the CUDA kernel and its plain version.

The renderer shades a draw from the raster's planes (``Renderer._shade_from``):
the raw interpolated varyings (K, [S,] H, W), divided by the 1/w plane,
the fragment shader, the composite over the colour so far where the draw
won the sample, and under coverage MSAA the box resolve of the four
sample layers.  For a draw whose shader is ``blinn_phong``, with blending
off and every channel written, ``shade_blinn_phong`` does all of that at
once: CUDA tensors launch ``csrc/shade_blinn_phong.cu``, which reads each
sample's tri_id, 1/w and varyings once and keeps everything else in
registers; CPU tensors take ``shade_blinn_phong_reference``, the same
operations in plain PyTorch, in the order and layout of the renderer's
own path (equal to it bit for bit).  ``blinn_phong`` is the fragment's
arithmetic, shared with ``shader.py``'s fragment shader.
"""

from __future__ import annotations

import torch

from ..utils.errors import FeatureNotPresentError
from . import _build

#: Wrapper calls of csrc/shade_blinn_phong.cu in this process: eager frames
#: and graph captures, never a graph's replay.
LAUNCHES = 0


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def blinn_phong(n, pos, base, light_pos, eye_pos, shininess, ambient) -> torch.Tensor:
    """Blinn-Phong (BASELINE config 5): ambient + diffuse + specular, rgb
    (..., 3) clamped to [0, 1], from the interpolated normal and world
    position (..., 3), the base colour (..., 3) and the uniforms (light and
    eye positions (3,), shininess and ambient ())."""
    n = n / torch.clamp_min(_norm(n), 1e-8)
    l = light_pos - pos  # noqa: E741
    l = l / torch.clamp_min(_norm(l), 1e-8)  # noqa: E741
    v = eye_pos - pos
    v = v / torch.clamp_min(_norm(v), 1e-8)
    h = l + v
    h = h / torch.clamp_min(_norm(h), 1e-8)
    ndotl = torch.clamp_min((n * l).sum(-1, keepdim=True), 0.0)
    ndoth = torch.clamp_min((n * h).sum(-1, keepdim=True), 0.0)
    spec = ndoth**shininess
    rgb = base * (ambient + ndotl) + 0.3 * spec
    return rgb.clamp(0.0, 1.0)


def shade_blinn_phong_reference(interp, invw, tri_id, lo: int, hi: int, color, light_pos, eye_pos, base_color,
                                shininess, ambient, resolve: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``shade_blinn_phong``, on any device."""
    coverage = tri_id.dim() == 3
    interp = interp / torch.where(invw == 0, torch.ones((), dtype=invw.dtype, device=invw.device), invw)[None]
    k = interp.shape[0]
    var = interp.movedim(0, -1)
    base = var[..., :3] if k == 9 else base_color.expand(*var.shape[:-1], 3)
    rgb = blinn_phong(var[..., k - 6 : k - 3], var[..., k - 3 :], base, light_pos, eye_pos, shininess, ambient)
    rgba = torch.cat([rgb, torch.ones((*rgb.shape[:-1], 1), dtype=rgb.dtype, device=rgb.device)], -1).movedim(-1, -3)
    if color.dim() == 1:
        color = color.reshape(4, 1, 1).expand(rgba.shape)
    won = (tri_id >= lo) & (tri_id < hi)
    out = torch.where(won[:, None] if coverage else won, rgba, color)
    return out.mean(dim=0) if coverage and resolve else out


def _uniform_operand(name, u, dev, sizes):
    """A uniform as (pointer, stride): a float32 tensor on ``dev`` of one
    value (stride 0, broadcast) or, for a vector, of three."""
    flat = u.reshape(-1).contiguous()
    if flat.device != dev or flat.dtype != torch.float32 or flat.numel() not in sizes:
        raise ValueError(f"uniform {name} must be float32 on {dev} with {' or '.join(map(str, sizes))} values, "
                         f"got {u.dtype} {tuple(u.shape)} on {u.device}")
    return flat, int(flat.numel() > 1)


def _shade_kernel(interp, invw, tri_id, lo, hi, color, light_pos, eye_pos, base_color, shininess, ambient,
                  resolve):
    """Launch csrc/shade_blinn_phong.cu and add one to LAUNCHES."""
    global LAUNCHES
    interp, invw, tri_id, color = interp.contiguous(), invw.contiguous(), tri_id.contiguous(), color.contiguous()
    dev = tri_id.device
    plane = tuple(tri_id.shape)
    k = interp.shape[0]
    if k not in (6, 9):
        raise ValueError(f"interp has {k} channels; blinn_phong's are 6 (normal, pos_ws) or 9 (color first)")
    _build.check_operand("tri_id", tri_id, torch.int32, plane, dev)
    _build.check_operand("interp", interp, torch.float32, (k, *plane), dev)
    _build.check_operand("invw", invw, torch.float32, plane, dev)
    samples = 4 if len(plane) == 3 else 1
    h, w = plane[-2:]
    clear = color.dim() == 1
    _build.check_operand("color", color, torch.float32, (4,) if clear else (*plane[:-2], 4, h, w), dev)
    vecs = [_uniform_operand(n, u, dev, (1, 3)) for n, u in
            (("light_pos", light_pos), ("eye_pos", eye_pos), ("base_color", base_color))]
    scalars = [_uniform_operand(n, u, dev, (1,))[0] for n, u in (("shininess", shininess), ("ambient", ambient))]
    resolve = resolve and samples == 4
    out = torch.empty((4, h, w) if resolve or samples == 1 else (samples, 4, h, w), dtype=torch.float32, device=dev)
    lib = _build.load()
    rc = lib.brt_shade_blinn_phong(
        _build.ptr(interp), _build.ptr(invw), _build.ptr(tri_id), lo, hi,
        _build.ptr(color), int(clear),
        *[a for t, s in vecs for a in (_build.ptr(t), s)],
        *[_build.ptr(t) for t in scalars],
        _build.ptr(out), samples, h * w, k, int(resolve), _build.stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"shade_blinn_phong kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def shade_blinn_phong(interp, invw, tri_id, lo: int, hi: int, color, light_pos, eye_pos, base_color, shininess,
                      ambient, resolve: bool = False) -> torch.Tensor:
    """Shade one draw with Blinn-Phong and composite it opaquely.

    ``interp`` (K, [S,] H, W) float32 holds the raw interpolated varyings
    in the renderer's channel order: K = 6 (normal, pos_ws), or 9 with the
    per-vertex colour first, which then replaces ``base_color``.  ``invw``
    ([S,] H, W) is the 1/w plane they are divided by (where it is 0, by
    1).  ``tri_id`` ([S,] H, W) int32
    is the draw's visibility snapshot: the draw won a sample where ``lo <=
    tri_id < hi``.  ``color`` is the colour so far, ([S,] 4, H, W), or the
    (4,) clear colour.  The uniforms are float32 tensors: ``light_pos``,
    ``eye_pos`` and ``base_color`` of 3 values (or one, broadcast),
    ``shininess`` and ``ambient`` of one.  S = 4 is coverage MSAA-4x.

    Returns the new colour, ([S,] 4, H, W); with ``resolve`` under S = 4,
    the box resolve (4, H, W), the mean of the four sample layers.  CUDA
    tensors launch the kernel, CPU tensors take the plain version.
    """
    dev = tri_id.device
    if dev.type == "cpu":
        return shade_blinn_phong_reference(interp, invw, tri_id, lo, hi, color, light_pos, eye_pos, base_color,
                                           shininess, ambient, resolve)
    if dev.type != "cuda":
        raise FeatureNotPresentError(f"no shading path for device {dev}")
    return _shade_kernel(interp, invw, tri_id, lo, hi, color, light_pos, eye_pos, base_color, shininess, ambient,
                         resolve)
