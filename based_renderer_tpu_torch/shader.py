"""Shader system: vertex/fragment programs as Python functions on tensors.

The counterpart of ``based_renderer_tpu/shader.py`` for the main path's
shaders.  ABI:
  vertex(attrs, uniforms) -> (clip_pos (N, 4), varyings dict[str, (N, C)])
  fragment(frag, uniforms) -> rgba (..., H, W, 4) float32
      frag: interpolated (..., H, W, C) varyings plus "tri_id" (..., H, W)
            int32, "depth" (..., H, W) f32 and "bary" (..., H, W, 3) f32.
A fragment shader takes leading batch axes where the JAX package vmaps
it: the four sample layers of coverage MSAA, (4, H, W, C), and the tiles
of compacted shading, (B, 8, 128, C).  Each batch entry is one image, so
screen-space differences (texture LOD) stay within it.  The dense-mesh
demos' ``blinn_phong`` and ``instanced_color`` and the textured shaders
(BASELINE config 3) are here; shader modules loaded from files arrive
with a later slice (ROADMAP A.14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import math3d
from .ops import fixedpoint as fp
from .ops import texture as tex_ops
from .ops.vertex import apply_instance_transform
from .scene import Texture
from .utils.errors import ShaderError


@dataclass(frozen=True)
class Shader:
    name: str
    vertex: Callable
    fragment: Callable
    # Names of the vertex attributes this shader consumes (besides position).
    attributes: tuple = ()


_REGISTRY: dict[str, Shader] = {}


def register(shader: Shader) -> Shader:
    _REGISTRY[shader.name] = shader
    return shader


def get(name: str) -> Shader:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ShaderError(f"unknown shader {name!r}; registered: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def mvp_transform(attrs, uniforms):
    """clip = proj @ view @ model @ pos, one (N, 4) x (4, 4) matmul."""
    mvp = uniforms["proj"] @ uniforms["view"] @ uniforms["model"]
    return math3d.transform_points(mvp, attrs["position"])


REFERENCE_COLOR = (0.1, 0.2, 0.3, 1.0)  # constant ps color, triangle.slang:17


def _passthrough_vs(attrs, uniforms):
    """NDC passthrough: vertices are already in NDC."""
    p = attrs["position"]
    lead = p.shape[:-1]
    if p.shape[-1] == 3:
        p = torch.cat([p, torch.ones((*lead, 1), dtype=p.dtype, device=p.device)], -1)
    elif p.shape[-1] == 2:
        p = torch.cat([p, p.new_zeros((*lead, 1)), p.new_ones((*lead, 1))], -1)
    return p, {}


def _const_color_fs(frag, uniforms):
    color = uniforms.get("color", REFERENCE_COLOR) if isinstance(uniforms, dict) else REFERENCE_COLOR
    tri = frag["tri_id"]
    return _as_f32(color, tri).expand(*tri.shape, 4)


register(Shader("flat_ndc", _passthrough_vs, _const_color_fs))
"""The triangle.slang program: NDC positions, constant color."""


def _mvp_vs(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {}


register(Shader("flat_mvp", _mvp_vs, _const_color_fs))
"""The cube.slang program: MVP transform, constant color."""


def _color_vs(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}


def _vertex_color_fs(frag, uniforms):
    return _opaque(frag["color"])


register(Shader("vertex_color", _color_vs, _vertex_color_fs, attributes=("color",)))
"""Per-vertex color with smooth interpolation (BASELINE config 2)."""


def _ndc_color_vs(attrs, uniforms):
    clip, _ = _passthrough_vs(attrs, uniforms)
    return clip, {"color": attrs["color"]}


register(Shader("ndc_color", _ndc_color_vs, _vertex_color_fs, attributes=("color",)))


def _opaque(rgb: torch.Tensor) -> torch.Tensor:
    """rgb (..., 3) with alpha 1 appended."""
    return torch.cat([rgb, torch.ones((*rgb.shape[:-1], 1), dtype=rgb.dtype, device=rgb.device)], -1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _textured_fullscreen_vs(attrs, uniforms):
    clip, _ = _passthrough_vs(attrs, uniforms)
    # A per-frame UV scroll keeps benchmark frames distinct.
    uv = attrs["uv"]
    if "uv_offset" in uniforms:
        uv = uv + uniforms["uv_offset"]
    return clip, {"uv": uv}


def _textured_fullscreen_fs(frag, uniforms, separable: bool = True):
    """Full-screen texture fetch: one (bilinear or trilinear) tap per pixel
    times a scalar tint, the sampler-floor workload.

    The companion geometry (geometry.fullscreen_quad_data) maps UV
    axis-aligned to the screen, so on a whole image (each axis at least
    64 pixels: not an (8, 128) tile of compacted shading) it samples with
    the separable resampler at the constant LOD of that mapping.  The
    "textured_fullscreen_gather" variant keeps the per-pixel path.
    """
    tex = uniforms["texture"]
    uv = frag["uv"]
    mipped = isinstance(tex, Texture) and tex.num_levels > 1
    sep_ok = separable and isinstance(tex, Texture) and uv.shape[-3] >= 64 and uv.shape[-2] >= 64
    if sep_ok:
        u_row = uv[..., 0, :, 0]  # (..., W)
        v_col = uv[..., :, 0, 1]  # (..., H)
        lod = None
        if mipped:
            th, tw = tex.meta[2][0]
            rho = torch.maximum(
                (u_row[..., 1] - u_row[..., 0]).abs() * float(tw),
                (v_col[..., 1] - v_col[..., 0]).abs() * float(th),
            )
            lod = torch.log2(torch.clamp_min(rho, 1e-12))
        albedo = tex_ops.sample_separable(tex, u_row, v_col, lod)
    elif mipped:
        th, tw = tex.meta[2][0]
        albedo = tex_ops.sample_texture(tex, uv, tex_ops.lod_from_uv(uv, th, tw))
    else:
        albedo = tex_ops.sample_texture(tex, uv)
    return _opaque(albedo[..., :3] * _uniform(uniforms, "tint", 1.0, uv))


register(Shader("textured_fullscreen", _textured_fullscreen_vs, _textured_fullscreen_fs, attributes=("uv",)))
"""Full-screen textured quad (the sampler floor of BASELINE config 3's tier)."""


def _textured_fullscreen_gather_fs(frag, uniforms):
    return _textured_fullscreen_fs(frag, uniforms, separable=False)


register(Shader("textured_fullscreen_gather", _textured_fullscreen_vs, _textured_fullscreen_gather_fs,
                attributes=("uv",)))


def _textured_lit_vs(attrs, uniforms):
    clip = mvp_transform(attrs, uniforms)
    normal_ws = attrs["normal"] @ math3d.normal_matrix(uniforms["model"]).T
    return clip, {"uv": attrs["uv"], "normal": normal_ws}


def _textured_lit_fs(frag, uniforms):
    """Sampled albedo * Lambert diffuse (BASELINE config 3).

    Mipmapped textures sample with the LOD from screen-space UV
    differences; otherwise a single bilinear tap."""
    tex = uniforms["texture"]
    uv = frag["uv"]
    if isinstance(tex, Texture) and tex.num_levels > 1:
        th, tw = tex.meta[2][0]
        albedo = tex_ops.sample_texture(tex, uv, tex_ops.lod_from_uv(uv, th, tw))
    else:
        albedo = tex_ops.sample_texture(tex, uv)
    n = frag["normal"]
    n = n / torch.clamp_min(_norm(n), 1e-8)
    light_dir = _uniform(uniforms, "light_dir", [0.0, 0.0, -1.0], n)
    light_dir = light_dir / torch.linalg.vector_norm(light_dir)
    ndotl = torch.clamp_min((n * -light_dir).sum(-1, keepdim=True), 0.0)
    ambient = _uniform(uniforms, "ambient", 0.15, n)
    return _opaque(albedo[..., :3] * (ambient + (1.0 - ambient) * ndotl))


register(Shader("textured_lit", _textured_lit_vs, _textured_lit_fs, attributes=("uv", "normal")))
"""Textured + Lambert-lit mesh (BASELINE config 3, the textured cube)."""


def _blinn_phong_vs(attrs, uniforms):
    clip = mvp_transform(attrs, uniforms)
    model = uniforms["model"]
    pos_ws = math3d.transform_points(model, attrs["position"])[..., :3]
    normal_ws = attrs["normal"] @ math3d.normal_matrix(model).T
    out = {"normal": normal_ws, "pos_ws": pos_ws}
    if "color" in attrs:
        out["color"] = attrs["color"]
    return clip, out


def _as_f32(value, like) -> torch.Tensor:
    """``value`` as float32 on ``like``'s device; a constant (a default)
    is made there by fill kernels, with no host-to-device copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32)
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=torch.float32, device=like.device)
    return fp.consts(value, like.device)


def _uniform(uniforms, key, default, like):
    """A float32 uniform on ``like``'s device, or its default."""
    return _as_f32(uniforms.get(key, default), like)


def _blinn_phong_fs(frag, uniforms):
    """Blinn-Phong: ambient + diffuse + specular (BASELINE config 5)."""
    n = frag["normal"]
    n = n / torch.clamp_min(_norm(n), 1e-8)
    pos = frag["pos_ws"]
    light_pos = _uniform(uniforms, "light_pos", [2.0, -2.0, -2.0], n)
    eye_pos = _uniform(uniforms, "eye_pos", [0.0, 0.0, -3.0], n)
    base = frag.get("color")
    if base is None:
        base = _uniform(uniforms, "base_color", [0.7, 0.7, 0.75], n).expand(*n.shape[:-1], 3)
    l = light_pos - pos  # noqa: E741
    l = l / torch.clamp_min(_norm(l), 1e-8)  # noqa: E741
    v = eye_pos - pos
    v = v / torch.clamp_min(_norm(v), 1e-8)
    h = l + v
    h = h / torch.clamp_min(_norm(h), 1e-8)
    ndotl = torch.clamp_min((n * l).sum(-1, keepdim=True), 0.0)
    ndoth = torch.clamp_min((n * h).sum(-1, keepdim=True), 0.0)
    shininess = _uniform(uniforms, "shininess", 32.0, n)
    ambient = _uniform(uniforms, "ambient", 0.1, n)
    spec = ndoth**shininess
    rgb = base * (ambient + ndotl) + 0.3 * spec
    return _opaque(rgb.clamp(0.0, 1.0))


register(Shader("blinn_phong", _blinn_phong_vs, _blinn_phong_fs, attributes=("normal",)))
"""Blinn-Phong lit mesh (BASELINE config 5, the 1M-triangle demo)."""


def _instanced_color_vs(attrs, uniforms):
    """Per-instance transform (BASELINE config 4) then shared view/proj."""
    world = apply_instance_transform(attrs)
    clip = math3d.transform_points(uniforms["proj"] @ uniforms["view"], world)
    out = {}
    if "color" in attrs:
        out["color"] = attrs["color"]
    if "instance_color" in attrs:
        out["color"] = attrs["instance_color"]
    return clip, out


register(Shader("instanced_color", _instanced_color_vs, _vertex_color_fs, attributes=("color",)))
"""Per-instance transform and colour (BASELINE config 4, the cube field)."""
