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
(BASELINE config 3) are here, and ``load_file``/``load_module`` compile
and register shader modules from Python source files at run time.
``blinn_phong`` also carries a fused body (``Shader.fused``), ops/shade.py's
one-pass shading, composite and resolve, which the renderer takes for
eligible draws on CUDA (``Renderer._shade_from``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch

from . import math3d
from .ops import fixedpoint as fp
from .ops import shade as shade_ops
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
    # Optional fused body: shades a draw from the raster's planes, composites
    # it opaquely and can resolve MSAA in one pass (ops/shade.py), called as
    # fused(interp, invw, tri_id, lo, hi, color, uniforms, resolve).  The
    # renderer takes it for an opaque, perspective-correct draw that writes
    # every channel.
    fused: Callable | None = None


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


# ---------------------------------------------------------------------------
# Shader modules on disk (the Slang-toolchain tier)
# ---------------------------------------------------------------------------

#: Directories searched by :func:`load_module`, the analog of the Slang
#: session's ``src/`` search path.
MODULE_SEARCH_PATH: list[str] = ["."]


def load_file(path, name: str | None = None) -> Shader:
    """Compile and register a shader module from a Python source file.

    A new material is a new source file, with no rebuild.  The file is
    exec'd with this module's vocabulary in scope (``Shader``,
    ``register``, ``torch``, ``math3d``, ``tex_ops``, ``mvp_transform``;
    normal ``import`` statements also work) and must define one of:

      - ``SHADER``: a :class:`Shader` (registered under its own name, or
        under ``name`` when given),
      - exactly one module-level :class:`Shader` value, or
      - ``vertex``/``fragment`` callables (plus optional ``ATTRIBUTES``),
        bound as ``Shader(<name or file stem>, vertex, fragment, ATTRIBUTES)``.

    An unreadable file, a syntax error, an exception while the file runs
    and a file without entry points each raise :class:`ShaderError`
    carrying the source path and the registered-module list.
    """
    src_path = os.fspath(path)
    try:
        with open(src_path) as f:
            src = f.read()
    except OSError as e:
        raise ShaderError(f"cannot read shader module {src_path!r}: {e}; registered: {sorted(_REGISTRY)}") from None
    module_name = name or os.path.splitext(os.path.basename(src_path))[0]
    ns: dict = {
        "Shader": Shader,
        "register": register,
        "torch": torch,
        "math3d": math3d,
        "tex_ops": tex_ops,
        "mvp_transform": mvp_transform,
        "__name__": f"based_renderer_tpu_torch.shader.modules.{module_name}",
        "__file__": src_path,
    }
    try:
        exec(compile(src, src_path, "exec"), ns)
    except ShaderError:
        raise
    except SyntaxError as e:
        raise ShaderError(f"shader module {src_path!r}: {e.__class__.__name__}: {e}; "
                          f"registered: {sorted(_REGISTRY)}") from e
    except Exception as e:
        raise ShaderError(f"shader module {src_path!r} raised during load: {e.__class__.__name__}: {e}; "
                          f"registered: {sorted(_REGISTRY)}") from e

    shd = ns.get("SHADER")
    if not isinstance(shd, Shader):
        # Explicit vertex+fragment callables win over stray Shader values (a
        # module may look up an existing shader while defining its own entry
        # points); Shader values count once however many names alias them.
        if callable(ns.get("vertex")) and callable(ns.get("fragment")):
            shd = Shader(module_name, ns["vertex"], ns["fragment"], tuple(ns.get("ATTRIBUTES", ())))
        else:
            found: list[Shader] = []
            for k, v in ns.items():
                if isinstance(v, Shader) and k != "Shader" and all(v is not f for f in found):
                    found.append(v)
            if len(found) != 1:
                raise ShaderError(
                    f"shader module {src_path!r} defines no entry points: expected SHADER, vertex+fragment "
                    f"callables, or a single Shader value (found {len(found)} distinct Shader values"
                    f"{', a vertex callable' if callable(ns.get('vertex')) else ''}"
                    f"{', a fragment callable' if callable(ns.get('fragment')) else ''}); "
                    f"registered: {sorted(_REGISTRY)}"
                )
            shd = found[0]
    if name is not None and shd.name != name:
        shd = Shader(name, shd.vertex, shd.fragment, shd.attributes)
    return register(shd)


def load_module(name: str, search_paths=None) -> Shader:
    """``loadModule("cube")``: find ``<name>.py`` on the search path and
    :func:`load_file` it.  A registered name returns the registered shader
    without touching the disk."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    paths = MODULE_SEARCH_PATH if search_paths is None else list(search_paths)
    for d in paths:
        candidate = os.path.join(d, f"{name}.py")
        if os.path.exists(candidate):
            return load_file(candidate, name=name)
    raise ShaderError(f"no shader module {name!r} on search path {paths}; registered: {sorted(_REGISTRY)}")


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
    is made there by fill kernels, with no host-to-device copy.  A tuple
    uniform reaches a shader as a tuple of device scalars (the renderer
    maps uniform trees leaf by leaf): it is stacked on the device, with
    no host read, which a captured frame may not make."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32)
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=torch.float32, device=like.device)
    if any(isinstance(v, torch.Tensor) for v in value):
        return torch.stack([_as_f32(v, like) for v in value])
    return fp.consts(value, like.device)


def _uniform(uniforms, key, default, like):
    """A float32 uniform on ``like``'s device, or its default."""
    return _as_f32(uniforms.get(key, default), like)


#: Blinn-Phong's uniforms and their defaults.
_BLINN_PHONG_DEFAULTS = {
    "light_pos": [2.0, -2.0, -2.0],
    "eye_pos": [0.0, 0.0, -3.0],
    "base_color": [0.7, 0.7, 0.75],
    "shininess": 32.0,
    "ambient": 0.1,
}


def _blinn_phong_uniform(uniforms, key, like):
    return _uniform(uniforms, key, _BLINN_PHONG_DEFAULTS[key], like)


def _blinn_phong_fs(frag, uniforms):
    """Blinn-Phong: ambient + diffuse + specular (BASELINE config 5)."""
    n = frag["normal"]
    base = frag.get("color")
    if base is None:
        base = _blinn_phong_uniform(uniforms, "base_color", n).expand(*n.shape[:-1], 3)
    u = [_blinn_phong_uniform(uniforms, k, n) for k in ("light_pos", "eye_pos", "shininess", "ambient")]
    return _opaque(shade_ops.blinn_phong(n, frag["pos_ws"], base, *u))


def _blinn_phong_fused(interp, invw, tri_id, lo, hi, color, uniforms, resolve):
    """The fused body: ops/shade.py's kernel reads the raster's planes and
    writes the composited (or resolved) colour."""
    u = [_blinn_phong_uniform(uniforms, k, interp) for k in _BLINN_PHONG_DEFAULTS]
    return shade_ops.shade_blinn_phong(interp, invw, tri_id, lo, hi, color, *u, resolve=resolve)


register(Shader("blinn_phong", _blinn_phong_vs, _blinn_phong_fs, attributes=("normal",), fused=_blinn_phong_fused))
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
