"""Shader system: vertex/fragment programs as Python functions on tensors.

The counterpart of ``based_renderer_tpu/shader.py`` for the main path's
shaders.  ABI:
  vertex(attrs, uniforms) -> (clip_pos (N, 4), varyings dict[str, (N, C)])
  fragment(frag, uniforms) -> rgba (H, W, 4) float32
      frag: interpolated (H, W, C) varyings plus "tri_id" (H, W) int32,
            "depth" (H, W) f32 and "bary" (H, W, 3) f32.
Shader modules loaded from files and the textured and lit shaders arrive
with later slices (ROADMAP A.11, A.14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import math3d
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
        zw = torch.tensor([0.0, 1.0], dtype=p.dtype, device=p.device).expand(*lead, 2)
        p = torch.cat([p, zw], -1)
    return p, {}


def _const_color_fs(frag, uniforms):
    color = uniforms.get("color", REFERENCE_COLOR) if isinstance(uniforms, dict) else REFERENCE_COLOR
    tri = frag["tri_id"]
    rgba = torch.as_tensor(color, dtype=torch.float32, device=tri.device)
    return rgba.expand(*tri.shape, 4)


register(Shader("flat_ndc", _passthrough_vs, _const_color_fs))
"""The triangle.slang program: NDC positions, constant color."""


def _mvp_vs(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {}


register(Shader("flat_mvp", _mvp_vs, _const_color_fs))
"""The cube.slang program: MVP transform, constant color."""


def _color_vs(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}


def _vertex_color_fs(frag, uniforms):
    rgb = frag["color"]
    return torch.cat([rgb, torch.ones((*rgb.shape[:2], 1), dtype=rgb.dtype, device=rgb.device)], -1)


register(Shader("vertex_color", _color_vs, _vertex_color_fs, attributes=("color",)))
"""Per-vertex color with smooth interpolation (BASELINE config 2)."""


def _ndc_color_vs(attrs, uniforms):
    clip, _ = _passthrough_vs(attrs, uniforms)
    return clip, {"color": attrs["color"]}


register(Shader("ndc_color", _ndc_color_vs, _vertex_color_fs, attributes=("color",)))
