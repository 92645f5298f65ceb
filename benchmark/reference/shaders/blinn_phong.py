"""Reference of the ``blinn_phong`` shader (BASELINE config 5): world-space
position and normal (through the inverse transpose of the model's 3x3)
interpolated per vertex; ambient + diffuse + specular (shininess 32,
ambient 0.1, specular weight 0.3), clamped to [0, 1]."""

from __future__ import annotations

import torch

from .. import precision as P

VARYINGS = ("normal", "pos_ws")
SHININESS = 32.0
AMBIENT = 0.1
SPECULAR = 0.3


def vertex(attrs: dict, uniforms: dict, precision: str):
    model = uniforms["model"]
    mvp = P.matmul(P.matmul(uniforms["proj"], uniforms["view"], precision), model, precision)
    pos = attrs["position"]
    pos4 = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    clip = P.combine_columns(mvp, pos4, precision)
    pos_ws = P.combine_columns(model, pos4, precision)[:, :3]
    normal_matrix = torch.linalg.inv(model[:3, :3]).T
    normal_ws = P.matmul(attrs["normal"], normal_matrix.T, precision)
    return clip, {"normal": normal_ws, "pos_ws": pos_ws}


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-8)


def fragment(frag: dict, uniforms: dict) -> torch.Tensor:
    n = _unit(frag["normal"])
    pos = frag["pos_ws"]
    l = _unit(uniforms["light_pos"] - pos)  # noqa: E741
    v = _unit(uniforms["eye_pos"] - pos)
    h = _unit(l + v)
    ndotl = torch.clamp_min((n * l).sum(-1, keepdim=True), 0.0)
    ndoth = torch.clamp_min((n * h).sum(-1, keepdim=True), 0.0)
    rgb = uniforms["base_color"] * (AMBIENT + ndotl) + SPECULAR * ndoth**SHININESS
    return rgb.clamp(0.0, 1.0)
