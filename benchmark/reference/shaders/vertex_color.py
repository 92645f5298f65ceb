"""Reference of the ``vertex_color`` shader (BASELINE config 2, cube.slang):
clip = proj @ view @ model @ position, the colour interpolated per vertex
and written opaque."""

from __future__ import annotations

import torch

from .. import precision as P

VARYINGS = ("color",)


def vertex(attrs: dict, uniforms: dict, precision: str):
    """(V, 4) clip positions and the (V, C) varyings."""
    mvp = P.matmul(P.matmul(uniforms["proj"], uniforms["view"], precision), uniforms["model"], precision)
    pos = attrs["position"]
    pos4 = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return P.combine_columns(mvp, pos4, precision), {"color": attrs["color"]}


def fragment(frag: dict, uniforms: dict) -> torch.Tensor:
    """(..., 3) linear colour of the interpolated varyings."""
    return frag["color"]
