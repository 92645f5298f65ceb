"""Reference of the ``instanced_color`` shader (BASELINE config 4): each
corner's position through its instance's transform (a per-corner (V, 16)
row-major 4x4), then through proj @ view; the instance's colour, opaque."""

from __future__ import annotations

import torch

from .. import precision as P

VARYINGS = ("color",)


def vertex(attrs: dict, uniforms: dict, precision: str):
    """(V, 4) clip positions and the (V, 3) colour."""
    pos = attrs["position"]
    pos4 = P.operand(torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1), precision)
    model = P.operand(attrs["transform"], precision).reshape(-1, 4, 4)
    # the instance's transform, per row in the fixed order of P.combine_columns
    world = model[:, :, 0] * pos4[:, 0:1]
    for j in range(1, 4):
        world = world + model[:, :, j] * pos4[:, j : j + 1]
    vp = P.matmul(uniforms["proj"], uniforms["view"], precision)
    return P.combine_columns(vp, world, precision), {"color": attrs["instance_color"]}


def fragment(frag: dict, uniforms: dict) -> torch.Tensor:
    """(..., 3) linear colour of the interpolated varyings."""
    return frag["color"]
