"""A field of instanced cubes: the cube's 36 corners drawn once per
instance, seen by a camera that circles the field as
``models/demos.instanced_demo``'s camera does.

The field's layout is the same for every seed: ``count`` cubes on a
square grid of ``spacing``, centred.  Each cube's turn about Y, its
scale, its height and its colour come from the seed, which also sets the
animation's start time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms
from .spinning_cube import mesh_data

F32 = torch.float32
#: The camera circles the field at 0.3 rad/s.
PERIOD_S = 2 * np.pi / 0.3


def start_time(seed: int) -> float:
    return float(np.random.default_rng([seed, 1]).uniform(0.0, PERIOD_S))


def grid(count: int, spacing: float) -> np.ndarray:
    """(count, 2) float32 x and z of each cube: row-major on a square grid,
    centred on the origin."""
    side = int(np.ceil(np.sqrt(count)))
    xs, zs = np.meshgrid(np.arange(side), np.arange(side))
    g = np.stack([xs.ravel()[:count], zs.ravel()[:count]], axis=-1).astype(np.float32)
    return (g - g.mean(axis=0)) * np.float32(spacing)


def extent(args: dict) -> float:
    """The camera's distance: the field's half width and 2 units more."""
    return float(np.abs(grid(int(args["count"]), args["spacing"])).max()) + 2.0


def mesh(seed: int, args: dict, device) -> dict:
    """The cube's (36, 3) float32 corner positions on ``device``."""
    return {"position": torch.tensor(mesh_data()["position"], device=device)}


def instances(seed: int, args: dict, device) -> dict:
    """{"transform": (I, 16) row-major 4x4, "instance_color": (I, 3)}
    float32 on ``device``."""
    count = int(args["count"])
    g = grid(count, args["spacing"])
    rng = np.random.default_rng([seed, 2])
    angle = rng.uniform(0.0, 2 * np.pi, count).astype(np.float32)
    scale = rng.uniform(0.4, 0.9, count).astype(np.float32)
    height = rng.uniform(-1.0, 1.0, count).astype(np.float32)
    color = rng.uniform(0.2, 1.0, (count, 3)).astype(np.float32)
    m = np.zeros((count, 4, 4), np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    m[:, 0, 0] = ca * scale
    m[:, 0, 2] = sa * scale
    m[:, 2, 0] = -sa * scale
    m[:, 2, 2] = ca * scale
    m[:, 1, 1] = scale
    m[:, 0, 3] = g[:, 0]
    m[:, 1, 3] = height
    m[:, 2, 3] = g[:, 1]
    m[:, 3, 3] = 1.0
    return {"transform": torch.tensor(m.reshape(count, 16), device=device),
            "instance_color": torch.tensor(color, device=device)}


def look_at(eye: torch.Tensor, up) -> torch.Tensor:
    """The view from ``eye`` toward the origin, view-space +z forward, as
    the program's ``math3d.look_at`` builds it."""
    up = torch.as_tensor(up, dtype=F32)
    fwd = torch.zeros(3, dtype=F32) - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(up, fwd)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(fwd, right)
    m = torch.eye(4, dtype=F32)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = fwd
    m[0, 3] = -torch.dot(right, eye)
    m[1, 3] = -torch.dot(true_up, eye)
    m[2, 3] = -torch.dot(fwd, eye)
    return m


def uniforms(t: float, aspect: float, args: dict) -> dict:
    """The camera circles the field at 0.3 rad/s, raised by 0.6 of its
    distance, looking at the centre; perspective 60 degrees, near 0.1, far
    four times the distance."""
    e = extent(args)
    a = torch.tensor(t, dtype=F32) * torch.tensor(0.3, dtype=F32)
    eye = torch.stack([torch.cos(a) * e, torch.tensor(-e * 0.6, dtype=F32), torch.sin(a) * e])
    view = look_at(eye, (0.0, -1.0, 0.0))
    proj = transforms.perspective(np.radians(60.0), aspect, 0.1, e * 4.0)
    return {"view": view, "proj": proj}
