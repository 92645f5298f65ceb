"""The cube.slang spinning cube (BASELINE config 2): a frozen copy of the
program's ``models/geometry.cube_mesh_data`` and of the uniforms of
``models/demos.cube_demo``.  The seed sets the animation's start time."""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms

#: One turn of the model takes 2 pi seconds of animation time.
PERIOD_S = 2 * np.pi


def start_time(seed: int) -> float:
    return float(np.random.default_rng([seed, 1]).uniform(0.0, PERIOD_S))


def mesh_data():
    """36 corners (6 faces x 2 triangles), non-indexed: positions, face
    normals, per-face UVs and colours (float32 numpy)."""
    h = np.float32(0.5)
    faces = [
        ((0, 0, -1), (-h, -h, -h), (2 * h, 0, 0), (0, 2 * h, 0)),
        ((0, 0, 1), (-h, -h, h), (2 * h, 0, 0), (0, 2 * h, 0)),
        ((-1, 0, 0), (-h, h, h), (0, 0, -2 * h), (0, -2 * h, 0)),
        ((1, 0, 0), (h, h, h), (0, 0, -2 * h), (0, -2 * h, 0)),
        ((0, -1, 0), (-h, -h, -h), (2 * h, 0, 0), (0, 0, 2 * h)),
        ((0, 1, 0), (-h, h, -h), (2 * h, 0, 0), (0, 0, 2 * h)),
    ]
    face_colors = np.array(
        [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9], [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9]],
        np.float32,
    )
    quad = np.array([(0, 0), (1, 0), (1, 1), (1, 1), (0, 1), (0, 0)], np.float32)
    pos, col = [], []
    for i, (n, c, ua, va) in enumerate(faces):
        n = np.array(n, np.float32)
        c = np.array(c, np.float32)
        ua = np.array(ua, np.float32)
        va = np.array(va, np.float32)
        fp = [c + u * ua + v * va for (u, v) in quad]
        for tri0 in (0, 3):  # wind every triangle along its face's outward normal
            g = np.cross(fp[tri0 + 1] - fp[tri0], fp[tri0 + 2] - fp[tri0])
            if np.dot(g, n) < 0:
                fp[tri0], fp[tri0 + 2] = fp[tri0 + 2], fp[tri0]
        pos += fp
        col += [face_colors[i]] * 6
    return {"position": np.stack(pos), "color": np.stack(col)}


def mesh(seed: int, args: dict, device) -> dict:
    """The (36, C) float32 corner attributes on ``device`` (the same for
    every seed)."""
    return {k: torch.tensor(v, device=device) for k, v in mesh_data().items()}


def uniforms(t: float, aspect: float, args: dict) -> dict:
    """Model spins about -Y after a -55 degree tilt about X; the camera is
    3 units back; perspective 45 degrees, near 0.1, far 10."""
    model = transforms.rotate(np.float32(t), (0.0, -1.0, 0.0))
    model = transforms.rotate(np.float32(np.radians(-55.0)), (1.0, 0.0, 0.0), model)
    view = transforms.translate((0.0, 0.0, 3.0))
    proj = transforms.perspective(np.radians(45.0), aspect, 0.1, 10.0)
    return {"model": model, "view": view, "proj": proj}
