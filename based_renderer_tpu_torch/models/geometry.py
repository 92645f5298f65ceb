"""Geometry generators for the demo set (numpy; upload via Renderer).

The reference hard-codes its geometry inside vertex shaders: a 3-vertex
NDC triangle (src/triangle.slang:4-13 of the reference) and a 36-vertex
unit cube, 6 faces x 2 triangles (src/cube.slang:12-61).  Here the same
shapes are mesh data, copied from based_renderer_tpu/models/geometry.py
(the procedural large meshes arrive with the dense-mesh slice).
"""

from __future__ import annotations

import numpy as np


def triangle_mesh_data():
    """The triangle.slang demo triangle: NDC positions (y-down), one face.

    triangle.slang uses (-0.5, 0.5), (0.5, 0.5), (0.0, -0.5) — in y-down
    screen convention that is two bottom corners and an apex at the top.
    """
    positions = np.array(
        [[-0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.0, -0.5, 0.0]], np.float32
    )
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    return {"positions": positions, "color": colors}

def cube_mesh_data(size: float = 1.0):
    """Unit cube centered at origin, 6 faces x 2 triangles, non-indexed
    (the cube.slang:12-61 vertex ordering: -Z, +Z, -X, +X, -Y, +Y faces),
    with per-vertex face normals, per-face UVs, and per-face colors."""
    h = np.float32(size * 0.5)
    # Each face: (normal, origin corner, u axis, v axis) -> two triangles.
    faces = [
        # normal,          corner,        u-axis,        v-axis
        ((0, 0, -1), (-h, -h, -h), (2 * h, 0, 0), (0, 2 * h, 0)),  # -Z
        ((0, 0, 1), (-h, -h, h), (2 * h, 0, 0), (0, 2 * h, 0)),  # +Z
        ((-1, 0, 0), (-h, h, h), (0, 0, -2 * h), (0, -2 * h, 0)),  # -X
        ((1, 0, 0), (h, h, h), (0, 0, -2 * h), (0, -2 * h, 0)),  # +X
        ((0, -1, 0), (-h, -h, -h), (2 * h, 0, 0), (0, 0, 2 * h)),  # -Y
        ((0, 1, 0), (-h, h, -h), (2 * h, 0, 0), (0, 0, 2 * h)),  # +Y
    ]
    face_colors = np.array(
        [
            [0.9, 0.2, 0.2],
            [0.2, 0.9, 0.2],
            [0.2, 0.2, 0.9],
            [0.9, 0.9, 0.2],
            [0.9, 0.2, 0.9],
            [0.2, 0.9, 0.9],
        ],
        np.float32,
    )
    quad = np.array([(0, 0), (1, 0), (1, 1), (1, 1), (0, 1), (0, 0)], np.float32)
    pos, nrm, uv, col = [], [], [], []
    for i, (n, c, ua, va) in enumerate(faces):
        n = np.array(n, np.float32)
        c = np.array(c, np.float32)
        ua = np.array(ua, np.float32)
        va = np.array(va, np.float32)
        fp = [c + u * ua + v * va for (u, v) in quad]
        fuv = [(u, v) for (u, v) in quad]
        # Consistent winding: cross(e1, e2) must point along the outward
        # normal for every face, so back-face culling sees a watertight
        # orientation (each triangle reversed independently if needed).
        for tri0 in (0, 3):
            g = np.cross(fp[tri0 + 1] - fp[tri0], fp[tri0 + 2] - fp[tri0])
            if np.dot(g, n) < 0:
                fp[tri0], fp[tri0 + 2] = fp[tri0 + 2], fp[tri0]
                fuv[tri0], fuv[tri0 + 2] = fuv[tri0 + 2], fuv[tri0]
        for k in range(6):
            pos.append(fp[k])
            nrm.append(n)
            uv.append(fuv[k])
            col.append(face_colors[i])
    return {
        "positions": np.stack(pos),
        "normal": np.stack(nrm),
        "uv": np.array(uv, np.float32),
        "color": np.stack(col),
    }
