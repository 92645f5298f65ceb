"""Geometry generators for the demo set (numpy; upload via Renderer).

The reference hard-codes its geometry inside vertex shaders: a 3-vertex
NDC triangle (src/triangle.slang:4-13 of the reference) and a 36-vertex
unit cube, 6 faces x 2 triangles (src/cube.slang:12-61).  Here the same
shapes are mesh data, copied from based_renderer_tpu/models/geometry.py,
with the instanced cube field and the procedural dense mesh of the
dense-mesh demos (and its on-device generator for generated meshes), and
the full-screen quad and checkerboard texture of the textured demos.
"""

from __future__ import annotations

import numpy as np
import torch


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


def fullscreen_quad_data(uv_tiles: float = 4.0):
    """Two NDC triangles covering the whole screen, with tiled UVs: every
    pixel samples (the sampler floor of a sky/background pass)."""
    corners = {
        "bl": ((-1.0, 1.0, 0.5), (0.0, uv_tiles)),
        "br": ((1.0, 1.0, 0.5), (uv_tiles, uv_tiles)),
        "tr": ((1.0, -1.0, 0.5), (uv_tiles, 0.0)),
        "tl": ((-1.0, -1.0, 0.5), (0.0, 0.0)),
    }
    order = ["bl", "br", "tr", "bl", "tr", "tl"]
    positions = np.array([corners[k][0] for k in order], np.float32)
    uv = np.array([corners[k][1] for k in order], np.float32)
    return {"positions": positions, "uv": uv}


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


def checkerboard_texture(size: int = 256, squares: int = 8):
    """Classic checkerboard albedo texture, (size, size, 3) float32."""
    ij = np.arange(size)
    cell = (ij[:, None] // (size // squares) + ij[None, :] // (size // squares)) % 2
    base = np.where(cell[..., None] > 0, np.float32(0.9), np.float32(0.25))
    tint = np.array([1.0, 0.85, 0.6], np.float32)
    return (base * tint).astype(np.float32)


def instanced_grid_transforms(count: int, spacing: float = 2.5, seed: int = 0):
    """Per-instance 4x4 transforms for a cube field (BASELINE config 4):
    a sqrt(count)^2 grid with per-instance rotation and color."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(count)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    grid = np.stack([xs.ravel()[:count], ys.ravel()[:count]], axis=-1).astype(np.float32)
    grid = (grid - grid.mean(axis=0)) * spacing
    angles = rng.uniform(0, 2 * np.pi, count).astype(np.float32)
    scales = rng.uniform(0.4, 0.9, count).astype(np.float32)
    transforms = np.zeros((count, 4, 4), np.float32)
    ca, sa = np.cos(angles), np.sin(angles)
    transforms[:, 0, 0] = ca * scales
    transforms[:, 0, 2] = sa * scales
    transforms[:, 2, 0] = -sa * scales
    transforms[:, 2, 2] = ca * scales
    transforms[:, 1, 1] = scales
    transforms[:, 0, 3] = grid[:, 0]
    transforms[:, 1, 3] = rng.uniform(-1.0, 1.0, count).astype(np.float32)
    transforms[:, 2, 3] = grid[:, 1]
    transforms[:, 3, 3] = 1.0
    colors = rng.uniform(0.2, 1.0, (count, 3)).astype(np.float32)
    return transforms, colors


def procedural_mesh_data(target_triangles: int = 1_000_000, seed: int = 0):
    """A bunny/dragon-class dense mesh (BASELINE config 5): a displaced
    torus-knot tube surface subdivided to ~target_triangles, with smooth
    normals.  Deterministic; generated at f64 then cast to f32."""
    # Tube around a (p, q) torus knot, displaced by harmonics for organic
    # surface detail.  rings * segs quads -> 2 * rings * segs triangles.
    rings = int(np.sqrt(target_triangles / 2 * 2))  # aspect ~2:1
    segs = max(8, int(target_triangles / (2 * rings)))
    p, q = 2, 3
    t = np.linspace(0, 2 * np.pi, rings, endpoint=False, dtype=np.float64)
    # Knot center curve.
    r = 2.0 + np.cos(q * t)
    cx = r * np.cos(p * t)
    cy = r * np.sin(p * t)
    cz = -np.sin(q * t)
    center = np.stack([cx, cy, cz], axis=-1)  # (rings, 3)
    # Frenet-ish frame.
    d = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    tangent = d / np.linalg.norm(d, axis=-1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tangent, up)
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    up2 = np.cross(side, tangent)
    phi = np.linspace(0, 2 * np.pi, segs, endpoint=False, dtype=np.float64)
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.02, 0.08, 4)
    freq = rng.integers(3, 9, 4)
    radius = 0.45 + sum(
        a * np.cos(f * phi)[None, :] * np.cos((i + 2) * t)[:, None]
        for i, (a, f) in enumerate(zip(amp, freq))
    )
    ring_pts = (
        center[:, None, :]
        + radius[..., None]
        * (np.cos(phi)[None, :, None] * side[:, None, :] + np.sin(phi)[None, :, None] * up2[:, None, :])
    )  # (rings, segs, 3)
    positions = ring_pts.reshape(-1, 3)

    # Quad grid indices with wraparound in both directions.
    ri = np.arange(rings)
    si = np.arange(segs)
    rr, ss = np.meshgrid(ri, si, indexing="ij")
    v00 = rr * segs + ss
    v01 = rr * segs + (ss + 1) % segs
    v10 = ((rr + 1) % rings) * segs + ss
    v11 = ((rr + 1) % rings) * segs + (ss + 1) % segs
    tris = np.concatenate(
        [np.stack([v00, v10, v11], -1).reshape(-1, 3), np.stack([v00, v11, v01], -1).reshape(-1, 3)]
    ).astype(np.int32)

    # Smooth normals: accumulate face normals at vertices.
    e1 = positions[tris[:, 1]] - positions[tris[:, 0]]
    e2 = positions[tris[:, 2]] - positions[tris[:, 0]]
    fn = np.cross(e1, e2)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)

    scale = 1.0 / np.abs(positions).max()
    return {
        "positions": (positions * scale).astype(np.float32),
        "normal": normals.astype(np.float32),
        "indices": tris,
    }


def procedural_mesh_device(target_triangles: int = 1_000_000, seed: int = 0, device=None):
    """The on-device twin of :func:`procedural_mesh_data`, for generated meshes.

    Returns a zero-argument function that makes the de-indexed per-corner
    attributes ``{"position": (3T, 3), "normal": (3T, 3)}`` with torch ops
    in float32 on ``device``: the layout that
    ``upload_mesh(**procedural_mesh_data(...))`` reaches after its
    host-side de-index.  The JAX package's generator (geometry.py:204)
    computes the same values in float32, so both agree with the float64
    numpy twin to float rounding, not bit for bit.  Each vertex normal sums
    its six face normals in the numpy twin's order, with rolls of the
    face-normal grid in place of a scatter-add, so every call gives the
    same bits.
    """
    rings = int(np.sqrt(target_triangles / 2 * 2))
    segs = max(8, int(target_triangles / (2 * rings)))
    p, q = 2, 3
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.02, 0.08, 4)
    freq = rng.integers(3, 9, 4)

    def gen():
        f32 = torch.float32
        t = torch.arange(rings, dtype=f32, device=device) * float(np.float32(2 * np.pi / rings))
        r = 2.0 + torch.cos(q * t)
        center = torch.stack([r * torch.cos(p * t), r * torch.sin(p * t), -torch.sin(q * t)], dim=-1)
        d = torch.roll(center, -1, 0) - torch.roll(center, 1, 0)
        tangent = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        up = torch.zeros_like(tangent)
        up[:, 2] = 1.0
        side = torch.linalg.cross(tangent, up)
        side = side / torch.linalg.vector_norm(side, dim=-1, keepdim=True)
        up2 = torch.linalg.cross(side, tangent)
        phi = torch.arange(segs, dtype=f32, device=device) * float(np.float32(2 * np.pi / segs))
        radius = 0.45 + sum(
            float(np.float32(a)) * torch.cos(float(np.float32(f)) * phi)[None, :] * torch.cos((i + 2) * t)[:, None]
            for i, (a, f) in enumerate(zip(amp, freq))
        )
        ring_pts = center[:, None, :] + radius[..., None] * (
            torch.cos(phi)[None, :, None] * side[:, None, :] + torch.sin(phi)[None, :, None] * up2[:, None, :]
        )
        positions = ring_pts.reshape(-1, 3)

        rr = torch.arange(rings, device=device)[:, None].expand(rings, segs)
        ss = torch.arange(segs, device=device)[None, :].expand(rings, segs)
        v00 = rr * segs + ss
        v01 = rr * segs + (ss + 1) % segs
        v10 = ((rr + 1) % rings) * segs + ss
        v11 = ((rr + 1) % rings) * segs + (ss + 1) % segs
        tris = torch.cat([torch.stack([v00, v10, v11], -1).reshape(-1, 3),
                          torch.stack([v00, v11, v01], -1).reshape(-1, 3)])

        e1 = positions[tris[:, 1]] - positions[tris[:, 0]]
        e2 = positions[tris[:, 2]] - positions[tris[:, 0]]
        fn = torch.linalg.cross(e1, e2)
        fa = fn[: rings * segs].reshape(rings, segs, 3)  # the (v00, v10, v11) triangles
        fb = fn[rings * segs :].reshape(rings, segs, 3)  # the (v00, v11, v01) triangles
        # Vertex (r, s) is corner 0 of fa[r, s] and fb[r, s], corner 1 of
        # fa[r-1, s] and fb[r-1, s-1], and corner 2 of fa[r-1, s-1] and
        # fb[r, s-1]: summed in that order, as np.add.at sums the corners.
        normals = fa + fb + torch.roll(fa, 1, 0) + torch.roll(fb, (1, 1), (0, 1))
        normals = (normals + torch.roll(fa, (1, 1), (0, 1)) + torch.roll(fb, 1, 1)).reshape(-1, 3)
        normals = normals / torch.clamp_min(torch.linalg.vector_norm(normals, dim=-1, keepdim=True), 1e-12)
        positions = positions * (1.0 / positions.abs().max())

        # De-index to the corner-sequential upload layout with one fused row gather.
        flat = torch.cat([positions, normals], dim=-1)[tris.reshape(-1)]  # (3T, 6)
        return {"position": flat[:, :3], "normal": flat[:, 3:]}

    return gen
