"""The dense Blinn-Phong mesh of BASELINE config 5: a frozen copy of the
program's ``models/geometry.procedural_mesh_device`` (a displaced
torus-knot tube, de-indexed to corner-sequential positions and smooth
normals) and of the uniforms of ``models/demos.big_mesh_demo``.

The seed sets the animation's start time.  The tube's four displacement
harmonics are the demo's own (``procedural_mesh_device``'s seed 0): the
demo's pair and slot budgets are sized for that mesh, and other harmonics
overflow them in some views.  The mesh is made on the device in a few
large torch calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms

#: One turn of the model takes 4 pi seconds of animation time (0.5 rad/s).
PERIOD_S = 4 * np.pi


def start_time(seed: int) -> float:
    return float(np.random.default_rng([seed, 1]).uniform(0.0, PERIOD_S))


def harmonics(mesh_seed: int = 0):
    """(amplitudes, frequencies) of the displacement: the demo's are those
    of ``mesh_seed`` 0."""
    rng = np.random.default_rng(mesh_seed)
    return rng.uniform(0.02, 0.08, 4), rng.integers(3, 9, 4)


def grid(triangles: int) -> tuple[int, int]:
    """(rings, segments) of the tube: 2 * rings * segments triangles."""
    rings = int(np.sqrt(triangles / 2 * 2))
    return rings, max(8, int(triangles / (2 * rings)))


def mesh(seed: int, args: dict, device) -> dict:
    """{"position": (3T, 3), "normal": (3T, 3)} float32 on ``device``, the
    same for every seed."""
    rings, segs = grid(int(args["triangles"]))
    amp, freq = harmonics(int(args.get("mesh_seed", 0)))
    p, q = 2, 3
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
    fa = fn[: rings * segs].reshape(rings, segs, 3)
    fb = fn[rings * segs :].reshape(rings, segs, 3)
    # Each vertex sums the normals of its six faces in one fixed order.
    normals = fa + fb + torch.roll(fa, 1, 0) + torch.roll(fb, (1, 1), (0, 1))
    normals = (normals + torch.roll(fa, (1, 1), (0, 1)) + torch.roll(fb, 1, 1)).reshape(-1, 3)
    normals = normals / torch.clamp_min(torch.linalg.vector_norm(normals, dim=-1, keepdim=True), 1e-12)
    positions = positions * (1.0 / positions.abs().max())
    flat = torch.cat([positions, normals], dim=-1)[tris.reshape(-1)]
    return {"position": flat[:, :3].contiguous(), "normal": flat[:, 3:].contiguous()}


def uniforms(t: float, aspect: float, args: dict) -> dict:
    """Model turns about -Y at 0.5 rad/s; camera 2.2 units back;
    perspective 50 degrees, near 0.1, far 10; a point light."""
    model = transforms.rotate(np.float32(t * 0.5), (0.0, -1.0, 0.0))
    view = transforms.translate((0.0, 0.0, 2.2))
    proj = transforms.perspective(np.radians(50.0), aspect, 0.1, 10.0)
    return {
        "model": model,
        "view": view,
        "proj": proj,
        "light_pos": torch.tensor([3.0, -3.0, -3.0]),
        "eye_pos": torch.tensor([0.0, 0.0, -2.2]),
        "base_color": torch.tensor([0.55, 0.65, 0.8]),
    }
