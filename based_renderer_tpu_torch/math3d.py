"""3D transform math (the GLM-equivalent layer), in PyTorch float32.

The counterpart of ``based_renderer_tpu/math3d.py`` for what the demos
need.  Matrices are (4, 4) float32 tensors with the column-vector
convention ``M @ v``; batched transforms are ``verts @ M.T``.  Clip
conventions: NDC x right, y down, z in [0, 1] (Vulkan style).
Matrices are built on the CPU; the renderer moves uniforms to its device.
"""

from __future__ import annotations

import torch

from .ops import transform as transform_ops

F32 = torch.float32


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def identity() -> torch.Tensor:
    return torch.eye(4, dtype=F32)


def translate(v, m: torch.Tensor | None = None) -> torch.Tensor:
    """GLM ``translate``: post-multiplies ``m`` by a translation by ``v``."""
    t = torch.eye(4, dtype=F32)
    t[:3, 3] = _t(v)
    return t if m is None else _t(m) @ t


def scale(v, m: torch.Tensor | None = None) -> torch.Tensor:
    """GLM ``scale``: post-multiplies ``m`` by a scale by ``v``."""
    s = torch.diag(torch.cat([_t(v), torch.ones((1,), dtype=F32)]))
    return s if m is None else _t(m) @ s


def rotate(angle, axis, m: torch.Tensor | None = None) -> torch.Tensor:
    """GLM ``rotate``: rotation by ``angle`` radians about ``axis``."""
    angle = _t(angle)
    axis = _t(axis)
    axis = axis / torch.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    c, s = torch.cos(angle), torch.sin(angle)
    ic = 1.0 - c
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    r = torch.stack(
        [
            torch.stack([c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s, zero]),
            torch.stack([y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s, zero]),
            torch.stack([z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic, zero]),
            torch.stack([zero, zero, zero, one]),
        ]
    )
    return r if m is None else _t(m) @ r


def perspective(fovy, aspect, z_near, z_far) -> torch.Tensor:
    """Vulkan-convention perspective: y-down NDC, depth in [0, 1]."""
    fovy = _t(fovy)
    f = 1.0 / torch.tan(fovy / 2.0)
    z_near = _t(z_near)
    z_far = _t(z_far)
    m = torch.zeros((4, 4), dtype=F32)
    m[0, 0] = f / _t(aspect)
    m[1, 1] = f
    m[2, 2] = z_far / (z_far - z_near)
    m[2, 3] = -(z_far * z_near) / (z_far - z_near)
    m[3, 2] = 1.0
    return m


def look_at(eye, center, up) -> torch.Tensor:
    """Right-handed look-at adapted to the left-handed projection: view-space
    +z points from ``eye`` toward ``center``."""
    eye, center, up = _t(eye), _t(center), _t(up)
    fwd = center - eye
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


def normal_matrix(model: torch.Tensor) -> torch.Tensor:
    """Inverse-transpose upper-3x3 for transforming normals (no singularity
    check, as in the JAX package: a singular model gives non-finite values)."""
    return torch.linalg.inv_ex(model[:3, :3])[0].T


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Batched ``M @ [p, 1]`` for ``pts`` of shape (N, 3) or (N, 4), with a
    (4, 4) ``m`` or one per point, (N, 4, 4).

    Each output is the fixed-order sum ((p0 m_i0 + p1 m_i1) + p2 m_i2) +
    p3 m_i3 of elementwise products, not a matrix product: a GEMM's
    summation order may change with N on the GPU, and a vertex must get
    the same bits whatever else is drawn with it (a culled draw equals
    the unculled one).  Points on the card go through one kernel, with
    the 1 of a 3-wide point implicit (``ops/transform.py``).
    """
    pts = pts.to(F32)
    return transform_ops.transform_points(m.to(device=pts.device, dtype=F32), pts)


def transform_directions(m: torch.Tensor, dirs) -> torch.Tensor:
    """Rotate direction vectors by the upper-3x3 of ``m`` (w = 0), in the
    fixed order of :func:`transform_points`."""
    dirs = torch.as_tensor(dirs, dtype=F32)
    return transform_ops.transform_points(m[:3, :3].to(device=dirs.device, dtype=F32), dirs)
