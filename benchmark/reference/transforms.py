"""The transforms the scenes' uniforms are built from: a frozen copy of the
program's ``math3d.rotate``, ``translate`` and ``perspective`` (float32,
column vectors, Vulkan clip: y down, depth in [0, 1]), so that a later
edit of the program cannot change the benchmark's inputs."""

from __future__ import annotations

import torch

F32 = torch.float32


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def translate(v) -> torch.Tensor:
    t = torch.eye(4, dtype=F32)
    t[:3, 3] = _t(v)
    return t


def rotate(angle, axis, m: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation by ``angle`` radians about ``axis``, post-multiplied onto ``m``."""
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
