"""The vertex stage's point transform: the CUDA kernel and its plain
version.

``transform_points(m, v)`` is ``m @ v`` per point as the fixed-order sum
((v0 m_i0 + v1 m_i1) + v2 m_i2) + v3 m_i3 of elementwise products, never
a matrix product: a GEMM's summation order may change with N on the GPU,
and a vertex must get the same bits whatever else is drawn with it (a
culled draw equals the unculled one).  ``m`` is one (R, C) matrix or one
per point, (N, R, C); ``v`` is (N, C), or (N, C - 1) with an implicit
trailing 1 (homogeneous points).  CUDA tensors launch
``csrc/transform_points.cu`` (R, C <= 4), which reads each point once and
writes its row once; CPU tensors take ``transform_points_reference``, the
same products and sums in plain PyTorch, each its own op so that nothing
contracts into an FMA.  The two are equal bit for bit.
"""

from __future__ import annotations

import torch

from ..utils.errors import FeatureNotPresentError
from . import _build

MAX_DIM = 4  # the kernel's largest R, C and point width


def transform_points_reference(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``transform_points``, on any device."""
    if m.shape[-1] == v.shape[-1] + 1:
        v = torch.cat([v, torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)], -1)
    out = m[..., :, 0] * v[..., 0:1]
    for j in range(1, v.shape[-1]):
        out = out + m[..., :, j] * v[..., j : j + 1]
    return out


def _transform_kernel(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/transform_points.cu."""
    dev = v.device
    if v.dim() != 2 or m.dim() not in (2, 3):
        raise ValueError(f"points {tuple(v.shape)} must be (N, P), the matrix {tuple(m.shape)} (R, C) or (N, R, C)")
    n, p = v.shape
    r, c = m.shape[-2:]
    if not (1 <= r <= MAX_DIM and 1 <= c <= MAX_DIM and c in (p, p + 1)):
        raise ValueError(f"a matrix {tuple(m.shape)} takes no points {tuple(v.shape)}: R, C at most {MAX_DIM}, "
                         f"P = C or C - 1")
    per_point = m.dim() == 3
    m, v = m.contiguous(), v.contiguous()
    _build.check_operand("m", m, torch.float32, (n, r, c) if per_point else (r, c), dev)
    _build.check_operand("v", v, torch.float32, (n, p), dev)
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    _build.launch("transform_points", _build.ptr(m), r * c if per_point else 0, _build.ptr(v), _build.ptr(out),
                  n, r, c, p, dev=dev)
    return out


def transform_points(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` per point in the fixed column order, (N, R) float32 on the
    card (see the module docstring).  CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    dev = v.device
    if dev.type == "cpu":
        return transform_points_reference(m, v)
    if dev.type != "cuda":
        raise FeatureNotPresentError(f"no transform path for device {dev}")
    return _transform_kernel(m, v)
