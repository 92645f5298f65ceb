"""The binner's float template planes of one draw: the CUDA kernel and its
plain version.

The binner (``ops/binning.py:_templates``) anchors each triangle's planes
at the pixel-(0, 0) centre: the barycentric planes b0 and b1 from the
exact origin edge values, the 1/w plane, and one plane per varying
channel (divided by w first when ``perspective``), each as (p00, pdx,
pdy).  ``template_planes`` builds them as one (T, 3 * (3 + K)) float32
tensor, the layout of ``Templates.planes``: CUDA tensors launch
``csrc/triangle_templates.cu``, which computes every row in one pass; CPU
tensors take ``template_planes_reference``, the same operations in plain
PyTorch, each its own op so that nothing contracts into an FMA.  The two
are equal bit for bit.
"""

from __future__ import annotations

import torch

from ..utils.errors import FeatureNotPresentError
from . import _build
from . import fixedpoint as fp


def template_planes_reference(e, a, b, inv_area, inv_w, channels, perspective: bool) -> torch.Tensor:
    """The plain PyTorch version of ``template_planes``, on any device."""
    ef = fp.i64_to_f32(e)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    sc = fp.f32(fp.SUBPIXEL_SCALE, inv_area)
    b0p = (ef[:, 1] * inv_area, af[:, 1] * sc * inv_area, bf[:, 1] * sc * inv_area)
    b1p = (ef[:, 2] * inv_area, af[:, 2] * sc * inv_area, bf[:, 2] * sc * inv_area)
    b2p = (1.0 - (b0p[0] + b1p[0]), -(b0p[1] + b1p[1]), -(b0p[2] + b1p[2]))

    def plane_of(q):  # (T, 3) per-vertex values -> plane triple
        return [q[:, 0] * b0p[i] + q[:, 1] * b1p[i] + q[:, 2] * b2p[i] for i in range(3)]

    planes = list(b0p) + list(b1p) + plane_of(inv_w)
    if channels is not None:
        ch = channels * inv_w[:, :, None] if perspective else channels
        for kk in range(channels.shape[-1]):
            planes += plane_of(ch[:, :, kk])
    return torch.stack(planes, dim=1)


def _planes_kernel(e, a, b, inv_area, inv_w, channels, perspective: bool) -> torch.Tensor:
    """Launch csrc/triangle_templates.cu."""
    dev = e.device
    t = e.shape[0]
    k = 0 if channels is None else channels.shape[-1]
    e, a, b, inv_area, inv_w = (x.contiguous() for x in (e, a, b, inv_area, inv_w))
    channels = channels.contiguous() if k else None
    _build.check_operand("e", e, torch.int64, (t, 3), dev)
    _build.check_operand("a", a, torch.int32, (t, 3), dev)
    _build.check_operand("b", b, torch.int32, (t, 3), dev)
    _build.check_operand("inv_area", inv_area, torch.float32, (t,), dev)
    _build.check_operand("inv_w", inv_w, torch.float32, (t, 3), dev)
    if k:
        _build.check_operand("channels", channels, torch.float32, (t, 3, k), dev)
    planes = torch.empty((t, 3 * (3 + k)), dtype=torch.float32, device=dev)
    _build.launch(
        "triangle_templates",
        _build.ptr(e), _build.ptr(a), _build.ptr(b), _build.ptr(inv_area), _build.ptr(inv_w), _build.ptr(channels),
        k, int(perspective), _build.ptr(planes), t, dev=dev,
    )
    return planes


def template_planes(e, a, b, inv_area, inv_w, channels, perspective: bool) -> torch.Tensor:
    """A draw's float template planes, (T, 3 * (3 + K)) float32.

    ``e`` (T, 3) int64 holds the exact biased edge values at the
    pixel-(0, 0) centre, ``a`` and ``b`` (T, 3) int32 the edge
    coefficients, ``inv_area`` (T,) and ``inv_w`` (T, 3) float32 the
    setup's reciprocals, ``channels`` (T, 3, K) float32 the per-vertex
    varyings (or None, K = 0).  Columns: the planes of b0, b1, 1/w and
    each channel, each as (p00, pdx, pdy).  CUDA tensors launch the
    kernel, CPU tensors take the plain version.
    """
    dev = e.device
    if dev.type == "cpu":
        return template_planes_reference(e, a, b, inv_area, inv_w, channels, perspective)
    if dev.type != "cuda":
        raise FeatureNotPresentError(f"no template path for device {dev}")
    return _planes_kernel(e, a, b, inv_area, inv_w, channels, perspective)
