"""Vertex stage runner: attribute assembly, instancing, triangle gather.

The PyTorch counterpart of ``based_renderer_tpu/ops/vertex.py``.
"""

from __future__ import annotations

import torch

from .. import math3d
from ..scene import Mesh


def expand_instances(mesh: Mesh, instances: dict | None):
    """Broadcast mesh attributes and instance attributes to (I*N, C).

    instances: dict of (I, ...) tensors; trailing dims are flattened, so a
    (I, 4, 4) transform becomes an (I*N, 16) attribute the shader reshapes.
    Returns (attrs, tri_idx): the merged attribute dict and the (I*T, 3)
    indices, offset by N per instance; tri_idx is None for corner-sequential
    meshes (upload_mesh de-indexes at upload, so the triangle gather is
    then a free reshape).
    """
    attrs = dict(mesh.attributes)
    tri_idx = mesh.indices
    if not instances:
        return attrs, tri_idx
    num_inst = next(iter(instances.values())).shape[0]
    n = mesh.num_vertices
    out = {k: v.repeat(num_inst, 1) for k, v in attrs.items()}
    for k, v in instances.items():
        flat = torch.as_tensor(v, dtype=torch.float32).reshape(v.shape[0], -1)
        out[k] = flat.repeat_interleave(n, dim=0)
    if tri_idx is not None:
        offsets = (torch.arange(num_inst, dtype=tri_idx.dtype, device=tri_idx.device) * n)[:, None, None]
        tri_idx = (tri_idx[None, :, :] + offsets).reshape(-1, 3)
    return out, tri_idx


def apply_instance_transform(attrs: dict) -> torch.Tensor:
    """Apply a per-vertex 'transform' attribute ((V, 16) row-major 4x4) to
    the positions, returning (V, 4) transformed positions.  Shaders call
    this before their view/projection multiply for instanced draws.  The
    sums run in a fixed order (math3d.transform_points), so a vertex's
    bits do not depend on how many are transformed with it."""
    return math3d.transform_points(attrs["transform"].reshape(-1, 4, 4), attrs["position"])


def gather_triangles(clip: torch.Tensor, varyings: dict, tri_idx):
    """Vertex-shader outputs -> per-triangle arrays for setup/raster.

    Returns clip_tri (T, 3, 4) and varyings_tri dict[str, (T, 3, C)].
    tri_idx None = corner-sequential mesh: the gather is a reshape.
    Otherwise one fused row gather of position and varyings.
    """
    if tri_idx is None:
        clip_tri = clip.reshape(-1, 3, clip.shape[-1])
        return clip_tri, {k: v.reshape(-1, 3, v.shape[-1]) for k, v in varyings.items()}
    keys = sorted(varyings)
    parts = [clip] + [varyings[k] for k in keys]
    fused = torch.cat(parts, dim=-1)  # (V, 4 + sum C)
    g = fused[tri_idx.to(torch.int64)]
    varyings_tri = {}
    off = clip.shape[-1]
    for k in keys:
        w = varyings[k].shape[-1]
        varyings_tri[k] = g[..., off : off + w]
        off += w
    return g[..., : clip.shape[-1]], varyings_tri
