"""Vertex stage runner: attribute assembly and triangle gather.

The PyTorch counterpart of ``based_renderer_tpu/ops/vertex.py``.
"""

from __future__ import annotations

import torch

from ..scene import Mesh
from ..utils.errors import FeatureNotPresentError


def expand_instances(mesh: Mesh, instances: dict | None):
    """Mesh attributes for one draw: (attrs, tri_idx).

    tri_idx is None for corner-sequential meshes (upload_mesh de-indexes
    at upload, so the triangle gather is then a free reshape).  Instance
    tables arrive with the instancing slice (ROADMAP A.12).
    """
    if instances:
        raise FeatureNotPresentError("instanced draws are not ported yet (ROADMAP A.12)")
    return dict(mesh.attributes), mesh.indices


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
