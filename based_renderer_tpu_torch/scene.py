"""Scene resources: meshes (the PyTorch counterpart of ``scene.py``).

Meshes are struct-of-arrays tensors on the renderer's device; uniforms
are a plain dict passed per draw.  Textures arrive with the textured
slice (ROADMAP A.11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """Device-resident triangle mesh.

    attributes: dict of (N, C) float32 per-vertex tensors; must contain
      "position" (N, 2|3|4).
    indices: (T, 3) int triangle list, or None for non-indexed
      (sequential triples).
    """

    attributes: dict
    indices: Optional[torch.Tensor]

    @property
    def num_vertices(self) -> int:
        return self.attributes["position"].shape[0]

    @property
    def num_triangles(self) -> int:
        if self.indices is not None:
            return self.indices.shape[0]
        return self.num_vertices // 3


def upload_mesh(positions, indices=None, device=None, **attrs) -> Mesh:
    """Upload per-vertex data to the device.

    Indexed meshes are de-indexed once here (host side), as in the JAX
    package: the triangle order (so draw-order depth ties and tri_ids) is
    unchanged, and the per-frame triangle gather becomes a reshape.

    Args:
      positions: (N, 2|3|4) float array.
      indices: optional (T, 3) int triangle list (expanded at upload).
      device: torch device of the mesh (default: CPU).
      **attrs: additional (N, C) per-vertex attributes (color, uv, ...).
    """
    pos = np.asarray(positions)
    n = pos.shape[0]
    if indices is not None:
        idx = np.asarray(indices, np.int64)
        if idx.ndim != 2 or idx.shape[1] != 3:
            raise ValueError(f"indices must be (T, 3), got {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"index out of bounds: [{idx.min()}, {idx.max()}] vs {n} vertices")
        flat = idx.reshape(-1)
        pos = pos[flat]
        attrs = {k: np.asarray(v)[flat] for k, v in attrs.items()}
    a = {"position": torch.tensor(np.asarray(pos, np.float32), device=device)}
    for k, v in attrs.items():
        v = torch.tensor(np.asarray(v, np.float32), device=device)
        if v.ndim == 1:
            v = v[:, None]
        if v.shape[0] != a["position"].shape[0]:
            raise ValueError(
                f"attribute {k!r} has {v.shape[0]} rows, expected {a['position'].shape[0]}"
            )
        a[k] = v
    if a["position"].shape[0] % 3 != 0:
        raise ValueError("non-indexed mesh needs a multiple-of-3 vertex count")
    return Mesh(attributes=a, indices=None)
