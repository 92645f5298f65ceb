"""State carried across from numpy (and so from the JAX package).

The renderer has no weights: its state is meshes (indexed or not),
textures, instance tables, uniforms and pipeline state.  These helpers build the
port's versions from plain numpy data, so one scene can be handed to both
packages (a JAX array converts with ``numpy.asarray``; a JAX pipeline
with ``dataclasses.asdict``).
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import BlendState, DepthState, Pipeline, StencilState
from .scene import Mesh, Texture

_TUPLE_FIELDS = ("raster_tile", "scissor", "shade_compact", "constants")


def mesh_from_numpy(attributes: dict, indices=None, device="cpu") -> Mesh:
    """Mesh from numpy arrays: (N, C) float attributes (with "position")
    and an optional (T, 3) index list, kept indexed."""
    if "position" not in attributes:
        raise ValueError(f"mesh needs a 'position' attribute, got {sorted(attributes)}")
    attrs = {}
    for k, v in attributes.items():
        t = torch.tensor(np.asarray(v, np.float32), device=device)
        attrs[k] = t[:, None] if t.ndim == 1 else t
    n = attrs["position"].shape[0]
    for k, t in attrs.items():
        if t.ndim != 2 or t.shape[0] != n:
            raise ValueError(f"attribute {k!r} has shape {tuple(t.shape)}; expected ({n}, C)")
    idx = None
    if indices is not None:
        idx_np = np.asarray(indices, np.int64)
        if idx_np.ndim != 2 or idx_np.shape[1] != 3:
            raise ValueError(f"indices must be (T, 3), got {idx_np.shape}")
        if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
            raise ValueError(f"index out of bounds: [{idx_np.min()}, {idx_np.max()}] vs {n} vertices")
        idx = torch.as_tensor(idx_np.astype(np.int32), device=device)
    elif n % 3:
        raise ValueError("non-indexed mesh needs a multiple-of-3 vertex count")
    return Mesh(attributes=attrs, indices=idx)


def uniforms_from_numpy(tree, device="cpu"):
    """Map a dict/list/tuple tree of arrays and numbers to tensors on
    ``device`` (floating values as float32)."""
    if isinstance(tree, dict):
        return {k: uniforms_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(uniforms_from_numpy(v, device) for v in tree)
    t = torch.tensor(np.asarray(tree), device=device)
    return t.to(torch.float32) if t.is_floating_point() else t


def texture_from_numpy(data, packed, meta, device="cpu") -> Texture:
    """Texture from numpy: the (H, W, C) level 0, the packed patch rows of
    every mip level and the static sampler state, as a JAX texture holds
    them (``numpy.asarray(tex.data)``, ``numpy.asarray(tex.packed)``,
    ``tex.meta``)."""
    data = np.asarray(data, np.float32)
    packed = np.asarray(packed, np.float32)
    wrap, channels, sizes = meta[:3]
    if data.ndim != 3 or data.shape[-1] != channels or tuple(sizes[0]) != data.shape[:2]:
        raise ValueError(f"texture data {data.shape} does not match meta {meta}")
    if packed.shape != (sum(h * w for h, w in sizes), 4 * channels):
        raise ValueError(f"packed patch rows {packed.shape} do not match meta {meta}")
    meta = (wrap, int(channels), tuple((int(h), int(w)) for h, w in sizes), *meta[3:])
    return Texture(data=torch.tensor(data, device=device), packed=torch.tensor(packed, device=device), meta=meta)


def instances_from_numpy(instances: dict, device="cpu") -> dict:
    """Instance tables from numpy: (I, ...) float arrays, kept in shape (an
    (I, 4, 4) transform stays (I, 4, 4); expand_instances flattens it)."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in instances.items()}


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if k in _TUPLE_FIELDS and isinstance(v, list) else v for k, v in d.items()}


def pipeline_from_dict(d: dict) -> Pipeline:
    """Pipeline from ``dataclasses.asdict`` of a pipeline of either package."""
    d = _tuples(dict(d))
    return Pipeline(
        **{
            **d,
            "depth": DepthState(**d["depth"]),
            "stencil": StencilState(**d["stencil"]),
            "blend": BlendState(**_tuples(d["blend"])),
        }
    )
