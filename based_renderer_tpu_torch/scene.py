"""Scene resources: meshes and textures (the PyTorch counterpart of
``scene.py``).

Meshes are struct-of-arrays tensors on the renderer's device; uniforms
are a plain dict passed per draw, and a Texture rides in them as it is.
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
    generator: for a generated mesh (generated_mesh), the zero-argument
      function that makes the same attributes with torch ops on the
      device; None for an uploaded mesh.
    """

    attributes: dict
    indices: Optional[torch.Tensor]
    generator: object = None

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


def _normalize_attributes(a: dict, device) -> dict:
    """Generated attributes as (N, C) contiguous float32 tensors on ``device``."""
    out = {}
    for k, v in dict(a).items():
        v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
        out[k] = (v[:, None] if v.ndim == 1 else v).contiguous()
    return out


def generated_mesh(generator, device=None) -> Mesh:
    """Mesh whose vertex data is defined by code.

    ``generator()`` returns a dict of (N, C) float32 corner-sequential
    attributes, "position" among them, made with torch ops.  It runs once
    here, to validate it and to give single frames their attributes, as in
    the JAX package (scene.py:151-205).  A sequence
    (Renderer.render_sequence_multi) runs it again once per call, before
    its frames, into buffers that the sequence's captured program owns, so
    the program's identity carries no attribute tensors.  Validation is
    the JAX package's: "position" is required, every attribute has its row
    count, and the vertex count is a multiple of 3.
    """

    def normalized_generator():
        return _normalize_attributes(generator(), device)

    a = normalized_generator()
    if "position" not in a:
        raise ValueError(f"generated mesh must contain 'position'; generator returned {sorted(a)}")
    n = a["position"].shape[0]
    for k, v in a.items():
        if v.shape[0] != n:
            raise ValueError(f"generated attribute {k!r} has {v.shape[0]} rows, expected {n}")
    if n % 3 != 0:
        raise ValueError("generated mesh needs a multiple-of-3 vertex count")
    return Mesh(attributes=a, indices=None, generator=normalized_generator)


@dataclass(frozen=True)
class Texture:
    """Device-resident (H, W, C) float32 texture + sampler state.

    The wrap mode and mip chain are baked at upload.  ``packed`` holds, per
    mip level, every texel's 2x2 neighborhood as one row of 4*C floats,
    all levels concatenated, so a bilinear tap at any level is one flat
    gather (ops/texture.py).  ``meta`` is static: (wrap, C, ((h, w), ...),
    mip_filter), as in the JAX package.
    """

    data: torch.Tensor  # (H, W, C) float32 level 0
    packed: torch.Tensor  # (sum_l h_l*w_l, 4*C) float32 patch rows
    meta: tuple  # (wrap: str, channels: int, sizes: ((h, w), ...), mip_filter: str)

    @property
    def shape(self):
        return self.data.shape

    @property
    def wrap(self) -> str:
        return self.meta[0]

    @property
    def mip_filter(self) -> str:
        return self.meta[3] if len(self.meta) > 3 else "nearest"

    @property
    def num_levels(self) -> int:
        return len(self.meta[2])

    def to(self, device) -> "Texture":
        """This texture on ``device`` (itself when it is there already)."""
        device = torch.device(device)
        if self.data.device == device and self.packed.device == device:
            return self
        return Texture(data=self.data.to(device), packed=self.packed.to(device), meta=self.meta)


def _patch_rows(level: np.ndarray, wrap: str) -> np.ndarray:
    """Pack each texel's 2x2 neighborhood into one (4*C,) row."""
    if wrap == "repeat":
        tx1 = np.roll(level, -1, axis=1)
        ty1 = np.roll(level, -1, axis=0)
        txy = np.roll(tx1, -1, axis=0)
    else:  # clamp / mirror both clamp the +1 neighbor at the high edge
        tx1 = np.concatenate([level[:, 1:], level[:, -1:]], axis=1)
        ty1 = np.concatenate([level[1:], level[-1:]], axis=0)
        txy = np.concatenate([tx1[1:], tx1[-1:]], axis=0)
    h, w, c = level.shape
    return np.concatenate([level, tx1, ty1, txy], axis=-1).reshape(h * w, 4 * c)


def upload_texture(image, device=None, wrap: str = "repeat", mipmaps: bool = False,
                   mip_filter: str = "linear") -> Texture:
    """Upload an image as a float32 texture (uint8 input is normalized).

    Args:
      wrap: "repeat" | "clamp", the sampler address mode, baked into the
        packed patch layout at upload.
      mipmaps: build a full box-filtered mip chain down to 1x1.  Requires
        power-of-two dimensions.
      mip_filter: "nearest" | "linear" (trilinear, the default).
    The mip chain is computed in numpy float32 exactly as the JAX package
    computes it, so both packages sample the same texels.
    """
    if mip_filter not in ("nearest", "linear"):
        raise ValueError(f"bad mip_filter {mip_filter!r}")
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, _c = img.shape
    if mipmaps and (h & (h - 1) or w & (w - 1)):
        raise ValueError(f"mipmapped textures need power-of-two dims, got {w}x{h}")

    levels = [img]
    if mipmaps:
        cur = img
        while cur.shape[0] > 1 or cur.shape[1] > 1:
            nh, nw = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
            if cur.shape[0] > 1 and cur.shape[1] > 1:
                cur = cur.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
            elif cur.shape[0] > 1:
                cur = cur.reshape(nh, 2, 1, -1).mean(axis=1)
            else:
                cur = cur.reshape(1, nw, 2, -1).mean(axis=2)
            levels.append(cur.astype(np.float32))

    packed = np.concatenate([_patch_rows(lv, wrap) for lv in levels], axis=0)
    meta = (wrap, levels[0].shape[-1], tuple((lv.shape[0], lv.shape[1]) for lv in levels), mip_filter)
    return Texture(
        data=torch.tensor(img, device=device),
        packed=torch.tensor(packed, device=device),
        meta=meta,
    )
