"""Per-instance frustum culling: drop whole instances before expansion.

The PyTorch counterpart of ``based_renderer_tpu/ops/cull.py``.  An
instanced draw with ``Pipeline.instance_cull`` tests every instance's
transformed mesh bounding box against the view volume and compacts the
survivors into a budget of slots before ``vertex.expand_instances``, so
the vertex stage, setup and the binner see fewer triangles.

The contract (the renderer's tests hold it bit for bit):

* The test is conservative: an instance is culled only when all 8 corners
  of its transformed object-space box lie strictly outside one frustum
  plane inset by ``slack_px`` pixels, or all have w <= W_EPS (setup drops
  every triangle with such a vertex).  Each plane functional is linear in
  clip coordinates, so the whole hull, and the instance inside it, is
  outside too whenever the vertex stage is affine in "position".
* Compaction is order-preserving (a stable sort of the visible flag), and
  the renderer carries each surviving triangle's original draw-order id
  through the raster records, so depth ties and the tri_id plane equal
  the unculled frame's.

Everything stays on the device: the budget is a static count taken from
the instance count, and ``overflowed`` is a () bool tensor.
"""

from __future__ import annotations

import torch

from ..scene import Mesh

W_EPS = 1e-6  # setup_triangles' w_eps


def mesh_bbox_corners(mesh: Mesh) -> torch.Tensor:
    """(8, 4) homogeneous corners of the mesh's object-space AABB."""
    p = mesh.attributes["position"][:, :3]
    lo = p.amin(dim=0)
    hi = p.amax(dim=0)
    c = torch.arange(8, device=p.device)
    sel = torch.stack([(c >> a) & 1 for a in range(3)], dim=-1).to(torch.float32)
    xyz = lo[None, :] * (1.0 - sel) + hi[None, :] * sel
    return torch.cat([xyz, torch.ones((8, 1), dtype=torch.float32, device=p.device)], dim=-1)


def instance_visibility(shader, mesh: Mesh, instances: dict, uniforms, width: int, height: int,
                        slack_px: float = 2.0) -> torch.Tensor:
    """Conservative per-instance visibility: (I,) bool.

    Runs the draw's own vertex stage on each instance's 8 box corners
    (instance attributes broadcast as in expand_instances; other
    per-vertex attributes take the mesh's first row, whose value the clip
    position does not depend on), then tests the clip-space hull against
    the left, right, top and bottom planes inset by ``slack_px`` pixels
    (margin for fixed-point snapping) and against the near plane.
    """
    corners = mesh_bbox_corners(mesh)
    num_inst = next(iter(instances.values())).shape[0]
    n = 8
    attrs = {k: v[0:1].expand(num_inst * n, v.shape[-1]) for k, v in mesh.attributes.items()}
    attrs["position"] = corners.repeat(num_inst, 1)
    for k, v in instances.items():
        flat = v.to(torch.float32).reshape(v.shape[0], -1)
        attrs[k] = flat.repeat_interleave(n, dim=0)
    clip, _ = shader.vertex(attrs, uniforms)
    clip = clip.reshape(num_inst, n, 4)
    x, y, w = clip[..., 0], clip[..., 1], clip[..., 3]
    sx = torch.full((), 1.0 + 2.0 * slack_px / width, dtype=torch.float32, device=clip.device)
    sy = torch.full((), 1.0 + 2.0 * slack_px / height, dtype=torch.float32, device=clip.device)
    out_left = (x + sx * w < 0).all(dim=1)
    out_right = (sx * w - x < 0).all(dim=1)
    out_top = (y + sy * w < 0).all(dim=1)
    out_bottom = (sy * w - y < 0).all(dim=1)
    out_near = (w <= torch.full((), W_EPS, dtype=torch.float32, device=clip.device)).all(dim=1)
    return ~(out_left | out_right | out_top | out_bottom | out_near)


def compact_instances(instances: dict, visible: torch.Tensor, budget: int):
    """Gather the visible instances, in order, into ``budget`` slots.

    Returns (the instances dict with leading dim ``budget``, orig_idx
    (budget,) int32 original instance indices, overflowed () bool).  Slots
    past the visible count hold culled instances, which cover nothing, so
    rendering them changes no pixel.  ``overflowed`` is True when more
    instances are visible than the budget holds: the trailing ones are
    dropped and the frame reports it, as a binner budget breach does.
    """
    num_inst = visible.shape[0]
    budget = min(int(budget), num_inst)
    keys = (~visible).to(torch.int32)
    orig_idx = torch.sort(keys, stable=True).indices[:budget]
    # One fused row gather over all instance attributes.
    names = sorted(instances)
    flats = [instances[k].to(torch.float32).reshape(num_inst, -1) for k in names]
    fused = torch.cat(flats, dim=-1)[orig_idx]
    out = {}
    off = 0
    for k, f in zip(names, flats):
        wdt = f.shape[-1]
        out[k] = fused[:, off : off + wdt].reshape((budget,) + tuple(instances[k].shape[1:]))
        off += wdt
    overflowed = visible.sum() > budget
    return out, orig_idx.to(torch.int32), overflowed
