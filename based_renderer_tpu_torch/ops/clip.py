"""Near-plane (w) clipping: the clipper stage of primitive assembly.

The PyTorch counterpart of ``based_renderer_tpu/ops/clip.py``.  Each
input triangle is clipped against the plane ``w = eps``, producing 0, 1
or 2 output triangles, statically shaped as exactly 2 slots per input;
unused slots are degenerate (all-equal vertices, area 0) so setup culls
them.  x/y/z planes need no clipping: the guard band absorbs off-screen
geometry and depth is clipped per fragment.
"""

from __future__ import annotations

import torch


def clip_near(clip_pos: torch.Tensor, varyings: dict, eps: float = 1e-5):
    """Clip triangles against w >= eps.

    Args:
      clip_pos: (T, 3, 4) f32 clip positions.
      varyings: dict of (T, 3, C) per-vertex attributes (lerped at cuts).
    Returns:
      (2T, 3, 4) positions and dict of (2T, 3, C) varyings; triangles 2t
      and 2t+1 are the (up to two) pieces of input triangle t, in input
      order, so draw-order depth semantics are preserved.
    """
    num_tris = clip_pos.shape[0]
    eps_t = torch.tensor(eps, dtype=torch.float32, device=clip_pos.device)
    w = clip_pos[..., 3]
    inside = w > eps_t  # (T, 3)
    n_in = inside.sum(dim=-1)  # 0..3

    # Canonical rotation: n_in == 1 rotates the single inside vertex to
    # slot 0; n_in == 2 rotates the single outside vertex to slot 2.
    i0, i1 = inside[:, 0], inside[:, 1]
    rot1 = torch.where(i0, 0, torch.where(i1, 1, 2))
    rot2 = torch.where(~i0, 1, torch.where(~i1, 2, 0))
    rot = torch.where(n_in == 1, rot1, torch.where(n_in == 2, rot2, 0))
    idx = (rot[:, None] + torch.arange(3, device=clip_pos.device)[None, :]) % 3
    tgather = torch.arange(num_tris, device=clip_pos.device)[:, None]
    p = clip_pos[tgather, idx]
    v = {k: a[tgather, idx] for k, a in varyings.items()}
    one = torch.ones((), dtype=torch.float32, device=clip_pos.device)

    def lerp_cut(a, b):
        """Intersection of segment a->b with w = eps (per-component lerp)."""
        wa = p[:, a, 3]
        wb = p[:, b, 3]
        t = (eps_t - wa) / torch.where(wb == wa, one, wb - wa)
        t = t.clamp(0.0, 1.0)[:, None]
        pos = p[:, a] + (p[:, b] - p[:, a]) * t
        var = {k: a2[:, a] + (a2[:, b] - a2[:, a]) * t for k, a2 in v.items()}
        return pos, var

    cut01, vcut01 = lerp_cut(0, 1)
    cut02, vcut02 = lerp_cut(0, 2)
    cut12, vcut12 = lerp_cut(1, 2)
    cut20, vcut20 = lerp_cut(2, 0)
    n = n_in[:, None, None]

    def slots(q, c01, c02, c12, c20):
        # Slot A: n=3 original; n=1 (v0, cut01, cut02); n=2 (v0, v1, cut12).
        # Slot B: n=2 (v0, cut12, cut20); otherwise degenerate.  n=0: both
        # degenerate.
        one_in = torch.stack([q[:, 0], c01, c02], dim=1)
        two_in = torch.stack([q[:, 0], q[:, 1], c12], dim=1)
        slot_a = torch.where(n == 3, q, torch.where(n == 1, one_in, two_in))
        degen = q[:, :1].expand(-1, 3, -1)
        slot_b = torch.where(n == 2, torch.stack([q[:, 0], c12, c20], dim=1), degen)
        slot_a = torch.where(n == 0, degen, slot_a)
        return torch.stack([slot_a, slot_b], dim=1).reshape(-1, 3, q.shape[-1])

    out_pos = slots(p, cut01, cut02, cut12, cut20)
    out_var = {
        k: slots(v[k], vcut01[k], vcut02[k], vcut12[k], vcut20[k]) for k in varyings
    }
    return out_pos, out_var
