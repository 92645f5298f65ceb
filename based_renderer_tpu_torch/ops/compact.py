"""Covered-tile compaction for deferred shading.

The PyTorch counterpart of ``based_renderer_tpu/ops/compact.py``.  The
fragment pass and its texture taps cost per pixel whatever the coverage,
so a draw with ``Pipeline.shade_compact`` shades only the (8, 128) tiles
its mask touches:

  1. reduce the draw's coverage mask to per-tile bits;
  2. sort the tile ids so covered tiles come first (in tile order);
  3. gather the first ``budget`` tiles' fragment inputs as tile rows;
  4. shade the (budget, 8, 128) micro-framebuffers as one batch;
  5. scatter the shaded tiles back.

The budget is a ladder of static sizes (renderer.py picks the smallest
that holds the covered-tile count, else shades full-screen).  Slots past
the covered count hold real but uncovered tiles whose mask is all false,
so shading them writes back what was there.  Shaders that take texture
LOD from screen-space UV differences (ops/texture.lod_from_uv) see
per-tile fields, so the last row/column of each tile clamps one step
earlier than full-screen shading would, as in the JAX package.

All of it is plain PyTorch: the JAX package computes it in XLA, outside
any Pallas kernel.
"""

from __future__ import annotations

import torch

TILE_H = 8
TILE_W = 128


def eligible(h: int, w: int) -> bool:
    return h % TILE_H == 0 and w % TILE_W == 0


def num_tiles(h: int, w: int) -> int:
    return (h // TILE_H) * (w // TILE_W)


def tile_rows(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, H, W) planar -> (NT, C * TILE_H * TILE_W) tile rows, channel-major
    within a row: a gathered row unpacks to a (C, TILE_H, TILE_W) planar
    micro-framebuffer with one reshape."""
    c = planes.shape[0]
    nty, ntx = h // TILE_H, w // TILE_W
    return (
        planes.reshape(c, nty, TILE_H, ntx, TILE_W)
        .permute(1, 3, 0, 2, 4)
        .reshape(nty * ntx, c * TILE_H * TILE_W)
    )


def untile_rows(rows: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """(NT, C * TILE_H * TILE_W) tile rows -> (C, H, W) planar."""
    nty, ntx = h // TILE_H, w // TILE_W
    return rows.reshape(nty, ntx, c, TILE_H, TILE_W).permute(2, 0, 3, 1, 4).reshape(c, h, w)


def covered_tile_order(mask: torch.Tensor, h: int, w: int):
    """Sorted tile ids (covered first, each group in tile order) + count.

    mask: (H, W) bool (pixels this draw may shade).
    Returns (order (NT,) int64 of unique tile ids, count () int64).
    """
    nty, ntx = h // TILE_H, w // TILE_W
    nt = nty * ntx
    cov = mask.reshape(nty, TILE_H, ntx, TILE_W).any(dim=3).any(dim=1).reshape(nt)
    tid = torch.arange(nt, dtype=torch.int64, device=mask.device)
    order = torch.sort(torch.where(cov, tid, tid + nt)).values
    return order % nt, cov.sum()


def gather_tiles(rows: torch.Tensor, sel: torch.Tensor, c: int) -> torch.Tensor:
    """Gather selected tile rows -> (B, C, TILE_H, TILE_W) planar."""
    return rows[sel].reshape(sel.shape[0], c, TILE_H, TILE_W)


def scatter_tiles(rows: torch.Tensor, sel: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Tile rows with (B, C, TILE_H, TILE_W) planar tiles written at ``sel``.

    ``sel`` entries are unique (covered_tile_order output), so this is a
    plain ``index_copy_``, on a copy: ``rows`` may be a view of the caller's
    colour buffer, as the JAX version's functional update leaves it.
    """
    return rows.clone().index_copy_(0, sel, tiles.reshape(tiles.shape[0], -1))
