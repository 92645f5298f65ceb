"""chip_smoke.py's bound of a raster kernel counts the winners' reads.

``chip_smoke.winning_records`` counts the records that won a pixel in one
raster call: distinct (bin, tri_id) pairs over the pixels whose tri_id is
set and was not kept from ``init``.  Held against a brute-force count of
the distinct record slots that the plain sublane raster's winners come
from, on the big_mesh demo (2000 triangles) at 128x96, tiles 128x8: one
draw, and a second draw of other triangles over the first's buffer.
"""

import pathlib
import sys

import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops.binning import bin_triangles
from based_renderer_tpu_torch.ops.setup import setup_triangles
from based_renderer_tpu_torch.ops.vertex import gather_triangles

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

W, H = 128, 96
TILE = (128, 8)


def _big_mesh_tris():
    r = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu")
    pipe, mesh, uniforms, _ = tbrt.demos.big_mesh_demo(r, triangles=2000)
    clip, var = tbrt.shader.get(pipe.shader).vertex(mesh.attributes, uniforms(0.2))
    clip_tri, var_tri = gather_triangles(clip, var, None)
    return pipe, clip_tri, torch.cat([var_tri[k] for k in sorted(var_tri)], dim=-1)


def _binned(pipe, clip, channels, id_offset=0):
    ts = setup_triangles(clip, W, H, cull_mode=pipe.cull_mode, front_face=pipe.front_face)
    b = bin_triangles(ts, W, H, *TILE, channels=channels, max_pairs=16 * clip.shape[0], id_offset=id_offset)
    assert not bool(b.overflowed)
    return b


def _winning_slots(binned, tri_id):
    """Brute force: for each pixel, the slot of its bin whose record carries
    the pixel's tri_id (pixels won by another stream find none)."""
    num_tx = -(-W // TILE[0])
    start, count = binned.tile_start.tolist(), binned.tile_count.tolist()
    ids = binned.records[13].tolist()
    slots = set()
    for y in range(H):
        for x in range(W):
            t = int(tri_id[y, x])
            if t < 0:
                continue
            b = (y // TILE[1]) * num_tx + x // TILE[0]
            hits = [s for s in range(start[b], start[b] + count[b]) if ids[s] == t]
            assert len(hits) <= 1
            slots.update(hits)
    return slots


def test_winner_count_equals_distinct_winning_slots():
    pipe, clip, ch = _big_mesh_tris()
    b = _binned(pipe, clip, ch)
    vis = traster.rasterize_binned(b, W, H, *TILE, sublane=True, num_channels=ch.shape[-1])[0]
    slots = _winning_slots(b, vis.tri_id)
    assert len(slots) > 100
    assert chip_smoke.winning_records(vis.tri_id, None, TILE) == len(slots)


def test_winner_count_skips_pixels_kept_from_init():
    """A second draw over the first's buffer: only its own winners count."""
    pipe, clip, ch = _big_mesh_tris()
    half = clip.shape[0] // 2
    first = _binned(pipe, clip[:half], ch[:half])
    second = _binned(pipe, clip[half:], ch[half:], id_offset=half)
    k = ch.shape[-1]
    init = traster.rasterize_binned(first, W, H, *TILE, sublane=True, num_channels=k)[0]
    vis = traster.rasterize_binned(second, W, H, *TILE, sublane=True, num_channels=k, init=init)[0]
    kept = vis.tri_id == init.tri_id
    assert bool(kept[init.tri_id >= 0].any()) and bool((~kept & (vis.tri_id >= 0)).any())
    slots = _winning_slots(second, vis.tri_id)
    assert chip_smoke.winning_records(vis.tri_id, init.tri_id, TILE) == len(slots)
