"""Covered-tile compaction (ops/compact.py, Pipeline.shade_compact): the port
vs the JAX package and vs its own full-screen shading.

Mirrors tests/test_compact.py.  Tile layout, covered-tile order and the
scatter equal the JAX functions exactly.  For pointwise fragment shaders
the compacted frame equals the port's own full-screen frame bit for bit,
on both branches (the covered tiles fit a budget, or they outnumber every
budget and the draw shades full-screen); the port evaluates each
operation alone in both, so unlike XLA's two compiled branches there is
no contraction to tell them apart.  Compaction follows the JAX package's
rule: on with the "pallas" backend, off under "auto" on the CPU.  The
textured cube, whose LOD reads per-tile differences under compaction,
equals the JAX package's compacted frame from shared clip space (tri_id
and depth_q exact, colour within 1e-4), MSAA-4x included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.ops import compact as jcp
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.models import geometry as tgeom
from based_renderer_tpu_torch.ops import compact as cp
from based_renderer_tpu_torch.utils import profiling

W, H = 256, 96  # 2 x 12 = 24 tiles of (8, 128)


def cfg(**kw):
    return tbrt.RendererConfig(width=W, height=H, raster_backend="pallas", **kw)


def _compacted(fn):
    """fn()'s result and how many draws it shaded per covered tile."""
    before = profiling.ROUTES_TAKEN["compacted_draws"]
    out = fn()
    return out, profiling.ROUTES_TAKEN["compacted_draws"] - before


def test_tile_layout_matches_jax():
    rng = np.random.default_rng(0)
    planes = rng.normal(size=(5, H, W)).astype(np.float32)
    rows = cp.tile_rows(torch.from_numpy(planes), H, W)
    assert tuple(rows.shape) == (cp.num_tiles(H, W), cp.TILE_H * cp.TILE_W * 5)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jcp.tile_rows(jnp.asarray(planes), H, W)))
    np.testing.assert_array_equal(cp.untile_rows(rows, 5, H, W).numpy(), planes)
    t = cp.gather_tiles(rows, torch.tensor([7]), 5)[0]
    ty, tx = 7 // (W // cp.TILE_W), 7 % (W // cp.TILE_W)
    np.testing.assert_array_equal(t.numpy(), planes[:, ty * 8 : ty * 8 + 8, tx * 128 : tx * 128 + 128])
    assert cp.eligible(48, 256) and not cp.eligible(44, 256) and not cp.eligible(48, 96)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covered_tile_order_and_scatter_match_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((H, W)) < 0.0004 * (seed + 1)
    order, count = cp.covered_tile_order(torch.from_numpy(mask), H, W)
    j_order, j_count = jcp.covered_tile_order(jnp.asarray(mask), H, W)
    assert int(count) == int(j_count)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert sorted(order.tolist()) == list(range(cp.num_tiles(H, W)))
    rows = rng.normal(size=(cp.num_tiles(H, W), 2 * 8 * 128)).astype(np.float32)
    tiles = rng.normal(size=(5, 2, 8, 128)).astype(np.float32)
    sel = order[:5]
    got = cp.scatter_tiles(torch.from_numpy(rows), sel, torch.from_numpy(tiles))
    want = jcp.scatter_tiles(jnp.asarray(rows), jnp.asarray(order.numpy()[:5], jnp.int32), jnp.asarray(tiles))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_covered_tile_order_picks_covered_first():
    mask = np.zeros((H, W), bool)
    mask[0, 0] = True  # tile 0
    mask[10, 200] = True  # tile row 1, col 1 -> tile 3
    order, count = cp.covered_tile_order(torch.from_numpy(mask), H, W)
    assert int(count) == 2 and order[:2].tolist() == [0, 3]


@pytest.mark.parametrize("budget_frac, branch", [(0.9, 1), (0.05, 0)])
def test_compact_matches_full(budget_frac, branch):
    """0.9 holds the cube's covered tiles (the compacted branch); 0.05 is
    one tile, rounded up to 8, which the cube outnumbers (full-screen)."""
    assert cp.num_tiles(H, W) == 24
    r = tbrt.Renderer(cfg(), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    base = r.render_frame(pipe, mesh, u(0.4))
    got, n = _compacted(lambda: r.render_frame(dataclasses.replace(pipe, shade_compact=budget_frac), mesh, u(0.4)))
    assert n == branch
    assert torch.equal(got.color_planar, base.color_planar) and torch.equal(got.tri_id, base.tri_id)


@pytest.mark.parametrize("budget_frac, branch", [((0.25, 0.6, 1.0), 1), (0.02, 0)])
def test_compact_msaa_matches_full(budget_frac, branch):
    """Coverage MSAA: sample layers fold into the tile-row channel axis;
    a tile covered in any layer is shaded."""
    r = tbrt.Renderer(cfg(msaa=4), device="cpu")
    pipe, mesh, u, _ = tdemos.big_mesh_demo(r, triangles=300)
    base = r.render_frame(pipe, mesh, u(0.3))
    got, n = _compacted(lambda: r.render_frame(dataclasses.replace(pipe, shade_compact=budget_frac), mesh, u(0.3)))
    assert n == branch
    assert torch.equal(got.tri_id, base.tri_id) and torch.equal(got.depth_q, base.depth_q)
    assert torch.equal(got.color_planar, base.color_planar)


def test_compact_multidraw_blend():
    """Each draw blends over the accumulated buffer through its own
    compacted pass."""
    r = tbrt.Renderer(cfg(), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    tri = r.upload_mesh(tgeom.triangle_mesh_data()["positions"])
    blend_pipe = tbrt.Pipeline(
        shader="flat_ndc",
        depth=tbrt.DepthState(test=False, write=False),
        blend=tbrt.BlendState(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha"),
    )
    tu = {"color": (0.9, 0.3, 0.1, 0.4)}

    def render(compact):
        p1, p2 = pipe, blend_pipe
        if compact:
            p1 = dataclasses.replace(p1, shade_compact=0.99)
            p2 = dataclasses.replace(p2, shade_compact=0.99)
        r.begin_frame()
        r.draw(p1, mesh, u(0.7))
        r.draw(p2, tri, tu)
        return r.end_frame()

    a = render(False)
    b, n = _compacted(lambda: render(True))
    assert n == 2 and torch.equal(b.color_planar, a.color_planar)


def test_compact_budget_ladder():
    r = tbrt.Renderer(cfg(), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    base = r.render_frame(pipe, mesh, u(0.5))
    got, n = _compacted(lambda: r.render_frame(dataclasses.replace(pipe, shade_compact=(0.1, 0.4, 0.9)), mesh, u(0.5)))
    assert n == 1 and torch.equal(got.color_planar, base.color_planar)


@pytest.mark.parametrize(
    "config", [dict(width=96, height=40, raster_backend="pallas"), dict(width=W, height=H)]
)
def test_compact_off_when_ineligible_or_auto_on_cpu(config):
    """Framebuffers that do not tile by (8, 128) shade full-screen, and so
    does "auto" on the CPU (the JAX package's _use_pallas rule)."""
    r = tbrt.Renderer(tbrt.RendererConfig(**config), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    a = r.render_frame(pipe, mesh, u(0.3))
    b, n = _compacted(lambda: r.render_frame(dataclasses.replace(pipe, shade_compact=0.5), mesh, u(0.3)))
    assert n == 0 and torch.equal(b.color_planar, a.color_planar)


def test_bad_budgets_rejected():
    for kw in (dict(shade_compact=1.5), dict(shade_compact=0.0), dict(shade_compact=(0.5, 1.5)), dict(shade_compact=())):
        with pytest.raises(ValueError, match="shade_compact"):
            tbrt.Pipeline(**kw)


def _ndc_textured(mod, monkeypatch):
    """textured_lit's fragment behind a clip-space passthrough vertex stage,
    registered in package ``mod`` for one test."""

    def vs(attrs, uniforms):
        return attrs["position"], {"uv": attrs["uv"], "normal": attrs["normal"]}

    monkeypatch.setitem(mod.shader._REGISTRY, "ndc_textured_lit",
                        mod.Shader("ndc_textured_lit", vs, mod.shader.get("textured_lit").fragment,
                                   attributes=("uv", "normal")))


def _shared_textured(monkeypatch, width, height, t, shade_compact, **config):
    """The JAX textured cube's clip space and varyings drawn by both packages
    (tests/test_torch_texture.py), with ``shade_compact`` set."""
    jr = jbrt.Renderer(jbrt.RendererConfig(width, height, raster_backend="pallas", **config))
    tr = tbrt.Renderer(tbrt.RendererConfig(width, height, raster_backend="pallas", **config), device="cpu")
    jpipe, jmesh, ju, _ = jdemos.textured_cube_demo(jr)
    u = ju(t)
    clip, var = jbrt.shader.get("textured_lit").vertex(jmesh.attributes, u)
    jt = u["texture"]
    tt = tbrt.convert.texture_from_numpy(np.asarray(jt.data), np.asarray(jt.packed), jt.meta)
    frames = []
    for r, mod, tex in ((jr, jbrt, jt), (tr, tbrt, tt)):
        _ndc_textured(mod, monkeypatch)
        pipe = mod.Pipeline(shader="ndc_textured_lit", depth=mod.DepthState(compare="less"), cull_mode="back",
                            front_face="ccw", shade_compact=shade_compact)
        mesh = r.upload_mesh(np.asarray(clip), uv=np.asarray(var["uv"]), normal=np.asarray(var["normal"]))
        frames.append(r.render_frame(pipe, mesh, {"texture": tex, "light_dir": np.asarray(u["light_dir"]),
                                                  "ambient": 0.15}))
    return frames


@pytest.mark.parametrize("msaa", [1, 4])
@pytest.mark.parametrize("shade_compact, branch", [((0.125, 0.25, 0.375, 0.5), 1), (0.02, 0)])
def test_textured_compacted_frame_matches_jax(msaa, shade_compact, branch, monkeypatch):
    """The textured cube at 256x96 (24 tiles), per covered tile (the demo's
    ladder) or over budget: equal to JAX's frame on the same branch.  The
    per-tile LOD makes the two branches differ at tile edges, so this pins
    the choice of branch as well as each branch's pixels."""
    (jf, tf), n = _compacted(lambda: _shared_textured(monkeypatch, 256, 96, 0.5, shade_compact, msaa=msaa))
    assert n == branch and (tf.tri_id >= 0).any()
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)
