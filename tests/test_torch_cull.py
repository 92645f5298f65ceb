"""Per-instance frustum culling in the port (ops/cull.py + Pipeline.instance_cull).

Mirrors tests/test_cull.py.  The contract is bit identity: the cull only
removes instances that cannot cover a pixel, and survivors keep their
original draw-order triangle ids, so tri_id and depth_q equal the unculled
frame exactly and the colour within 1e-5.  The visibility test and the
compaction are held against the JAX package's ops/cull.py on the same
inputs (exactly: the same float32 operations), and the per-triangle ids
through the record assembly against the JAX binner's, bit for bit (its
program compiled without XLA's fusion pass, as tests/test_torch_tmpl.py
does).  Frames run the Pallas backend rule in both packages, which the
cull follows.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu import math3d as jmath3d
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.ops import binning as jbin
from based_renderer_tpu.ops import cull as jcull
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.scene import Mesh as JMesh
from based_renderer_tpu_torch import math3d
from based_renderer_tpu_torch.models import geometry
from based_renderer_tpu_torch.ops import binassem as tasm
from based_renderer_tpu_torch.ops import binning as tbin
from based_renderer_tpu_torch.ops import cull
from based_renderer_tpu_torch.ops import setup as tsetup

W, H = 192, 128
UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _spread_instances(count, spread=30.0, seed=3):
    """A wide field of cubes, most of which fall outside a narrow view (numpy)."""
    rng = np.random.default_rng(seed)
    t = np.zeros((count, 4, 4), np.float32)
    t[:, 0, 0] = t[:, 1, 1] = t[:, 2, 2] = t[:, 3, 3] = 1.0
    t[:, :3, 3] = rng.uniform(-spread, spread, (count, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (count, 3)).astype(np.float32)
    return {"transform": t.reshape(count, 16), "instance_color": colors}


def _case(r, count=64, instance_cull=None, **pipe_kw):
    """The port's instanced draw of tests/test_cull.py _instanced_case."""
    mesh = r.upload_mesh(geometry.cube_mesh_data()["positions"])
    instances = {k: torch.from_numpy(v) for k, v in _spread_instances(count).items()}
    pipe = tbrt.Pipeline(shader="instanced_color", depth=tbrt.DepthState(test=True, write=True, compare="less"),
                         cull_mode="back", front_face="ccw", near_clip=False, instance_cull=instance_cull, **pipe_kw)
    aspect = r.config.width / r.config.height
    view = math3d.look_at((0.0, 0.0, -40.0), (0.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    proj = math3d.perspective(np.radians(30.0), aspect, 0.1, 200.0)
    return pipe, mesh, {"view": view, "proj": proj}, instances


def _renderer(width=W, height=H, **cfg):
    return tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, raster_backend="pallas", **cfg), device="cpu")


def _assert_same_frame(a, b, color_tol=1e-5):
    assert torch.equal(a.tri_id, b.tri_id)
    assert torch.equal(a.depth_q, b.depth_q)
    np.testing.assert_allclose(a.color_np(), b.color_np(), rtol=0, atol=color_tol)


def test_visibility_is_conservative_and_effective():
    r = _renderer()
    pipe, mesh, u, inst = _case(r)
    shd = tbrt.shader.get(pipe.shader)
    vis = cull.instance_visibility(shd, mesh, inst, u, W, H).numpy()
    # The JAX package's test on the same inputs: the same flags.
    jmesh = JMesh(attributes={"position": jnp.asarray(mesh.attributes["position"].numpy())}, indices=None)
    ju = {"view": jnp.asarray(u["view"].numpy()), "proj": jnp.asarray(u["proj"].numpy())}
    jvis = jcull.instance_visibility(jbrt.shader.get(pipe.shader), jmesh,
                                     {k: jnp.asarray(v.numpy()) for k, v in inst.items()}, ju, W, H)
    np.testing.assert_array_equal(vis, np.asarray(jvis))
    # The narrow 30-degree view over a 60-unit field culls a lot...
    assert vis.sum() < len(vis)
    # ...but never an instance that covers a pixel in the unculled frame.
    f = r.render_frame(pipe, mesh, u, instances=inst)
    tid = f.tri_id.numpy()
    covered = np.unique(tid[tid >= 0]) // mesh.num_triangles
    assert covered.size > 0
    assert vis[covered].all(), "a covering instance was culled"


@pytest.mark.parametrize("budget", [10, 2])
def test_compaction_is_order_preserving(budget):
    inst_np = _spread_instances(16)
    visible = np.array([True, False, True, True, False, False, True, False] * 2)
    out, orig_idx, of = cull.compact_instances({k: torch.from_numpy(v) for k, v in inst_np.items()},
                                               torch.from_numpy(visible), budget=budget)
    jout, jidx, jof = jcull.compact_instances({k: jnp.asarray(v) for k, v in inst_np.items()},
                                              jnp.asarray(visible), budget=budget)
    np.testing.assert_array_equal(orig_idx.numpy(), np.asarray(jidx))
    assert orig_idx.dtype == torch.int32 and bool(of) == bool(jof) == (budget < visible.sum())
    for k in inst_np:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    nvis = min(int(visible.sum()), budget)
    vis_idx = np.nonzero(visible)[0][:nvis]
    np.testing.assert_array_equal(orig_idx.numpy()[:nvis], vis_idx)  # stable order
    np.testing.assert_array_equal(out["transform"].numpy()[:nvis], inst_np["transform"][vis_idx])


def test_bbox_corners_match_jax():
    pos = np.random.default_rng(0).normal(size=(36, 3)).astype(np.float32)
    got = cull.mesh_bbox_corners(tbrt.Mesh({"position": torch.from_numpy(pos)}, None)).numpy()
    want = np.asarray(jcull.mesh_bbox_corners(JMesh({"position": jnp.asarray(pos)}, None)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("msaa", [1, 4])
def test_instance_cull_bit_identical(msaa):
    r = _renderer(msaa=msaa)
    pipe, mesh, u, inst = _case(r, instance_cull=0.6)
    base = r.render_frame(dataclasses.replace(pipe, instance_cull=None), mesh, u, instances=inst)
    culled = r.render_frame(pipe, mesh, u, instances=inst)
    assert not bool(culled.overflowed)
    _assert_same_frame(base, culled)
    assert (base.tri_id >= 0).any()


def test_instance_cull_budget_overflow_surfaces():
    r = _renderer()
    pipe, mesh, u, inst = _case(r, instance_cull=0.02)  # far below the visible count
    f = r.render_frame(pipe, mesh, u, instances=inst)
    assert bool(f.overflowed)


def _jax_case(jr, count=64, instance_cull=None):
    """The JAX package's _instanced_case (tests/test_cull.py) on the same numpy inputs."""
    mesh = jr.upload_mesh(geometry.cube_mesh_data()["positions"])
    pipe = jbrt.Pipeline(shader="instanced_color", depth=jbrt.DepthState(test=True, write=True, compare="less"),
                         cull_mode="back", front_face="ccw", near_clip=False, instance_cull=instance_cull)
    aspect = jr.config.width / jr.config.height
    view = jmath3d.look_at((0.0, 0.0, -40.0), (0.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    proj = jmath3d.perspective(np.radians(30.0), aspect, 0.1, 200.0)
    inst = {k: jnp.asarray(v) for k, v in _spread_instances(count).items()}
    return pipe, mesh, {"view": view, "proj": proj}, inst


def test_instance_cull_multidraw_ids_do_not_collide():
    """A culled instanced draw, then the cube: the cube's ids sit above the
    whole logical range of the first draw.  The culled frame also equals
    the JAX package's culled frame (each package runs its own vertex
    matmul: tri_id on >= 99.9% of pixels, colour within 1e-4 there)."""
    r = _renderer()
    pipe, mesh, u, inst = _case(r, instance_cull=0.6)
    pipe2, mesh2, u2, _ = tbrt.demos.cube_demo(r)

    def frame(cull_frac):
        r.begin_frame()
        r.draw(dataclasses.replace(pipe, instance_cull=cull_frac), mesh, u, inst)
        r.draw(pipe2, mesh2, u2(0.4))
        return r.end_frame()

    base, culled = frame(None), frame(0.6)
    _assert_same_frame(base, culled)
    assert (culled.tri_id >= 64 * 12).any()  # the cube's ids follow all 768 instance triangles

    jr = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, raster_backend="pallas"))
    jpipe, jmesh, ju, jinst = _jax_case(jr, instance_cull=0.6)
    jpipe2, jmesh2, ju2, _ = jdemos.cube_demo(jr)
    jr.begin_frame()
    jr.draw(jpipe, jmesh, ju, jinst)
    jr.draw(jpipe2, jmesh2, ju2(0.4))
    jf = jr.end_frame()
    same = culled.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(culled.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)


def _fallback_messages(r, pipe, mesh, u, inst):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f = r.render_frame(pipe, mesh, u, instances=inst)
    return f, [str(w.message) for w in caught if "instance_cull" in str(w.message)]


def test_instance_cull_xla_backend_falls_back_with_warning():
    r = tbrt.Renderer(tbrt.RendererConfig(width=64, height=64, raster_backend="xla"), device="cpu")
    pipe, mesh, u, inst = _case(r, count=8, instance_cull=0.5)
    f, msgs = _fallback_messages(r, pipe, mesh, u, inst)
    base = r.render_frame(dataclasses.replace(pipe, instance_cull=None), mesh, u, instances=inst)
    assert torch.equal(base.tri_id, f.tri_id)
    jr = jbrt.Renderer(jbrt.RendererConfig(width=64, height=64, raster_backend="xla"))
    jpipe, jmesh, ju, jinst = _jax_case(jr, count=8, instance_cull=0.5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jr.render_frame(jpipe, jmesh, ju, instances=jinst)
    assert msgs and msgs == [str(w.message) for w in caught if "instance_cull" in str(w.message)]


def test_instance_cull_near_clip_falls_back_and_debug_raises():
    r = _renderer(64, 64)
    pipe, mesh, u, inst = _case(r, count=8, instance_cull=0.5)
    clipped = dataclasses.replace(pipe, near_clip=True)
    f, msgs = _fallback_messages(r, clipped, mesh, u, inst)
    assert len(msgs) == 1 and "near_clip" in msgs[0]
    assert torch.equal(f.tri_id, r.render_frame(dataclasses.replace(clipped, instance_cull=None), mesh, u,
                                                instances=inst).tri_id)
    rd = tbrt.Renderer(dataclasses.replace(r.config, debug=True), device="cpu")
    with pytest.raises(tbrt.errors.DrawError, match="instance_cull"):
        rd.render_frame(clipped, mesh, u, instances=inst)


def _jax_bin(clip, ch, **kw):
    js = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2))(jnp.asarray(clip), W, H)
    ch_j = jnp.asarray(ch)
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=W, height=H, interpret=True, **kw))
    return fn.lower(js, channels=ch_j).compile(compiler_options=UNFUSED)(js, channels=ch_j)


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.1, 1.1, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0.05, 0.95, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32), rng.normal(size=(n, 3, 2)).astype(np.float32)


@pytest.mark.parametrize("tmpl", ["xla", "pallas"])
def test_per_triangle_ids_in_records_match_jax(tmpl):
    """B3's plain version (and, under tmpl="pallas", the field-major
    templates and the rows entry's plain version) with a (T,) id tensor
    against the JAX binner's Pallas assembly with an array id_offset: every
    record bit for bit.  The records carry the given ids; the (tile, tri)
    order is the local stream's."""
    clip, ch = _scene(150, 5)
    ids = (np.random.default_rng(1).permutation(4000)[:150] + 7).astype(np.int32)
    kw = dict(tile_w=128, tile_h=8, max_pairs=150 * 8, slots=150 * 4, assemble="pallas", tmpl=tmpl)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    tb = tbin.bin_triangles(ts, W, H, channels=torch.from_numpy(ch), id_offset=torch.from_numpy(ids), **kw)
    jb = _jax_bin(clip, ch, id_offset=jnp.asarray(ids), **kw)
    for name in ("records", "tile_start", "tile_count", "num_pairs", "overflowed"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.frecords.numpy().view(np.int32), np.asarray(jb.frecords).view(np.int32))
    live = int(tb.tile_count.sum())
    assert live > 150 and set(tb.records[13, :live].tolist()) <= set(ids.tolist())


@pytest.mark.parametrize("msaa4", [False, True])
def test_scalar_id_records_unchanged(msaa4):
    """The scalar path is unchanged: an int offset and the (T,) tensor
    arange(T) + offset give the same records bit for bit, from both
    entries' plain versions, invalid tail slots included."""
    clip, ch = _scene(120, 11)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    channels = torch.from_numpy(ch)
    ps = tbin.pair_stream(ts, W, H, 128, 8, None, 40, channels, True)
    ps_ids = tbin.pair_stream(ts, W, H, 128, 8, None, torch.arange(120, dtype=torch.int32) + 40, channels, True)
    fw = tbin.frecord_width(2)
    slots = tbin.padded_slots(ps)
    want = tasm.assemble_records(ps.tmpl, *slots, ps.total, fw, msaa4)
    got = tasm.assemble_records(ps_ids.tmpl, *slots, ps.total, fw, msaa4)
    rows = tasm.assemble_records_rows(tasm.transpose_templates(*tbin.templates_field_major(ps_ids.tmpl)), *slots,
                                      ps.total, fw, 2, msaa4)
    for rec, frec in (got, rows):
        assert torch.equal(rec, want[0])
        assert torch.equal(frec.view(torch.int32), want[1].view(torch.int32))


def test_culled_draw_under_tmpl_pallas():
    """A culled draw with raster_tmpl="pallas" (the template transpose and
    the rows entry, whose ids come from the template row) equals the
    unculled default frame."""
    r = _renderer()
    pipe, mesh, u, inst = _case(r, instance_cull=0.6, raster_assemble="pallas", raster_tile=(128, 8))
    base = r.render_frame(dataclasses.replace(pipe, instance_cull=None), mesh, u, instances=inst)
    culled = r.render_frame(dataclasses.replace(pipe, raster_tmpl="pallas"), mesh, u, instances=inst)
    assert not bool(culled.overflowed) and (culled.tri_id >= 0).any()
    _assert_same_frame(base, culled)
