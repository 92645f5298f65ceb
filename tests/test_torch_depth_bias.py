"""Depth bias and depth clamp in the port vs the JAX package.

Mirrors tests/test_depth_bias.py.  The bias is a per-triangle integer
offset on the quantized vertex depths (ops/setup.py), so every TriSetup
field of the port's ``setup_triangles(..., depth_bias=...)`` equals the JAX
setup's exactly, and biased draws equal the port's copy of the numpy
oracle (tri_id and depth_q exact).  Frames through the renderer's bias and
clamp paths equal the JAX Renderer's (tri_id and depth_q exact from
shared inputs, colour within atol 1e-4, tests/test_pallas.py:107).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import geometry
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.reference import oracle

BIASES = [(1000.0, 0.0, 0.0), (0.0, 2.5, 0.0), (-500.0, 1.25, 0.001), (4096.0, -0.75, -0.0005)]
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("depth_bias",))


def random_clip_triangles(rng, n, spread=1.2, z_range=(0.0, 1.0), w_range=(0.5, 3.0)):
    w = rng.uniform(*w_range, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-spread, spread, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(*z_range, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], axis=-1).astype(np.float32)


@pytest.mark.parametrize("seed,bias", list(enumerate(BIASES)))
def test_setup_fields_exact(seed, bias):
    clip = random_clip_triangles(np.random.default_rng(seed), 48)
    t = tsetup.setup_triangles(torch.from_numpy(clip), 96, 64, depth_bias=bias)
    j = _jax_setup(jnp.asarray(clip), 96, 64, depth_bias=bias)
    for field in t._fields:
        got = getattr(t, field).numpy()
        if field == "area2":
            want = (np.asarray(j.area2_hi).astype(np.int64) << 32) | np.asarray(j.area2_lo).astype(np.uint32)
        else:
            want = np.asarray(getattr(j, field))
        np.testing.assert_array_equal(got, want, err_msg=field)
    unbiased = tsetup.setup_triangles(torch.from_numpy(clip), 96, 64)
    assert not torch.equal(t.zq, unbiased.zq)


@pytest.mark.parametrize("seed,bias", list(enumerate(BIASES)))
def test_biased_draw_matches_oracle(seed, bias):
    clip = random_clip_triangles(np.random.default_rng(seed), 24)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 96, 64, depth_bias=bias)
    vis = traster.rasterize_vis(ts, 96, 64, tile_w=32, tile_h=32)
    ora = oracle.rasterize(clip, 96, 64, depth_bias=bias)
    np.testing.assert_array_equal(vis.tri_id.numpy(), ora["tri_id"])
    np.testing.assert_array_equal(vis.depth_q.numpy(), ora["depth_q"])


def test_bias_changes_depth_by_constant():
    """A pure constant bias shifts every covered depth by rint(constant)
    quantized LSBs (2^6 final units each) and leaves coverage alone."""
    clip = random_clip_triangles(np.random.default_rng(7), 8, z_range=(0.3, 0.7))
    v0, v1 = (
        traster.rasterize_vis(tsetup.setup_triangles(torch.from_numpy(clip), 64, 64, depth_bias=b), 64, 64,
                              depth_test=False)
        for b in (None, (17.0, 0.0, 0.0))
    )
    assert torch.equal(v0.tri_id, v1.tri_id)
    covered = v0.tri_id >= 0
    assert ((v1.depth_q[covered].long() - v0.depth_q[covered].long()) == 17 * 64).all()


def test_slope_bias_scales_with_gradient():
    """bias_slope adds rint(slope * m) LSBs: nothing on a screen-parallel
    triangle, something on a sloped one."""
    rng = np.random.default_rng(3)

    def depths(clip):
        return [
            traster.rasterize_vis(tsetup.setup_triangles(torch.from_numpy(clip), 64, 64, depth_bias=b), 64, 64,
                                  depth_test=False)
            for b in (None, (0.0, 100.0, 0.0))
        ]

    a, b = depths(random_clip_triangles(rng, 4, z_range=(0.5, 0.5), w_range=(1.0, 1.0)))
    assert torch.equal(a.depth_q, b.depth_q)
    a, b = depths(random_clip_triangles(rng, 4, z_range=(0.1, 0.9), w_range=(1.0, 1.0)))
    cov = a.tri_id >= 0
    assert (a.depth_q[cov] != b.depth_q[cov]).any()


def _decal_frame(mod, r, bias_constant):
    tri = geometry.triangle_mesh_data()
    # Mid-range depth: the depth clip runs after the bias.
    pos = np.concatenate([tri["positions"][:, :2], np.full((3, 1), 0.5, np.float32)], axis=1)
    mesh = r.upload_mesh(pos)
    decal = mod.Pipeline(shader="flat_ndc", depth=mod.DepthState(bias_enable=bias_constant != 0,
                                                                 bias_constant=bias_constant))
    r.begin_frame()
    r.draw(mod.Pipeline(shader="flat_ndc"), mesh, {"color": (1.0, 0.0, 0.0, 1.0)})
    r.draw(decal, mesh, {"color": (0.0, 1.0, 0.0, 1.0)})
    return r.end_frame()


@pytest.mark.parametrize("bias_constant", [0.0, -64.0])
def test_bias_resolves_coplanar_fighting(bias_constant):
    """The same triangle drawn twice z-fights and the second loses under
    'less'; a negative bias pulls the decal in front.  Both frames equal the
    JAX Renderer's."""
    tf = _decal_frame(tbrt, tbrt.Renderer(tbrt.RendererConfig(64, 48), device="cpu"), bias_constant)
    jf = _decal_frame(jbrt, jbrt.Renderer(jbrt.RendererConfig(64, 48, raster_backend="xla")), bias_constant)
    covered = tf.tri_id.numpy() >= 0
    assert covered.any()
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)
    winner = 1 if bias_constant else 0  # green decal, or the red base
    np.testing.assert_allclose(tf.color_np()[covered][:, winner], 1.0, atol=1e-6)


def test_depth_clamp_keeps_out_of_range_fragments():
    """Depth clamp draws fragments past the far plane at z = 1 instead of
    discarding them, as the oracle does."""
    clip = np.array([[[-0.9, -0.9, 1.3, 1.0], [0.9, -0.9, 1.3, 1.0], [0.0, 0.9, 1.3, 1.0]]], np.float32)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 48, 48)
    assert not (traster.rasterize_vis(ts, 48, 48, tile_w=16, tile_h=16).tri_id >= 0).any()
    vis = traster.rasterize_vis(ts, 48, 48, tile_w=16, tile_h=16, depth_clip="clamp", depth_test=False)
    covered = vis.tri_id >= 0
    assert covered.any() and (vis.depth_q[covered] == oracle.DEPTH_ONE_Q).all()
    ora = oracle.rasterize(clip, 48, 48, depth_clip="clamp", depth_test=False)
    np.testing.assert_array_equal(vis.tri_id.numpy(), ora["tri_id"])
    np.testing.assert_array_equal(vis.depth_q.numpy(), ora["depth_q"])


def test_pipeline_clamp_through_renderer():
    """DepthState.clamp through both renderers: clipped without it, drawn
    at the far plane with it."""
    pos = np.float32([[-0.9, -0.9, 1.4], [0.9, -0.9, 1.4], [0.0, 0.9, 1.4]])
    frames = []
    for mod, r in ((tbrt, tbrt.Renderer(tbrt.RendererConfig(48, 48), device="cpu")),
                   (jbrt, jbrt.Renderer(jbrt.RendererConfig(48, 48, raster_backend="xla")))):
        mesh = r.upload_mesh(pos)
        clipped = r.render_frame(mod.Pipeline(shader="flat_ndc"), mesh, {"color": (1, 0, 0, 1)})
        clamped = r.render_frame(
            mod.Pipeline(shader="flat_ndc", depth=mod.DepthState(clamp=True, compare="less_equal")), mesh,
            {"color": (1, 0, 0, 1)},
        )
        assert not (np.asarray(clipped.tri_id) >= 0).any() and (np.asarray(clamped.tri_id) >= 0).any()
        frames.append(clamped)
    tf, jf = frames
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)
