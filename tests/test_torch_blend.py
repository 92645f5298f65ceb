"""Blending in the port vs the JAX package: every BlendState family.

Mirrors tests/test_blend_state.py and tests/test_renderer.py:153.  The
port's ``renderer._blend`` is held against the JAX package's on the same
numpy colours, in planar (4, H, W) layout and per sample (4, 4, H, W), the
JAX function vmapped over samples as its renderer does; then whole frames
of the port's Renderer against the JAX package's blend of the same source
and destination, and against the JAX Renderer (multi-draw and coverage
MSAA-4x frames, where each sample blends on its own).  Colour agrees
within atol 1e-4, the JAX package's colour tolerance
(tests/test_pallas.py:107); tri_id is exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.models import geometry
from based_renderer_tpu.renderer import _blend as jblend
from based_renderer_tpu_torch.renderer import _blend as tblend

CLEAR = (0.25, 0.5, 0.75, 0.4)
SRC = (0.9, 0.3, 0.1, 0.6)
ATOL = 1e-4

STATES = [
    dict(enable=True, src_factor="zero", dst_factor="zero"),
    dict(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha", src_alpha_factor="one",
         dst_alpha_factor="one_minus_src_alpha"),
    dict(enable=True, src_factor="dst_color", dst_factor="src_color"),
    dict(enable=True, src_factor="one_minus_dst_color", dst_factor="one_minus_src_color"),
    dict(enable=True, src_factor="one", dst_factor="one", color_op="subtract"),
    dict(enable=True, src_factor="one", dst_factor="one", color_op="reverse_subtract"),
    dict(enable=True, color_op="min"),
    dict(enable=True, color_op="max", alpha_op="min"),
    dict(enable=True, src_factor="constant_color", dst_factor="one_minus_constant_alpha",
         constants=(0.2, 0.4, 0.6, 0.3)),
    dict(enable=True, src_factor="constant_alpha", dst_factor="one_minus_constant_color",
         constants=(0.7, 0.1, 0.5, 0.5)),
    dict(enable=True, src_factor="src_alpha_saturate", dst_factor="one"),
    dict(enable=True, src_factor="dst_alpha", dst_factor="one_minus_dst_alpha", src_alpha_factor="zero",
         dst_alpha_factor="src_alpha"),
    dict(enable=True, src_factor="one", dst_factor="one", color_op="add", alpha_op="reverse_subtract"),
    dict(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha", write_mask="rg"),
    dict(enable=False, write_mask="b"),
    dict(enable=False, write_mask=""),
]


@pytest.mark.parametrize("state", STATES, ids=range(len(STATES)))
def test_blend_matches_jax_blend(state):
    """Planar and per-sample layouts, random colours (alpha in [0, 1])."""
    rng = np.random.default_rng(len(str(state)))
    src = rng.random((4, 4, 6, 5), dtype=np.float32)
    dst = rng.random((4, 4, 6, 5), dtype=np.float32)
    t_state, j_state = tbrt.BlendState(**state), jbrt.BlendState(**state)
    t = tblend(torch.from_numpy(src[0]), torch.from_numpy(dst[0]), t_state).numpy()
    np.testing.assert_allclose(t, np.asarray(jblend(jnp.asarray(src[0]), jnp.asarray(dst[0]), j_state)), rtol=0, atol=1e-6)
    t4 = tblend(torch.from_numpy(src), torch.from_numpy(dst), t_state).numpy()
    j4 = jax.vmap(lambda s, d: jblend(s, d, j_state))(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(t4, np.asarray(j4), rtol=0, atol=1e-6)


def _flat_draw(mod, r, state, color=SRC):
    """A flat triangle covering part of the frame, depth off, in ``mod``'s package."""
    tri = geometry.triangle_mesh_data()
    mesh = r.upload_mesh(tri["positions"] * np.float32([[2.0, 2.0, 0.0]]))
    depth = mod.DepthState(test=False, write=False)
    return mod.Pipeline(shader="flat_ndc", blend=state, depth=depth), mesh, {"color": color}


@pytest.mark.parametrize("state", STATES, ids=range(len(STATES)))
def test_renderer_blend_matches_jax_blend(state):
    """A flat triangle blended over the clear colour: covered pixels hold
    the JAX package's _blend(SRC, CLEAR), the rest keep the clear."""
    r = tbrt.Renderer(tbrt.RendererConfig(64, 48), device="cpu")
    pipe, mesh, u = _flat_draw(tbrt, r, tbrt.BlendState(**state))
    f = r.render_frame(pipe, mesh, u, clear_color=CLEAR)
    img, covered = f.color_np(), f.tri_id.numpy() >= 0
    want = np.asarray(jblend(jnp.float32(SRC).reshape(4, 1, 1), jnp.float32(CLEAR).reshape(4, 1, 1),
                             jbrt.BlendState(**state)))[:, 0, 0]
    assert covered.any() and not covered.all()
    np.testing.assert_allclose(img[covered], np.broadcast_to(want, img[covered].shape), rtol=0, atol=ATOL)
    np.testing.assert_allclose(img[~covered], np.broadcast_to(np.float32(CLEAR), img[~covered].shape), rtol=0, atol=0)


def _two_draws(mod, r, second):
    first, mesh, u = _flat_draw(mod, r, mod.BlendState())
    r.begin_frame(clear_color=CLEAR)
    r.draw(first, mesh, u)
    r.draw(dataclasses.replace(first, blend=second), mesh, {"color": (0.05, 0.06, 0.07, 0.08)})
    return r.end_frame()


def test_partial_write_mask_two_draws():
    """The second draw writes only G+A over the first draw's output."""
    state = dict(enable=True, src_factor="one", dst_factor="one", write_mask="ga")
    tf = _two_draws(tbrt, tbrt.Renderer(tbrt.RendererConfig(64, 48), device="cpu"), tbrt.BlendState(**state))
    jf = _two_draws(jbrt, jbrt.Renderer(jbrt.RendererConfig(64, 48, raster_backend="xla")), jbrt.BlendState(**state))
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=ATOL)
    covered = tf.tri_id.numpy() >= 0
    np.testing.assert_allclose(tf.color_np()[covered][:, 0], SRC[0], rtol=0, atol=ATOL)  # R untouched
    np.testing.assert_allclose(tf.color_np()[covered][:, 1], SRC[1] + 0.06, rtol=0, atol=ATOL)


def test_alpha_blend():
    """tests/test_renderer.py:153: src_alpha over opaque blue."""
    r = tbrt.Renderer(tbrt.RendererConfig(64, 48), device="cpu")
    state = tbrt.BlendState(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha")
    pipe, mesh, _ = _flat_draw(tbrt, r, state)
    f = r.render_frame(pipe, mesh, {"color": (1.0, 0.0, 0.0, 0.5)}, clear_color=(0, 0, 1, 1))
    m = f.tri_id.numpy() >= 0
    np.testing.assert_allclose(f.color_np()[m][:, 0], 0.5, atol=1e-5)
    np.testing.assert_allclose(f.color_np()[m][:, 2], 0.5, atol=1e-5)


def test_bad_blend_state_raises():
    for kw in (dict(src_factor="nope"), dict(color_op="xor"), dict(write_mask="rgz"), dict(write_mask="rr"),
               dict(constants=(1.0, 0.0))):
        for mod in (tbrt, jbrt):
            with pytest.raises(ValueError):
                mod.BlendState(**kw)


def test_msaa_blends_per_sample():
    """Coverage MSAA-4x: a translucent triangle over the cube blends each
    sample against that sample's colour, then the samples resolve.  The
    frame equals the JAX renderer's (tri_id per sample exact, colour within
    1e-4), edge pixels included, where the samples of a pixel differ."""
    W, H = 128, 96
    jr = jbrt.Renderer(jbrt.RendererConfig(W, H, msaa=4, raster_backend="xla"))
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    clip, _ = jbrt.shader.get(jpipe.shader).vertex(jmesh.attributes, ju(0.8))  # shared clip space
    frames = []
    for mod, r in ((jbrt, jr), (tbrt, tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4), device="cpu"))):
        cube = r.upload_mesh(np.asarray(clip), color=np.asarray(jmesh.attributes["color"]))
        tri = np.array([[-0.9, 0.8, 0.3, 1.0], [0.9, 0.7, 0.3, 1.0], [0.1, -0.9, 0.6, 1.0]], np.float32)
        glass = mod.Pipeline(
            shader="ndc_color", depth=mod.DepthState(write=False),
            blend=mod.BlendState(enable=True, src_factor="constant_alpha", dst_factor="one_minus_constant_alpha",
                                 constants=(0.0, 0.0, 0.0, 0.35), write_mask="rgb"),
        )
        r.begin_frame(clear_color=(0.1, 0.2, 0.3, 1.0))
        r.draw(mod.Pipeline(shader="ndc_color"), cube)
        r.draw(glass, r.upload_mesh(tri, color=np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1]])))
        frames.append(r.end_frame())
    jf, tf = frames
    tid = tf.tri_id.numpy()
    np.testing.assert_array_equal(tid, np.asarray(jf.tri_id))
    edges = (tid != tid[:1]).any(0)
    assert edges.sum() > 20 and (tid >= 24).any()
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tf.color_np()[edges], jf.color_np()[edges], rtol=0, atol=ATOL)
