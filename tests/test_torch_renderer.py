"""The port's Renderer vs the JAX package's (Pallas backend, interpreted).

(a) From shared clip space: tri_id and depth_q exact, colour atol 1e-4.
(b) The real demos, each package doing its own vertex matmul: tri_id
    equal on >= 99.9% of pixels, colour atol 1e-4 where tri_id agrees.
"""

import dataclasses

import numpy as np
import pytest

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch.models import demos as tdemos

W, H = 128, 96


def _renderers(width=W, height=H, **cfg):
    j = jbrt.Renderer(jbrt.RendererConfig(width=width, height=height, raster_backend="pallas", **cfg))
    t = tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, **cfg), device="cpu")
    return j, t


def _jax_cube_clip(r, t):
    """The cube's clip-space corners as JAX computes them: (36, 4)."""
    pipe, mesh, uniforms, _ = jdemos.cube_demo(r)
    u = uniforms(t)
    clip, _ = jbrt.shader.get(pipe.shader).vertex(mesh.attributes, u)
    return np.asarray(clip), np.asarray(mesh.attributes["color"])


def _assert_frames_equal(tf, jf):
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("extent", [(W, H), (100, 70)])
def test_shared_clip_space_cube(extent):
    jr, tr = _renderers(*extent)
    clip, color = _jax_cube_clip(jr, 0.5)
    pipe = jbrt.Pipeline(shader="ndc_color", depth=jbrt.DepthState(compare="less"))
    jf = jr.render_frame(pipe, jr.upload_mesh(clip, color=color))
    tpipe = tbrt.convert.pipeline_from_dict(dataclasses.asdict(pipe))
    tf = tr.render_frame(tpipe, tr.upload_mesh(clip, color=color))
    assert (tf.tri_id >= 0).sum() > 0 and not bool(tf.overflowed)
    _assert_frames_equal(tf, jf)


def test_shared_clip_space_two_draws():
    """A second draw continues the first's visibility (init chain), and
    each draw shades against its own snapshot."""
    jr, tr = _renderers(clear_color=(0.1, 0.2, 0.3, 1.0))
    clip, color = _jax_cube_clip(jr, 1.3)
    tri = np.array([[-0.9, 0.8, 0.3, 1.0], [0.9, 0.8, 0.3, 1.0], [0.0, -0.9, 0.7, 1.0]], np.float32)
    tri_col = np.eye(3, dtype=np.float32)
    frames = []
    for r, mod in ((jr, jbrt), (tr, tbrt)):
        p = mod.Pipeline(shader="ndc_color")
        r.begin_frame()
        r.draw(p, r.upload_mesh(clip, color=color))
        r.draw(p, r.upload_mesh(tri, color=tri_col))
        frames.append(r.end_frame())
    jf, tf = frames
    # The clipper gives the cube's 12 triangles 24 ids; the next draw's follow.
    assert (tf.tri_id >= 24).any() and ((tf.tri_id >= 0) & (tf.tri_id < 24)).any()
    _assert_frames_equal(tf, jf)


@pytest.mark.parametrize("demo", ["cube", "triangle"])
def test_real_demos(demo):
    jr, tr = _renderers()
    jpipe, jmesh, ju, _ = getattr(jdemos, f"{demo}_demo")(jr)
    tpipe, tmesh, tu, _ = getattr(tdemos, f"{demo}_demo")(tr)
    assert tpipe == tbrt.convert.pipeline_from_dict(dataclasses.asdict(jpipe))
    jf = jr.render_frame(jpipe, jmesh, ju(0.5))
    tf = tr.render_frame(tpipe, tmesh, tu(0.5))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)
    assert (tf.tri_id >= 0).any()
    if demo == "triangle":  # analytic coverage: half of a (W/2 x H/2) box
        assert int((tf.tri_id >= 0).sum()) == (W // 2) * (H // 2) // 2


def test_frame_result_views():
    _, tr = _renderers(framebuffer_srgb=True)
    pipe, mesh, u, _ = tdemos.cube_demo(tr)
    f = tr.render_frame(pipe, mesh, u(0.2))
    assert f.color_np().shape == (H, W, 4)
    assert f.color_u8().dtype == np.uint8 and f.color_u8().shape == (H, W, 4)
    d = f.depth_np()
    assert d.shape == (H, W) and d.max() <= 1.0
    assert np.isfinite(f.color_np()).all()
