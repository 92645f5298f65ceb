"""MSAA frames: the port's Renderer vs the JAX package's, on the CPU.

Coverage MSAA-4x (``msaa=4``) and 2x2 supersampling (``msaa=4,
msaa_supersample=True``).  From shared clip space (the JAX vertex stage's
outputs drawn by both renderers): per-sample tri_id and depth_q exact,
resolved colour within atol 1e-4, the JAX package's colour tolerance
(tests/test_pallas.py:107).  The JAX side runs its Pallas kernels
interpreted, except the supersampled frame, which it renders on its XLA
backend as tests/test_msaa.py:182 does (bit-identical visibility).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu import shader as jshader
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch import renderer as trenderer
from based_renderer_tpu_torch import shader as tshader
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.utils import errors as terrors
from based_renderer_tpu_torch.utils import profiling

W, H = 128, 96


def _renderers(width=W, height=H, backend="pallas", **cfg):
    j = jbrt.Renderer(jbrt.RendererConfig(width=width, height=height, raster_backend=backend, **cfg))
    t = tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, raster_backend=backend, **cfg), device="cpu")
    return j, t


def _jax_cube_clip(r, t):
    """The cube's clip-space corners and colours as JAX computes them."""
    pipe, mesh, uniforms, _ = jdemos.cube_demo(r)
    clip, _ = jbrt.shader.get(pipe.shader).vertex(mesh.attributes, uniforms(t))
    return np.asarray(clip), np.asarray(mesh.attributes["color"])


def _assert_frames_equal(tf, jf, shape):
    assert tuple(tf.tri_id.shape) == shape and tuple(tf.color_planar.shape) == (4, H, W)
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)


def _cube_frames(t, backend="pallas", **cfg):
    jr, tr = _renderers(backend=backend, **cfg)
    clip, color = _jax_cube_clip(jr, t)
    pipe = jbrt.Pipeline(shader="ndc_color", depth=jbrt.DepthState(compare="less"))
    jf = jr.render_frame(pipe, jr.upload_mesh(clip, color=color))
    tpipe = tbrt.convert.pipeline_from_dict(dataclasses.asdict(pipe))
    tf = tr.render_frame(tpipe, tr.upload_mesh(clip, color=color))
    return tf, jf


@pytest.mark.parametrize("t", [0.5, 1.7])
def test_shared_clip_space_cube_msaa4(t):
    """The MSAA cube runs the MSAA raster (B4) and matches JAX per sample."""
    before = profiling.ROUTES_TAKEN["raster_msaa4"]
    tf, jf = _cube_frames(t, msaa=4)
    assert profiling.ROUTES_TAKEN["raster_msaa4"] == before  # CPU tensors: the plain version
    assert (tf.tri_id >= 0).sum() > 0 and not bool(tf.overflowed)
    _assert_frames_equal(tf, jf, (4, H, W))
    tid = tf.tri_id.numpy()
    assert (tid[0] != tid[1]).any() or (tid[0] != tid[2]).any()  # the layers differ at edges


def test_shared_clip_space_cube_supersampled():
    tf, jf = _cube_frames(0.5, backend="xla", msaa=4, msaa_supersample=True)
    assert (tf.tri_id >= 0).sum() > 0
    _assert_frames_equal(tf, jf, (2 * H, 2 * W))


def test_shared_clip_space_big_mesh_msaa4(monkeypatch):
    """big_mesh (2000 triangles) under MSAA takes the demo's dense route:
    24-row records from the kernel assembly and the MSAA sublane raster."""
    jr, tr = _renderers(msaa=4)
    jpipe, jmesh, ju, _ = jdemos.big_mesh_demo(jr, triangles=2000)
    tpipe = tdemos.big_mesh_demo(tr, triangles=2000)[0]
    assert tpipe == tbrt.convert.pipeline_from_dict(dataclasses.asdict(jpipe))
    shd = jshader.get(jpipe.shader)
    clip, var = shd.vertex(jmesh.attributes, ju(0.2))
    data = {"position": np.asarray(clip), **{k: np.asarray(v) for k, v in var.items()}}
    keys = sorted(var)

    def passthrough(attrs, uniforms):
        return attrs["position"], {k: attrs[k] for k in keys}

    routes = []
    rasterize_vis = trenderer.rasterize_vis

    def spy(*args, **kwargs):
        routes.append((kwargs.get("msaa4", False), kwargs.get("sublane", False)))
        return rasterize_vis(*args, **kwargs)

    monkeypatch.setattr(trenderer, "rasterize_vis", spy)
    frames = []
    for r, mod, sh in ((jr, jbrt, jshader), (tr, tbrt, tshader)):
        orig = sh.get(jpipe.shader)
        monkeypatch.setitem(sh._REGISTRY, jpipe.shader, mod.Shader(orig.name, passthrough, orig.fragment, orig.attributes))
        mesh = r.upload_mesh(data["position"], **{k: data[k] for k in keys})
        u = ju(0.2) if mod is jbrt else tbrt.convert.uniforms_from_numpy({k: np.asarray(v) for k, v in ju(0.2).items()})
        frames.append(r.render_frame(jpipe if mod is jbrt else tpipe, mesh, u))
    jf, tf = frames
    assert routes == [(True, True)]  # the MSAA sublane route
    assert int((tf.tri_id >= 0).sum()) > 2000 and not bool(tf.overflowed) and not bool(jf.overflowed)
    _assert_frames_equal(tf, jf, (4, H, W))


@pytest.mark.parametrize("cfg", [dict(msaa=4), dict(msaa=4, msaa_supersample=True)])
def test_real_cube_demo(cfg):
    """Each package runs its own vertex stage: tri_id equal on >= 99.9% of
    samples, colour within 1e-4 where every sample of the pixel agrees."""
    jr, tr = _renderers(backend="xla" if "msaa_supersample" in cfg else "pallas", **cfg)
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    tpipe, tmesh, tu, _ = tdemos.cube_demo(tr)
    jf = jr.render_frame(jpipe, jmesh, ju(0.9))
    tf = tr.render_frame(tpipe, tmesh, tu(0.9))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999, same.mean()
    px = same.reshape(4, H, W).all(0) if same.shape[0] == 4 else same.reshape(H, 2, W, 2).all((1, 3))
    np.testing.assert_allclose(tf.color_np()[px], jf.color_np()[px], rtol=0, atol=1e-4)


def test_msaa_antialiases_and_supersample_agrees():
    """Coverage MSAA gives intermediate edge colours and ~matches the
    supersampled frame (tests/test_msaa.py:170)."""
    r4 = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r4)
    c4 = r4.render_frame(pipe, mesh, u(0.6)).color_np()
    css = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4, msaa_supersample=True), device="cpu").render_frame(
        pipe, mesh, u(0.6)
    ).color_np()
    assert np.abs(c4 - css).mean() < 5e-3
    c1 = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu").render_frame(pipe, mesh, u(0.6)).color_np()
    assert np.sum((c4[..., 0] > 0.02) & (c4[..., 0] < c1[..., 0].max() - 0.02)) > 50


def test_supersample_flag_alone_changes_nothing():
    frames = []
    for cfg in (dict(), dict(msaa_supersample=True)):
        r = tbrt.Renderer(tbrt.RendererConfig(W, H, **cfg), device="cpu")
        pipe, mesh, u, _ = tdemos.cube_demo(r)
        frames.append(r.render_frame(pipe, mesh, u(0.3)))
    a, b = frames
    assert a.tri_id.shape == (H, W)
    assert torch.equal(a.tri_id, b.tri_id) and torch.equal(a.color_planar, b.color_planar)


def test_two_draws_and_blend_mask_msaa4():
    """Two draws share the per-sample buffer (init chain through the MSAA
    raster); a partial write mask takes the unfused per-sample composite."""
    jr, tr = _renderers(msaa=4, clear_color=(0.1, 0.2, 0.3, 1.0))
    clip, color = _jax_cube_clip(jr, 1.3)
    tri = np.array([[-0.9, 0.8, 0.3, 1.0], [0.9, 0.8, 0.3, 1.0], [0.0, -0.9, 0.7, 1.0]], np.float32)
    frames = []
    for r, mod in ((jr, jbrt), (tr, tbrt)):
        p = mod.Pipeline(shader="ndc_color")
        r.begin_frame()
        r.draw(p, r.upload_mesh(clip, color=color))
        r.draw(dataclasses.replace(p, blend=mod.BlendState(write_mask="rg")), r.upload_mesh(tri, color=np.eye(3, dtype=np.float32)))
        frames.append(r.end_frame())
    jf, tf = frames
    assert (tf.tri_id >= 24).any() and ((tf.tri_id >= 0) & (tf.tri_id < 24)).any()
    _assert_frames_equal(tf, jf, (4, H, W))


def test_msaa_sublane_fallback_runs_the_msaa_raster():
    """On the Pallas backend, an ineligible raster_sublane draw under MSAA
    warns and runs the sequential MSAA raster; an eligible one takes the
    MSAA sublane raster and renders the same samples."""
    r = tbrt.Renderer(tbrt.RendererConfig(256, 128, msaa=4, raster_backend="pallas"), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    ok = dataclasses.replace(pipe, raster_sublane=True, raster_tile=(128, 8), raster_assemble="pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fo = r.render_frame(ok, mesh, u(0.4))
    seq = r.render_frame(dataclasses.replace(ok, raster_sublane=False), mesh, u(0.4))
    assert fo.tri_id.shape == (4, 128, 256)
    assert torch.equal(fo.tri_id, seq.tri_id) and torch.equal(fo.depth_q, seq.depth_q)
    bad = dataclasses.replace(ok, depth=tbrt.DepthState(compare="not_equal"))
    with pytest.warns(RuntimeWarning, match="ineligible"):
        fb = r.render_frame(bad, mesh, u(0.4))
    assert torch.equal(fb.tri_id, r.render_frame(dataclasses.replace(bad, raster_sublane=False), mesh, u(0.4)).tri_id)
    with pytest.raises(terrors.DrawError, match="ineligible"):
        tbrt.Renderer(tbrt.RendererConfig(256, 128, msaa=4, debug=True, raster_backend="pallas"),
                      device="cpu").render_frame(bad, mesh, u(0.4))


def test_cleared_frame_shapes():
    for cfg, shape in ((dict(msaa=4), (4, H, W)), (dict(msaa=4, msaa_supersample=True), (2 * H, 2 * W))):
        r = tbrt.Renderer(tbrt.RendererConfig(W, H, clear_color=(0.2, 0.4, 0.6, 1.0), **cfg), device="cpu")
        f = r.begin_frame().end_frame()
        assert tuple(f.tri_id.shape) == shape and tuple(f.depth_q.shape) == shape
        assert (f.tri_id == -1).all() and f.color_np().shape == (H, W, 4)
        np.testing.assert_allclose(f.color_np()[0, 0], [0.2, 0.4, 0.6, 1.0], rtol=0, atol=1e-7)


def test_cpu_frame_launches_no_kernel():
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4), device="cpu")
    pipe, mesh, u, _ = tdemos.big_mesh_demo(r, triangles=2000)
    routes = ("raster_msaa4", "raster_msaa4_sublane", "assemble_records")
    before = [profiling.ROUTES_TAKEN[k] for k in routes]
    f = r.render_frame(pipe, mesh, u(0.2))
    assert [profiling.ROUTES_TAKEN[k] for k in routes] == before
    assert f.tri_id.shape == (4, H, W) and np.isfinite(f.color_np()).all() and (f.tri_id >= 0).any()
