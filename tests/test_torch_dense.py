"""The dense-mesh path: big_mesh and instanced demos, port vs JAX (Pallas, interpreted).

(a) From shared clip space (the JAX vertex stage's outputs fed to both
    renderers through the demo's own pipeline): tri_id and depth_q exact,
    colour atol 1e-4.
(b) Each package doing its own vertex stage: tri_id equal on >= 99.9% of
    pixels, colour atol 1e-4 where tri_id agrees; overflowed equal.
Plus the budget overflow, the sublane fallback signals and the debug-mode
draw validation, in both packages.
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
from based_renderer_tpu.ops import vertex as jvertex
from based_renderer_tpu.scene import Mesh as JMesh
from based_renderer_tpu.utils import errors as jerrors
from based_renderer_tpu_torch import renderer as trenderer
from based_renderer_tpu_torch import shader as tshader
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.scene import Mesh as TMesh
from based_renderer_tpu_torch.utils import errors as terrors

W, H = 128, 96
DEMO_KW = {"big_mesh": dict(triangles=2000), "instanced": dict(count=32)}


def _renderers(**cfg):
    j = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, raster_backend="pallas", **cfg))
    t = tbrt.Renderer(tbrt.RendererConfig(width=W, height=H, raster_backend="pallas", **cfg), device="cpu")
    return j, t


def _sublane_flags(monkeypatch):
    """The ``sublane`` argument of every rasterize_vis call the port's
    renderer makes from now on (the route each draw takes)."""
    flags = []
    orig = trenderer.rasterize_vis

    def spy(*args, **kwargs):
        flags.append(kwargs.get("sublane", False))
        return orig(*args, **kwargs)

    monkeypatch.setattr(trenderer, "rasterize_vis", spy)
    return flags


def _demos(name, jr, tr):
    j = getattr(jdemos, f"{name}_demo")(jr, **DEMO_KW[name])
    t = getattr(tdemos, f"{name}_demo")(tr, **DEMO_KW[name])
    return j, t


def _port_instances(inst):
    return None if inst is None else tbrt.convert.instances_from_numpy({k: np.asarray(v) for k, v in inst.items()})


@pytest.mark.parametrize("name", ["big_mesh", "instanced"])
def test_pipelines_match_jax(name):
    jr, tr = _renderers()
    (jpipe, _, _, jinst), (tpipe, _, _, tinst) = _demos(name, jr, tr)
    assert tpipe == tbrt.convert.pipeline_from_dict(dataclasses.asdict(jpipe))
    assert tpipe.raster_sublane and tpipe.raster_assemble == "pallas"
    assert (jinst is None) == (tinst is None)
    for k in jinst or {}:
        np.testing.assert_array_equal(tinst[k].numpy(), np.asarray(jinst[k]))


@pytest.mark.parametrize("name", ["big_mesh", "instanced"])
def test_shared_clip_space(name, monkeypatch):
    """Both renderers draw the JAX vertex stage's clip positions and
    varyings through the demo pipeline (sublane raster, kernel assembly)."""
    jr, tr = _renderers()
    (jpipe, jmesh, ju, jinst), (tpipe, _, _, _) = _demos(name, jr, tr)
    flags = _sublane_flags(monkeypatch)
    shd = jshader.get(jpipe.shader)
    attrs, _ = jvertex.expand_instances(jmesh, jinst)
    clip, var = shd.vertex(attrs, ju(0.2))
    data = {"position": np.asarray(clip), **{k: np.asarray(v) for k, v in var.items()}}
    keys = sorted(var)

    def passthrough(attrs, uniforms):
        return attrs["position"], {k: attrs[k] for k in keys}

    frames = []
    for r, mod, sh in ((jr, jbrt, jshader), (tr, tbrt, tshader)):
        orig = sh.get(jpipe.shader)
        monkeypatch.setitem(sh._REGISTRY, jpipe.shader, mod.Shader(orig.name, passthrough, orig.fragment, orig.attributes))
        mesh = r.upload_mesh(data["position"], **{k: data[k] for k in keys})
        pipe = jpipe if mod is jbrt else tpipe
        frames.append(r.render_frame(pipe, mesh, ju(0.2) if mod is jbrt else _uniforms_np(ju(0.2))))
    jf, tf = frames
    assert flags == [True]
    assert int((tf.tri_id >= 0).sum()) > 500 and not bool(tf.overflowed) and not bool(jf.overflowed)
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)


def _uniforms_np(u):
    return tbrt.convert.uniforms_from_numpy({k: np.asarray(v) for k, v in u.items()})


@pytest.mark.parametrize("name", ["big_mesh", "instanced"])
def test_real_demos(name, monkeypatch):
    jr, tr = _renderers()
    (jpipe, jmesh, ju, jinst), (tpipe, tmesh, tu, tinst) = _demos(name, jr, tr)
    flags = _sublane_flags(monkeypatch)
    for t in (0.2, 1.1):
        jf = jr.render_frame(jpipe, jmesh, ju(t), instances=jinst)
        tf = tr.render_frame(tpipe, tmesh, tu(t), instances=tinst)
        same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
        assert same.mean() >= 0.999, same.mean()
        assert (tf.tri_id >= 0).sum() > 500
        np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)
        assert bool(tf.overflowed) == bool(jf.overflowed) is False
    assert flags == [True, True]


def test_tight_budget_overflows_in_both():
    jr, tr = _renderers()
    (jpipe, jmesh, ju, _), (tpipe, tmesh, tu, _) = _demos("big_mesh", jr, tr)
    jf = jr.render_frame(dataclasses.replace(jpipe, raster_pairs_factor=1.0), jmesh, ju(0.2))
    tf = tr.render_frame(dataclasses.replace(tpipe, raster_pairs_factor=1.0), tmesh, tu(0.2))
    assert bool(jf.overflowed) and bool(tf.overflowed)
    jd, td = _renderers(debug=True)
    (jpipe, jmesh, ju, _), (tpipe, tmesh, tu, _) = _demos("big_mesh", jd, td)
    with pytest.raises(jerrors.AllocationError):
        jd.render_frame(dataclasses.replace(jpipe, raster_pairs_factor=1.0), jmesh, ju(0.2))
    with pytest.raises(terrors.AllocationError):
        td.render_frame(dataclasses.replace(tpipe, raster_pairs_factor=1.0), tmesh, tu(0.2))


def test_sublane_fallback_signals():
    """On the Pallas backend, an ineligible raster_sublane draw warns and
    runs on the sequential raster (raises DrawError in debug mode); an
    eligible one stays quiet."""
    r = tbrt.Renderer(tbrt.RendererConfig(256, 128, raster_backend="pallas"), device="cpu")
    pipe, mesh, u, _ = tdemos.cube_demo(r)
    bad = dataclasses.replace(pipe, raster_sublane=True, depth=tbrt.DepthState(test=False, write=False))
    with pytest.warns(RuntimeWarning, match="raster_sublane"):
        fb = r.render_frame(bad, mesh, u(0.0))
    plain = r.render_frame(dataclasses.replace(bad, raster_sublane=False), mesh, u(0.0))
    assert torch.equal(fb.tri_id, plain.tri_id) and torch.equal(fb.color_planar, plain.color_planar)
    ok = dataclasses.replace(pipe, raster_sublane=True, raster_tile=(128, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fo = r.render_frame(ok, mesh, u(0.0))
    seq = r.render_frame(dataclasses.replace(ok, raster_sublane=False), mesh, u(0.0))
    assert torch.equal(fo.tri_id, seq.tri_id) and torch.equal(fo.depth_q, seq.depth_q)
    for why in (dict(raster_tile=(64, 8)), dict(depth=tbrt.DepthState(compare="not_equal"))):
        with pytest.warns(RuntimeWarning, match="ineligible"):
            r.render_frame(dataclasses.replace(ok, **why), mesh, u(0.0))
    rd = tbrt.Renderer(tbrt.RendererConfig(256, 128, debug=True, raster_backend="pallas"), device="cpu")
    with pytest.raises(terrors.DrawError, match="ineligible"):
        rd.render_frame(bad, mesh, u(0.0))


@pytest.mark.parametrize("knob", [dict(raster_sublane=True), dict(raster_batch=8)])
def test_xla_backend_takes_no_variant_silently(knob):
    """Off the Pallas backend neither package checks a kernel variant's
    eligibility (the JAX renderer's _use_pallas gate): a debug-mode
    raster_backend="xla" frame with an ineligible draw renders with no
    warning and no DrawError, and the two frames agree (each package runs
    its own vertex matmul: tri_id on >= 99.9% of pixels, colour within 1e-4
    where tri_id agrees)."""
    frames = []
    for mod, demos in ((jbrt, jdemos), (tbrt, tdemos)):
        cfg = mod.RendererConfig(128, 64, debug=True, raster_backend="xla")
        r = mod.Renderer(cfg, **({"device": "cpu"} if mod is tbrt else {}))
        pipe, mesh, u, _ = demos.cube_demo(r)
        bad = dataclasses.replace(pipe, depth=mod.DepthState(test=False, write=False), **knob)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            frames.append(r.render_frame(bad, mesh, u(0.3)))
    jf, tf = frames
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999 and (tf.tri_id >= 0).any()
    np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)


def _malformed(mod, mesh_cls):
    pos = np.random.default_rng(0).uniform(-1, 1, (6, 3)).astype(np.float32)
    col = np.ones((6, 3), np.float32)
    arr = (lambda x: torch.from_numpy(np.asarray(x))) if mod is tbrt else (lambda x: np.asarray(x))
    return [
        (mesh_cls({"position": arr(pos), "color": arr(col[:5])}, None), None),
        (mesh_cls({"position": arr(pos), "color": arr(col[:, :, None])}, None), None),
        (mesh_cls({"position": arr(np.ones((6, 5), np.float32)), "color": arr(col)}, None), None),
        (mesh_cls({"position": arr(pos), "color": arr(col)}, arr(np.array([[0, 1, 6]], np.int32))), None),
        (
            mesh_cls({"position": arr(pos), "color": arr(col)}, None),
            {"transform": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), "instance_color": np.ones((3, 3), np.float32)},
        ),
    ]


@pytest.mark.parametrize("case", range(5))
def test_debug_validation_matches_jax(case):
    """The same malformed draws raise DrawError at draw time in debug mode in
    both packages, and are recorded without a check otherwise."""
    for mod, mesh_cls, errs in ((jbrt, JMesh, jerrors), (tbrt, TMesh, terrors)):
        kw = {} if mod is tbrt else {"raster_backend": "pallas"}
        mesh, inst = _malformed(mod, mesh_cls)[case]
        pipe = mod.Pipeline(shader="vertex_color")
        r = mod.Renderer(mod.RendererConfig(64, 32, debug=True, **kw), **({"device": "cpu"} if mod is tbrt else {}))
        r.begin_frame()
        with pytest.raises(errs.DrawError):
            r.draw(pipe, mesh, {}, instances=inst)
        quiet = mod.Renderer(mod.RendererConfig(64, 32, **kw), **({"device": "cpu"} if mod is tbrt else {}))
        quiet.begin_frame()
        quiet.draw(pipe, mesh, {}, instances=inst)


def test_instance_attribute_satisfies_shader():
    """instanced_color needs 'color'; an 'instance_color' table provides it,
    and a draw with neither raises DrawError in both packages."""
    for mod, mesh_cls, errs in ((jbrt, JMesh, jerrors), (tbrt, TMesh, terrors)):
        r = mod.Renderer(mod.RendererConfig(64, 32), **({"device": "cpu"} if mod is tbrt else {}))
        pos = np.zeros((3, 3), np.float32)
        mesh = r.upload_mesh(pos)
        pipe = mod.Pipeline(shader="instanced_color")
        r.begin_frame()
        r.draw(pipe, mesh, {}, instances={"transform": np.eye(4, dtype=np.float32)[None], "instance_color": np.ones((1, 3), np.float32)})
        with pytest.raises(errs.DrawError, match="color"):
            r.draw(pipe, mesh, {}, instances={"transform": np.eye(4, dtype=np.float32)[None]})
