"""end_frame through the port's per-key frame program.

A frame runs through one cached program per key, as the JAX package jits
one per key (its renderer.py:338-404).  On the CPU the program is the
eager frame over buffers the program owns, so here:
  * ``num_cached_programs`` equals the JAX package's after each step of
    tests/test_renderer.py:33-46 and tests/test_present.py:210-220;
  * every frame through the program equals ``_run_frame`` (the eager
    frame on the caller's inputs) bit for bit, and the JAX package's
    "pallas" frame at the tolerance of test_torch_renderer.py's real
    demos (each package runs its own vertex matmul): tri_id (and stencil)
    on >= 99.9% of pixels, colour within 1e-4 where tri_id agrees;
  * the program renders the caller's current inputs: a new mesh of the
    same shapes (a cache hit), an attribute edited in place, a numpy
    uniform mutated in place, a new clear colour (no new program);
  * a texture's sampler state is part of the key, and a result outlives
    later frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.models import geometry
from based_renderer_tpu_torch.utils import profiling

W, H = 128, 96
INSTANCES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small frames are many small tensor ops, which intra-op threads only
    slow (and oversubscribe the cores under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(width=W, height=H, **cfg):
    return tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, **cfg), device="cpu")


def _draw_all(r, draws, t, **clear):
    r.begin_frame(**clear)
    for pipe, mesh, uniforms, inst in draws:
        r.draw(pipe, mesh, uniforms(t), instances=inst)


def _frame(r, draws, t, **clear):
    """The frame through the renderer's program."""
    _draw_all(r, draws, t, **clear)
    return r.end_frame()


def _eager(r, draws, t, **clear):
    """The same frame, eagerly on the caller's inputs: the result tuple."""
    _draw_all(r, draws, t, **clear)
    return r._run_frame(*r.close_frame())


def _assert_bitwise(f, eager):
    color, depth_q, tri_id, stencil, overflowed, pair_budget_use = eager
    assert torch.equal(f.color_planar, color)
    assert torch.equal(f.depth_q, depth_q) and torch.equal(f.tri_id, tri_id)
    assert (f.stencil is None) == (stencil is None)
    if stencil is not None:
        assert torch.equal(f.stencil, stencil)
    assert bool(f.overflowed) == bool(overflowed) and not bool(overflowed)
    assert torch.equal(f.pair_budget_use, pair_budget_use) and 0 <= float(pair_budget_use) <= 1


# ---- program counts against the JAX package ------------------------------


def test_program_count_matches_jax_frames_and_pipelines():
    """tests/test_renderer.py:33-46 through both packages: two cube frames,
    then a second pipeline state."""
    counts = {}
    for name, mod, demos, r in (
        ("jax", jbrt, jdemos, jbrt.Renderer(jbrt.RendererConfig(width=96, height=64))),
        ("port", tbrt, tdemos, _port(96, 64)),
    ):
        pipe, mesh, uniforms, _ = demos.cube_demo(r)
        steps = []
        r.render_frame(pipe, mesh, uniforms(0.0))
        steps.append(r.num_cached_programs)
        r.render_frame(pipe, mesh, uniforms(0.7))
        steps.append(r.num_cached_programs)
        pipe2 = mod.Pipeline(shader=pipe.shader, depth=mod.DepthState(test=False, write=False))
        r.render_frame(pipe2, mesh, uniforms(0.0))
        steps.append(r.num_cached_programs)
        counts[name] = steps
    assert counts["port"] == counts["jax"] == [1, 1, 2]


def test_program_count_matches_jax_across_resize():
    """tests/test_present.py:210-220 through both packages: a resize makes
    a program, and a resize back to the earlier extent is a cache hit."""
    counts = {}
    for name, demos, r in (
        ("jax", jdemos, jbrt.Renderer(jbrt.RendererConfig(width=64, height=48))),
        ("port", tdemos, _port(64, 48)),
    ):
        pipe, mesh, uniforms, _ = demos.cube_demo(r)
        steps = []
        for extent in ((64, 48), (32, 24), (64, 48)):
            r.resize(*extent)
            f = r.render_frame(pipe, mesh, uniforms(0.1))
            assert f.color_np().shape == (extent[1], extent[0], 4)
            steps.append(r.num_cached_programs)
        counts[name] = steps
    assert counts["port"] == counts["jax"] == [1, 2, 2]


# ---- frames through the program against eager and JAX ---------------------


def _render_state(mod, demos, r):
    """chip_smoke.py's render-state frame at INSTANCES cubes: the cube
    stamps stencil 1; the instances draw two-pass where the stencil is
    not 1; the cube again, depth write off, winning over its own copy only
    through its depth bias, blended at constant alpha 0.5."""
    cube_pipe, cube_mesh, cube_u, _ = demos.cube_demo(r)
    inst_pipe, inst_mesh, inst_u, inst = demos.instanced_demo(r, count=INSTANCES)
    stamp = mod.StencilState(enable=True, compare="always", ref=1, pass_op="replace")
    field = dataclasses.replace(inst_pipe, raster_sublane=False, raster_two_pass=True,
                                stencil=mod.StencilState(enable=True, compare="not_equal", ref=1))
    decal = dataclasses.replace(
        cube_pipe,
        depth=mod.DepthState(compare="less", write=False, bias_enable=True, bias_constant=-64.0),
        blend=mod.BlendState(enable=True, src_factor="constant_alpha", dst_factor="one_minus_constant_alpha",
                             constants=(0.0, 0.0, 0.0, 0.5)),
    )
    return [
        (dataclasses.replace(cube_pipe, stencil=stamp), cube_mesh, cube_u, None),
        (field, inst_mesh, inst_u, inst),
        (decal, cube_mesh, cube_u, None),
    ]


def _scene(case, mod, demos, r):
    """[(pipeline, mesh, uniforms_fn, instances)] of a case, in either package."""
    if case == "render_state":
        return _render_state(mod, demos, r)
    if case == "culled_instanced":
        # The orbit keeps nearly every cube in view: a budget of all of
        # them, whose survivors still come first (permuted original ids).
        pipe, mesh, u, inst = demos.instanced_demo(r, count=INSTANCES)
        return [(dataclasses.replace(pipe, instance_cull=1.0), mesh, u, inst)]
    if case == "compacted_cube":
        pipe, mesh, u, inst = demos.cube_demo(r)
        return [(dataclasses.replace(pipe, shade_compact=(0.25, 0.5)), mesh, u, inst)]
    return [getattr(demos, f"{case}_demo")(r)]


def _assert_matches_jax(f, jf, lod=False):
    """tri_id (and stencil) on >= 99.9% of pixels, colour within 1e-4 where
    tri_id agrees (with ``lod``, where the right and lower neighbours'
    agree too: a pixel's LOD reads their uv)."""
    same = f.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999 and (f.tri_id >= 0).any()
    if lod:
        same = same.copy()
        same[:, :-1] &= same[:, 1:]
        same[:-1] &= same[1:]
    np.testing.assert_allclose(f.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)
    assert (f.stencil is None) == (jf.stencil is None)
    if f.stencil is not None:
        assert (f.stencil.numpy() == np.asarray(jf.stencil)).mean() >= 0.999


@pytest.mark.parametrize("case", ["cube", "textured_cube", "culled_instanced", "compacted_cube", "render_state"])
def test_program_frames_match_eager_and_jax(case):
    from based_renderer_tpu_torch import renderer as renderer_mod

    r = _port(raster_backend="pallas")
    draws = _scene(case, tbrt, tdemos, r)
    compacted = profiling.ROUTES_TAKEN["compacted_draws"]
    for t in (0.3, 0.9):  # the key's first call, then the cached program
        f = _frame(r, draws, t)
        _assert_bitwise(f, _eager(r, draws, t))
    assert r.num_cached_programs == 1
    if case in ("textured_cube", "compacted_cube"):  # compaction ran, in the program's frames too
        assert profiling.ROUTES_TAKEN["compacted_draws"] >= compacted + 4
    if case == "render_state":
        assert bool((f.stencil == 1).any()) and bool((f.tri_id >= 24 + 12 * INSTANCES).any())

    jr = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, raster_backend="pallas"))
    jdraws = _scene(case, jbrt, jdemos, jr)
    assert [d[0] for d in draws] == [tbrt.convert.pipeline_from_dict(dataclasses.asdict(d[0])) for d in jdraws]
    _assert_matches_jax(f, _frame(jr, jdraws, 0.9), lod=case == "textured_cube")


# ---- inputs ----------------------------------------------------------------


def test_new_mesh_of_the_same_shapes_hits_the_cache():
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.cube_demo(r)
    first = r.render_frame(pipe, mesh, uniforms(0.4))
    data = geometry.cube_mesh_data()
    small = r.upload_mesh(data["positions"] * np.float32(0.5), color=data["color"])
    assert small.attributes["position"].shape == mesh.attributes["position"].shape
    f = r.render_frame(pipe, small, uniforms(0.4))
    assert r.num_cached_programs == 1
    _assert_bitwise(f, _eager(r, [(pipe, small, uniforms, None)], 0.4))
    assert (f.tri_id >= 0).sum() < (first.tri_id >= 0).sum()


def test_attribute_edited_in_place_is_rendered():
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.cube_demo(r)
    before = r.render_frame(pipe, mesh, uniforms(0.4))
    mesh.attributes["color"].mul_(0.5)
    mesh.attributes["position"].mul_(0.75)
    f = r.render_frame(pipe, mesh, uniforms(0.4))
    _assert_bitwise(f, _eager(r, [(pipe, mesh, uniforms, None)], 0.4))
    assert not torch.equal(f.tri_id, before.tri_id)
    assert r.num_cached_programs == 1


def test_numpy_uniform_mutated_in_place_is_rendered():
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.cube_demo(r)
    u = {k: np.array(v.numpy()) for k, v in uniforms(0.2).items()}
    first = r.render_frame(pipe, mesh, u)
    u["model"][...] = uniforms(1.1)["model"].numpy()  # the same array object, new values
    f = r.render_frame(pipe, mesh, u)
    _assert_bitwise(f, _eager(r, [(pipe, mesh, lambda _: u, None)], 0.0))
    _assert_bitwise(f, _eager(r, [(pipe, mesh, uniforms, None)], 1.1))
    assert not torch.equal(f.tri_id, first.tri_id)
    assert r.num_cached_programs == 1


def test_new_clear_colour_adds_no_program():
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.cube_demo(r)
    r.render_frame(pipe, mesh, uniforms(0.4))
    for clear in ((1.0, 0.0, 0.5, 1.0), (0.0, 0.25, 0.0, 0.5)):
        f = r.render_frame(pipe, mesh, uniforms(0.4), clear_color=clear)
        _assert_bitwise(f, _eager(r, [(pipe, mesh, uniforms, None)], 0.4, clear_color=clear))
        bg = f.color_np()[f.tri_id.numpy() < 0]
        np.testing.assert_array_equal(bg, np.broadcast_to(np.float32(clear), bg.shape))
    assert r.num_cached_programs == 1
    r.render_frame(pipe, mesh, uniforms(0.4), clear_depth=0.5)  # the clear depth is in the key
    assert r.num_cached_programs == 2


@pytest.mark.parametrize("a, b", [
    (dict(wrap="repeat", mipmaps=True), dict(wrap="clamp", mipmaps=True)),
    (dict(mipmaps=True, mip_filter="linear"), dict(mipmaps=True, mip_filter="nearest")),
    (dict(mipmaps=False), dict(mipmaps=True)),
], ids=["wrap", "mip_filter", "mip_chain"])
def test_texture_sampler_state_is_in_the_key(a, b):
    """Two textures of one image (same data shape) with other sampler
    state are two programs, and each frame is its texture's eager frame."""
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.textured_fullscreen_demo(r)
    img = geometry.checkerboard_texture()
    frames = []
    for kw in (a, b):
        tex = r.upload_texture(img, **kw)
        draws = [(pipe, mesh, lambda t, tex=tex: {**uniforms(t), "texture": tex}, None)]
        f = _frame(r, draws, 3.0)  # the uv offset scrolls past the texture's edge
        _assert_bitwise(f, _eager(r, draws, 3.0))
        frames.append(f)
    assert r.num_cached_programs == 2
    assert not torch.equal(frames[0].color_planar, frames[1].color_planar)


def test_result_outlives_later_frames():
    r = _port()
    pipe, mesh, uniforms, _ = tdemos.cube_demo(r)
    held = r.render_frame(pipe, mesh, uniforms(0.2))
    copies = [x.clone() for x in (held.color_planar, held.depth_q, held.tri_id)]
    later = [r.render_frame(pipe, mesh, uniforms(t)) for t in (0.8, 1.4)]
    assert all(torch.equal(a, b) for a, b in zip((held.color_planar, held.depth_q, held.tri_id), copies))
    assert not torch.equal(held.tri_id, later[-1].tri_id)
