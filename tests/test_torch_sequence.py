"""Frame sequences in the port: render_sequence and render_sequence_multi.

Mirrors tests/test_present.py:60-144 and tests/test_renderer.py:276.  On
the CPU a sequence is the eager frame loop over the cached program's input
buffers (on CUDA those buffers feed captured CUDA graphs), so every
sequence frame equals the same render_frame bit for bit, and each
checksum is sum(color) of its frame.  Against the JAX package's
render_sequence (a lax.scan), on draws whose vertex stage is exact in
both packages (NDC positions: the vertex matmuls differ by rounding
otherwise), checksums agree within rtol 1e-4 and colours within 1e-4.
Both packages run "auto" on the CPU (the XLA rule) unless a test names
"pallas" for compaction or the instance cull.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch import math3d
from based_renderer_tpu_torch.models import demos, geometry
from based_renderer_tpu_torch.utils import profiling
from based_renderer_tpu_torch.utils.errors import AllocationError, FrameError


def _stack(frames):
    """Per-frame uniform dicts -> one dict of stacked (N, ...) tensors."""
    return {k: torch.stack([torch.as_tensor(np.asarray(f[k])) for f in frames]) for k in frames[0]}


def _renderer(width=64, height=48, **cfg):
    return tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, **cfg), device="cpu")


def _assert_frames(r, sums, colors, frames):
    """colors[i] equals frames[i]'s colour bit for bit; sums[i] is its sum."""
    assert colors.shape == (len(frames), 4, r.config.height, r.config.width)
    for i, f in enumerate(frames):
        assert torch.equal(colors[i], f.color_planar)
        assert float(sums[i]) == float(f.color_planar.sum())
    assert len(set(np.round(sums.numpy(), 3))) == len(frames)


def test_render_sequence_matches_frames():
    r = _renderer()
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    sums, colors = r.render_sequence(pipe, mesh, _stack([uniforms(0.3 * i) for i in range(4)]), return_frames=True)
    assert colors.shape == (4, 4, 48, 64)  # (N, C, H, W): planar device layout
    _assert_frames(r, sums, colors, [r.render_frame(pipe, mesh, uniforms(0.3 * i)) for i in range(4)])
    assert not bool(r.last_sequence_overflowed)


def test_render_sequence_cache_and_mesh_identity():
    """The program keeps the mesh it was built on: the same mesh hits the
    cache, and a swapped mesh of the same shapes gets a new program that
    renders the new data."""
    r = _renderer()
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    useq = _stack([uniforms(0.3 * i) for i in range(3)])
    sums1 = r.render_sequence(pipe, mesh, useq)
    n0 = r.num_cached_programs
    assert n0 == 1
    assert torch.equal(sums1, r.render_sequence(pipe, mesh, useq))
    assert r.num_cached_programs == n0  # same mesh: cache hit
    small = r.upload_mesh(mesh.attributes["position"].numpy() * 0.5, color=mesh.attributes["color"].numpy())
    sums2 = r.render_sequence(pipe, small, useq)
    assert r.num_cached_programs == n0 + 1  # new mesh: new program
    assert float(sums2[0]) == float(r.render_frame(pipe, small, uniforms(0.0)).color_planar.sum())
    assert not np.allclose(sums1.numpy(), sums2.numpy())


@pytest.mark.parametrize("demo, count", [("cube", None), ("instanced", 16)])
def test_render_sequence_uniforms_fn_matches_seq(demo, count):
    """uniforms_fn, evaluated at f32(t0) + f32(dt) * f32(i) and uploaded
    once, renders the frames of host-stacked uniforms_seq at the same
    times; t0 and dt change no cache key."""
    r = _renderer()
    pipe, mesh, uniforms, inst = getattr(demos, f"{demo}_demo")(r, **({} if count is None else {"count": count}))
    dt = 0.25
    s_seq = r.render_sequence(pipe, mesh, _stack([uniforms(i * dt) for i in range(3)]), instances=inst)
    s_fn = r.render_sequence(pipe, mesh, instances=inst, uniforms_fn=uniforms, num_frames=3, t0=0.0, dt=dt)
    np.testing.assert_allclose(s_fn.numpy(), s_seq.numpy(), rtol=2e-6)
    n0 = r.num_cached_programs
    s_fn2 = r.render_sequence(pipe, mesh, instances=inst, uniforms_fn=uniforms, num_frames=3, t0=0.1, dt=dt)
    assert r.num_cached_programs == n0
    assert not np.allclose(s_fn2.numpy(), s_fn.numpy())


def test_render_sequence_empty_uniforms_needs_count():
    r = _renderer(32, 32)
    pipe, mesh, _, _ = demos.triangle_demo(r)
    with pytest.raises(FrameError):
        r.render_sequence(pipe, mesh, {})
    sums = r.render_sequence(pipe, mesh, {}, num_frames=3)
    assert sums.shape == (3,)


def test_render_sequence_needs_exactly_one_uniform_source():
    r = _renderer(32, 32)
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    with pytest.raises(FrameError, match="not both"):
        r.render_sequence(pipe, mesh, _stack([uniforms(0.0)]), uniforms_fn=uniforms, num_frames=1)
    with pytest.raises(FrameError, match="uniforms_seq or uniforms_fn"):
        r.render_sequence(pipe, mesh)
    r.render_frame(pipe, mesh, uniforms(0.0))  # no frame is left open


def _blend_pipe(mod=tbrt):
    return mod.Pipeline(
        shader="flat_ndc",
        depth=mod.DepthState(test=False, write=False),
        blend=mod.BlendState(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha"),
    )


ALPHAS = np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.5], [0, 0, 1, 0.8]], np.float32)


def test_render_sequence_multi_matches_per_frame():
    """A two-draw blended animation equals per-frame rendering exactly."""
    r = _renderer(96, 64)
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    tri = r.upload_mesh(geometry.triangle_mesh_data()["positions"])
    times = [0.0, 0.4, 0.9]
    sums, frames = r.render_sequence_multi(
        [
            {"pipeline": pipe, "mesh": mesh, "uniforms_seq": _stack([uniforms(t) for t in times])},
            {"pipeline": _blend_pipe(), "mesh": tri, "uniforms_seq": {"color": torch.from_numpy(ALPHAS)}},
        ],
        return_frames=True,
    )
    want = []
    for k, t in enumerate(times):
        r.begin_frame()
        r.draw(pipe, mesh, uniforms(t))
        r.draw(_blend_pipe(), tri, {"color": torch.from_numpy(ALPHAS[k])})
        want.append(r.end_frame())
    _assert_frames(r, sums, frames, want)


@pytest.mark.parametrize("multi", [False, True])
def test_sequences_match_jax(multi):
    """The port's sequence against the JAX package's on NDC draws: the
    triangle with a per-frame colour alone, or under it the cube in clip
    space as JAX's vertex stage puts it (static mesh, empty uniforms)."""
    w, h = 96, 64
    tr = _renderer(w, h)
    jr = jbrt.Renderer(jbrt.RendererConfig(width=w, height=h))
    tri_pos = geometry.triangle_mesh_data()["positions"]
    t_draws = [{"pipeline": _blend_pipe(), "mesh": tr.upload_mesh(tri_pos),
                "uniforms_seq": {"color": torch.from_numpy(ALPHAS)}}]
    j_draws = [{"pipeline": _blend_pipe(jbrt), "mesh": jr.upload_mesh(tri_pos),
                "uniforms_seq": {"color": jnp.asarray(ALPHAS)}}]
    if multi:
        jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
        clip, _ = jbrt.shader.get(jpipe.shader).vertex(jmesh.attributes, ju(0.5))
        clip, color = np.asarray(clip), np.asarray(jmesh.attributes["color"])
        t_draws.insert(0, {"pipeline": tbrt.Pipeline(shader="ndc_color"), "mesh": tr.upload_mesh(clip, color=color),
                           "uniforms_seq": {}})
        j_draws.insert(0, {"pipeline": jbrt.Pipeline(shader="ndc_color"), "mesh": jr.upload_mesh(clip, color=color),
                           "uniforms_seq": {}})
    t_sums, t_cols = tr.render_sequence_multi(t_draws, return_frames=True)
    j_sums, j_cols = jr.render_sequence_multi(j_draws, return_frames=True)
    np.testing.assert_allclose(t_sums.numpy(), np.asarray(j_sums), rtol=1e-4)
    np.testing.assert_allclose(t_cols.numpy(), np.asarray(j_cols), rtol=0, atol=1e-4)


def test_textured_compacted_sequence_equals_frames():
    """Compacted shading in a sequence: pass 2 stops at the draw's
    covered-tile count, the host picks the budget, and the segment for
    that budget runs (on CUDA: is captured on first use, then replayed).
    At 256x96 the ladder is (8, 16) tiles; the camera distances give 19,
    16 and 8 covered tiles, so the frames take full-screen shading and
    both budgets.  The texture rides in static_uniforms, as bench.py
    passes it."""
    r = _renderer(256, 96, raster_backend="pallas")
    pipe, mesh, uniforms, _ = demos.textured_cube_demo(r)
    frames = [dict(uniforms(0.1 * i), view=math3d.translate((0.0, 0.0, z)))
              for i, z in enumerate((2.5, 3.0, 6.0, 3.0))]
    static = {"texture": frames[0]["texture"]}
    useq = _stack([{k: v for k, v in f.items() if k != "texture"} for f in frames])
    before = profiling.ROUTES_TAKEN["compacted_draws"]
    sums, colors = r.render_sequence(pipe, mesh, useq, static_uniforms=static, return_frames=True)
    assert profiling.ROUTES_TAKEN["compacted_draws"] > before
    _assert_frames(r, sums, colors, [r.render_frame(pipe, mesh, f) for f in frames])
    (program,) = r._sequences.values()
    assert set(program.root.children) == {0, 8, 16}  # 0: full-screen


def test_culled_instanced_sequence():
    """An instance-culled draw in a sequence equals its eager frames, and
    the unculled sequence within 1e-5.  The demo's orbit keeps nearly all
    of its 32 cubes in view, so the budget is all of them: the survivors
    still come first, so the records carry permuted original ids."""
    r = _renderer(128, 96, raster_backend="pallas")
    pipe, mesh, uniforms, inst = demos.instanced_demo(r, count=32)
    culled = dataclasses.replace(pipe, instance_cull=1.0)
    times = [0.5 * i for i in range(3)]
    useq = _stack([uniforms(t) for t in times])
    sums, colors = r.render_sequence(culled, mesh, useq, instances=inst, return_frames=True)
    assert not bool(r.last_sequence_overflowed)
    _assert_frames(r, sums, colors, [r.render_frame(culled, mesh, uniforms(t), instances=inst) for t in times])
    _, base = r.render_sequence(pipe, mesh, useq, instances=inst, return_frames=True)
    np.testing.assert_allclose(colors.numpy(), base.numpy(), rtol=0, atol=1e-5)


def test_sequence_overflow_flag_and_debug_raise():
    """An overflow in any frame sets last_sequence_overflowed; in debug mode
    it raises AllocationError."""
    r = _renderer(64, 48, raster_backend="pallas")
    pipe, mesh, uniforms, inst = demos.instanced_demo(r, count=16)
    starved = dataclasses.replace(pipe, instance_cull=0.05)
    useq = _stack([uniforms(0.5 * i) for i in range(2)])
    r.render_sequence(starved, mesh, useq, instances=inst)
    assert bool(r.last_sequence_overflowed)
    rd = _renderer(64, 48, raster_backend="pallas", debug=True)
    with pytest.raises(AllocationError):
        rd.render_sequence(starved, mesh, useq, instances=inst)
