"""The spec's adversarial streams through every plain route of the port.

Each stream of ``based_renderer_tpu_torch/reference/adversarial.py``
(slivers that engage DEPTH_GRAD_CLAMP, the clamp-boundary sliver,
guard-band vertices and their fuzz, both zshift extremes, a ground plane
cut by the near plane, degenerate triangles, the shared-edge quad, random
triangles, the empty draw and a seeded mix) runs at 96x64 through the
port's plain routes: sequential (128x32 and 32x16), two-pass, sublane
(128x8, also from the kernel assembly's layout and from transposed
template rows), batched (64x64) and coverage MSAA-4x with its sublane
form.  Every route's tri_id and depth_q (and stencil) equal the port's
oracle exactly, per sample under MSAA; the port's oracle equals the JAX
package's; and the JAX package's rasterize_vis_pallas(..., interpret=True)
(sequential, sublane, MSAA and MSAA sublane) gives the same ints, with
barycentrics within atol 2e-4 of the port's (tests/test_pallas.py:40).
Each case asserts that its regime is engaged.

The JAX Pallas runs take every stream padded to 256 triangles with
zero-area ones (which no route bins), so one interpret compile of each
kernel serves every stream; the empty draw runs unpadded.  The empty draw
and a fully culled instanced draw also go through Renderer.render_frame
and render_sequence on the CPU.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as tbrt
import test_raster_bitexact as jax_bitexact
import test_spec_adversarial as jax_adversarial
from based_renderer_tpu.ops import fixedpoint as jfp
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu.reference import oracle as jax_oracle
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.ops import binassem, binning
from based_renderer_tpu_torch.ops import fixedpoint as tfp
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops.binning import bin_triangles
from based_renderer_tpu_torch.ops.setup import setup_triangles
from based_renderer_tpu_torch.reference import adversarial as adv
from based_renderer_tpu_torch.reference import oracle

W, H = 96, 64
ATOL = 2e-4
T_PAD = 256
PAIRS = 64 * T_PAD + 4096
ORDERED = ("less", "less_equal", "greater", "greater_equal")
COMPARES = ("never", "less", "equal", "less_equal", "greater", "not_equal", "greater_equal", "always")
CASES = adv.cases(W, H, fuzz_seeds=(0, 1))
BY_LABEL = {label: (stream, clip) for stream, label, clip in CASES}
INCREMENT = tbrt.StencilState(enable=True, compare="always", pass_op="increment_clamp",
                              depth_fail_op="increment_wrap")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The 96x64 routes are thousands of small tensor ops, which intra-op
    threads only slow (and oversubscribe the cores under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clear(compare):
    return 0.0 if compare.startswith("greater") else 1.0


def port_routes(clip, compare="less", cull="none", front="ccw", depth_test=True, stencil=None, depth_clip=True):
    """{route: VisBuffer} of every plain route of the port that takes these
    modes; the MSAA routes' planes are (4, H, W)."""
    clip_t = torch.from_numpy(clip)
    ts = setup_triangles(clip_t, W, H, cull_mode=cull, front_face=front)
    ts4 = setup_triangles(clip_t, W, H, cull_mode=cull, front_face=front, bbox_pad_fp=tfp.MSAA4_BBOX_PAD_FP)
    kw = dict(depth_test=depth_test, depth_write=depth_test, depth_compare=compare, depth_clear=_clear(compare),
              depth_clip=depth_clip, max_pairs=PAIRS, return_overflow=True)
    runs = {
        "sequential": (ts, dict(stencil=stencil)),
        "sequential 32x16": (ts, dict(tile_w=32, tile_h=16, stencil=stencil)),
        "two_pass": (ts, dict(two_pass=True, stencil=stencil)),
        "msaa4": (ts4, dict(msaa4=True, stencil=stencil)),
    }
    if depth_test and compare in ORDERED and stencil is None:
        dense = dict(tile_w=128, tile_h=8, sublane=True)
        runs.update({
            "sublane": (ts, dense),
            "sublane assemble=pallas": (ts, dict(dense, assemble="pallas")),
            "sublane tmpl=pallas": (ts, dict(dense, assemble="pallas", tmpl="pallas")),
            "batched 64x64": (ts, dict(tile_w=64, tile_h=64, batch=16)),
            "msaa4 sublane": (ts4, dict(dense, msaa4=True, assemble="pallas")),
        })
    out = {}
    for name, (setup, extra) in runs.items():
        vis, overflowed, _ = traster.rasterize_vis(setup, W, H, **kw, **extra)
        assert not bool(overflowed), name
        out[name] = vis
    return out


def oracles(clip, compare="less", cull="none", front="ccw", depth_test=True, stencil=None, depth_clip=True):
    """(port oracle, port MSAA-4x oracle); the port's oracle is held equal
    to the JAX package's on the same call."""
    kw = dict(cull_mode=cull, front_face=front, depth_test=depth_test, depth_write=depth_test,
              depth_compare=compare, depth_clear=_clear(compare), depth_clip=depth_clip, stencil=stencil)
    ora = oracle.rasterize(clip, W, H, **kw)
    want = jax_oracle.rasterize(clip, W, H, **kw)
    for k in ("tri_id", "depth_q", "bary", *(("stencil",) if stencil is not None else ())):
        np.testing.assert_array_equal(ora[k], want[k], err_msg=k)
    return ora, oracle.rasterize_msaa4(clip, W, H, **kw)


def assert_routes_match_oracle(routes, ora, ora4, stencil=False):
    for name, vis in routes.items():
        want = ora4 if name.startswith("msaa4") else ora
        np.testing.assert_array_equal(vis.tri_id.numpy(), want["tri_id"], err_msg=f"{name} tri_id")
        np.testing.assert_array_equal(vis.depth_q.numpy(), want["depth_q"], err_msg=f"{name} depth_q")
        if stencil:
            np.testing.assert_array_equal(vis.stencil.numpy(), want["stencil"], err_msg=f"{name} stencil")


def padded(clip):
    """The stream followed by zero-area triangles up to T_PAD."""
    out = np.zeros((T_PAD, 3, 4), np.float32)
    out[..., 3] = 1.0
    out[: clip.shape[0]] = clip
    return out


def jax_pallas(clip, msaa4=False, sublane=False):
    pad = jfp.MSAA4_BBOX_PAD_FP if msaa4 else 0
    ts = jsetup.setup_triangles(jnp.asarray(clip if clip.shape[0] == 0 else padded(clip)), W, H, bbox_pad_fp=pad)
    tile = dict(tile_w=128, tile_h=8, sublane=True) if sublane else {}
    return rasterize_vis_pallas(ts, W, H, interpret=True, msaa4=msaa4, max_pairs=PAIRS, **tile)


def assert_port_equals_jax(vis, jv, label):
    np.testing.assert_array_equal(vis.tri_id.numpy(), np.asarray(jv.tri_id), err_msg=f"{label} tri_id")
    np.testing.assert_array_equal(vis.depth_q.numpy(), np.asarray(jv.depth_q), err_msg=f"{label} depth_q")
    for k in ("b0", "b1", "b2"):
        np.testing.assert_allclose(getattr(vis, k).numpy(), np.asarray(getattr(jv, k)), rtol=0, atol=ATOL,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("seed", range(5))
def test_sliver_stream_starts_with_the_jax_input(seed):
    clip = adv.slivers(W, H, seed=seed)
    want = jax_adversarial.steep_slivers(np.random.default_rng(100 + seed), 220)
    np.testing.assert_array_equal(clip[:220], want)
    assert clip.shape[0] == 236


@pytest.mark.parametrize("seed", range(4))
def test_random_stream_is_the_jax_input(seed):
    want = jax_bitexact.random_clip_triangles(np.random.default_rng(seed), 24)
    np.testing.assert_array_equal(adv.random_tris(seed), want)


@pytest.mark.parametrize("label", list(BY_LABEL))
def test_stream_through_every_route(label):
    """Every route under "less" against both oracles and JAX Pallas."""
    stream, clip = BY_LABEL[label]
    routes = port_routes(clip)
    ora, ora4 = oracles(clip)
    ts = setup_triangles(torch.from_numpy(clip), W, H)
    binned = bin_triangles(ts, W, H, max_pairs=PAIRS) if clip.shape[0] else None
    adv.assert_engaged(stream, ts, ora["tri_id"], None if binned is None else binned.records,
                       None if binned is None else int(binned.tile_count.sum()))
    assert_routes_match_oracle(routes, ora, ora4)
    assert_port_equals_jax(routes["sequential"], jax_pallas(clip), "sequential")
    assert_port_equals_jax(routes["sublane"], jax_pallas(clip, sublane=True), "sublane")
    if clip.shape[0]:  # JAX's own tests run its MSAA kernels at T = 0 (tests/test_pallas.py)
        assert_port_equals_jax(routes["msaa4"], jax_pallas(clip, msaa4=True), "msaa4")
        assert_port_equals_jax(routes["msaa4 sublane"], jax_pallas(clip, msaa4=True, sublane=True), "msaa4 sublane")
    if stream == "empty":
        assert all(int((v.tri_id >= 0).sum()) == 0 for v in routes.values())


def test_near_plane_stream_is_cut_beyond_the_guard_band():
    """The cut vertices (w = the clipper's eps) snap to the guard band."""
    raw = adv.near_plane_raw(W, H)
    assert (raw[..., 3] < 0).any() and (raw[..., 3] > 0).any()
    clip = adv.near_plane(W, H)
    assert clip.shape == (2 * raw.shape[0], 3, 4)
    ts = setup_triangles(torch.from_numpy(clip), W, H)
    cut = np.isclose(clip[..., 3], 1e-5, rtol=1e-3).any(-1) & ts.valid.numpy()
    xf, yf = ts.xf.numpy()[cut], ts.yf.numpy()[cut]
    assert np.isin(xf, (adv.GUARD_LO, adv.GUARD_HI)).any() or np.isin(yf, (adv.GUARD_LO, adv.GUARD_HI)).any()


@pytest.mark.parametrize("compare", COMPARES)
def test_depth_compares(compare):
    """Every compare on the routes that take it (all eight sequential,
    two-pass and MSAA; the ordered four sublane and batched) for the
    random stream of test_raster_bitexact.py:106-119 and the mixed fuzz."""
    for clip in (adv.random_tris(7, n=12), BY_LABEL["fuzz seed 0"][1], BY_LABEL["slivers seed 0"][1]):
        routes = port_routes(clip, compare=compare)
        assert ("sublane" in routes) == (compare in ORDERED)
        assert_routes_match_oracle(routes, *oracles(clip, compare=compare))


@pytest.mark.parametrize("cull,front", [("back", "ccw"), ("front", "ccw"), ("back", "cw")])
def test_cull_modes(cull, front):
    """test_raster_bitexact.py:121-126's random stream, the near-plane cut
    and the guard-band fuzz under each cull mode."""
    for clip in (adv.random_tris(11, n=16), BY_LABEL["near_plane"][1], BY_LABEL["guard_band fuzz 0"][1]):
        routes = port_routes(clip, cull=cull, front=front)
        assert_routes_match_oracle(routes, *oracles(clip, cull=cull, front=front))


@pytest.mark.parametrize("label", ["guard_band fuzz 1", "random seed 1", "zshift_steep", "fuzz seed 1"])
def test_stencil(label):
    """The stencil plane (increment on pass, wrap on depth fail) on the
    sequential, two-pass and MSAA routes, against the oracle's."""
    clip = BY_LABEL[label][1]
    routes = port_routes(clip, stencil=INCREMENT)
    assert_routes_match_oracle(routes, *oracles(clip, stencil=INCREMENT), stencil=True)
    assert int(routes["sequential"].stencil.max()) >= 2


@pytest.mark.parametrize("label", ["slivers seed 2", "zshift_steep", "guard_band fuzz 0", "near_plane"])
def test_depth_clamp(label):
    """depth_clip="clamp" (the depthClampEnable analog): the steep planes'
    out-of-range depths clamp to [0, 1] and stay covered."""
    clip = BY_LABEL[label][1]
    routes = port_routes(clip, depth_clip="clamp")
    ora, ora4 = oracles(clip, depth_clip="clamp")
    assert_routes_match_oracle(routes, ora, ora4)
    assert (ora["tri_id"] >= 0).sum() >= (oracles(clip)[0]["tri_id"] >= 0).sum()


@pytest.mark.parametrize("msaa4", [False, True])
def test_zero_size_assembly_and_transpose(msaa4):
    """The record assembly (both entries) and the template transpose on
    no slots and no templates, which the binner never hands them: empty
    outputs of the right rows."""
    ts = setup_triangles(torch.from_numpy(adv.empty()), W, H)
    col = torch.zeros((0, 3, 3))
    tmpl = binning._templates(ts, 0, col, True)
    none = torch.zeros((0,), dtype=torch.int64)
    fw = binning.frecord_width(3)
    rec, frec = binassem.assemble_records(tmpl, none, none, none, torch.zeros((), dtype=torch.int64), fw, msaa4)
    assert rec.shape == (binassem.record_width(msaa4), 0) and frec.shape == (fw, 0)
    fused_t, row_width = binning.templates_field_major(tmpl)
    fused = binassem.transpose_templates(fused_t, row_width)
    assert fused.shape == (0, row_width)
    rows = binassem.assemble_records_rows(fused, none, none, none, torch.zeros((), dtype=torch.int64), fw, 3, msaa4)
    assert rows[0].shape == rec.shape and rows[1].shape == frec.shape


def test_shared_edge_fill_rule():
    """Each half alone and both, depth test off: disjoint halves whose
    union is the quad (test_raster_bitexact.py:77-104), on every route
    that takes depth test off, against the oracle."""
    clip = adv.shared_edge()
    parts = [port_routes(c, depth_test=False) for c in (clip[:1], clip[1:], clip)]
    for name in parts[2]:
        planes = [p[name].tri_id for p in parts]
        layers = [planes] if planes[0].dim() == 2 else [[x[s] for x in planes] for s in range(4)]
        for a, b, ab in layers:
            assert adv.assert_shared_edge(a, b, ab) > 0
    for c, routes in zip((clip[:1], clip[1:], clip), parts):
        assert_routes_match_oracle(routes, *oracles(c, depth_test=False))


def _empty_mesh(r):
    return r.upload_mesh(np.zeros((0, 3), np.float32), color=np.zeros((0, 3), np.float32))


def _frames_equal(a, b):
    for k in ("tri_id", "depth_q", "color_planar"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_empty_draw_through_the_renderer():
    """render_frame and render_sequence of a draw with no triangles: no
    coverage, the clear colour, no overflow; the next frame equals the
    same frame drawn alone."""
    r = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu")
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    empty = _empty_mesh(r)
    f = r.render_frame(pipe, empty, uniforms(0.1))
    assert int((f.tri_id >= 0).sum()) == 0 and not bool(f.overflowed)
    clear = torch.tensor(r.config.clear_color).reshape(4, 1, 1)
    assert torch.equal(f.color_planar, clear.expand_as(f.color_planar))
    u = [uniforms(0.2 * i) for i in range(3)]
    stacked = {k: torch.stack([torch.as_tensor(np.asarray(x[k])) for x in u]) for k in u[0]}
    sums, colors = r.render_sequence(pipe, empty, stacked, return_frames=True)
    assert not bool(r.last_sequence_overflowed)
    assert torch.equal(colors, clear.expand_as(colors[0]).expand_as(colors).contiguous())
    alone = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu")
    _frames_equal(r.render_frame(pipe, mesh, uniforms(0.3)), alone.render_frame(pipe, mesh, uniforms(0.3)))


def test_fully_culled_instanced_draw():
    """An instanced draw under instance_cull whose every instance lies
    outside the frustum: the compacted slots hold culled instances only;
    no coverage, no overflow, and the next frame equals it drawn alone.
    The Pallas backend rule culls on the CPU (no fallback warning)."""
    cfg = tbrt.RendererConfig(W, H, raster_backend="pallas")
    r = tbrt.Renderer(cfg, device="cpu")
    pipe, mesh, uniforms, inst = demos.instanced_demo(r, count=32)
    pipe = dataclasses.replace(pipe, instance_cull=0.5)
    away = inst["transform"].clone().reshape(-1, 4, 4)
    away[:, :3, 3] += torch.tensor([1e5, 0.0, 0.0])
    gone = {**inst, "transform": away.reshape(-1, 16)}
    u = [uniforms(0.1 * i) for i in range(2)]
    stacked = {k: torch.stack([torch.as_tensor(np.asarray(x[k])) for x in u]) for k in u[0]}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f = r.render_frame(pipe, mesh, u[0], instances=gone)
        sums, colors = r.render_sequence(pipe, mesh, stacked, instances=gone, return_frames=True)
    assert int((f.tri_id >= 0).sum()) == 0 and not bool(f.overflowed)
    assert not bool(r.last_sequence_overflowed)
    clear = torch.tensor(r.config.clear_color).reshape(4, 1, 1)
    assert torch.equal(colors, clear.expand_as(colors[0]).expand_as(colors).contiguous())
    frame = r.render_frame(pipe, mesh, u[0], instances=inst)
    assert int((frame.tri_id >= 0).sum()) > 0
    _frames_equal(frame, tbrt.Renderer(cfg, device="cpu").render_frame(pipe, mesh, u[0], instances=inst))
