"""The fused Blinn-Phong pass (ops/shade.py, csrc/shade_blinn_phong.cu) and
the renderer's rule for taking it (renderer._fused_body).

On the CPU the renderer never takes the fused route (its tensors are not
on CUDA), so these tests patch ``renderer._on_card`` to accept CPU
tensors: the fused body then runs ops/shade.py's plain version, which
must give the renderer's plain colour bit for bit.  The tests marked
``cuda`` hold the kernel against that plain version on the card and skip
here; run them there with

    python3 -m pytest tests/test_torch_shade_fused.py -m cuda --noconftest -s

This file imports nothing of JAX, so it runs on the card's host.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch

import based_renderer_tpu_torch as brt
from based_renderer_tpu_torch import renderer as rmod
from based_renderer_tpu_torch import shader
from based_renderer_tpu_torch.ops import shade
from based_renderer_tpu_torch.ops.raster import VisBuffer

W, H = 128, 96
COLOR_TOL = 1e-5  # the kernel against its plain version on the card
UNIFORMS = {"light_pos": torch.tensor([3.0, -3.0, -3.0]), "eye_pos": torch.tensor([0.0, 0.0, -2.2]),
            "base_color": torch.tensor([0.55, 0.65, 0.8])}


@pytest.fixture
def fused_route(monkeypatch):
    """The renderer takes fused bodies for CPU tensors too."""
    monkeypatch.setattr(rmod, "_on_card", lambda t: True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python3 -m pytest tests/test_torch_shade_fused.py -m cuda --noconftest`")
    return torch.device("cuda")


def _fused_draws(fn):
    """fn()'s result and how many draws it shaded through a fused body."""
    before = rmod.FUSED_SHADED_DRAWS
    out = fn()
    return out, rmod.FUSED_SHADED_DRAWS - before


def _synthetic(r, draws=1, k=6, seed=0):
    """Pass 1's result for ``draws`` blinn_phong draws on made-up planes at
    the renderer's size: each draw wins about half of the samples (later
    draws over earlier ones), the rest is background (-1); 1/w is 0 on a
    strip of won samples; each draw has its own uniforms."""
    g = torch.Generator().manual_seed(seed)
    dev = r.device
    msaa = r.config.msaa == 4 and not r.config.msaa_supersample
    plane = (4, H, W) if msaa else (H, W)
    tri = torch.full(plane, -1, dtype=torch.int32)
    pipe = brt.Pipeline(shader="blinn_phong")
    keys = (["color"] if k == 9 else []) + ["normal", "pos_ws"]
    per_draw, off = [], 0
    for d in range(draws):
        ntri = 40
        won = torch.rand(plane, generator=g) < 0.5
        tri = torch.where(won, torch.randint(off, off + ntri, plane, generator=g, dtype=torch.int32), tri)
        interp = torch.randn((k, *plane), generator=g) * 2
        invw = torch.rand(plane, generator=g) + 0.1
        invw[..., 3, 5:40] = 0
        vis = VisBuffer(tri_id=tri.clone(), depth_q=torch.randint(0, 2**30, plane, generator=g, dtype=torch.int32),
                        b0=torch.rand(plane, generator=g), b1=torch.rand(plane, generator=g),
                        b2=torch.rand(plane, generator=g))
        var_tri = {key: torch.zeros(ntri, 3, 3) for key in keys}
        u = {**UNIFORMS, "shininess": torch.tensor(8.0 + 24 * d), "ambient": torch.tensor(0.1 + 0.05 * d)}
        moved = [x.to(dev) for x in (interp, invw)]
        vis = VisBuffer(*(x.to(dev) for x in vis[:5]))
        per_draw.append((var_tri, off, ntri, moved[0], moved[1], vis, {a: b.to(dev) for a, b in u.items()}))
        off += ntri
    assert bool(((vis.tri_id >= 0) & (per_draw[-1][4] == 0)).any()) and bool((vis.tri_id < 0).any())
    zero = torch.zeros((), device=dev)
    return rmod._Visibility([SimpleNamespace(pipeline=pipe)] * draws, per_draw, vis, zero.bool(), zero.double(), 1.0)


def _shade(r, fv):
    return r._shade_from(fv, 0, torch.tensor([0.1, 0.2, 0.3, 1.0], device=r.device))[0]


SYNTHETIC = {
    "msaa4": dict(msaa=4),
    "no_msaa": dict(msaa=1),
    "msaa4_two_draws": dict(msaa=4, draws=2),
    "no_msaa_two_draws": dict(msaa=1, draws=2),
    "msaa4_vertex_color": dict(msaa=4, k=9),
    "no_msaa_vertex_color_two_draws": dict(msaa=1, k=9, draws=2),
}


@pytest.mark.parametrize("case", SYNTHETIC)
def test_plain_version_equals_the_plain_path_bitwise(case, monkeypatch):
    """ops/shade's plain version, through the fused route, against the
    renderer's plain path on the same planes: background samples, 1/w = 0
    samples, a first draw keeping per-sample colour and a last one
    resolving."""
    kw = dict(SYNTHETIC[case])
    r = brt.Renderer(brt.RendererConfig(W, H, msaa=kw.pop("msaa")), device="cpu")
    fv = _synthetic(r, **kw)
    want, n = _fused_draws(lambda: _shade(r, fv))
    assert n == 0
    monkeypatch.setattr(rmod, "_on_card", lambda t: True)
    got, n = _fused_draws(lambda: _shade(r, fv))
    assert n == len(fv.draws)
    assert got.shape == (4, H, W) and torch.equal(got, want)


def _demo_frame(r, ts=(0.3,)):
    pipe, mesh, u, _ = brt.demos.big_mesh_demo(r, triangles=2000)
    r.begin_frame()
    for t in ts:
        r.draw(pipe, mesh, u(t))
    return r.end_frame()


@pytest.mark.parametrize("msaa, supersample, ts", [(4, False, (0.3,)), (1, False, (0.3,)), (4, True, (0.3,)),
                                                   (4, False, (0.3, 2.1))],
                         ids=["msaa4", "no_msaa", "supersample", "msaa4_two_draws"])
def test_demo_frame_through_the_fused_route_is_bitwise(msaa, supersample, ts, monkeypatch):
    """A big_mesh frame at 128x96 through render_frame's program: the fused
    route's colour equals the plain path's, tri_id and depth_q untouched."""
    cfg = brt.RendererConfig(W, H, msaa=msaa, msaa_supersample=supersample)
    want = _demo_frame(brt.Renderer(cfg, device="cpu"), ts)
    monkeypatch.setattr(rmod, "_on_card", lambda t: True)
    got, n = _fused_draws(lambda: _demo_frame(brt.Renderer(cfg, device="cpu"), ts))
    assert n == len(ts)
    assert bool((want.tri_id < 0).any()) and bool((want.tri_id >= 0).any())
    for key in ("color_planar", "tri_id", "depth_q"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key


def _flat_fused_vs(attrs, uniforms):
    return shader.mvp_transform(attrs, uniforms), {}


INELIGIBLE = {
    "blending": lambda p: dataclasses.replace(
        p, blend=brt.BlendState(enable=True, src_factor="src_alpha", dst_factor="one_minus_src_alpha")),
    "partial_write_mask": lambda p: dataclasses.replace(p, blend=brt.BlendState(write_mask="rgb")),
    "compacted": lambda p: dataclasses.replace(p, shade_compact=0.9),
    "no_varyings": lambda p: dataclasses.replace(p, shader="flat_fused"),
    "not_perspective_correct": lambda p: dataclasses.replace(p, perspective_correct=False),
    "cpu_tensors": lambda p: p,
}


@pytest.mark.parametrize("case", INELIGIBLE)
def test_ineligible_draws_take_the_plain_path(case, monkeypatch):
    """Blending, a partial write mask, a compacted draw, a draw without
    varyings, one whose varyings are not divided by 1/w and CPU tensors
    each shade through the plain path, as before."""
    if case != "cpu_tensors":
        monkeypatch.setattr(rmod, "_on_card", lambda t: True)
    # A shader with blinn_phong's fused body and no varyings.
    monkeypatch.setitem(shader._REGISTRY, "flat_fused", shader.Shader(
        "flat_fused", _flat_fused_vs, shader.get("flat_mvp").fragment, fused=shader.get("blinn_phong").fused))
    r = brt.Renderer(brt.RendererConfig(W, H, msaa=4, raster_backend="pallas"), device="cpu")
    pipe, mesh, u, _ = brt.demos.big_mesh_demo(r, triangles=2000)
    pipe = INELIGIBLE[case](pipe)
    compacted = rmod.COMPACTED_DRAWS
    f, n = _fused_draws(lambda: r.render_frame(pipe, mesh, u(0.3)))
    assert n == 0 and bool((f.tri_id >= 0).any())
    assert (rmod.COMPACTED_DRAWS - compacted == 1) == (case == "compacted")
    eligible = dataclasses.replace(pipe, blend=brt.BlendState(), shade_compact=None, perspective_correct=True)
    want_fused = case != "cpu_tensors" and case != "no_varyings"
    assert _fused_draws(lambda: r.render_frame(eligible, mesh, u(0.3)))[1] == int(want_fused)


def test_only_blinn_phong_has_a_fused_body(fused_route):
    """Every other registered shader, the cube's vertex_color among them,
    renders through the plain path."""
    with_body = [n for n in shader.names() if shader.get(n).fused is not None]
    assert with_body == ["blinn_phong"]
    planes = torch.zeros(6, 4, 4)
    for name in shader.names():
        body = rmod._fused_body(shader.get(name), brt.Pipeline(shader=name), planes, False)
        assert (body is not None) == (name == "blinn_phong"), name
    r = brt.Renderer(brt.RendererConfig(W, H), device="cpu")
    pipe, mesh, u, _ = brt.demos.cube_demo(r)
    assert _fused_draws(lambda: r.render_frame(pipe, mesh, u(0.4)))[1] == 0


def test_fused_draws_count_wrapper_calls(fused_route):
    """Each fused draw of an eager frame counts once, and so does each
    frame of a sequence on the CPU (where every frame runs eagerly); the
    plain version launches no kernel."""
    r = brt.Renderer(brt.RendererConfig(W, H, msaa=4), device="cpu")
    launches = shade.LAUNCHES
    assert _fused_draws(lambda: _demo_frame(r, (0.3, 1.1, 2.0)))[1] == 3
    pipe, mesh, u, _ = brt.demos.big_mesh_demo(r, triangles=2000)
    _, n = _fused_draws(lambda: r.render_sequence(pipe, mesh, uniforms_fn=u, num_frames=3))
    assert n == 3 and shade.LAUNCHES == launches


@pytest.mark.parametrize("name, value, sizes, stride", [
    ("light_pos", torch.tensor([1.0, 2.0, 3.0]), (1, 3), 1),
    ("base_color", torch.tensor(0.5), (1, 3), 0),
    ("eye_pos", torch.tensor([[1.0, 2.0, 3.0]]), (1, 3), 1),
    ("shininess", torch.tensor([32.0]), (1,), 0),
])
def test_uniform_operands_broadcast_one_value(name, value, sizes, stride):
    flat, s = shade._uniform_operand(name, value, torch.device("cpu"), sizes)
    assert s == stride and flat.dim() == 1 and torch.equal(flat, value.reshape(-1))


@pytest.mark.parametrize("bad", ["channels", "tri_id_dtype", "color_shape", "uniform_size", "uniform_dtype"])
def test_kernel_wrapper_refuses_bad_operands(bad):
    """The wrapper's checks run before the library loads, so they raise here."""
    plane = (4, 8, 16)
    ops = dict(interp=torch.zeros(6, *plane), invw=torch.ones(plane), tri_id=torch.zeros(plane, dtype=torch.int32),
               lo=0, hi=1, color=torch.zeros(4), light_pos=torch.zeros(3), eye_pos=torch.zeros(3),
               base_color=torch.zeros(3), shininess=torch.tensor(32.0), ambient=torch.tensor(0.1), resolve=True)
    if bad == "channels":
        ops["interp"] = torch.zeros(7, *plane)
    elif bad == "tri_id_dtype":
        ops["tri_id"] = ops["tri_id"].long()
    elif bad == "color_shape":
        ops["color"] = torch.zeros(4, 8, 16)
    elif bad == "uniform_size":
        ops["light_pos"] = torch.zeros(2)
    else:
        ops["ambient"] = torch.tensor(0.1, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        shade._shade_kernel(**ops)


# ---- on the card --------------------------------------------------------


def _gap(a, b) -> float:
    return float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("samples, k, clear, resolve", [
    (4, 6, True, True), (4, 6, False, False), (4, 9, False, True), (1, 6, True, False), (1, 9, False, False),
])
def test_kernel_matches_plain_version(cuda_device, samples, k, clear, resolve):
    g = torch.Generator().manual_seed(samples * 100 + k)
    plane = (samples, H, W) if samples == 4 else (H, W)
    interp = torch.randn((k, *plane), generator=g) * 2
    invw = torch.rand(plane, generator=g) + 0.1
    invw[..., 3, 5:40] = 0
    tri = torch.randint(-1, 60, plane, generator=g, dtype=torch.int32)
    color = torch.rand(4, generator=g) if clear else torch.rand((*plane[:-2], 4, H, W), generator=g)
    u = [torch.tensor([3.0, -3.0, -3.0]), torch.tensor([0.0, 0.0, -2.2]), torch.tensor([0.55, 0.65, 0.8]),
         torch.tensor(32.0), torch.tensor(0.1)]
    args = [x.to(cuda_device) for x in (interp, invw, tri)]
    rest = [x.to(cuda_device) for x in (color, *u)]
    launches = shade.LAUNCHES
    got = shade.shade_blinn_phong(*args, 10, 50, *rest, resolve=resolve)
    want = shade.shade_blinn_phong_reference(*args, 10, 50, *rest, resolve=resolve)
    torch.cuda.synchronize()
    assert shade.LAUNCHES == launches + 1
    assert got.shape == want.shape and _gap(got, want) <= COLOR_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["msaa4_two_draws", "no_msaa_two_draws", "msaa4_vertex_color"])
def test_two_draw_frame_on_the_card(cuda_device, case, monkeypatch):
    """The renderer's fused route on the card against its plain path."""
    kw = dict(SYNTHETIC[case])
    r = brt.Renderer(brt.RendererConfig(W, H, msaa=kw.pop("msaa")), device=cuda_device)
    fv = _synthetic(r, **kw)
    got, n = _fused_draws(lambda: _shade(r, fv))
    assert n == len(fv.draws)
    monkeypatch.setattr(rmod, "_on_card", lambda t: False)
    want, n = _fused_draws(lambda: _shade(r, fv))
    assert n == 0 and _gap(got, want) <= COLOR_TOL


def _kernel_launches(fn) -> int:
    """Launches of the shading kernel, by its symbol, that fn() makes on
    the card (a graph's replay included); tried again while none is seen,
    since the profiler may drop a launch's record (it never adds one)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "shade_blinn_phong_kernel" in e.key)
        if n:
            break
    return n


def _eager(r, pipe, mesh, uniforms):
    """The frame's result tuple, run eagerly on the caller's inputs."""
    r.begin_frame()
    r.draw(pipe, mesh, uniforms)
    return r._run_frame(*r.close_frame())


@pytest.mark.cuda
def test_big_mesh_4k_msaa4_frame_eager_and_replayed(cuda_device, monkeypatch):
    """One 1M-triangle big_mesh frame at 3840x2160 MSAA-4x, eager and
    replayed from its captured graphs, against the plain path: tri_id and
    depth_q bitwise, the colour within 1e-5.  The eager frame launches the
    kernel once, the capture twice (its warm-up and the capture) and the
    replay once from the graph; the plain frame never."""
    cfg = brt.RendererConfig(3840, 2160, msaa=4)
    r = brt.Renderer(cfg, device=cuda_device)
    pipe, mesh, u, _ = brt.demos.big_mesh_demo(r)
    launches = shade.LAUNCHES
    eager = _eager(r, pipe, mesh, u(0.3))
    assert shade.LAUNCHES == launches + 1
    r.render_frame(pipe, mesh, u(1.0))  # the key's first call captures
    assert shade.LAUNCHES == launches + 3
    replayed, n = _fused_draws(lambda: r.render_frame(pipe, mesh, u(0.3)))
    assert n == 0 and shade.LAUNCHES == launches + 3  # a replay calls no wrapper
    assert _kernel_launches(lambda: r.render_frame(pipe, mesh, u(0.3))) == 1
    monkeypatch.setattr(rmod, "_on_card", lambda t: False)
    plain = _eager(r, pipe, mesh, u(0.3))
    assert shade.LAUNCHES == launches + 3
    assert _kernel_launches(lambda: _eager(r, pipe, mesh, u(0.3))) == 0
    torch.cuda.synchronize()
    for label, got in (("eager", eager), ("replayed", replayed)):
        got_color = got[0] if isinstance(got, tuple) else got.color_planar
        got_ids = (got[2], got[1]) if isinstance(got, tuple) else (got.tri_id, got.depth_q)
        assert torch.equal(got_ids[0], plain[2]) and torch.equal(got_ids[1], plain[1]), label
        gap = _gap(got_color, plain[0])
        equal = float((got_color == plain[0]).all(dim=0).float().mean())
        print(f"[shade 4K] {label}: colour max gap {gap:.3g}, bitwise-equal pixels {100 * equal:.3f}%")
        assert gap <= COLOR_TOL, label
