"""The binner's float template planes (ops/templates.py,
csrc/triangle_templates.cu).

On the CPU ``binning._templates`` builds the planes with the plain
version, which is held here bit for bit to a fixed-order numpy statement
of the arithmetic the kernel follows: f32 throughout, one rounding per
product and sum, the int64 edge values by the two-step rule.  The streams
cover K = 0, 3 and 6 channels with and without the perspective divide, the
adversarial clamp slivers and steep covering triangles, and edge values
above 2^31, where the two-step rule rounds twice.  The tests marked
``cuda`` hold the kernel to the plain version on the card and skip here;
run them there with

    python3 -m pytest tests/test_torch_templates.py -m cuda --noconftest -s

This file imports nothing of JAX, so it runs on the card's host.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as brt
from based_renderer_tpu_torch.ops import binning, templates
from based_renderer_tpu_torch.ops import fixedpoint as fp
from based_renderer_tpu_torch.ops.setup import setup_triangles
from based_renderer_tpu_torch.ops.vertex import expand_instances, gather_triangles
from based_renderer_tpu_torch.reference import adversarial as adv
from based_renderer_tpu_torch.utils import profiling

W, H = 128, 96


def planes_numpy(e, a, b, inv_area, inv_w, channels, perspective):
    """The planes as the kernel computes them, column by column, in numpy
    float32: (T, 3 * (3 + K))."""
    f = np.float32
    lo = ((e + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    hi = (e - lo) >> 32
    ef = hi.astype(f) * f(2.0**32) + lo.astype(f)
    bary = []
    for i in (1, 2):  # b0 from edge 1, b1 from edge 2
        bary += [ef[:, i] * inv_area, a[:, i].astype(f) * f(16) * inv_area, b[:, i].astype(f) * f(16) * inv_area]
    bary += [f(1) - (bary[0] + bary[3]), -(bary[1] + bary[4]), -(bary[2] + bary[5])]
    qs = [inv_w]
    if channels is not None:
        qs += [channels[:, :, k] * inv_w if perspective else channels[:, :, k] for k in range(channels.shape[-1])]
    cols = bary[:6]
    for q in qs:
        cols += [(q[:, 0] * bary[c] + q[:, 1] * bary[3 + c]) + q[:, 2] * bary[6 + c] for c in range(3)]
    return np.stack(cols, axis=1)


def random_clip(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


# name: (clip stream, channels K, perspective)
STREAMS = {
    "k0": (lambda: random_clip(0), 0, True),
    "k3_perspective": (lambda: random_clip(1), 3, True),
    "k3_flat": (lambda: random_clip(2), 3, False),
    "k6_perspective": (lambda: random_clip(3), 6, True),
    "k6_flat": (lambda: random_clip(4), 6, False),
    "clamp_slivers": (lambda: adv.clamp_slivers(W, H, 0, 32), 6, True),
    "steep_covering": (lambda: adv.steep_covering(W, H, 32), 3, True),
    "edges_above_2_31": (lambda: adv.guard_band_fuzz(W, H, 7, 256), 6, True),
    "empty": (adv.empty, 3, True),
}


def stream(name):
    """(setup, channels, perspective) of a stream on the CPU; each asserts
    the regime it is there for."""
    make, k, perspective = STREAMS[name]
    clip = torch.from_numpy(make())
    ts = setup_triangles(clip, W, H)
    g = torch.Generator().manual_seed(len(name))
    channels = torch.randn((clip.shape[0], 3, k), generator=g) * 4 if k else None
    e = binning._templates(ts, 0, None, perspective).e
    if name == "clamp_slivers":
        assert bool((ts.dzdy_q.abs() == fp.DEPTH_GRAD_CLAMP).any() | (ts.dzdx_q.abs() == fp.DEPTH_GRAD_CLAMP).any())
    elif name == "steep_covering":  # planes as steep as the depth window allows at this size
        assert bool((ts.zshift >= 17).all())
    elif name == "edges_above_2_31":  # the two-step rule rounds twice on some b0 or b1 edge value
        assert bool((fp.i64_to_f32(e[:, 1:]) != e[:, 1:].to(torch.float32)).any())
    elif name == "empty":  # a draw of no triangles, whose operands have no storage
        assert clip.shape[0] == 0
    return ts, channels, perspective


@pytest.mark.parametrize("name", STREAMS)
def test_plain_planes_equal_the_fixed_order_statement(name):
    ts, channels, perspective = stream(name)
    before = profiling.ROUTES_TAKEN["triangle_templates"]
    tmpl = binning._templates(ts, 0, channels, perspective)
    assert profiling.ROUTES_TAKEN["triangle_templates"] == before  # the CPU launches nothing
    k = 0 if channels is None else channels.shape[-1]
    assert tmpl.planes.shape == (ts.valid.shape[0], 3 * (3 + k)) and tmpl.planes.is_contiguous()
    want = planes_numpy(tmpl.e.numpy(), ts.a.numpy(), ts.b.numpy(), ts.inv_area.numpy(), ts.inv_w.numpy(),
                        None if channels is None else channels.numpy(), perspective)
    np.testing.assert_array_equal(tmpl.planes.numpy().view(np.int32), want.view(np.int32))


def _operands(t=8, k=3):
    return dict(e=torch.zeros(t, 3, dtype=torch.int64), a=torch.zeros(t, 3, dtype=torch.int32),
                b=torch.zeros(t, 3, dtype=torch.int32), inv_area=torch.ones(t), inv_w=torch.ones(t, 3),
                channels=torch.zeros(t, 3, k), perspective=True)


@pytest.mark.parametrize("bad", ["e_int32", "a_shape", "inv_area_float64", "inv_w_shape", "channels_float64",
                                 "channels_rows"])
def test_kernel_wrapper_refuses_bad_operands(bad):
    """The wrapper's checks run before the library loads, so they raise here."""
    ops = _operands()
    if bad == "e_int32":
        ops["e"] = ops["e"].int()
    elif bad == "a_shape":
        ops["a"] = torch.zeros(8, 2, dtype=torch.int32)
    elif bad == "inv_area_float64":
        ops["inv_area"] = ops["inv_area"].double()
    elif bad == "inv_w_shape":
        ops["inv_w"] = torch.ones(8)
    elif bad == "channels_float64":
        ops["channels"] = ops["channels"].double()
    else:
        ops["channels"] = torch.zeros(7, 3, 3)
    before = profiling.ROUTES_TAKEN["triangle_templates"]
    with pytest.raises((ValueError, TypeError)):
        templates._planes_kernel(**ops)
    assert profiling.ROUTES_TAKEN["triangle_templates"] == before


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python3 -m pytest tests/test_torch_templates.py -m cuda --noconftest`")
    return torch.device("cuda")


def _to(ts, dev):
    return ts._replace(**{k: v.to(dev) for k, v in ts._asdict().items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name", STREAMS)
def test_kernel_planes_equal_the_plain_path_bitwise(cuda_device, name):
    ts, channels, perspective = stream(name)
    want = binning._templates(ts, 0, channels, perspective).planes
    before = profiling.ROUTES_TAKEN["triangle_templates"]
    got = binning._templates(_to(ts, cuda_device), 0, None if channels is None else channels.to(cuda_device),
                             perspective).planes
    assert profiling.ROUTES_TAKEN["triangle_templates"] == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.fixture
def plain_templates(monkeypatch):
    """A context that builds the binner's planes with the plain version on
    the card, as the tree did before the kernel."""

    class Plain:
        def __enter__(self):
            monkeypatch.setattr(binning, "template_planes", templates.template_planes_reference)

        def __exit__(self, *exc):
            monkeypatch.setattr(binning, "template_planes", templates.template_planes)

    return Plain()


def _eager(r, pipe, mesh, uniforms):
    r.begin_frame()
    r.draw(pipe, mesh, uniforms)
    return r._run_frame(*r.close_frame())


@pytest.mark.cuda
def test_big_mesh_4k_draw_and_frames_unchanged(cuda_device, plain_templates):
    """The 1M-triangle big_mesh draw at 3840x2160 MSAA-4x: at three views
    the planes, the records and the frame (colour, tri_id, depth_q) with
    the kernel equal those of the plain version bit for bit; each eager
    frame takes the route once."""
    cfg = brt.RendererConfig(3840, 2160, msaa=4)
    r = brt.Renderer(cfg, device=cuda_device)
    pipe, mesh, u, inst = brt.demos.big_mesh_demo(r)
    shd = brt.shader.get(pipe.shader)
    attrs, tri_idx = expand_instances(mesh, inst)
    for t in (0.3, 2.1, 4.7):
        clip, var = shd.vertex(attrs, {k: v.to(cuda_device) for k, v in u(t).items()})
        clip_tri, var_tri = gather_triangles(clip, var, tri_idx)
        ts = setup_triangles(clip_tri, cfg.width, cfg.height, cull_mode=pipe.cull_mode, front_face=pipe.front_face,
                             bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP)
        channels = torch.cat([var_tri[k] for k in sorted(var_tri)], dim=-1)
        n = clip_tri.shape[0]
        kw = dict(max_pairs=int(n * pipe.raster_pairs_factor), slots=int(n * pipe.raster_slots_factor),
                  channels=channels, assemble="pallas", msaa4=True)
        got_planes = binning._templates(ts, 0, channels, True).planes
        got_bin = binning.bin_triangles(ts, cfg.width, cfg.height, 128, 8, **kw)
        before = profiling.ROUTES_TAKEN["triangle_templates"]
        got_frame = _eager(r, pipe, mesh, u(t))
        assert profiling.ROUTES_TAKEN["triangle_templates"] == before + 1
        with plain_templates:
            want_planes = templates.template_planes_reference(
                binning._templates(ts, 0, None, True).e, ts.a, ts.b, ts.inv_area, ts.inv_w, channels, True)
            want_bin = binning.bin_triangles(ts, cfg.width, cfg.height, 128, 8, **kw)
            want_frame = _eager(r, pipe, mesh, u(t))
            assert profiling.ROUTES_TAKEN["triangle_templates"] == before + 1
        torch.cuda.synchronize()
        assert n == 1_000_000 and got_planes.shape == (n, 27)
        assert torch.equal(got_planes.view(torch.int32), want_planes.view(torch.int32)), t
        assert torch.equal(got_bin.records, want_bin.records), t
        assert torch.equal(got_bin.frecords.view(torch.int32), want_bin.frecords.view(torch.int32)), t
        for i, key in ((0, "colour"), (1, "depth_q"), (2, "tri_id")):
            assert torch.equal(got_frame[i], want_frame[i]), (t, key)
