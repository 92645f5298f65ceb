"""The vertex stage's point transform (ops/transform.py,
csrc/transform_points.cu).

On the CPU ``math3d.transform_points`` and ``transform_directions`` take
the plain version, which is held here bit for bit to a fixed-order numpy
statement of the arithmetic the kernel follows: f32 throughout, one
rounding per product and sum, the columns summed in order, a 3-wide
point's 1 as a product like any other.  The cases cover 3- and 4-wide
points, a (3, 3) matrix, per-point (N, 4, 4) matrices and values whose
products round, overflow or meet negative zero and infinities.  The
vertex stage's outputs on the CPU equal those of the elementwise code it
replaced.  The tests marked ``cuda`` hold the kernel to the plain version
on the card and skip here; run them there with

    python3 -m pytest tests/test_torch_transform.py -m cuda --noconftest -s

This file imports nothing of JAX, so it runs on the card's host.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as brt
from based_renderer_tpu_torch import math3d
from based_renderer_tpu_torch.ops import transform, vertex
from based_renderer_tpu_torch.ops.vertex import expand_instances
from based_renderer_tpu_torch.utils import profiling
from based_renderer_tpu_torch.utils.errors import FeatureNotPresentError


def transform_numpy(m, v):
    """``m @ [v, 1]`` (or ``m @ v``) per point as the kernel computes it,
    output element by element, in numpy float32: (N, R)."""
    f = np.float32
    n, r, c = v.shape[0], m.shape[-2], m.shape[-1]
    per = m if m.ndim == 3 else np.broadcast_to(m, (n, r, c))
    cols = [v[:, j] for j in range(v.shape[1])]
    if c == v.shape[1] + 1:
        cols.append(np.ones(n, f))
    out = np.empty((n, r), f)
    for i in range(r):
        acc = per[:, i, 0] * cols[0]
        for j in range(1, c):
            acc = acc + per[:, i, j] * cols[j]
        out[:, i] = acc
    return out


def _rounding_values(rng, shape, inf: bool):
    """Magnitudes from 1e-22 to 1e22 of both signs, with negative zeros
    (and, with ``inf``, infinities) sprinkled in: products that round,
    overflow and underflow."""
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-22, 23, size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    if not flat.size:
        return x
    flat[rng.integers(0, flat.size, size=max(flat.size // 16, 1))] = -0.0
    if inf:
        flat[rng.integers(0, flat.size, size=max(flat.size // 64, 1))] = np.inf
        flat[rng.integers(0, flat.size, size=max(flat.size // 64, 1))] = -np.inf
    return x


# name: (matrix shape from N, point width, values): points of 3 or 4
# floats, a (3, 3) rotation of directions, per-point matrices.
CASES = {
    "points3_shared4x4": (lambda n: (4, 4), 3, "normal"),
    "points4_shared4x4": (lambda n: (4, 4), 4, "normal"),
    "directions_shared3x3": (lambda n: (3, 3), 3, "normal"),
    "points3_per_point4x4": (lambda n: (n, 4, 4), 3, "normal"),
    "points4_per_point4x4": (lambda n: (n, 4, 4), 4, "normal"),
    "points3_shared4x4_rounding": (lambda n: (4, 4), 3, "rounding"),
    "points4_per_point4x4_rounding": (lambda n: (n, 4, 4), 4, "rounding"),
    "points3_shared3x4": (lambda n: (3, 4), 3, "normal"),
}


def operands(name, n=257):
    shape, width, values = CASES[name]
    rng = np.random.default_rng(len(name))
    if values == "rounding":  # infinities in the points only, and points of negative zeros
        m, v = _rounding_values(rng, shape(n), False), _rounding_values(rng, (n, width), True)
        v[1::37] = -0.0
    else:
        m = rng.normal(size=shape(n)).astype(np.float32) * np.float32(3)
        v = rng.uniform(-50, 50, size=(n, width)).astype(np.float32)
    return m, v


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("name", CASES)
def test_plain_transform_equals_the_fixed_order_statement(name):
    m, v = operands(name)
    before = profiling.ROUTES_TAKEN["transform_points"]
    got = transform.transform_points(torch.from_numpy(m), torch.from_numpy(v))
    assert profiling.ROUTES_TAKEN["transform_points"] == before  # the CPU launches nothing
    assert got.dtype == torch.float32 and got.shape == (v.shape[0], m.shape[-2])
    with np.errstate(over="ignore", invalid="ignore"):
        want = transform_numpy(m, v)
    if "rounding" in name:  # the case reaches every regime it is there for
        per = m if m.ndim == 3 else m[None]
        a, b = per[..., : v.shape[1]], v[:, None, :]
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            prod = a * b
        finite = np.isfinite(a) & np.isfinite(b) & (a != 0) & (b != 0)
        assert np.isinf(prod[finite]).any()  # overflow
        assert (np.abs(prod[finite]) < np.finfo(np.float32).tiny).any()  # underflow
        assert (np.signbit(prod) & (prod == 0)).any()  # negative zeros
        assert np.isinf(want).any() and np.isnan(want).any()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---- the vertex stage on the CPU, against the code it replaced ----------


def _old_combine_columns(m, v):
    out = m[..., :, 0] * v[..., 0:1]
    for j in range(1, v.shape[-1]):
        out = out + m[..., :, j] * v[..., j : j + 1]
    return out


def _old_transform_points(m, pts):
    pts = pts.to(torch.float32)
    if pts.shape[-1] == 3:
        pts = torch.cat([pts, torch.ones((*pts.shape[:-1], 1), dtype=torch.float32)], -1)
    return _old_combine_columns(m.to(torch.float32), pts)


def _old_apply_instance_transform(attrs):
    p = attrs["position"]
    if p.shape[-1] == 3:
        p = torch.cat([p, torch.ones((*p.shape[:-1], 1), dtype=torch.float32)], -1)
    return _old_combine_columns(attrs["transform"].reshape(-1, 4, 4), p)


@pytest.mark.parametrize("name", ["points3_shared4x4", "points4_shared4x4", "points3_shared4x4_rounding"])
def test_math3d_transform_points_unchanged_on_cpu(name):
    m, v = map(torch.from_numpy, operands(name))
    got = math3d.transform_points(m, v)
    assert torch.equal(got.view(torch.int32), _old_transform_points(m, v).view(torch.int32))
    dirs = v[:, :3]
    assert torch.equal(math3d.transform_directions(m, dirs).view(torch.int32),
                       _old_combine_columns(m[:3, :3], dirs).view(torch.int32))


@pytest.mark.parametrize("width", [3, 4])
def test_apply_instance_transform_unchanged_on_cpu(width):
    """The instanced demo's table, expanded per corner (4-wide corners are
    what the instance cull transforms)."""
    r = brt.Renderer(brt.RendererConfig(128, 96), device="cpu")
    _, mesh, _, inst = brt.demos.instanced_demo(r, count=32)
    attrs, _ = expand_instances(mesh, inst)
    if width == 4:
        p = attrs["position"]
        attrs = {**attrs, "position": torch.cat([p, torch.ones((p.shape[0], 1))], -1)}
    got = vertex.apply_instance_transform(attrs)
    assert got.shape == (attrs["position"].shape[0], 4)
    assert torch.equal(got.view(torch.int32), _old_apply_instance_transform(attrs).view(torch.int32))


@pytest.mark.parametrize("bad", ["points_float64", "matrix_float64", "points_3d", "matrix_5x5", "width_mismatch",
                                 "per_point_rows", "matrix_device"])
def test_kernel_wrapper_refuses_bad_operands(bad):
    """The wrapper's checks run before the library loads, so they raise here."""
    m, v = torch.ones(4, 4), torch.ones(8, 3)
    if bad == "points_float64":
        v = v.double()
    elif bad == "matrix_float64":
        m = m.double()
    elif bad == "points_3d":
        v = torch.ones(2, 4, 3)
    elif bad == "matrix_5x5":
        m, v = torch.ones(5, 5), torch.ones(8, 5)
    elif bad == "width_mismatch":
        v = torch.ones(8, 2)
    elif bad == "per_point_rows":
        m = torch.ones(7, 4, 4)
    else:
        m = m.to("meta")
    before = profiling.ROUTES_TAKEN["transform_points"]
    with pytest.raises((ValueError, TypeError)):
        transform._transform_kernel(m, v)
    assert profiling.ROUTES_TAKEN["transform_points"] == before


def test_no_path_for_other_devices():
    with pytest.raises(FeatureNotPresentError):
        transform.transform_points(torch.ones(4, 4, device="meta"), torch.ones(8, 3, device="meta"))


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python3 -m pytest tests/test_torch_transform.py -m cuda --noconftest`")
    return torch.device("cuda")


@pytest.fixture
def plain_transform(monkeypatch):
    """A context in which the vertex stage transforms with the plain
    version on the card, as the tree did before the kernel."""

    kernel_path = transform.transform_points

    class Plain:
        def __enter__(self):
            monkeypatch.setattr(transform, "transform_points", transform.transform_points_reference)

        def __exit__(self, *exc):
            monkeypatch.setattr(transform, "transform_points", kernel_path)

    return Plain()


def _launched(fn):
    before = profiling.ROUTES_TAKEN["transform_points"]
    out = fn()
    return out, profiling.ROUTES_TAKEN["transform_points"] - before


def _equal_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 257, 100_003])
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_the_plain_version_bitwise(cuda_device, name, n):
    m, v = (torch.from_numpy(x).to(cuda_device) for x in operands(name, n))
    got, launches = _launched(lambda: transform.transform_points(m, v))
    want = transform.transform_points_reference(m, v)
    assert launches == 1 and got.shape == want.shape
    assert _equal_bits(got, want)


def _vertex_inputs(r, demo, dev):
    """The demo's shader, its per-corner attributes and its uniforms on
    ``dev`` at a time t."""
    pipe, mesh, uniforms, inst = getattr(brt.demos, demo)(r)
    attrs, _ = expand_instances(mesh, inst)
    return brt.shader.get(pipe.shader), attrs, lambda t: {k: v.to(dev) for k, v in uniforms(t).items()}


@pytest.mark.cuda
def test_big_mesh_4k_vertex_stage_unchanged(cuda_device, plain_transform):
    """The 4K blinn_phong draw's 3M corners: at three views the clip
    coordinates and pos_ws with the kernel equal the plain version's bit
    for bit; the vertex stage takes the route twice (MVP and model)."""
    r = brt.Renderer(brt.RendererConfig(3840, 2160, msaa=4), device=cuda_device)
    shd, attrs, uniforms = _vertex_inputs(r, "big_mesh_demo", cuda_device)
    for t in (0.3, 2.1, 4.7):
        u = uniforms(t)
        (clip, var), launches = _launched(lambda: shd.vertex(attrs, u))
        with plain_transform:
            (want_clip, want_var), plain = _launched(lambda: shd.vertex(attrs, u))
        torch.cuda.synchronize()
        assert clip.shape == (3_000_000, 4) and (launches, plain) == (2, 0)
        assert _equal_bits(clip, want_clip), t
        assert _equal_bits(var["pos_ws"], want_var["pos_ws"]), t


@pytest.mark.cuda
def test_instanced_field_positions_unchanged(cuda_device, plain_transform):
    """The 10k-instance field's 360k corners: world positions (per-point
    matrices) and clip coordinates equal the plain version's bit for bit;
    the shader takes the route twice."""
    r = brt.Renderer(brt.RendererConfig(1920, 1080), device=cuda_device)
    shd, attrs, uniforms = _vertex_inputs(r, "instanced_demo", cuda_device)
    for t in (0.0, 1.3):
        u = uniforms(t)
        world, launches = _launched(lambda: vertex.apply_instance_transform(attrs))
        (clip, _), shader_launches = _launched(lambda: shd.vertex(attrs, u))
        with plain_transform:
            want_world = vertex.apply_instance_transform(attrs)
            want_clip, _ = shd.vertex(attrs, u)
        torch.cuda.synchronize()
        assert world.shape == (360_000, 4) and (launches, shader_launches) == (1, 2)
        assert _equal_bits(world, want_world) and _equal_bits(clip, want_clip), t


# (demo, config, transform launches an eager frame)
FRAMES = {
    "cube_1080p": ("cube_demo", dict(width=1920, height=1080), 1),
    "big_mesh_4k_msaa4": ("big_mesh_demo", dict(width=3840, height=2160, msaa=4), 2),
    "instanced_10k_1080p": ("instanced_demo", dict(width=1920, height=1080), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", FRAMES)
def test_eager_frames_unchanged(cuda_device, plain_transform, name):
    """An eager frame of each benchmarked configuration with the kernel
    equals the plain path's (colour, tri_id, depth_q bitwise) at two
    views, and takes the route as often as its shader transforms."""
    demo, cfg, want_launches = FRAMES[name]
    r = brt.Renderer(brt.RendererConfig(**cfg), device=cuda_device)
    pipe, mesh, uniforms, inst = getattr(brt.demos, demo)(r)

    def eager(t):
        r.begin_frame()
        r.draw(pipe, mesh, uniforms(t), instances=inst)
        return r._run_frame(*r.close_frame())

    for t in (0.4, 3.3):
        got, launches = _launched(lambda: eager(t))
        with plain_transform:
            want, plain = _launched(lambda: eager(t))
        torch.cuda.synchronize()
        assert (launches, plain) == (want_launches, 0)
        for i, key in ((0, "colour"), (1, "depth_q"), (2, "tri_id")):
            assert torch.equal(got[i], want[i]), (name, t, key)
