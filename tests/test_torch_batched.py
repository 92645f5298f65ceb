"""The batched route (``batch``, B7) vs the JAX package's _raster_kernel_batched.

On CUDA tensors ``rasterize_binned(batch=n)`` launches the sublane kernel
(csrc/raster_sublane.cu) at any tile that divides 128; on CPU tensors it
takes that kernel's plain version, the per-pixel key reduction.  Held
against ``rasterize_vis_pallas(batch=8 or 16, interpret=True)``: tri_id and
depth_q exact under the four ordered compares at tiles 32x16 and 128x8,
ties across batches included; the float
planes within atol 2e-4 (tests/test_pallas.py:40).  The same ValueErrors as
the JAX package, and the renderer's fallback warnings
(tests/test_renderer.py:244-273).
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu.pipeline import StencilState as JStencilState
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.utils import errors as terrors
from based_renderer_tpu_torch.utils import profiling

W, H = 96, 64
ATOL = 2e-4
TIE = np.asarray([[[-0.5, -0.5, 0.3, 1], [0.5, -0.5, 0.3, 1], [0, 0.5, 0.3, 1]]], np.float32)
ORDERED = ["less", "less_equal", "greater", "greater_equal"]
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("scissor",))


def random_clip(seed, n=24, z_lo=0.0, z_hi=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(z_lo, z_hi, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _both(clip, channels=None, init=None, **kw):
    """(port, jax) batched outputs of one draw; ``init`` is a (port, jax) pair."""
    kw = dict(dict(tile_w=32, tile_h=16, batch=8), **kw)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, scissor=kw.get("scissor"))
    js = _jax_setup(jnp.asarray(clip), W, H, scissor=kw.get("scissor"))
    t_init, j_init = (None, None) if init is None else init
    t_ch = None if channels is None else torch.from_numpy(channels)
    j_ch = None if channels is None else jnp.asarray(channels)
    t = traster.rasterize_vis(ts, W, H, channels=t_ch, init=t_init, **kw)
    j = rasterize_vis_pallas(js, W, H, channels=j_ch, init=j_init, interpret=True, **kw)
    return t, j


def _assert_match(t, j):
    if not isinstance(t, traster.VisBuffer):
        (tv, ti, tw), (jv, ji, jw) = t, j
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=ATOL)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=ATOL)
    else:
        tv, jv = t, j
    np.testing.assert_array_equal(tv.tri_id.numpy(), np.asarray(jv.tri_id))
    np.testing.assert_array_equal(tv.depth_q.numpy(), np.asarray(jv.depth_q))
    for k in ("b0", "b1", "b2"):
        np.testing.assert_allclose(getattr(tv, k).numpy(), np.asarray(getattr(jv, k)), rtol=0, atol=ATOL)
    assert tv.stencil is None


@pytest.mark.parametrize("tile", [(32, 16), (128, 8)])
@pytest.mark.parametrize("compare", ORDERED)
def test_compares_and_tiles(compare, tile):
    clip = np.concatenate([random_clip(21, 32)] + [TIE] * 3)
    ch = np.random.default_rng(2).normal(size=(35, 3, 1)).astype(np.float32)
    clear = 0.5 if compare.startswith("greater") else 1.0
    t, j = _both(clip, ch, tile_w=tile[0], tile_h=tile[1], depth_compare=compare, depth_clear=clear)
    assert (t[0].tri_id >= 0).any()
    _assert_match(t, j)


@pytest.mark.parametrize("compare", ["less", "less_equal"])
def test_coplanar_ties_across_batches(compare):
    """Nineteen coplanar copies span two batches of 16: the first wins
    under the strict compare, the last under the *_equal one."""
    t, j = _both(np.concatenate([TIE] * 19), batch=16, depth_compare=compare)
    _assert_match(t, j)
    win = np.unique(t.tri_id.numpy()[t.tri_id.numpy() >= 0])
    assert win.tolist() == [0 if compare == "less" else 18]


def test_init_chain():
    """A second draw continues the first's buffer: the winner is held
    against init, and b2 is derived where tri_id >= 0 (raster_pallas.py:705)."""
    ch_a, ch_b = (np.random.default_rng(s).normal(size=(16, 3, 1)).astype(np.float32) for s in (3, 4))
    ta, ja = _both(random_clip(22, 16), ch_a)
    _assert_match(ta, ja)
    tb, jb = _both(random_clip(23, 16), ch_b, init=(ta[0], ja[0]), id_offset=16)
    _assert_match(tb, jb)
    ids = tb[0].tri_id
    assert ((ids >= 0) & (ids < 16)).any() and (ids >= 16).any()


def test_clamp_and_scissor():
    clip = random_clip(7, 32, z_lo=-0.6, z_hi=1.6)  # fragments outside [0, 1]
    ch = np.random.default_rng(9).normal(size=(32, 3, 1)).astype(np.float32)
    t, j = _both(clip, ch, depth_clip="clamp", depth_compare="greater_equal", depth_clear=0.0,
                 scissor=(13, 5, 81, 58))
    _assert_match(t, j)
    assert (t[0].tri_id[:5] == -1).all() and (t[0].tri_id >= 0).any()


@pytest.mark.parametrize("tile_h", [16, 32])
def test_plain_batched_equals_plain_sequential(tile_h):
    """On CPU tensors the batched route is the sublane plain version, at a
    tile narrower than 128: ints exact, floats bitwise against the plain
    sequential raster, and no kernel launch counted."""
    clip = np.concatenate([random_clip(41, 40, z_lo=-0.3, z_hi=1.3)] + [TIE] * 5)
    ch = np.random.default_rng(42).normal(size=(45, 3, 2)).astype(np.float32)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 100, 70)
    b = traster.bin_triangles(ts, 100, 70, 32, tile_h, channels=torch.from_numpy(ch))
    kw = dict(tile_w=32, tile_h=tile_h, num_channels=2)
    before = profiling.ROUTES_TAKEN["raster_batched"]
    bat = traster.rasterize_binned(b, 100, 70, batch=16, **kw)
    seq = traster.rasterize_binned_reference(b, 100, 70, **kw)
    assert profiling.ROUTES_TAKEN["raster_batched"] == before
    for x, y in zip(list(bat[0][:5]) + list(bat[1:]), list(seq[0][:5]) + list(seq[1:])):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "kw",
    [
        dict(depth_compare="not_equal"),
        dict(depth_test=False),
        dict(depth_write=False),
        dict(stencil="on"),
        dict(msaa4=True),
        dict(two_pass=True),
        dict(batch=12),
        dict(sublane=True, tile_w=128, tile_h=8),
    ],
)
def test_ineligible_modes_raise_value_error(kw):
    """The JAX package's ValueErrors (raster_pallas.py:1945-2011), in both packages."""
    clip = random_clip(12, 4)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 64, 64)
    js = _jax_setup(jnp.asarray(clip), 64, 64)
    t_kw, j_kw = {"batch": 8, **kw}, {"batch": 8, **kw}
    if "stencil" in kw:
        t_kw["stencil"] = tbrt.StencilState(enable=True)
        j_kw["stencil"] = JStencilState(enable=True)
    with pytest.raises(ValueError) as t_err:
        traster.rasterize_vis(ts, 64, 64, **t_kw)
    with pytest.raises(ValueError) as j_err:
        rasterize_vis_pallas(js, 64, 64, interpret=True, **j_kw)
    assert str(t_err.value) == str(j_err.value)


def test_kernel_fallback_signals():
    """On the Pallas backend, a requested-but-ineligible raster_batch or
    raster_sublane warns and runs the sequential raster (DrawError in debug
    mode); eligible draws stay quiet, and a batched draw renders the
    sequential frame."""
    cfg = tbrt.RendererConfig(width=256, height=128, raster_backend="pallas")
    r = tbrt.Renderer(cfg, device="cpu")
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    bad = dataclasses.replace(pipe, raster_sublane=True, depth=tbrt.DepthState(test=False, write=False))
    with pytest.warns(RuntimeWarning, match="raster_sublane"):
        r.render_frame(bad, mesh, u(0.0))
    for state, why in (
        (dict(depth=tbrt.DepthState(compare="not_equal")), "unordered depth compare"),
        (dict(stencil=tbrt.StencilState(enable=True)), "stencil enabled"),
        (dict(raster_two_pass=True), "two-pass"),
    ):
        with pytest.warns(RuntimeWarning, match=f"raster_batch.*{why}"):
            r.render_frame(dataclasses.replace(pipe, raster_batch=8, **state), mesh, u(0.0))
    with pytest.warns(RuntimeWarning, match="coverage-sample MSAA"):
        tbrt.Renderer(dataclasses.replace(cfg, msaa=4), device="cpu").render_frame(
            dataclasses.replace(pipe, raster_batch=8), mesh, u(0.0)
        )
    ok = dataclasses.replace(pipe, raster_batch=8, raster_tile=(64, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fb = r.render_frame(ok, mesh, u(0.3))
        r.render_frame(dataclasses.replace(pipe, raster_sublane=True, raster_tile=(128, 8)), mesh, u(0.0))
    fs = r.render_frame(dataclasses.replace(ok, raster_batch=0), mesh, u(0.3))
    assert torch.equal(fb.tri_id, fs.tri_id) and torch.equal(fb.depth_q, fs.depth_q)
    with pytest.raises(terrors.DrawError, match="ineligible"):
        tbrt.Renderer(dataclasses.replace(cfg, debug=True), device="cpu").render_frame(bad, mesh, u(0.0))
