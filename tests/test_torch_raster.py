"""The port's plain raster vs the JAX Pallas kernel run in interpret mode.

tri_id and depth_q are exact; the float planes (b0, b1, b2, invw and the
channels) agree within atol 2e-4, the JAX package's own barycentric
tolerance (tests/test_pallas.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.utils.errors import FeatureNotPresentError

ATOL = 2e-4
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("scissor",))


def random_clip(seed, n=24, z_lo=0.0, z_hi=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(z_lo, z_hi, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def small_tris(seed, n, center=(0.0, 0.0), spread=0.2, size=0.15):
    """n small triangles around one point, random depths (dense tiles)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, size=(n, 1, 2)).astype(np.float32) + np.float32(center)
    d = rng.uniform(-size, size, size=(n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, size=(n, 1, 1)).astype(np.float32).repeat(3, 1)
    return np.concatenate([c + d, z, np.ones((n, 3, 1), np.float32)], -1)


def _render_both(clip, W, H, channels=None, init=None, **kw):
    """(port, jax) outputs of one draw; ``init`` is a (port, jax) pair."""
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, scissor=kw.get("scissor"))
    js = _jax_setup(jnp.asarray(clip), W, H, scissor=kw.get("scissor"))
    t_ch = None if channels is None else torch.from_numpy(channels)
    j_ch = None if channels is None else jnp.asarray(channels)
    t_init, j_init = (None, None) if init is None else init
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


@pytest.mark.parametrize("tile", [(128, 32), (128, 8), (64, 64)])
def test_tiles_with_channels(tile):
    clip = random_clip(0, 40)
    ch = np.random.default_rng(1).normal(size=(40, 3, 3)).astype(np.float32)
    t, j = _render_both(clip, 128, 96, ch, tile_w=tile[0], tile_h=tile[1])
    assert (t[0].tri_id >= 0).any()
    _assert_match(t, j)


def test_ragged_extent_init_chain():
    """100x70 pads to the tile grid and crops; the second draw continues
    the first's visibility (invw/channels restart at 1/0)."""
    W, H = 100, 70
    clip_a, clip_b = random_clip(2, 10), random_clip(3, 14)
    ch_a = np.random.default_rng(4).normal(size=(10, 3, 2)).astype(np.float32)
    ch_b = np.random.default_rng(5).normal(size=(14, 3, 2)).astype(np.float32)
    ta, ja = _render_both(clip_a, W, H, ch_a)
    _assert_match(ta, ja)
    tb, jb = _render_both(clip_b, W, H, ch_b, init=(ta[0], ja[0]), id_offset=10)
    _assert_match(tb, jb)
    assert tb[0].tri_id.shape == (H, W)
    assert ((tb[0].tri_id >= 0) & (tb[0].tri_id < 10)).any()  # draw A survives
    assert (tb[0].tri_id >= 10).any()


@pytest.mark.parametrize(
    "compare", ["never", "less", "equal", "less_equal", "greater", "not_equal", "greater_equal", "always"]
)
def test_depth_compares(compare):
    # Draw every triangle twice: exact depth ties decide equal/less_equal.
    clip = np.repeat(small_tris(6, 12, spread=0.5, size=0.4), 2, axis=0)
    t, j = _render_both(clip, 64, 32, tile_w=64, tile_h=32, depth_compare=compare, depth_clear=0.5)
    _assert_match(t, j)


@pytest.mark.parametrize(
    "kw",
    [
        dict(depth_clip=False),
        dict(depth_clip="clamp", depth_compare="greater_equal", depth_clear=0.0),
        dict(depth_test=False, depth_write=False),
        dict(depth_write=False),
    ],
)
def test_clip_clamp_and_depth_state(kw):
    clip = random_clip(7, 32, z_lo=-0.6, z_hi=1.6)  # fragments outside [0, 1]
    t, j = _render_both(clip, 96, 64, tile_w=32, tile_h=32, **kw)
    _assert_match(t, j)


def test_scissor():
    clip = random_clip(8, 32)
    ch = np.random.default_rng(9).normal(size=(32, 3, 1)).astype(np.float32)
    t, j = _render_both(clip, 128, 64, ch, tile_w=64, tile_h=16, scissor=(13, 5, 101, 58))
    _assert_match(t, j)
    assert (t[0].tri_id[:5] == -1).all() and (t[0].tri_id[:, 101:] == -1).all()


def test_tile_with_over_128_records():
    clip = small_tris(10, 300, spread=0.3, size=0.3)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 32, 32)
    binned = traster.bin_triangles(ts, 32, 32, 32, 32)
    assert int(binned.tile_count.max()) > 128
    t, j = _render_both(clip, 32, 32, tile_w=32, tile_h=32)
    _assert_match(t, j)


def test_plain_version_is_the_cpu_path():
    clip = random_clip(11, 16)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 64, 64)
    binned = traster.bin_triangles(ts, 64, 64, 64, 32)
    before = traster.KERNEL_LAUNCHES
    a = traster.rasterize_binned(binned, 64, 64, 64, 32)
    b = traster.rasterize_binned_reference(binned, 64, 64, 64, 32)
    assert traster.KERNEL_LAUNCHES == before  # no kernel on CPU tensors
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "kw",
    [dict(two_pass=True), dict(msaa4=True), dict(batch=8), dict(sublane=True), dict(bin_rows=4)],
)
def test_out_of_slice_raises(kw):
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(12, 4)), 64, 64)
    with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
        traster.rasterize_vis(ts, 64, 64, **kw)


def test_schedule_knobs_change_nothing():
    clip = random_clip(13, 20)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 64, 64)
    base = traster.rasterize_vis(ts, 64, 64)
    other = traster.rasterize_vis(ts, 64, 64, skip_losers=True, unroll=4)
    for x, y in zip(base[:5], other[:5]):
        assert torch.equal(x, y)
