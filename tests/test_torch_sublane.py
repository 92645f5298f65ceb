"""The port's plain sublane raster vs rasterize_vis_pallas(sublane=True, interpret=True).

tri_id and depth_q are exact under every ordered compare, group size and
band binning, ties included; the float planes agree within atol 2e-4,
the JAX package's barycentric tolerance (tests/test_pallas.py:40).  The
plain sublane raster is also held against the port's plain sequential
raster (ints exact, floats bitwise) and band binning against the
unbanded stream (bit for bit).
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
from based_renderer_tpu_torch.utils import profiling

ATOL = 2e-4
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("scissor",))
TIE = np.asarray([[[-0.5, -0.5, 0.3, 1], [0.5, -0.5, 0.3, 1], [0, 0.5, 0.3, 1]]], np.float32)


def random_clip(seed, n=24, z_lo=0.0, z_hi=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(z_lo, z_hi, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _both(clip, W, H, channels=None, init=None, **kw):
    """(port, jax) sublane outputs of one draw; ``init`` is a (port, jax) pair."""
    kw = dict(tile_w=128, tile_h=8, sublane=True, **kw)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, scissor=kw.get("scissor"))
    js = _jax_setup(jnp.asarray(clip), W, H, scissor=kw.get("scissor"))
    t_init, j_init = (None, None) if init is None else init
    t = traster.rasterize_vis(
        ts, W, H, channels=None if channels is None else torch.from_numpy(channels), init=t_init, **kw
    )
    j = rasterize_vis_pallas(
        js, W, H, channels=None if channels is None else jnp.asarray(channels), init=j_init, interpret=True, **kw
    )
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


def _bits_equal(a, b):
    for x, y in zip(a, b, strict=True):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _flat(out):
    """VisBuffer or (vis, interp, invw) -> list of tensors."""
    if isinstance(out, traster.VisBuffer):
        return list(out[:5])
    vis, interp, invw = out
    return list(vis[:5]) + [interp, invw]


@pytest.mark.parametrize("compare", ["less", "less_equal", "greater", "greater_equal"])
def test_compares_with_channels(compare):
    clip = random_clip(21, 40)
    ch = np.random.default_rng(2).normal(size=(40, 3, 3)).astype(np.float32)
    clear = 0.5 if compare.startswith("greater") else 1.0
    t, j = _both(clip, 96, 64, ch, depth_compare=compare, depth_clear=clear)
    assert (t[0].tri_id >= 0).any()
    _assert_match(t, j)


@pytest.mark.parametrize("group", [8, 16, 32, 64])
@pytest.mark.parametrize("compare", ["less", "less_equal"])
def test_group_sizes_with_ties(compare, group):
    """Coplanar copies span the group boundaries of every size: the port's
    single result equals the JAX kernel at each raster_group."""
    clip = np.concatenate([random_clip(31, 40)] + [TIE] * 70)
    t, j = _both(clip, 96, 64, depth_compare=compare, sublane_group=group)
    _assert_match(t, j)


@pytest.mark.parametrize("compare", ["less", "less_equal", "greater", "greater_equal"])
def test_equal_depth_ties(compare):
    """The winner of 11 coplanar copies is decided by the tie rule alone:
    the first for strict compares, the last for the *_equal ones."""
    clear = 0.0 if compare.startswith("greater") else 1.0
    t, j = _both(np.concatenate([TIE] * 11), 96, 64, depth_compare=compare, depth_clear=clear)
    _assert_match(t, j)
    win = np.unique(t.tri_id.numpy()[t.tri_id.numpy() >= 0])
    assert win.tolist() == [0 if compare in ("less", "greater") else 10]


@pytest.mark.parametrize(
    "kw",
    [
        dict(depth_clip="clamp", depth_compare="greater_equal", depth_clear=0.0),
        dict(depth_clip=False),
        dict(scissor=(13, 5, 81, 58)),
    ],
)
def test_clip_clamp_and_scissor(kw):
    clip = random_clip(7, 32, z_lo=-0.6, z_hi=1.6)  # fragments outside [0, 1]
    ch = np.random.default_rng(9).normal(size=(32, 3, 1)).astype(np.float32)
    t, j = _both(clip, 96, 64, ch, **kw)
    _assert_match(t, j)


def test_init_chain_large_id_offset():
    """A second draw continues the first's buffer; ids past 2^20 round-trip."""
    clip_a, clip_b = random_clip(22, 16), random_clip(23, 24)
    rng = np.random.default_rng(24)
    ch_a = rng.normal(size=(16, 3, 2)).astype(np.float32)
    ch_b = rng.normal(size=(24, 3, 2)).astype(np.float32)
    ta, ja = _both(clip_a, 100, 70, ch_a)
    _assert_match(ta, ja)
    tb, jb = _both(clip_b, 100, 70, ch_b, init=(ta[0], ja[0]), id_offset=1 << 20)
    _assert_match(tb, jb)
    ids = tb[0].tri_id
    assert ((ids >= 0) & (ids < 16)).any() and (ids >= 1 << 20).any()


def _scene(seed, n, W, H):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.1, 1.1, size=(n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, size=(n, 3, 1)).astype(np.float32)
    return np.concatenate([xy, z, np.ones((n, 3, 1), np.float32)], -1)


@pytest.mark.parametrize("bin_rows", [1, 2, 4, 8])
@pytest.mark.parametrize("depth_clip", [True, False])
def test_band_binning_bit_identical(bin_rows, depth_clip):
    """Band binning (test_bin_rows.py): bit-identical to the unbanded stream."""
    W, H = 256, 96
    clip = _scene(3, 120, W, H)
    ch = np.random.default_rng(4).normal(size=(120, 3, 4)).astype(np.float32)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    kw = dict(
        tile_w=128, tile_h=8, sublane=True, sublane_group=16, channels=torch.from_numpy(ch),
        depth_clip=depth_clip, max_pairs=120 * 128, slots=120 * 128,
    )
    base = traster.rasterize_vis(ts, W, H, **kw)
    band = traster.rasterize_vis(ts, W, H, bin_rows=bin_rows, **kw)
    _bits_equal(_flat(base), _flat(band))
    assert (base[0].tri_id >= 0).sum() > 1000


def test_band_binning_matches_jax_with_init():
    W, H = 256, 96
    clip_a, clip_b = _scene(11, 40, W, H), _scene(12, 40, W, H)
    kw = dict(bin_rows=2, max_pairs=40 * 128, slots=40 * 128)
    ta, ja = _both(clip_a, W, H, **kw)
    _assert_match(ta, ja)
    tb, jb = _both(clip_b, W, H, init=(ta, ja), id_offset=40, **kw)
    _assert_match(tb, jb)


def test_band_binning_overflow_surfaces():
    W, H = 256, 96
    ts = tsetup.setup_triangles(torch.from_numpy(_scene(3, 4, W, H)), W, H)
    kw = dict(tile_w=128, tile_h=8, sublane=True, return_overflow=True)
    assert not bool(traster.rasterize_vis(ts, W, H, max_pairs=256, slots=256, **kw)[1])
    assert bool(traster.rasterize_vis(ts, W, H, bin_rows=1, max_pairs=256, slots=256, **kw)[1])
    assert not bool(traster.rasterize_vis(ts, W, H, bin_rows=1, max_pairs=2048, slots=2048, **kw)[1])


@pytest.mark.parametrize("compare", ["less", "less_equal", "greater", "greater_equal"])
@pytest.mark.parametrize("tile_h", [8, 32])
def test_plain_sublane_equals_plain_sequential(compare, tile_h):
    """On eligible modes the two plain rasters agree: ints exact, floats bitwise."""
    clip = np.concatenate([random_clip(41, 60, z_lo=-0.3, z_hi=1.3)] + [TIE] * 5)
    ch = np.random.default_rng(42).normal(size=(65, 3, 2)).astype(np.float32)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 200, 90)
    b = traster.bin_triangles(ts, 200, 90, 128, tile_h, channels=torch.from_numpy(ch), assemble="pallas")
    kw = dict(tile_w=128, tile_h=tile_h, depth_compare=compare, num_channels=2,
              depth_clear=0.5 if compare.startswith("greater") else 1.0)
    seq = traster.rasterize_binned_reference(b, 200, 90, **kw)
    sub = traster.rasterize_binned_sublane_reference(b, 200, 90, **kw)
    _bits_equal(_flat(seq), _flat(sub))
    assert (sub[0].tri_id >= 0).sum() > 1000


def test_cpu_tensors_take_the_plain_version():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(11, 16)), 64, 64)
    b = traster.bin_triangles(ts, 64, 64, 128, 8)
    before = profiling.ROUTES_TAKEN["raster_sublane"]
    a = traster.rasterize_binned(b, 64, 64, 128, 8, sublane=True)
    c = traster.rasterize_binned_sublane_reference(b, 64, 64, 128, 8)
    assert profiling.ROUTES_TAKEN["raster_sublane"] == before
    _bits_equal(list(a[:5]), list(c[:5]))


@pytest.mark.parametrize(
    "kw",
    [
        dict(depth_compare="not_equal"),
        dict(depth_test=False),
        dict(depth_write=False),
        dict(two_pass=True),
        dict(batch=8),
        dict(tile_w=64),
        dict(sublane_group=12),
        dict(bin_rows=3),
    ],
)
def test_ineligible_modes_raise_value_error(kw):
    """The JAX package's ValueErrors, raised in both packages."""
    clip = random_clip(12, 4)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 64, 64)
    js = _jax_setup(jnp.asarray(clip), 64, 64)
    kw = {"tile_w": 128, "tile_h": 8, **kw}
    with pytest.raises(ValueError):
        traster.rasterize_vis(ts, 64, 64, sublane=True, **kw)
    with pytest.raises(ValueError):
        rasterize_vis_pallas(js, 64, 64, sublane=True, interpret=True, **kw)


def test_band_binning_requires_sublane():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(12, 4)), 64, 64)
    with pytest.raises(ValueError, match="sublane"):
        traster.rasterize_vis(ts, 64, 64, tile_w=128, tile_h=8, bin_rows=4)
    # Band binning has no MSAA form: the JAX package's ValueError.
    with pytest.raises(ValueError, match="msaa4"):
        traster.rasterize_vis(ts, 64, 64, tile_w=128, tile_h=8, sublane=True, msaa4=True, bin_rows=4)
