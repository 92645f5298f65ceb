"""The port's plain MSAA-4x sublane raster (B5's plain version) vs the JAX package.

Mirrors tests/test_msaa.py:91-151: per-sample tri_id and depth_q of
``rasterize_vis(msaa4=True, sublane=True)`` on CPU tensors equal
``rasterize_vis_pallas(msaa4=True, sublane=True, interpret=True)`` and the
numpy oracle, ties across group boundaries included; floats within atol
2e-4 (tests/test_pallas.py:40).  On eligible modes the plain B5 (a
per-(pixel, sample) key reduction) also equals the plain B4 (the
sequential loop): ints exact, floats bitwise, an independent check of
the tie rules.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu_torch.ops import fixedpoint as fp
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.reference import oracle
from based_renderer_tpu_torch.utils import profiling

W, H = 96, 64
ATOL = 2e-4
PAD = fp.MSAA4_BBOX_PAD_FP
TIE = np.asarray([[[-0.5, -0.5, 0.3, 1], [0.5, -0.5, 0.3, 1], [0, 0.5, 0.3, 1]]], np.float32)
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("bbox_pad_fp",))


def random_clip(seed, n=24, z_lo=0.0, z_hi=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(z_lo, z_hi, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _tie_clip():
    """40 random triangles and 5 of them drawn 3 times more: exact depth
    ties that span group boundaries (tests/test_msaa.py:98)."""
    return np.concatenate([random_clip(20, 40), np.repeat(random_clip(20, 40)[:5], 3, axis=0)])


def _port(clip, channels=None, init=None, sublane=True, tile_h=8, **kw):
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=PAD)
    ch = None if channels is None else torch.from_numpy(channels)
    return traster.rasterize_vis(
        ts, W, H, tile_w=128, tile_h=tile_h, msaa4=True, sublane=sublane, channels=ch, init=init, **kw
    )


def _jax(clip, channels=None, init=None, **kw):
    js = _jax_setup(jnp.asarray(clip), W, H, bbox_pad_fp=PAD)
    ch = None if channels is None else jnp.asarray(channels)
    return rasterize_vis_pallas(
        js, W, H, tile_w=128, tile_h=8, msaa4=True, sublane=True, channels=ch, init=init, interpret=True, **kw
    )


def _flat(out):
    if hasattr(out, "tri_id"):  # a VisBuffer of either package
        return list(out[:5])
    vis, interp, invw = out
    return list(vis[:5]) + [interp, invw]


def _assert_match(t, j):
    t, j = _flat(t), [np.asarray(x) for x in _flat(j)]
    for x, y in zip(t[:2], j[:2], strict=True):
        assert x.shape[0] == 4
        np.testing.assert_array_equal(x.numpy(), y)
    for x, y in zip(t[2:], j[2:], strict=True):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=ATOL)


def _bits_equal(a, b):
    for x, y in zip(_flat(a), _flat(b), strict=True):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("compare", ["less", "less_equal"])
def test_sublane_matches_jax_and_sequential(compare, group):
    """Per-sample tri_id, depth, barycentrics, invw and channels equal the
    JAX MSAA sublane kernel, and the port's plain sequential MSAA raster
    bitwise, equal-depth ties across group boundaries included."""
    clip = _tie_clip()
    ch = np.random.default_rng(21).normal(size=(len(clip), 3, 4)).astype(np.float32)
    t = _port(clip, ch, depth_compare=compare, sublane_group=group)
    _assert_match(t, _jax(clip, ch, depth_compare=compare, sublane_group=group))
    _bits_equal(t, _port(clip, ch, sublane=False, depth_compare=compare))


@pytest.mark.parametrize("compare", ["greater", "greater_equal"])
def test_greater_compares_vs_oracle(compare):
    clip = _tie_clip()
    vis = _port(clip, depth_compare=compare, depth_clear=0.0)
    ora = oracle.rasterize_msaa4(clip, W, H, depth_compare=compare, depth_clear=0.0)
    np.testing.assert_array_equal(vis.tri_id.numpy(), ora["tri_id"])
    np.testing.assert_array_equal(vis.depth_q.numpy(), ora["depth_q"])


def test_no_depth_clip():
    """depth_clip=False (the JAX kernel's late-bias path): bit-identical."""
    clip = random_clip(22, 30, z_lo=-0.5, z_hi=1.5)
    t = _port(clip, depth_clip=False)
    _assert_match(t, _jax(clip, depth_clip=False))
    _bits_equal(t, _port(clip, sublane=False, depth_clip=False))


def test_init_chain():
    """init= chaining through the MSAA sublane raster matches JAX and one
    oracle pass over both draws."""
    clip_a, clip_b = random_clip(6, 10), random_clip(7, 14)
    ta, ja = _port(clip_a), _jax(clip_a)
    tb = _port(clip_b, init=ta, id_offset=10)
    _assert_match(tb, _jax(clip_b, init=ja, id_offset=10))
    ora = oracle.rasterize_msaa4(np.concatenate([clip_a, clip_b]), W, H)
    np.testing.assert_array_equal(tb.tri_id.numpy(), ora["tri_id"])
    np.testing.assert_array_equal(tb.depth_q.numpy(), ora["depth_q"])


@pytest.mark.parametrize("tile_h", [8, 32])
@pytest.mark.parametrize("compare", ["less", "less_equal", "greater", "greater_equal"])
def test_plain_sublane_equals_plain_sequential(compare, tile_h):
    """On eligible modes the two plain MSAA rasters agree: ints exact, floats bitwise."""
    clip = np.concatenate([random_clip(41, 36, z_lo=-0.3, z_hi=1.3)] + [TIE] * 4)
    ch = np.random.default_rng(42).normal(size=(40, 3, 2)).astype(np.float32)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), 200, 90, bbox_pad_fp=PAD)
    b = traster.bin_triangles(ts, 200, 90, 128, tile_h, channels=torch.from_numpy(ch), assemble="pallas", msaa4=True)
    kw = dict(tile_w=128, tile_h=tile_h, depth_compare=compare, num_channels=2,
              depth_clear=0.5 if compare.startswith("greater") else 1.0)
    seq = traster.rasterize_binned_msaa4_reference(b, 200, 90, **kw)
    sub = traster.rasterize_binned_msaa4_sublane_reference(b, 200, 90, **kw)
    _bits_equal(seq, sub)
    assert (sub[0].tri_id >= 0).sum() > 4000


@pytest.mark.parametrize("compare", ["less", "less_equal", "greater", "greater_equal"])
def test_equal_depth_ties(compare):
    """The winner of 11 coplanar copies is decided by the tie rule alone,
    in every sample layer: the first for strict compares, the last for the
    *_equal ones."""
    clear = 0.0 if compare.startswith("greater") else 1.0
    clip = np.concatenate([TIE] * 11)
    vis = _port(clip, depth_compare=compare, depth_clear=clear)
    _bits_equal(vis, _port(clip, sublane=False, depth_compare=compare, depth_clear=clear))
    ids = vis.tri_id.numpy()
    assert np.unique(ids[ids >= 0]).tolist() == [0 if compare in ("less", "greater") else 10]


def test_scissor_and_clamp():
    clip = random_clip(31, 30, z_lo=-0.6, z_hi=1.6)
    kw = dict(depth_clip="clamp", depth_compare="greater_equal", depth_clear=0.0, scissor=(13, 5, 81, 58))
    vis = _port(clip, **kw)
    _bits_equal(vis, _port(clip, sublane=False, **kw))
    assert (vis.tri_id[:, :5] == -1).all() and (vis.tri_id[:, :, 81:] == -1).all()


def test_bin_rows_with_msaa4_raises():
    """Band binning has no MSAA form: a ValueError in both packages."""
    clip = random_clip(12, 4)
    with pytest.raises(ValueError, match="msaa4"):
        _port(clip, bin_rows=4)
    with pytest.raises(ValueError, match="msaa4"):
        _jax(clip, bin_rows=4)


def test_cpu_tensors_take_the_plain_version():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(11, 16)), W, H, bbox_pad_fp=PAD)
    b = traster.bin_triangles(ts, W, H, 128, 8, msaa4=True)
    before = profiling.ROUTES_TAKEN["raster_msaa4_sublane"]
    a = traster.rasterize_binned(b, W, H, 128, 8, sublane=True, msaa4=True)
    c = traster.rasterize_binned_msaa4_sublane_reference(b, W, H, 128, 8)
    assert profiling.ROUTES_TAKEN["raster_msaa4_sublane"] == before
    _bits_equal(a, c)
