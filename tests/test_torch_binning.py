"""The port's binner vs the JAX binner (assemble="xla", tmpl="xla").

Records, tile_start, tile_count, num_pairs and overflowed are compared
exactly.  Float records are compared exactly against the JAX binner
compiled without XLA's fusion pass: fused, XLA:CPU contracts the 3-term
plane sums and the tile re-anchor into FMAs (see the last test), while
the port, like the spec, rounds every operation on its own.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import binning as jbin
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.ops import binning as tbin
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.utils.errors import FeatureNotPresentError

W, H = 128, 96
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2))


def random_clip(seed, n=24):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _bin_both(clip, channels=None, fused=False, **kw):
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    tb = tbin.bin_triangles(
        ts, W, H, channels=None if channels is None else torch.from_numpy(channels), **kw
    )
    js = _jax_setup(jnp.asarray(clip), W, H)
    j_ch = None if channels is None else jnp.asarray(channels)
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=W, height=H, **kw))
    opts = {} if fused else {"xla_disable_hlo_passes": "fusion"}
    jb = fn.lower(js, channels=j_ch).compile(compiler_options=opts)(js, channels=j_ch)
    return tb, jb


def _assert_same(tb, jb, float_rows=None):
    for name in ("records", "tile_start", "tile_count", "num_pairs", "overflowed"):
        np.testing.assert_array_equal(
            getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name
        )
    got, want = tb.frecords.numpy(), np.asarray(jb.frecords)
    rows = list(range(got.shape[0])) if float_rows is None else float_rows
    np.testing.assert_array_equal(got[rows].view(np.int32), want[rows].view(np.int32))


@pytest.mark.parametrize("tile", [(128, 32), (32, 16), (64, 64)])
def test_records_match_with_channels(tile):
    clip = random_clip(0, 40)
    ch = np.random.default_rng(1).normal(size=(40, 3, 3)).astype(np.float32)
    tb, jb = _bin_both(clip, ch, tile_w=tile[0], tile_h=tile[1])
    assert not bool(tb.overflowed)
    _assert_same(tb, jb)


def test_records_match_no_perspective_id_offset():
    clip = random_clip(2, 24)
    ch = np.random.default_rng(3).uniform(size=(24, 3, 2)).astype(np.float32)
    tb, jb = _bin_both(clip, ch, tile_w=32, tile_h=32, perspective=False, id_offset=70)
    _assert_same(tb, jb)


def test_max_pairs_overflow_matches():
    clip = random_clip(4, 64)
    tb, jb = _bin_both(clip, tile_w=16, tile_h=16, max_pairs=96)
    assert bool(tb.overflowed)
    _assert_same(tb, jb)


def test_slots_cut_matches():
    clip = random_clip(5, 200)
    tb, jb = _bin_both(clip, tile_w=32, tile_h=16, slots=64)
    assert bool(tb.overflowed) and tb.records.shape[1] == 128 + tbin.SEGMENT_ALIGN
    _assert_same(tb, jb)
    tb, jb = _bin_both(clip[:20], tile_w=32, tile_h=16, slots=256)
    assert not bool(tb.overflowed)
    _assert_same(tb, jb)


def test_fused_jax_contracts_float_rows():
    """Against the default (fused) compile: the b0/b1 plane steps and the
    f32 tri-id row are single multiplies or copies and stay exact.  The
    re-anchor p00 + pdx*ox + pdy*oy and the invw/channel planes
    q0*b0 + q1*b1 + q2*b2 become FMAs (fma(q2, b2, fma(q0, b0, q1*b1))),
    a few hundred ulp apart where the terms cancel: rtol 1e-5 + atol 1e-5."""
    clip = random_clip(7, 40)
    ch = np.random.default_rng(8).normal(size=(40, 3, 3)).astype(np.float32)
    tb, jb = _bin_both(clip, ch, fused=True, tile_w=32, tile_h=16)
    _assert_same(tb, jb, float_rows=[1, 2, 4, 5, tbin.ftid_col(3)])
    got, want = tb.frecords.numpy(), np.asarray(jb.frecords)
    assert (got != want).any()  # the contraction is real, not a no-op
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layout_widths():
    assert tbin.RECORD_WIDTH == jbin.RECORD_WIDTH
    assert tbin.SEGMENT_ALIGN == jbin.SEGMENT_ALIGN
    for k in range(6):
        assert tbin.frecord_width(k) == jbin.frecord_width(k)
        assert tbin.ftid_col(k) == jbin.ftid_col(k)


def test_modes_rejected():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(6, 4)), W, H)
    for kw in (dict(assemble="pallas"), dict(tmpl="pallas")):
        with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
            tbin.bin_triangles(ts, W, H, **kw)
    for kw in (dict(assemble="mosaic"), dict(tmpl="row")):
        with pytest.raises(ValueError):
            tbin.bin_triangles(ts, W, H, **kw)
