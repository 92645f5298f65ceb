"""The port's kernel record assembly vs the JAX binner's (assemble="pallas").

Records, tile_start, tile_count, num_pairs and overflowed are exact over
the whole array, tail slots included, and the stream has JAX's padded
length.  Float records equal the JAX binner compiled without XLA's fusion
pass bit for bit; against fused JAX (which contracts the plane sums and
the re-anchor into FMAs) the copied rows (b0/b1 steps, f32 tri_id) stay
exact and the rest agree within rtol 1e-5 + atol 1e-5, as in
tests/test_torch_binning.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import binning as jbin
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.ops import binassem as tasm
from based_renderer_tpu_torch.ops import binning as tbin
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.utils import profiling

W, H = 128, 96
_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2))


def random_clip(seed, n=24):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _bin_both(clip, channels=None, fused=False, **kw):
    kw = dict(assemble="pallas", **kw)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    tb = tbin.bin_triangles(ts, W, H, channels=None if channels is None else torch.from_numpy(channels), **kw)
    js = _jax_setup(jnp.asarray(clip), W, H)
    j_ch = None if channels is None else jnp.asarray(channels)
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=W, height=H, interpret=True, **kw))
    opts = {} if fused else {"xla_disable_hlo_passes": "fusion"}
    jb = fn.lower(js, channels=j_ch).compile(compiler_options=opts)(js, channels=j_ch)
    return ts, tb, jb


def _assert_same(tb, jb, float_rows=None):
    for name in ("records", "tile_start", "tile_count", "num_pairs", "overflowed"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    got, want = tb.frecords.numpy(), np.asarray(jb.frecords)
    assert got.shape == want.shape
    rows = list(range(got.shape[0])) if float_rows is None else float_rows
    np.testing.assert_array_equal(got[rows].view(np.int32), want[rows].view(np.int32))


def _p_pad(stream_len):
    return -(-(stream_len + tbin.SEGMENT_ALIGN) // 128) * 128


@pytest.mark.parametrize(
    "case",
    [
        dict(tile_w=128, tile_h=8, nch=2),
        dict(tile_w=32, tile_h=16, nch=6),
        dict(tile_w=128, tile_h=8, nch=6, max_pairs=1000),  # not a multiple of 128
        dict(tile_w=16, tile_h=16, nch=2, max_pairs=1100, slots=200),  # slots cut, overflow
        dict(tile_w=64, tile_h=32, nch=0, id_offset=77),
    ],
)
def test_records_match_unfused_jax(case):
    case = dict(case)
    nch = case.pop("nch")
    n = 200 if "slots" in case else 60
    clip = random_clip(sum(map(ord, str(case))) % 1000, n)
    ch = np.random.default_rng(1).normal(size=(n, 3, nch)).astype(np.float32) if nch else None
    _, tb, jb = _bin_both(clip, ch, **case)
    stream = max(case.get("max_pairs", max(4 * n, 1024)), n)
    if "slots" in case:
        stream = min(stream, -(-case["slots"] // 128) * 128)
        assert bool(tb.overflowed)
    assert tb.records.shape == (16, _p_pad(stream))
    assert int(tb.num_pairs) > 60
    _assert_same(tb, jb)


@pytest.mark.parametrize("assemble", ["xla", "pallas"])
def test_msaa4_records_match_unfused_jax(assemble):
    """24-row MSAA records (raw A, B in rows 16-21) on both assembly
    routes: exact over the whole array, tail included."""
    clip = random_clip(12, 60)
    ch = np.random.default_rng(13).normal(size=(60, 3, 3)).astype(np.float32)
    kw = dict(tile_w=32, tile_h=16, msaa4=True, assemble=assemble, max_pairs=1000)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=6)
    tb = tbin.bin_triangles(ts, W, H, channels=torch.from_numpy(ch), **kw)
    js = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("bbox_pad_fp",))(
        jnp.asarray(clip), W, H, bbox_pad_fp=6
    )
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=W, height=H, interpret=True, **kw))
    j_ch = jnp.asarray(ch)
    jb = fn.lower(js, channels=j_ch).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})(js, channels=j_ch)
    stream = 1000 if assemble == "pallas" else None
    assert tb.records.shape[0] == 24
    if stream is not None:
        assert tb.records.shape[1] == _p_pad(stream)
    _assert_same(tb, jb)
    live = int(tb.num_pairs)
    assert (tb.records[16:22, :live] != 0).any() and not tb.records[22:].any()
    torch.testing.assert_close(tb.records[3:9, :live], tb.records[16:22, :live] * 16, rtol=0, atol=0)


def test_past_the_kernel_width_takes_the_xla_layout():
    """K = 33 gives a 129+ column template row: both packages keep the XLA
    layout (stream + zero tail) although assemble="pallas" was asked."""
    assert tbin.pallas_assembly_fits(32) and not tbin.pallas_assembly_fits(33)
    clip = random_clip(5, 20)
    ch = np.random.default_rng(6).normal(size=(20, 3, 33)).astype(np.float32)
    _, tb, jb = _bin_both(clip, ch, tile_w=64, tile_h=32)
    assert tb.records.shape == (16, 1024 + tbin.SEGMENT_ALIGN)
    assert not tb.records[:, 1024:].any()
    _assert_same(tb, jb)


def test_fused_jax_within_tolerance():
    clip = random_clip(7, 40)
    ch = np.random.default_rng(8).normal(size=(40, 3, 3)).astype(np.float32)
    _, tb, jb = _bin_both(clip, ch, fused=True, tile_w=32, tile_h=16)
    _assert_same(tb, jb, float_rows=[1, 2, 4, 5, tbin.ftid_col(3)])
    np.testing.assert_allclose(tb.frecords.numpy(), np.asarray(jb.frecords), rtol=1e-5, atol=1e-5)


def test_reference_equals_xla_assembly_on_live_slots():
    clip = random_clip(9, 80)
    ch = torch.from_numpy(np.random.default_rng(10).normal(size=(80, 3, 4)).astype(np.float32))
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    kw = dict(tile_w=32, tile_h=16, channels=ch, slots=640)
    x = tbin.bin_triangles(ts, W, H, assemble="xla", **kw)
    p = tbin.bin_triangles(ts, W, H, assemble="pallas", **kw)
    live = min(int(x.num_pairs), 640)
    assert live > 300 and x.records.shape[1] == 640 + 128 and p.records.shape[1] == _p_pad(640)
    assert torch.equal(x.records[:, :live], p.records[:, :live])
    assert torch.equal(x.frecords[:, :live].view(torch.int32), p.frecords[:, :live].view(torch.int32))
    for name in ("tile_start", "tile_count", "num_pairs", "overflowed"):
        assert torch.equal(getattr(x, name), getattr(p, name))
    # Tail slots: impossible edges, zero steps, the rest from the slot's triangle.
    tail = p.records[:, 640:]
    assert (tail[:3] == tasm.INVALID_EDGE).all() and not tail[3:9].any()
    ps = tbin.pair_stream(ts, W, H, 32, 16, None, 0, ch, True, 640)
    assert torch.equal(ps.t_slot, x.records[13, :640].long())


def test_cpu_tensors_take_the_plain_version():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(11, 30)), W, H)
    ps = tbin.pair_stream(ts, W, H, 128, 8)
    args = (ps.tmpl, *tbin.padded_slots(ps), ps.total, tbin.frecord_width(0))
    before = profiling.ROUTES_TAKEN["assemble_records"]
    a = tasm.assemble_records(*args)
    b = tasm.assemble_records_reference(*args)
    assert profiling.ROUTES_TAKEN["assemble_records"] == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
