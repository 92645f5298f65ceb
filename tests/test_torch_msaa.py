"""The port's plain MSAA-4x raster (B4's plain version) vs the JAX package.

Mirrors tests/test_msaa.py: per-sample tri_id and depth_q of the port's
``rasterize_vis(msaa4=True)`` on CPU tensors are bit-identical to
``rasterize_vis_pallas(msaa4=True, interpret=True)`` and to the numpy
oracle's ``rasterize_msaa4`` (the port's own copy); the float planes
(b0, b1, b2, invw, channels) agree with the JAX kernel within atol 2e-4,
the JAX package's barycentric tolerance (tests/test_pallas.py:40).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
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
_jax_setup = jax.jit(
    jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("scissor", "bbox_pad_fp")
)


def random_clip(seed, n=24, z_lo=0.0, z_hi=1.0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(z_lo, z_hi, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def sliver_clip(seed=5, n=48):
    """Subpixel slivers (tests/test_msaa.py:72): sample positions, not
    pixel centers, decide coverage."""
    rng = np.random.default_rng(seed)
    bx = rng.uniform(2.0, W - 3.0, size=n).astype(np.float32)
    by = rng.uniform(2.0, H - 3.0, size=n).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    ln = rng.uniform(0.1, 1.5, size=n).astype(np.float32)
    off = rng.uniform(1.0 / 16, 4.0 / 16, size=n).astype(np.float32)
    sx = np.stack([bx, bx + np.cos(ang) * ln, bx - np.sin(ang) * off], -1)
    sy = np.stack([by, by + np.sin(ang) * ln, by + np.cos(ang) * off], -1)
    z = rng.uniform(0, 1, size=(n, 1)).astype(np.float32) * np.ones((n, 3), np.float32)
    nx = sx / np.float32(W) * 2 - 1
    ny = sy / np.float32(H) * 2 - 1
    return np.stack([nx, ny, z, np.ones_like(nx)], axis=-1).astype(np.float32)


def _both(clip, channels=None, init=None, **kw):
    """(port, jax) MSAA outputs of one draw; ``init`` is a (port, jax) pair."""
    kw = dict(dict(tile_w=32, tile_h=16), msaa4=True, **kw)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, scissor=kw.get("scissor"), bbox_pad_fp=PAD)
    js = _jax_setup(jnp.asarray(clip), W, H, scissor=kw.get("scissor"), bbox_pad_fp=PAD)
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
        assert ti.shape == (ti.shape[0], 4, H, W) and tw.shape == (4, H, W)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=ATOL)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=ATOL)
    else:
        tv, jv = t, j
    assert tv.tri_id.shape == (4, H, W)
    np.testing.assert_array_equal(tv.tri_id.numpy(), np.asarray(jv.tri_id))
    np.testing.assert_array_equal(tv.depth_q.numpy(), np.asarray(jv.depth_q))
    for k in ("b0", "b1", "b2"):
        np.testing.assert_allclose(getattr(tv, k).numpy(), np.asarray(getattr(jv, k)), rtol=0, atol=ATOL)


def _assert_oracle(vis, ora):
    np.testing.assert_array_equal(vis.tri_id.numpy(), ora["tri_id"])
    np.testing.assert_array_equal(vis.depth_q.numpy(), ora["depth_q"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_with_channels(seed):
    clip = random_clip(seed)
    ch = np.random.default_rng(seed + 100).normal(size=(24, 3, 3)).astype(np.float32)
    t, j = _both(clip, ch)
    _assert_match(t, j)
    _assert_oracle(t[0], oracle.rasterize_msaa4(clip, W, H))


def test_greater_compare():
    clip = random_clip(3)
    t, j = _both(clip, depth_compare="greater", depth_clear=0.0)
    _assert_match(t, j)
    _assert_oracle(t, oracle.rasterize_msaa4(clip, W, H, depth_compare="greater", depth_clear=0.0))


def test_per_sample_coverage_differs():
    """Sample layers genuinely differ at edges (otherwise MSAA is a no-op)."""
    clip = random_clip(4)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=PAD)
    vis = traster.rasterize_vis(ts, W, H, tile_w=32, tile_h=16, msaa4=True)
    _assert_oracle(vis, oracle.rasterize_msaa4(clip, W, H))
    tid = vis.tri_id.numpy()
    assert (tid[0] != tid[1]).any() or (tid[0] != tid[2]).any()


def test_slivers():
    clip = sliver_clip()
    t, j = _both(clip)
    _assert_match(t, j)
    _assert_oracle(t, oracle.rasterize_msaa4(clip, W, H))
    assert (t.tri_id >= 0).any()


@pytest.mark.parametrize(
    "kw",
    [
        dict(depth_clip=False),
        dict(depth_clip="clamp", depth_compare="greater_equal", depth_clear=0.0, scissor=(13, 5, 81, 58)),
        dict(depth_test=False, depth_write=False),
    ],
)
def test_clip_clamp_scissor_and_depth_state(kw):
    clip = random_clip(7, 24, z_lo=-0.6, z_hi=1.6)  # fragments outside [0, 1]
    t, j = _both(clip, **kw)
    _assert_match(t, j)


@pytest.mark.parametrize(
    "kw", [dict(), dict(depth_compare="less_equal"), dict(depth_clip="clamp"), dict(cull_mode="back")]
)
def test_oracle_modes(kw):
    """The plain MSAA raster equals the oracle bit for bit in each mode."""
    clip = np.concatenate([random_clip(8, 30, z_lo=-0.4, z_hi=1.4), np.repeat(random_clip(9, 4), 2, axis=0)])
    cull = kw.pop("cull_mode", "none")
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, cull_mode=cull, bbox_pad_fp=PAD)
    vis = traster.rasterize_vis(ts, W, H, tile_w=64, tile_h=32, msaa4=True, **kw)
    _assert_oracle(vis, oracle.rasterize_msaa4(clip, W, H, cull_mode=cull, **kw))


def test_init_chain():
    """init= chaining across draws matches JAX and one oracle pass over both."""
    clip_a, clip_b = random_clip(6, 10), random_clip(7, 14)
    ta, ja = _both(clip_a)
    tb, jb = _both(clip_b, init=(ta, ja), id_offset=10)
    _assert_match(tb, jb)
    _assert_oracle(tb, oracle.rasterize_msaa4(np.concatenate([clip_a, clip_b]), W, H))


def test_two_pass_yields_to_msaa4():
    """msaa4 takes the MSAA raster before two_pass, as in the JAX package."""
    clip = random_clip(10)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=PAD)
    a = traster.rasterize_vis(ts, W, H, msaa4=True)
    b = traster.rasterize_vis(ts, W, H, msaa4=True, two_pass=True)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


def test_records_are_24_rows_and_checked():
    clip = random_clip(11, 8)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=PAD)
    b16 = traster.bin_triangles(ts, W, H, 32, 16)
    b24 = traster.bin_triangles(ts, W, H, 32, 16, msaa4=True)
    assert b16.records.shape[0] == 16 and b24.records.shape[0] == 24
    assert torch.equal(b16.records, b24.records[:16])
    with pytest.raises(ValueError, match="22 rows"):
        traster._kernel_operands(b16, W, H, 12, 0, None, msaa4=True)


def test_cpu_tensors_take_the_plain_version():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(12, 16)), W, H, bbox_pad_fp=PAD)
    b = traster.bin_triangles(ts, W, H, 32, 16, msaa4=True)
    before = profiling.ROUTES_TAKEN["raster_msaa4"]
    a = traster.rasterize_binned(b, W, H, 32, 16, msaa4=True)
    c = traster.rasterize_binned_msaa4_reference(b, W, H, 32, 16)
    assert profiling.ROUTES_TAKEN["raster_msaa4"] == before
    for x, y in zip(a[:5], c[:5]):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "kw",
    [
        dict(
            stencil=tbrt.StencilState(enable=True, pass_op="increment_clamp", depth_fail_op="invert"),
            depth_compare="greater",
            depth_clear=0.0,
        ),
        dict(tmpl="pallas", tile_w=64, tile_h=32),
    ],
)
def test_msaa_out_of_slice_raises(kw):
    """Per-sample stencil and tmpl='pallas' (B8) under MSAA were outside the
    port's slice; they now equal the JAX kernels (stencil exact)."""
    jkw = dict(kw)
    if "stencil" in kw:
        jkw["stencil"] = jbrt.StencilState(**dataclasses.asdict(kw["stencil"]))
    tile = {} if "tile_w" in kw else dict(tile_w=32, tile_h=16)
    t = traster.rasterize_vis(
        tsetup.setup_triangles(torch.from_numpy(random_clip(13)), W, H, bbox_pad_fp=PAD), W, H,
        msaa4=True, **tile, **kw,
    )
    j = rasterize_vis_pallas(
        _jax_setup(jnp.asarray(random_clip(13)), W, H, bbox_pad_fp=PAD), W, H,
        msaa4=True, interpret=True, **tile, **jkw,
    )
    _assert_match(t, j)
    if "stencil" in kw:
        np.testing.assert_array_equal(t.stencil.numpy(), np.asarray(j.stencil))
        assert int(t.stencil.max()) >= 1


def test_msaa_with_batch_raises_value_error():
    ts = tsetup.setup_triangles(torch.from_numpy(random_clip(14, 4)), W, H, bbox_pad_fp=PAD)
    with pytest.raises(ValueError, match="msaa"):
        traster.rasterize_vis(ts, W, H, tile_w=128, tile_h=8, msaa4=True, batch=8)
