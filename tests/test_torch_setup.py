"""Triangle setup: every TriSetup field of the port equals the JAX one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.ops import setup as tsetup


def random_clip(seed, n=24):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _edge_cases():
    """Degenerate, behind-the-eye, far off-screen and steep-depth tris."""
    tris = [
        [[0.1, 0.1, 0.5, 1.0], [0.1, 0.1, 0.5, 1.0], [0.3, 0.2, 0.5, 1.0]],  # zero area
        [[-0.5, -0.5, 0.5, -1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0]],  # w < 0
        [[40.0, 40.0, 0.5, 1.0], [41.0, 40.0, 0.5, 1.0], [40.0, 41.0, 0.5, 1.0]],  # off-screen
        [[-1.0, -1.0, -0.5, 1.0], [1.0, -1.0, 1.5, 1.0], [0.0, 1.0, 0.2, 1.0]],  # steep z
        [[-900.0, -5.0, 0.5, 1.0], [900.0, -5.0, 0.5, 1.0], [0.0, 5.0, 0.5, 1.0]],  # guard band
    ]
    return np.asarray(tris, np.float32)


_jax_setup = jax.jit(
    jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("cull_mode", "front_face", "scissor")
)
_jax_anchor = jax.jit(jsetup.depth_tile_anchor)
_jax_at_pixel = jax.jit(jsetup.depth_at_pixel)


def _compare(ts, js):
    for name in ts._fields:
        got = getattr(ts, name).numpy()
        if name == "area2":
            hi = np.asarray(js.area2_hi).astype(np.int64)
            lo = np.asarray(js.area2_lo).view(np.uint32).astype(np.int64)
            want = (hi << 32) | lo
        else:
            want = np.asarray(getattr(js, name))
        assert got.dtype == want.dtype or name == "area2", (name, got.dtype, want.dtype)
        # Exact for ints and floats alike (bitwise for floats).
        if got.dtype.kind == "f":
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(cull_mode="back"),
        dict(cull_mode="front", front_face="cw"),
        dict(scissor=(16, 8, 100, 70)),
    ],
)
def test_setup_fields_match(kw):
    clip = np.concatenate([random_clip(0, 48), _edge_cases()])
    W, H = 128, 96
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, **kw)
    js = _jax_setup(jnp.asarray(clip), W, H, **kw)
    _compare(ts, js)


def test_depth_anchor_and_pixel_match():
    clip = random_clip(3, 32)
    W, H = 300, 200
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    js = _jax_setup(jnp.asarray(clip), W, H)
    ax = np.array([0, 128, 256], np.int32)[:, None]
    ay = np.array([0, 128], np.int32)[:, None, None]
    want = np.asarray(
        _jax_anchor(js.zq[:, 0], js.xf[:, 0], js.yf[:, 0], js.gx, js.gy, js.zshift,
                                 jnp.asarray(ax), jnp.asarray(ay))
    )
    got = tsetup.depth_tile_anchor(ts.zq[:, 0], ts.xf[:, 0], ts.yf[:, 0], ts.gx, ts.gy, ts.zshift,
                                   torch.from_numpy(ax), torch.from_numpy(ay))
    np.testing.assert_array_equal(got.numpy(), want)
    dx = np.arange(0, 128, 9, dtype=np.int32)[:, None, None, None]
    want_px = _jax_at_pixel(jnp.asarray(want), js.dzdx_q, js.dzdy_q, js.zshift, jnp.asarray(dx), 127 - jnp.asarray(dx))
    got_px = tsetup.depth_at_pixel(got, ts.dzdx_q, ts.dzdy_q, ts.zshift, torch.from_numpy(dx), 127 - torch.from_numpy(dx))
    np.testing.assert_array_equal(got_px.numpy(), np.asarray(want_px))
