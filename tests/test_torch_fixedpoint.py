"""The port's fixed-point spec vs the JAX package's, bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu.ops import fixedpoint as jfp
from based_renderer_tpu.reference.oracle import _recip_f32_exact as oracle_recip
from based_renderer_tpu_torch.ops import fixedpoint as tfp


@pytest.mark.parametrize("biased_exp", [1, 127, 180])
def test_recip_all_mantissas(biased_exp):
    """Every one of the 2^23 mantissas at an exponent: port == JAX == oracle."""
    bits = (np.int32(biased_exp) << 23) | np.arange(1 << 23, dtype=np.int32)
    x = bits.view(np.float32)
    got = tfp.recip_f32_exact(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jfp.recip_f32_exact)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), oracle_recip(x).view(np.int32))


def test_snap_fixed_matches():
    rng = np.random.default_rng(0)
    c = rng.uniform(-9000.0, 9000.0, size=4096).astype(np.float32)
    # Exact half-grid values exercise the half-even rounding.
    c[:64] = (np.arange(64, dtype=np.float32) - 32.0) / 32.0
    got = tfp.snap_fixed(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfp.snap_fixed(jnp.asarray(c))))


def test_edge_coeffs_and_topleft_bias_match():
    rng = np.random.default_rng(1)
    xf = rng.integers(jfp.GUARD_LO, jfp.GUARD_HI, size=(2048, 3), dtype=np.int32)
    yf = rng.integers(jfp.GUARD_LO, jfp.GUARD_HI, size=(2048, 3), dtype=np.int32)
    xf[:16, 1] = xf[:16, 0]  # vertical and horizontal edges hit the tie rule
    yf[16:32, 2] = yf[16:32, 1]
    a, b, area2 = tfp.edge_coeffs(torch.from_numpy(xf), torch.from_numpy(yf))
    ja, jb, (hi, lo) = jax.jit(jfp.edge_coeffs)(jnp.asarray(xf), jnp.asarray(yf))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    j_area = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(area2.numpy(), j_area)
    np.testing.assert_array_equal(
        tfp.topleft_bias(a, b).numpy(), np.asarray(jax.jit(jfp.topleft_bias)(ja, jb))
    )
