"""Front end of the main path: vertex stage, triangle gather, near clip."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from based_renderer_tpu import math3d as jm3d
from based_renderer_tpu import shader as jshader
from based_renderer_tpu.ops import clip as jclip
from based_renderer_tpu.ops import vertex as jvertex
from based_renderer_tpu_torch import math3d as tm3d
from based_renderer_tpu_torch import shader as tshader
from based_renderer_tpu_torch.ops import clip as tclip
from based_renderer_tpu_torch.ops import vertex as tvertex


def _uniforms(t):
    """The cube demo's uniforms, built once by each package's math3d."""
    def build(m3d, t_val):
        model = m3d.rotate(np.float32(t_val), (0.0, -1.0, 0.0))
        model = m3d.rotate(np.float32(np.radians(-55.0)), (1.0, 0.0, 0.0), model)
        return {
            "model": model,
            "view": m3d.translate((0.0, 0.0, 3.0)),
            "proj": m3d.perspective(np.radians(45.0), 4 / 3, 0.1, 10.0),
        }

    return build(tm3d, t), build(jm3d, t)


def test_math3d_matrices_match():
    tu, ju = _uniforms(0.7)
    for k in tu:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["flat_ndc", "flat_mvp", "vertex_color", "ndc_color"])
def test_shader_vertex_stage(name):
    """Vertex stage from the same matrices: rtol 1e-6 (the 4x4 matmul may
    sum in another order), varyings exact (passed through)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, size=(30, 3)).astype(np.float32)
    col = rng.uniform(0, 1, size=(30, 3)).astype(np.float32)
    tu, ju = _uniforms(0.3)
    ju = {k: jnp.asarray(tu[k].numpy()) for k in tu}  # identical matrices
    t_clip, t_var = tshader.get(name).vertex({"position": torch.from_numpy(pos), "color": torch.from_numpy(col)}, tu)
    j_clip, j_var = jshader.get(name).vertex({"position": jnp.asarray(pos), "color": jnp.asarray(col)}, ju)
    np.testing.assert_allclose(t_clip.numpy(), np.asarray(j_clip), rtol=1e-6, atol=1e-6)
    assert sorted(t_var) == sorted(j_var)
    for k in t_var:
        np.testing.assert_array_equal(t_var[k].numpy(), np.asarray(j_var[k]))
    assert tshader.get(name).attributes == jshader.get(name).attributes


def test_mvp_transform_matches():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    tu, _ = _uniforms(1.1)
    ju = {k: jnp.asarray(v.numpy()) for k, v in tu.items()}
    got = tshader.mvp_transform({"position": torch.from_numpy(pos)}, tu).numpy()
    want = np.asarray(jshader.mvp_transform({"position": jnp.asarray(pos)}, ju))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_registry_holds_the_main_path_shaders():
    assert set(tshader.names()) == {"flat_ndc", "flat_mvp", "vertex_color", "ndc_color"}
    with pytest.raises(KeyError):
        tshader.get("unlit")  # the Pipeline default is not registered in either package
    with pytest.raises(KeyError):
        jshader.get("unlit")


@pytest.mark.parametrize("indexed", [False, True])
def test_gather_triangles(indexed):
    rng = np.random.default_rng(2)
    clip = rng.normal(size=(12, 4)).astype(np.float32)
    var = {"color": rng.normal(size=(12, 3)).astype(np.float32), "uv": rng.normal(size=(12, 2)).astype(np.float32)}
    idx = rng.integers(0, 12, size=(7, 3)).astype(np.int32) if indexed else None
    tc, tv = tvertex.gather_triangles(
        torch.from_numpy(clip), {k: torch.from_numpy(v) for k, v in var.items()},
        None if idx is None else torch.from_numpy(idx),
    )
    jc, jv = jvertex.gather_triangles(
        jnp.asarray(clip), {k: jnp.asarray(v) for k, v in var.items()}, None if idx is None else jnp.asarray(idx)
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for k in var:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))


def _crossing_tris(seed, n=64):
    """Triangles with 0, 1, 2 or 3 vertices behind w = eps."""
    rng = np.random.default_rng(seed)
    clip = rng.uniform(-2, 2, size=(n, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.choice(np.float32([-1.5, -0.2, 1e-6, 0.3, 2.0]), size=(n, 3))
    clip[:4, :, 3] = 1.0  # all in front
    clip[4:8, :, 3] = -1.0  # all behind
    clip[8, 1, 3] = clip[8, 0, 3]  # equal-w edge (the guarded divide)
    return clip


def test_clip_near_exact_against_unfused_jax():
    """clip_near bit for bit against JAX compiled without XLA's fusion
    pass.  Fused, XLA:CPU contracts the cut lerp a + (b - a)*t into an
    FMA; see the next test."""
    clip = _crossing_tris(3)
    col = np.random.default_rng(4).normal(size=(64, 3, 3)).astype(np.float32)
    tp, tv = tclip.clip_near(torch.from_numpy(clip), {"color": torch.from_numpy(col)})
    args = (jnp.asarray(clip), {"color": jnp.asarray(col)})
    unfused = jax.jit(jclip.clip_near).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"}
    )
    jp, jv = unfused(*args)
    assert tp.shape == (128, 3, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv["color"].numpy(), np.asarray(jv["color"]))


def test_clip_near_within_one_ulp_of_jitted_jax():
    """Under jit the contracted lerp rounds once where the port rounds
    twice: the results stay within 1 ulp of the largest input coordinate
    (|x| <= 2, so 2.4e-7), though near-zero outputs differ in more of
    their own ulps."""
    clip = _crossing_tris(5)
    col = np.random.default_rng(6).uniform(-2, 2, size=(64, 3, 3)).astype(np.float32)
    tp, tv = tclip.clip_near(torch.from_numpy(clip), {"color": torch.from_numpy(col)})
    jp, jv = jax.jit(jclip.clip_near)(jnp.asarray(clip), {"color": jnp.asarray(col)})
    ulp = np.spacing(np.float32(2.0))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ulp)
    np.testing.assert_allclose(tv["color"].numpy(), np.asarray(jv["color"]), rtol=0, atol=ulp)
