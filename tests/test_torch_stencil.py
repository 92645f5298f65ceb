"""Stencil in the port: the helpers, the plain sequential raster (B1's and
B4's plain versions), the two-pass route and the renderer, vs the JAX package.

Mirrors tests/test_stencil.py.  The same numpy inputs go through the
port's ``rasterize_vis`` on CPU tensors and the JAX package's
``rasterize_vis_pallas(..., interpret=True)`` (and raster_xla's helpers):
tri_id, depth_q and the stencil plane are exact, the float planes agree
within atol 2e-4 (the JAX package's barycentric tolerance,
tests/test_pallas.py:40), and tri_id, depth_q and stencil also equal the
port's copy of the numpy oracle.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import geometry
from based_renderer_tpu.ops import raster_xla as jxla
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu_torch.ops import fixedpoint as fp
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.reference import oracle

W, H = 96, 64
ATOL = 2e-4
OPS = ["keep", "zero", "replace", "increment_clamp", "decrement_clamp", "invert", "increment_wrap", "decrement_wrap"]
COMPARES = ["never", "less", "equal", "less_equal", "greater", "not_equal", "greater_equal", "always"]


def random_clip(seed, n=24):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


def _jst(st):
    return None if st is None else jbrt.StencilState(**dataclasses.asdict(st))


def _both(clip, st, init=None, msaa4=False, **kw):
    """(port, jax) outputs of one draw; ``init`` is a (port, jax) pair."""
    pad = fp.MSAA4_BBOX_PAD_FP if msaa4 else 0
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=pad)
    js = jsetup.setup_triangles(jnp.asarray(clip), W, H, bbox_pad_fp=pad)
    t_init, j_init = (None, None) if init is None else init
    t = traster.rasterize_vis(ts, W, H, stencil=st, init=t_init, msaa4=msaa4, **kw)
    j = rasterize_vis_pallas(js, W, H, stencil=_jst(st), init=j_init, msaa4=msaa4, interpret=True, **kw)
    return t, j


def _assert_match(t, j):
    for k in ("tri_id", "depth_q", "stencil"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    for k in ("b0", "b1", "b2"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)), rtol=0, atol=ATOL)


def assert_stencil_identical(clip, st, two_pass=False, stencil_clear=0):
    t, j = _both(clip, st, two_pass=two_pass, stencil_clear=stencil_clear)
    _assert_match(t, j)
    ora = oracle.rasterize(clip, W, H, stencil=st, stencil_clear=stencil_clear)
    for k in ("tri_id", "depth_q", "stencil"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), ora[k], err_msg=k)
    return ora


@pytest.mark.parametrize("op", OPS)
def test_apply_op_and_update_match_raster_xla(op):
    rng = np.random.default_rng(OPS.index(op))
    sbuf = rng.integers(0, 256, size=(16, 16)).astype(np.int32)
    sbuf[0, :4] = (0, 1, 254, 255)  # the clamp and wrap edges
    covered, s_pass, d_pass = (rng.random((16, 16)) < 0.6 for _ in range(3))
    np.testing.assert_array_equal(
        traster.stencil_apply_op(op, torch.from_numpy(sbuf), 0x5A).numpy(),
        np.asarray(jxla.stencil_apply_op(op, jnp.asarray(sbuf), 0x5A)),
    )
    others = OPS[(OPS.index(op) + 3) % 8], OPS[(OPS.index(op) + 5) % 8]
    for fail_op, dfail_op, pass_op in ((op, *others), (others[0], op, others[1]), (*others, op)):
        st = tbrt.StencilState(enable=True, ref=0xA7, write_mask=0x3C, fail_op=fail_op, depth_fail_op=dfail_op,
                               pass_op=pass_op)
        t = traster.stencil_update(st, torch.from_numpy(sbuf), *map(torch.from_numpy, (covered, s_pass, d_pass)))
        j = jxla.stencil_update(_jst(st), jnp.asarray(sbuf), *map(jnp.asarray, (covered, s_pass, d_pass)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("compare", COMPARES)
def test_stencil_test_matches_raster_xla(compare):
    """The operand order is compare(ref & mask, stencil & mask): the
    asymmetric compares catch a swap."""
    sbuf = np.arange(256, dtype=np.int32).reshape(16, 16)
    for ref, mask in ((0x35, 0xFF), (0x35, 0xF0), (0, 0x0F), (255, 0xFF)):
        st = tbrt.StencilState(enable=True, compare=compare, ref=ref, compare_mask=mask)
        t = traster.stencil_test(st, torch.from_numpy(sbuf)).numpy()
        np.testing.assert_array_equal(t, np.asarray(jxla.stencil_test(_jst(st), jnp.asarray(sbuf))))
        if compare == "less":
            assert t[0, 0] == ((ref & mask) < 0)


@pytest.mark.parametrize("two_pass", [False, True])
def test_stencil_increment_overdraw(two_pass):
    """always/increment counts overdraw per pixel, on the sequential and the
    two-pass route."""
    st = tbrt.StencilState(enable=True, compare="always", pass_op="increment_clamp",
                           depth_fail_op="increment_wrap", fail_op="keep")
    ora = assert_stencil_identical(random_clip(0), st, two_pass=two_pass)
    assert ora["stencil"].max() >= 2


def test_stencil_ops_zoo():
    st = tbrt.StencilState(enable=True, compare="greater_equal", ref=0x35, compare_mask=0xF0, write_mask=0x66,
                           pass_op="replace", fail_op="invert", depth_fail_op="decrement_clamp")
    assert_stencil_identical(random_clip(1), st, stencil_clear=0x40)


def test_stencil_never_fail_ops_still_apply():
    st = tbrt.StencilState(enable=True, compare="never", fail_op="increment_clamp")
    ora = assert_stencil_identical(random_clip(2), st)
    assert (ora["tri_id"] == -1).all() and ora["stencil"].max() >= 1


def test_stencil_msaa_per_sample():
    st = tbrt.StencilState(enable=True, compare="always", pass_op="increment_clamp")
    clip = random_clip(3)
    t, j = _both(clip, st, msaa4=True, tile_w=32, tile_h=16)
    _assert_match(t, j)
    ora = oracle.rasterize_msaa4(clip, W, H, stencil=st)
    np.testing.assert_array_equal(t.stencil.numpy(), ora["stencil"])
    s = ora["stencil"]
    assert (s[0] != s[1]).any() or (s[0] != s[2]).any()  # edge samples differ


@pytest.mark.parametrize("with_init_stencil", [True, False])
def test_init_chain(with_init_stencil):
    """A second draw continues the first's stencil, or starts from the clear
    value when init carries none (raster_pallas.py:2060-2066)."""
    stamp = tbrt.StencilState(enable=True, compare="always", ref=7, pass_op="replace")
    masked = tbrt.StencilState(enable=True, compare="equal", ref=7, pass_op="increment_clamp",
                               fail_op="invert", depth_fail_op="zero")
    ta, ja = _both(random_clip(4, 12), stamp, tile_w=32, tile_h=32)
    _assert_match(ta, ja)
    init = (ta, ja) if with_init_stencil else (ta._replace(stencil=None), ja._replace(stencil=None))
    tb, jb = _both(random_clip(5, 16), masked, init=init, tile_w=32, tile_h=32, id_offset=12, stencil_clear=7)
    _assert_match(tb, jb)
    assert (tb.stencil.numpy() == 8).any()


def _random_init(seed):
    rng = np.random.default_rng(seed)
    planes = dict(
        tri_id=rng.integers(-1, 6, size=(H, W)).astype(np.int32),
        depth_q=rng.integers(0, fp.DEPTH_ONE_Q + 1, size=(H, W)).astype(np.int32),
        b0=rng.random((H, W), dtype=np.float32),
        b1=rng.random((H, W), dtype=np.float32),
        b2=rng.random((H, W), dtype=np.float32),
        stencil=rng.integers(0, 256, size=(H, W)).astype(np.int32),
    )
    t = traster.VisBuffer(**{k: torch.from_numpy(v) for k, v in planes.items()})
    j = jxla.VisBuffer(**{k: jnp.asarray(v) for k, v in planes.items()})
    return t, j


@pytest.mark.parametrize("stencil_on", [False, True])
@pytest.mark.parametrize("compare", COMPARES)
def test_two_pass_matches_jax_two_pass(compare, stencil_on):
    """The two-pass route (csrc/raster_tile.cu on the card, B1's plain
    version here) against JAX's _raster_kernel_two_pass, continuing a
    random init buffer."""
    st = tbrt.StencilState(enable=True, compare="less_equal", ref=0x80, pass_op="increment_wrap",
                           fail_op="decrement_wrap", depth_fail_op="invert") if stencil_on else None
    ch = np.random.default_rng(8).normal(size=(24, 3, 2)).astype(np.float32)
    clip = random_clip(6 + COMPARES.index(compare))
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    js = jsetup.setup_triangles(jnp.asarray(clip), W, H)
    t_init, j_init = _random_init(7)
    kw = dict(tile_w=32, tile_h=16, depth_compare=compare, two_pass=True)
    t = traster.rasterize_vis(ts, W, H, channels=torch.from_numpy(ch), init=t_init, stencil=st, **kw)
    j = rasterize_vis_pallas(js, W, H, channels=jnp.asarray(ch), init=j_init, stencil=_jst(st), interpret=True, **kw)
    _assert_match(t[0], j[0])
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=0, atol=ATOL)


def _stamp_then_mask(mod, r):
    tri = geometry.triangle_mesh_data()["positions"]
    stamp = mod.Pipeline(shader="flat_ndc", depth=mod.DepthState(test=False, write=False),
                         stencil=mod.StencilState(enable=True, compare="always", ref=1, pass_op="replace"))
    masked = mod.Pipeline(shader="flat_ndc", depth=mod.DepthState(test=False, write=False),
                          stencil=mod.StencilState(enable=True, compare="equal", ref=1))
    r.begin_frame()
    r.draw(stamp, r.upload_mesh(tri * np.float32(0.6)), {"color": (1.0, 0.0, 0.0, 1.0)})
    r.draw(masked, r.upload_mesh(tri), {"color": (0.0, 1.0, 0.0, 1.0)})
    return r.end_frame()


def test_renderer_stencil_masked_draw():
    """Two-draw frame: draw A stamps the stencil, draw B renders only where
    the stencil equals the stamp; FrameResult.stencil and the colour match
    the JAX renderer."""
    tf = _stamp_then_mask(tbrt, tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu"))
    jf = _stamp_then_mask(jbrt, jbrt.Renderer(jbrt.RendererConfig(W, H, raster_backend="xla")))
    stencil = tf.stencil.numpy()
    np.testing.assert_array_equal(stencil, np.asarray(jf.stencil))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)
    green = tf.color_np()[..., 1] > 0.5
    np.testing.assert_array_equal(green, stencil == 1)
    assert green.any() and not green.all()


def test_stencil_off_draw_keeps_the_attachment():
    """A draw with stencil off leaves the stencil attachment as it was."""
    r = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu")
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    r.begin_frame()
    r.draw(dataclasses.replace(pipe, stencil=tbrt.StencilState(enable=True, ref=9, pass_op="replace")), mesh, u(0.2))
    r.draw(pipe, mesh, u(1.4))
    f = r.end_frame()
    alone = r.render_frame(dataclasses.replace(pipe, stencil=tbrt.StencilState(enable=True, ref=9, pass_op="replace")),
                           mesh, u(0.2))
    assert torch.equal(f.stencil, alone.stencil) and (f.stencil == 9).any()
