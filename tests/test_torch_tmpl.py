"""The template-layout path (raster_tmpl="pallas"): the port vs the JAX package.

Mirrors tests/test_tmpl.py.  The field-major template matrix equals the
JAX package's field-major build bit for bit (the JAX program compiled
without XLA's fusion pass, which contracts the plane sums into FMAs; see
tests/test_torch_binassem.py), the plain transpose equals the Pallas
transpose run interpreted (pad lanes zero), and the binner's records
under tmpl="pallas" equal the JAX binner's bit for bit, and the port's own
default layout, under both assemblies and with and without MSAA.  K in
{0, 4, 33} gives W8 in {32, 48, 136}: 136 is past the 128 lanes the TPU
version was run at.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.ops import binassem as jasm
from based_renderer_tpu.ops import binning as jbin
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.ops import binassem as tasm
from based_renderer_tpu_torch.ops import binning as tbin
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.utils import profiling

W, H = 256, 96
UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _scene(n, seed, k):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.1, 1.1, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0.05, 0.95, size=(n, 3, 1)).astype(np.float32) * w
    clip = np.concatenate([xy, z, w], -1).astype(np.float32)
    ch = rng.normal(size=(n, 3, k)).astype(np.float32) if k else None
    return clip, ch


def _jax_setup(clip, pad=0):
    fn = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2), static_argnames=("bbox_pad_fp",))
    return fn(jnp.asarray(clip), W, H, bbox_pad_fp=pad)


def _jax_field_major(js, ch, id_offset):
    """fusedT as the JAX binner builds it under tmpl="pallas" (binning.py:434-445)."""

    def build(js, ch):
        ti, tf = jbin._triangle_templates(js, id_offset, ch, True, transposed=True)
        fused = jnp.concatenate([ti, jax.lax.bitcast_convert_type(tf, jnp.int32)], axis=0)
        n_all = fused.shape[0]
        return jnp.pad(fused, ((0, -(-n_all // 8) * 8 - n_all), (0, 0)))

    ch_j = None if ch is None else jnp.asarray(ch)
    return jax.jit(build).lower(js, ch_j).compile(compiler_options=UNFUSED)(js, ch_j)


@pytest.mark.parametrize("k, w8, width", [(0, 32, 64), (4, 48, 64), (33, 136, 192)])
def test_field_major_templates_and_transpose_match_jax(k, w8, width):
    clip, ch = _scene(150, k + 1, k)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    tmpl = tbin._templates(ts, 9, None if ch is None else torch.from_numpy(ch), True)
    fused_t, row_width = tbin.templates_field_major(tmpl)
    assert fused_t.dtype == torch.int32 and tuple(fused_t.shape) == (w8, 150) and row_width == width
    want = np.asarray(_jax_field_major(_jax_setup(clip), ch, 9))
    np.testing.assert_array_equal(fused_t.numpy(), want)

    rows = tasm.transpose_templates_reference(fused_t, row_width)
    j_rows = np.asarray(jasm.transpose_templates(jnp.asarray(want), row_width, interpret=True))
    assert tuple(rows.shape) == (150, width) and j_rows.shape == (1024, width)
    np.testing.assert_array_equal(rows.numpy(), j_rows[:150])
    assert not rows[:, w8:].any()
    # The CPU wrapper takes the plain version and launches nothing.
    before = profiling.ROUTES_TAKEN["transpose_templates"]
    assert torch.equal(tasm.transpose_templates(fused_t, row_width), rows)
    assert profiling.ROUTES_TAKEN["transpose_templates"] == before


@pytest.mark.parametrize("w8, width", [(12, 64), (72, 64), (32, 96), (0, 64)])
def test_transpose_shape_rules(w8, width):
    with pytest.raises(ValueError, match="multiple of"):
        tasm.transpose_templates(torch.zeros((w8, 5), dtype=torch.int32), width)


@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("assemble", ["xla", "pallas"])
@pytest.mark.parametrize("msaa4", [False, True])
def test_tmpl_records_match_jax(k, assemble, msaa4):
    clip, ch = _scene(200, 3, k)
    pad = 6 if msaa4 else 0
    kw = dict(tile_w=128, tile_h=8, msaa4=msaa4, max_pairs=200 * 8, slots=200 * 4, assemble=assemble,
              tmpl="pallas", id_offset=5)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H, bbox_pad_fp=pad)
    tb = tbin.bin_triangles(ts, W, H, channels=None if ch is None else torch.from_numpy(ch), **kw)
    js = _jax_setup(clip, pad)
    ch_j = None if ch is None else jnp.asarray(ch)
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=W, height=H, interpret=True, **kw))
    jb = fn.lower(js, channels=ch_j).compile(compiler_options=UNFUSED)(js, channels=ch_j)
    for name in ("records", "tile_start", "tile_count", "num_pairs", "overflowed"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.frecords.numpy().view(np.int32), np.asarray(jb.frecords).view(np.int32))
    # The same stream as the port's default layout, tail slots included.
    base = tbin.bin_triangles(ts, W, H, channels=None if ch is None else torch.from_numpy(ch),
                              **dict(kw, tmpl="xla"))
    assert torch.equal(base.records, tb.records)
    assert torch.equal(base.frecords.view(torch.int32), tb.frecords.view(torch.int32))
    assert int(tb.num_pairs) > 200


def test_wide_rows_take_the_plain_assembly():
    """K = 33: 129 template columns, W8 = 136, rows of 192.  assemble="pallas"
    keeps the plain layout (stream + zero tail), as in the JAX package."""
    clip, ch = _scene(60, 8, 33)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    kw = dict(tile_w=64, tile_h=32, channels=torch.from_numpy(ch), assemble="pallas")
    a = tbin.bin_triangles(ts, W, H, **kw)
    b = tbin.bin_triangles(ts, W, H, tmpl="pallas", **kw)
    assert b.records.shape == (16, 1024 + tbin.SEGMENT_ALIGN) and not b.records[:, 1024:].any()
    assert torch.equal(a.records, b.records)
    assert torch.equal(a.frecords.view(torch.int32), b.frecords.view(torch.int32))


@pytest.mark.parametrize("k, width", [(3, 64), (6, 64), (32, 128)])
@pytest.mark.parametrize("msaa4", [False, True])
def test_rows_plain_version_equals_the_per_field_one(msaa4, k, width):
    """On the same padded slots the row assembly's plain version equals the
    per-field assembly's, invalid tail slots included; the CPU wrappers
    launch nothing.  K = 32 gives the widest rows the kernel stages (126
    used columns of 128)."""
    clip, ch = _scene(120, 11, k)
    ts = tsetup.setup_triangles(torch.from_numpy(clip), W, H)
    ps = tbin.pair_stream(ts, W, H, 128, 8, None, 40, torch.from_numpy(ch), True)
    fused_t, row_width = tbin.templates_field_major(ps.tmpl)
    assert row_width == width
    fused = tasm.transpose_templates(fused_t, row_width)
    fw = tbin.frecord_width(k)
    slots = tbin.padded_slots(ps)
    routes = ("assemble_records", "assemble_records_rows")
    before = [profiling.ROUTES_TAKEN[k] for k in routes]
    rec, frec = tasm.assemble_records_rows(fused, *slots, ps.total, fw, k, msaa4)
    want_rec, want_frec = tasm.assemble_records_reference(ps.tmpl, *slots, ps.total, fw, msaa4)
    assert [profiling.ROUTES_TAKEN[k] for k in routes] == before
    assert torch.equal(rec, want_rec)
    assert torch.equal(frec.view(torch.int32), want_frec.view(torch.int32))
    assert (rec[:3, int(ps.total):] == tasm.INVALID_EDGE).all()
    with pytest.raises(ValueError, match="channels"):
        tasm.assemble_records_rows(fused, *slots, ps.total, fw, k + 5, msaa4)


@pytest.mark.parametrize("k, width", [(3, 42), (6, 63), (32, 130)])
def test_rows_width_must_be_a_multiple_of_4(k, width):
    """The kernel copies template rows in 16-byte chunks, so both versions
    refuse a row width that is not a multiple of 4 int32."""
    fused = torch.zeros((5, width), dtype=torch.int32)
    slots = torch.zeros(128, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 4"):
        tasm.assemble_records_rows(fused, slots, slots, slots, torch.tensor(3), tbin.frecord_width(k), k)


@pytest.mark.parametrize("demo", ["cube", "big_mesh"])
def test_frame_with_tmpl_equals_the_default(demo):
    r = tbrt.Renderer(tbrt.RendererConfig(192, 96), device="cpu")
    kw = {"triangles": 2000} if demo == "big_mesh" else {}
    pipe, mesh, u, _ = getattr(tdemos, f"{demo}_demo")(r, **kw)
    if demo == "big_mesh":
        pipe = dataclasses.replace(pipe, raster_pairs_factor=16.0)
    a = r.render_frame(pipe, mesh, u(0.3))
    b = r.render_frame(dataclasses.replace(pipe, raster_tmpl="pallas"), mesh, u(0.3))
    assert not bool(b.overflowed) and (b.tri_id >= 0).any()
    assert torch.equal(a.tri_id, b.tri_id) and torch.equal(a.depth_q, b.depth_q)
    assert torch.equal(a.color_planar, b.color_planar)


def test_frame_with_tmpl_equals_jax():
    """The JAX package's tmpl frame (its test_tmpl_pallas_end_to_end_frame)
    against the port's: each package runs its own vertex matmul, so tri_id
    on >= 99.9% of pixels, colour within 1e-4 where it agrees."""
    jr = jbrt.Renderer(jbrt.RendererConfig(192, 96, raster_backend="pallas"))
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    jf = jr.render_frame(dataclasses.replace(jpipe, raster_tmpl="pallas"), jmesh, ju(0.3))
    tr = tbrt.Renderer(tbrt.RendererConfig(192, 96), device="cpu")
    tpipe, tmesh, tu, _ = tdemos.cube_demo(tr)
    tf = tr.render_frame(dataclasses.replace(tpipe, raster_tmpl="pallas"), tmesh, tu(0.3))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)
