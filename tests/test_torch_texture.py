"""Texture sampling and the textured frames: the port vs the JAX package.

Mirrors tests/test_texture.py.  Every sampler and the LOD take the same
seeded numpy UVs in both packages; samplers agree within 1e-5 (each
package runs its own mul-add chains: XLA may contract them into FMAs),
the separable resampler within the 3e-7 that the JAX package holds its
own separable and gather paths to (test_texture.py:289), and the packed
patch rows and mip chain exactly.  Textured frames from shared
clip-space input: tri_id and depth_q exact, colour within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.models import geometry as jgeom
from based_renderer_tpu.ops import texture as jtex
from based_renderer_tpu_torch.models import demos as tdemos
from based_renderer_tpu_torch.models import geometry as tgeom
from based_renderer_tpu_torch.ops import texture as ttex

TOL = 1e-5
SEP_TOL = 3e-7


def _both_textures(img, **kw):
    jt = jbrt.upload_texture(img, **kw)
    tt = tbrt.upload_texture(img, **kw)
    return jt, tt


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _uv(seed, shape, lo=-0.3, hi=1.3):
    return np.random.default_rng(seed).uniform(lo, hi, size=(*shape, 2)).astype(np.float32)


def _uv_grid(h, w, scale=1.0):
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([(u + 0.5) / w * scale, (v + 0.5) / h * scale], axis=-1)


def reference_bilinear(tex, uv, wrap):
    th, tw, c = tex.shape
    out = np.zeros((*uv.shape[:-1], c), np.float32)

    def wr(v, size):
        return v % size if wrap == "repeat" else np.clip(v, 0, size - 1)

    for idx in np.ndindex(uv.shape[:-1]):
        fx = uv[idx][0] * tw - 0.5
        fy = uv[idx][1] * th - 0.5
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        ax, ay = fx - x0, fy - y0
        t00 = tex[wr(y0, th), wr(x0, tw)]
        t01 = tex[wr(y0, th), wr(x0 + 1, tw)]
        t10 = tex[wr(y0 + 1, th), wr(x0, tw)]
        t11 = tex[wr(y0 + 1, th), wr(x0 + 1, tw)]
        out[idx] = (t00 * (1 - ax) + t01 * ax) * (1 - ay) + (t10 * (1 - ax) + t11 * ax) * ay
    return out


@pytest.mark.parametrize("wrap", ["repeat", "clamp", "mirror"])
def test_raw_samplers_match_jax(wrap):
    rng = np.random.default_rng(0)
    tex = rng.random((8, 16, 3)).astype(np.float32)
    uv = _uv(1, (6, 7))
    got = ttex.sample_bilinear(_t(tex), _t(uv), wrap=wrap).numpy()
    np.testing.assert_allclose(got, np.asarray(jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv), wrap=wrap)),
                               rtol=0, atol=TOL)
    if wrap != "mirror":
        np.testing.assert_allclose(got, reference_bilinear(tex, uv, wrap), rtol=0, atol=TOL)
    near = ttex.sample_nearest(_t(tex), _t(uv), wrap=wrap).numpy()
    np.testing.assert_array_equal(near, np.asarray(jtex.sample_nearest(jnp.asarray(tex), jnp.asarray(uv), wrap=wrap)))


def test_nearest_and_bilinear_at_texel_centers():
    tex = np.arange(12, dtype=np.float32).reshape(3, 4, 1)
    uv = np.array([[(x + 0.5) / 4, (y + 0.5) / 3] for y in range(3) for x in range(4)], np.float32)
    np.testing.assert_array_equal(ttex.sample_nearest(_t(tex), _t(uv))[:, 0].numpy(), np.arange(12))
    rng = np.random.default_rng(1)
    tex2 = rng.random((4, 4, 2)).astype(np.float32)
    uv2 = np.array([[(x + 0.5) / 4, (y + 0.5) / 4] for y in range(4) for x in range(4)], np.float32)
    np.testing.assert_allclose(ttex.sample_bilinear(_t(tex2), _t(uv2)).numpy(), tex2.reshape(16, 2), atol=1e-6)
    with pytest.raises(ValueError, match="wrap"):
        ttex.sample_bilinear(_t(tex2), _t(uv2), wrap="border")


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("mipmaps", [False, True])
def test_upload_matches_jax(wrap, mipmaps):
    img = np.random.default_rng(2).uniform(size=(16, 32, 3)).astype(np.float32)
    jt, tt = _both_textures(img, wrap=wrap, mipmaps=mipmaps)
    assert tt.meta == jt.meta and tt.num_levels == (6 if mipmaps else 1)
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    # The packed sampler equals the raw bilinear sampler at level 0.
    uv = _t(_uv(3, (24, 24)))
    np.testing.assert_allclose(ttex.sample_texture(tt, uv).numpy(), ttex.sample_bilinear(_t(img), uv, wrap=wrap).numpy(),
                               rtol=0, atol=1e-6)


def test_upload_rules_and_sampler_state():
    img = tgeom.checkerboard_texture(64)
    np.testing.assert_array_equal(img, jgeom.checkerboard_texture(64))
    tex = tbrt.upload_texture(img, mipmaps=True)
    assert tex.num_levels == 7 and tex.meta[2][0] == (64, 64) and tex.meta[2][-1] == (1, 1)
    assert tex.mip_filter == "linear" and tex.wrap == "repeat"
    u8 = tbrt.upload_texture((img * 255).astype(np.uint8))
    np.testing.assert_array_equal(u8.data.numpy(), np.asarray(jbrt.upload_texture((img * 255).astype(np.uint8)).data))
    for mod in (jbrt, tbrt):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.upload_texture(np.zeros((6, 8, 3), np.float32), mipmaps=True)
        with pytest.raises(ValueError, match="mip_filter"):
            mod.upload_texture(img, mip_filter="cubic")
    r = tbrt.Renderer(tbrt.RendererConfig(32, 32), device="cpu")
    t = r.upload_texture(img, wrap="clamp", mipmaps=True, mip_filter="nearest")
    assert (t.wrap, t.mip_filter, t.num_levels, t.packed.device.type) == ("clamp", "nearest", 7, "cpu")


def test_texture_from_numpy_round_trips():
    jt = jbrt.upload_texture(jgeom.checkerboard_texture(32), wrap="clamp", mipmaps=True)
    tt = tbrt.convert.texture_from_numpy(np.asarray(jt.data), np.asarray(jt.packed), jt.meta)
    assert tt.meta == jt.meta
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    with pytest.raises(ValueError, match="packed"):
        tbrt.convert.texture_from_numpy(np.asarray(jt.data), np.asarray(jt.packed)[:-1], jt.meta)
    with pytest.raises(ValueError, match="data"):
        tbrt.convert.texture_from_numpy(np.asarray(jt.data)[:, :-1], np.asarray(jt.packed), jt.meta)


@pytest.mark.parametrize("shape", [(20, 24), (3, 12, 16), (2, 8, 128)])
def test_lod_from_uv_matches_jax_per_image(shape):
    """The LOD over the two screen axes: a (H, W) field equals JAX's, and
    each layer of a batch, sample layers or tiles, equals JAX's on it."""
    uv = _uv(4, shape, 0.0, 3.0) * np.linspace(0.5, 2.0, shape[-1], dtype=np.float32)[:, None]
    got = ttex.lod_from_uv(_t(uv), 64, 128).numpy()
    layers = uv.reshape(-1, *shape[-2:], 2)
    want = np.stack([np.asarray(jtex.lod_from_uv(jnp.asarray(x), 64, 128)) for x in layers]).reshape(shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("mip_filter", ["nearest", "linear"])
def test_mip_samplers_match_jax(wrap, mip_filter):
    jt, tt = _both_textures(jgeom.checkerboard_texture(64), wrap=wrap, mipmaps=True, mip_filter=mip_filter)
    uv = _uv(5, (3, 16, 16), -0.4, 1.7)
    lod = np.random.default_rng(6).uniform(-1.0, 8.0, size=(3, 16, 16)).astype(np.float32)
    got = ttex.sample_texture(tt, _t(uv), _t(lod)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtex.sample_texture(jt, jnp.asarray(uv), jnp.asarray(lod))),
                               rtol=0, atol=TOL)
    tri = ttex.sample_trilinear(tt, _t(uv), _t(lod)).numpy()
    np.testing.assert_allclose(tri, np.asarray(jtex.sample_trilinear(jt, jnp.asarray(uv), jnp.asarray(lod))),
                               rtol=0, atol=TOL)
    lvl = np.random.default_rng(7).integers(0, 7, size=(3, 16, 16)).astype(np.int32)
    np.testing.assert_allclose(ttex._sample_packed_level(tt, _t(uv), _t(lvl)).numpy(),
                               np.asarray(jtex._sample_packed_level(jt, jnp.asarray(uv), jnp.asarray(lvl))),
                               rtol=0, atol=TOL)


def test_trilinear_limits_and_minification():
    img = tgeom.checkerboard_texture(64)
    tex = tbrt.upload_texture(img, mipmaps=True)
    uv = _t(_uv_grid(32, 32))
    s0 = ttex.sample_trilinear(tex, uv, torch.zeros(32, 32))
    np.testing.assert_allclose(s0.numpy(), ttex.sample_bilinear(_t(img), uv).numpy(), atol=1e-6)
    top = ttex.sample_trilinear(tex, uv, torch.full((32, 32), 6.0)).numpy()
    np.testing.assert_allclose(top, np.broadcast_to(img.reshape(-1, 3).mean(0), top.shape), atol=3e-4)
    big = tbrt.upload_texture(tgeom.checkerboard_texture(256), mipmaps=True)
    uvm = _t(_uv_grid(64, 64, scale=19.37))
    lod = ttex.lod_from_uv(uvm, 256, 256)
    assert float(lod.mean()) > 4.0
    minified = ttex.sample_texture(big, uvm, lod)
    assert float(minified[..., 0].std()) < 0.25 * float(ttex.sample_bilinear(big.data, uvm)[..., 0].std())


@pytest.mark.parametrize("max_aniso", [1, 4, 8])
def test_anisotropic_matches_jax(max_aniso):
    jt, tt = _both_textures(jgeom.checkerboard_texture(256), mipmaps=True)
    v, u = np.mgrid[0:48, 0:40].astype(np.float32)
    uv = np.stack([(u + 0.5) / 40 * 8.0, (v + 0.5) / 48 * 0.9], axis=-1)
    got = ttex.sample_anisotropic(tt, _t(uv), max_aniso=max_aniso).numpy()
    want = np.asarray(jtex.sample_anisotropic(jt, jnp.asarray(uv), max_aniso=max_aniso))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # Two layers at once equal each layer alone.
    both = ttex.sample_anisotropic(tt, _t(np.stack([uv, uv[::-1].copy()])), max_aniso=max_aniso).numpy()
    np.testing.assert_array_equal(both[0], got)
    with pytest.raises(ValueError, match="max_aniso"):
        ttex.sample_anisotropic(tt, _t(uv), max_aniso=0)


def _broadcast_uv(u_row, v_col):
    h, w = v_col.shape[0], u_row.shape[0]
    return np.stack([np.broadcast_to(u_row[None, :], (h, w)), np.broadcast_to(v_col[:, None], (h, w))], axis=-1)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("mip_filter", ["nearest", "linear"])
def test_separable_matches_jax_and_the_gather_path(wrap, mip_filter):
    rng = np.random.default_rng(7)
    img = rng.random((16, 32, 4)).astype(np.float32)
    jt, tt = _both_textures(img, wrap=wrap, mipmaps=True, mip_filter=mip_filter)
    u_row = rng.uniform(-0.4, 1.7, (40,)).astype(np.float32)
    v_col = rng.uniform(-0.4, 1.7, (24,)).astype(np.float32)
    uv = _t(_broadcast_uv(u_row, v_col))
    for lod in (-1.0, 0.0, 0.7, 1.49, 2.51, 9.0):
        got = ttex.sample_separable(tt, _t(u_row), _t(v_col), torch.tensor(lod))
        want = np.asarray(jtex.sample_separable(jt, jnp.asarray(u_row), jnp.asarray(v_col), jnp.float32(lod)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SEP_TOL, err_msg=f"lod={lod}")
        gather = ttex.sample_texture(tt, uv, torch.full(uv.shape[:-1], lod))
        np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=0, atol=SEP_TOL, err_msg=f"lod={lod}")
    # Layers with their own LOD equal each layer alone.
    lods = torch.tensor([0.7, 2.51])
    two = ttex.sample_separable(tt, _t(np.stack([u_row, u_row])), _t(np.stack([v_col, v_col[::-1].copy()])), lods)
    one = ttex.sample_separable(tt, _t(u_row), _t(v_col[::-1].copy()), lods[1])
    assert torch.equal(two[1], one)


def test_separable_fetch_and_single_level():
    rng = np.random.default_rng(9)
    base = rng.random((8, 16, 4)).astype(np.float32)
    tex = tbrt.upload_texture(base)
    u_row = _t((np.arange(16) + 0.5).astype(np.float32) / 16.0)
    v_col = _t((np.arange(8) + 0.5).astype(np.float32) / 8.0)
    np.testing.assert_array_equal(ttex.sample_separable(tex, u_row, v_col).numpy(), base)
    tex3 = tbrt.upload_texture(rng.random((8, 8, 3)).astype(np.float32))
    u, v = torch.linspace(0.0, 1.0, 17), torch.linspace(0.1, 0.9, 9)
    uv = _t(_broadcast_uv(u.numpy(), v.numpy()))
    assert torch.equal(ttex.sample_separable(tex3, u, v), ttex.sample_texture(tex3, uv))
    with pytest.raises(ValueError, match="Texture"):
        ttex.sample_separable(tex3.data, u, v)


def test_fullscreen_separable_matches_gather():
    """The textured_fullscreen shader's separable path against its gather
    variant (test_texture.py's test_fullscreen_shader_separable_matches_gather):
    the last row and column differ by design (the gather LOD bends there)."""
    r = tbrt.Renderer(tbrt.RendererConfig(128, 96), device="cpu")
    pipe, mesh, u, _ = tdemos.textured_fullscreen_demo(r)
    f_sep = r.render_frame(pipe, mesh, u(0.4))
    f_gat = r.render_frame(dataclasses.replace(pipe, shader="textured_fullscreen_gather"), mesh, u(0.4))
    assert torch.equal(f_sep.tri_id, f_gat.tri_id)
    cs, cg = f_sep.color_planar.numpy(), f_gat.color_planar.numpy()
    np.testing.assert_allclose(cs[:, :-1, :-1], cg[:, :-1, :-1], atol=2e-4)
    assert np.abs(cs - cg).max() < 0.5


# ---------------------------------------------------------------------------
# Textured frames against the JAX package
# ---------------------------------------------------------------------------


def _ndc_textured(mod, monkeypatch):
    """textured_lit's fragment behind a vertex stage that passes clip space
    and the varyings through, registered in package ``mod`` for one test."""

    def vs(attrs, uniforms):
        return attrs["position"], {"uv": attrs["uv"], "normal": attrs["normal"]}

    monkeypatch.setitem(mod.shader._REGISTRY, "ndc_textured_lit",
                        mod.Shader("ndc_textured_lit", vs, mod.shader.get("textured_lit").fragment,
                                   attributes=("uv", "normal")))


def _shared_textured_cube(monkeypatch, width, height, t, **cfg):
    """The textured cube's clip space, uv and world normals as JAX computes
    them, drawn by both packages with the same texture."""
    jr = jbrt.Renderer(jbrt.RendererConfig(width, height, raster_backend="pallas", **cfg))
    tr = tbrt.Renderer(tbrt.RendererConfig(width, height, raster_backend="pallas", **cfg), device="cpu")
    jpipe, jmesh, ju, _ = jdemos.textured_cube_demo(jr)
    u = ju(t)
    clip, var = jbrt.shader.get("textured_lit").vertex(jmesh.attributes, u)
    data = {"position": np.asarray(clip), "uv": np.asarray(var["uv"]), "normal": np.asarray(var["normal"])}
    jt = u["texture"]
    tt = tbrt.convert.texture_from_numpy(np.asarray(jt.data), np.asarray(jt.packed), jt.meta)
    frames = []
    for r, mod, tex in ((jr, jbrt, jt), (tr, tbrt, tt)):
        _ndc_textured(mod, monkeypatch)
        pipe = mod.Pipeline(**{**dataclasses.asdict(jpipe), "shader": "ndc_textured_lit",
                               "depth": mod.DepthState(**dataclasses.asdict(jpipe.depth)),
                               "stencil": mod.StencilState(), "blend": mod.BlendState()})
        mesh = r.upload_mesh(data["position"], uv=data["uv"], normal=data["normal"])
        uni = {"texture": tex, "light_dir": np.asarray(u["light_dir"]), "ambient": 0.15}
        frames.append(r.render_frame(pipe, mesh, uni))
    return frames


def _assert_frames_equal(tf, jf, atol=1e-4):
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=atol)


@pytest.mark.parametrize("extent, t", [((128, 96), 0.5), ((96, 64), 1.7)])
def test_shared_clip_space_textured_cube(extent, t, monkeypatch):
    """128x96 tiles by (8, 128), so both packages shade the cube per
    covered tile (LOD per tile); 96x64 does not, so both shade it
    full-screen (LOD over the whole image)."""
    jf, tf = _shared_textured_cube(monkeypatch, *extent, t)
    assert (tf.tri_id >= 0).any() and not bool(tf.overflowed)
    _assert_frames_equal(tf, jf)


@pytest.mark.parametrize("demo", ["textured_cube", "textured_fullscreen"])
def test_real_textured_demos(demo):
    """128x96 tiles by (8, 128): both packages shade the cube per covered
    tile (the "pallas" backend turns compaction on in both)."""
    jr = jbrt.Renderer(jbrt.RendererConfig(128, 96, raster_backend="pallas"))
    tr = tbrt.Renderer(tbrt.RendererConfig(128, 96, raster_backend="pallas"), device="cpu")
    jpipe, jmesh, ju, _ = getattr(jdemos, f"{demo}_demo")(jr)
    tpipe, tmesh, tu, _ = getattr(tdemos, f"{demo}_demo")(tr)
    assert tpipe == tbrt.convert.pipeline_from_dict(dataclasses.asdict(jpipe))
    jf = jr.render_frame(jpipe, jmesh, ju(0.5))
    tf = tr.render_frame(tpipe, tmesh, tu(0.5))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    if demo == "textured_fullscreen":  # NDC positions: clip space is shared
        _assert_frames_equal(tf, jf)
    assert same.mean() >= 0.999 and (tf.tri_id >= 0).any()
    # A pixel's LOD reads its right and lower neighbours' uv: compare where
    # those agree too.
    lod_same = same.copy()
    lod_same[:, :-1] &= same[:, 1:]
    lod_same[:-1] &= same[1:]
    np.testing.assert_allclose(tf.color_np()[lod_same], jf.color_np()[lod_same], rtol=0, atol=1e-4)
