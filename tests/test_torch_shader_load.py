"""Shader modules loaded from source files: the port's load_file and
load_module against the JAX package's (tests/test_shader_load.py, with
torch twins of its shader sources), and the math3d helpers shader files
call (identity, scale, transform_directions) against JAX at atol 1e-6.

Tolerances: the port's file-loaded cube frame equals its built-in one
bitwise (tri_id, depth_q, colour); against the JAX package's file-loaded
frame at raster_backend="pallas": tri_id and depth_q exact, colour within
1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu import math3d as jm
from based_renderer_tpu import shader as jshader
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch import math3d as tm
from based_renderer_tpu_torch import shader
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.utils.errors import ShaderError

W, H = 128, 96

# The JAX test's module, in torch: plain vertex/fragment functions using the
# vocabulary load_file puts in scope (torch, mvp_transform, ...).
MODULE_SRC = """
ATTRIBUTES = ("color",)

def vertex(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}

def fragment(frag, uniforms):
    rgb = frag["color"] * float(uniforms.get("gain", 1.0))
    a = torch.ones((*rgb.shape[:-1], 1), dtype=rgb.dtype, device=rgb.device)
    return torch.cat([rgb, a], -1)
"""

JAX_MODULE_SRC = """
ATTRIBUTES = ("color",)

def vertex(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}

def fragment(frag, uniforms):
    rgb = frag["color"] * jnp.float32(uniforms.get("gain", 1.0))
    a = jnp.ones((*rgb.shape[:2], 1), jnp.float32)
    return jnp.concatenate([rgb, a], -1)
"""

SHADER_VAR_SRC = """
def _vs(attrs, uniforms):
    p = attrs["position"]
    p = torch.cat([p, torch.ones((*p.shape[:-1], 1), dtype=p.dtype, device=p.device)], -1)
    return p, {}

def _fs(frag, uniforms):
    tri = frag["tri_id"]
    return torch.tensor((0.25, 0.5, 0.75, 1.0), device=tri.device).expand(*tri.shape, 4)

SHADER = Shader("disk_flat", _vs, _fs)
"""


@pytest.fixture
def registry(monkeypatch):
    """The registry as it was before the test, restored after it."""
    monkeypatch.setattr(shader, "_REGISTRY", dict(shader._REGISTRY))
    return shader._REGISTRY


def test_load_file_and_render(tmp_path, registry):
    path = tmp_path / "disk_color.py"
    path.write_text(MODULE_SRC)
    shd = shader.load_file(path)
    assert shd.name == "disk_color"
    assert shd.attributes == ("color",)
    assert shader.get("disk_color") is shd
    # The cube demo through the disk-loaded shader: it is the vertex_color
    # program, so the frame equals the built-in one bit for bit.
    r = tbrt.Renderer(tbrt.RendererConfig(width=W, height=H), device="cpu")
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    ref = r.render_frame(pipe, mesh, uniforms(0.3))
    got = r.render_frame(dataclasses.replace(pipe, shader="disk_color"), mesh, uniforms(0.3))
    assert torch.equal(ref.tri_id, got.tri_id) and torch.equal(ref.depth_q, got.depth_q)
    assert torch.equal(ref.color_planar, got.color_planar)
    np.testing.assert_array_equal(ref.color_u8(), got.color_u8())
    assert (got.tri_id >= 0).any()


def _jax_cube_clip(r, t):
    """The cube's clip-space corners as the JAX package computes them."""
    pipe, mesh, uniforms, _ = jdemos.cube_demo(r)
    clip, _ = jbrt.shader.get(pipe.shader).vertex(mesh.attributes, uniforms(t))
    return np.asarray(clip), np.asarray(mesh.attributes["color"])


def _both_loaded(tmp_path, monkeypatch, src, jax_src):
    """Load ``src`` into the port and ``jax_src`` into the JAX package, both
    as "disk_color"; returns a (port, JAX) renderer pair at pallas."""
    (tmp_path / "tdisk.py").write_text(src)
    (tmp_path / "jdisk.py").write_text(jax_src)
    monkeypatch.setattr(jshader, "_REGISTRY", dict(jshader._REGISTRY))
    assert shader.load_file(tmp_path / "tdisk.py", name="disk_color").attributes == ("color",)
    assert jshader.load_file(tmp_path / "jdisk.py", name="disk_color").attributes == ("color",)
    tr = tbrt.Renderer(tbrt.RendererConfig(width=W, height=H, raster_backend="pallas"), device="cpu")
    jr = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, raster_backend="pallas"))
    return tr, jr


@pytest.mark.parametrize("t", [0.3, 1.1])
def test_file_loaded_frame_matches_jax(tmp_path, registry, monkeypatch, t):
    """Each package's file-loaded shader fed the same clip-space cube (the
    JAX package's vertex matmul, the stage before which the packages are
    float-approximate): tri_id and depth_q exact, colour within 1e-4."""
    clip_src = MODULE_SRC.replace("mvp_transform(attrs, uniforms)", 'attrs["position"]')
    jax_clip_src = JAX_MODULE_SRC.replace("mvp_transform(attrs, uniforms)", 'attrs["position"]')
    tr, jr = _both_loaded(tmp_path, monkeypatch, clip_src, jax_clip_src)
    clip, color = _jax_cube_clip(jr, t)
    pipe = jbrt.Pipeline(shader="disk_color", depth=jbrt.DepthState(compare="less"))
    tpipe = tbrt.convert.pipeline_from_dict(dataclasses.asdict(pipe))
    jf = jr.render_frame(pipe, jr.upload_mesh(clip, color=color))
    tf = tr.render_frame(tpipe, tr.upload_mesh(clip, color=color))
    assert (tf.tri_id >= 0).sum() > 0
    np.testing.assert_array_equal(tf.tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(tf.depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(tf.color_np(), jf.color_np(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("t", [0.3, 1.1])
def test_file_loaded_cube_matches_jax(tmp_path, registry, monkeypatch, t):
    """The cube demo through each package's file-loaded MVP shader, each
    package doing its own vertex matmul (as tests/test_torch_renderer.py's
    real demos): tri_id equal on >= 99.9% of pixels, colour within 1e-4
    where it agrees."""
    tr, jr = _both_loaded(tmp_path, monkeypatch, MODULE_SRC, JAX_MODULE_SRC)
    tpipe, tmesh, tu, _ = demos.cube_demo(tr)
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    tf = tr.render_frame(dataclasses.replace(tpipe, shader="disk_color"), tmesh, tu(t))
    jf = jr.render_frame(dataclasses.replace(jpipe, shader="disk_color"), jmesh, ju(t))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999 and (tf.tri_id >= 0).any()
    np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)


def test_load_file_shader_variable_and_rename(tmp_path, registry):
    path = tmp_path / "mymod.py"
    path.write_text(SHADER_VAR_SRC)
    shd = shader.load_file(path)
    assert shd.name == "disk_flat"  # SHADER's own name wins namelessly
    shd2 = shader.load_file(path, name="disk_flat2")
    assert shd2.name == "disk_flat2"
    # Re-exec'd module: same entry-point code, fresh function objects.
    assert shader.get("disk_flat2").fragment.__code__.co_code == shd.fragment.__code__.co_code
    # The module renders: NDC passthrough, one constant colour.
    r = tbrt.Renderer(tbrt.RendererConfig(width=32, height=32), device="cpu")
    tri = r.upload_mesh(np.array([[-0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.0, -0.5, 0.5]], np.float32))
    f = r.render_frame(tbrt.Pipeline(shader="disk_flat2"), tri)
    covered = f.color_np()[f.tri_id.numpy() >= 0]
    assert len(covered) > 0 and (covered == np.float32([0.25, 0.5, 0.75, 1.0])).all()


def test_load_module_search_path(tmp_path, registry):
    (tmp_path / "trimod.py").write_text(SHADER_VAR_SRC)
    shd = shader.load_module("trimod", search_paths=[str(tmp_path)])
    assert shader.get("trimod") is shd
    # Registered names short-circuit the filesystem.
    assert shader.load_module("trimod", search_paths=["/nonexistent"]) is shd
    with pytest.raises(ShaderError, match="search path"):
        shader.load_module("no_such_module", search_paths=[str(tmp_path)])


def test_load_module_default_search_path(tmp_path, registry, monkeypatch):
    (tmp_path / "pathmod.py").write_text(SHADER_VAR_SRC)
    monkeypatch.setattr(shader, "MODULE_SEARCH_PATH", [str(tmp_path / "missing"), str(tmp_path)])
    assert shader.load_module("pathmod").name == "pathmod"


def test_load_file_syntax_error(tmp_path):
    path = tmp_path / "broken.py"
    path.write_text("def vertex(attrs, uniforms:\n    pass\n")
    with pytest.raises(ShaderError, match="SyntaxError") as e:
        shader.load_file(path)
    assert str(path) in str(e.value) and "flat_ndc" in str(e.value)


def test_load_file_runtime_error(tmp_path):
    path = tmp_path / "raises.py"
    path.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(ShaderError, match="boom") as e:
        shader.load_file(path)
    assert str(path) in str(e.value) and "flat_ndc" in str(e.value)


def test_load_file_no_entry_points(tmp_path):
    path = tmp_path / "empty.py"
    path.write_text("x = 1\n")
    with pytest.raises(ShaderError, match="no entry points"):
        shader.load_file(path)
    # Diagnostics carry the registered-module list (the SLANG_CHECK analog).
    with pytest.raises(ShaderError, match="flat_ndc"):
        shader.load_file(path)


def test_load_file_missing_file():
    with pytest.raises(ShaderError, match="cannot read"):
        shader.load_file("/nonexistent/shader_module.py")


def test_entry_points_win_over_imported_shader(tmp_path, registry):
    # A module may import/inspect an existing Shader while defining its
    # own vertex/fragment: the explicit entry points win, not the stray
    # imported value.
    path = tmp_path / "derived.py"
    path.write_text(
        "from based_renderer_tpu_torch import shader as _s\n"
        "BASE = _s.get('vertex_color')  # inspected, not the entry point\n"
        "def vertex(attrs, uniforms):\n"
        "    return BASE.vertex(attrs, uniforms)\n"
        "def fragment(frag, uniforms):\n"
        "    rgba = BASE.fragment(frag, uniforms)\n"
        "    return rgba * 0.5\n"
    )
    shd = shader.load_file(path)
    assert shd.name == "derived"
    assert shd.vertex is not shader.get("vertex_color").vertex


def test_aliased_shader_counts_once(tmp_path, registry):
    path = tmp_path / "aliased.py"
    path.write_text(SHADER_VAR_SRC.replace("SHADER = ", "A = ") + "B = A\n")  # two names, ONE shader
    assert shader.load_file(path).name == "disk_flat"


def test_two_shader_values_are_ambiguous(tmp_path, registry):
    path = tmp_path / "two.py"
    path.write_text(SHADER_VAR_SRC.replace("SHADER = ", "A = ") + 'B = Shader("other", _vs, _fs)\n')
    with pytest.raises(ShaderError, match="found 2 distinct Shader values"):
        shader.load_file(path)
    with pytest.raises(jbrt.errors.ShaderError, match="found 2 distinct Shader values"):
        jshader.load_file(path)  # the same source gives the same verdict in the JAX package


# ---------------------------------------------------------------------------
# math3d helpers that shader files call, against the JAX package (atol 1e-6)
# ---------------------------------------------------------------------------


def test_identity_matches_jax():
    np.testing.assert_array_equal(tm.identity().numpy(), np.asarray(jm.identity()))
    assert tm.identity().dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-3, 3, 3).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(tm.scale(v).numpy(), np.asarray(jm.scale(v)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.scale(v, torch.from_numpy(m)).numpy(), np.asarray(jm.scale(v, m)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_directions_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = np.array(jm.rotate(rng.uniform(-3, 3), rng.normal(size=3), jm.translate(rng.normal(size=3))))
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    got = tm.transform_directions(torch.from_numpy(m), dirs)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.transform_directions(m, dirs)), rtol=0, atol=1e-6)
    # w = 0: the translation does not move a direction.
    assert torch.equal(got, tm.transform_directions(tm.translate(rng.normal(size=3), torch.from_numpy(m)), dirs))
