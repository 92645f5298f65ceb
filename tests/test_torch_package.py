"""The port as a package: no jax, the same knobs, the render state it has
and the errors for what it has not."""

import dataclasses
import pathlib
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch.utils.errors import DeviceError, ShaderError

PORT = pathlib.Path(tbrt.__file__).resolve().parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys, based_renderer_tpu_torch, based_renderer_tpu_torch.ops.raster, "
        "based_renderer_tpu_torch.ops._build, based_renderer_tpu_torch.convert, "
        "based_renderer_tpu_torch.ops.texture, based_renderer_tpu_torch.ops.compact, based_renderer_tpu_torch.ops.cull, "
        "based_renderer_tpu_torch.parallel, based_renderer_tpu_torch.parallel.launch, "
        "based_renderer_tpu_torch.parallel.workers, based_renderer_tpu_torch.entry; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'based_renderer_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_use_no_finished_kernels():
    imports = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|based_renderer_tpu)\b", re.MULTILINE)
    banned = ("scaled_dot_product_attention", "torch.compile", "cudnn", "torch/extension.h")
    for path in list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu")):
        text = path.read_text()
        assert not imports.search(text), path.name
        for word in banned:
            assert word not in text, (path.name, word)


@pytest.mark.parametrize(
    "name", ["Pipeline", "DepthState", "StencilState", "BlendState", "RendererConfig"]
)
def test_state_fields_match_jax(name):
    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
            out.append((f.name, str(f.type), default if not dataclasses.is_dataclass(default) else dataclasses.asdict(default)))
        return out

    assert spec(getattr(tbrt, name)) == spec(getattr(jbrt, name))


def test_validation_matches_jax():
    for kw in (dict(raster_tile=(96, 32)), dict(cull_mode="sideways"), dict(raster_unroll=3)):
        for mod in (jbrt, tbrt):
            with pytest.raises(ValueError):
                mod.Pipeline(**kw)
    for kw in (dict(msaa=2), dict(width=0), dict(height=9000)):
        for mod in (jbrt, tbrt):
            with pytest.raises(ValueError):
                mod.RendererConfig(**kw)


_OUT_OF_SLICE = [
    dict(stencil=tbrt.StencilState(enable=True, ref=3, pass_op="replace", depth_fail_op="increment_clamp")),
    dict(blend=tbrt.BlendState(enable=True, src_factor="constant_alpha", dst_factor="one_minus_constant_alpha",
                               constants=(0.0, 0.0, 0.0, 0.5))),
    dict(depth=tbrt.DepthState(bias_enable=True, bias_constant=-64.0, bias_slope=1.5)),
    dict(shade_compact=0.5),
    dict(instance_cull=0.5),
    dict(raster_batch=8, raster_tile=(128, 8)),  # batch with eligible depth state
    dict(raster_batch=8),
    dict(raster_two_pass=True),
    dict(raster_sublane=True, raster_two_pass=True),
    dict(raster_tmpl="pallas"),
]


def _as_jax(value):
    """A port state dataclass as the JAX package's, field for field."""
    if dataclasses.is_dataclass(value):
        return getattr(jbrt, type(value).__name__)(**dataclasses.asdict(value))
    return value


def _frame(r, pipe, mesh, u):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f = r.render_frame(pipe, mesh, u)
    return f, sorted(str(w.message).split(" requested")[0] for w in caught if w.category is RuntimeWarning)


@pytest.mark.parametrize("kw", _OUT_OF_SLICE)
def test_out_of_slice_state_raises(kw):
    """Stencil, blending, depth bias, shade_compact, instance_cull,
    raster_batch, raster_two_pass and raster_tmpl='pallas' were outside
    the port's slice: they now draw, warn about an ineligible kernel
    variant as the JAX package does, and the
    cube frame equals the JAX package's (each package runs its own vertex
    matmul: tri_id and stencil on >= 99.9% of pixels, colour within 1e-4
    where tri_id agrees).  Both packages run the Pallas backend, whose
    rule the variant warnings follow.  At 64x32 neither package compacts
    (64 is not a multiple of 128), so shade_compact shades full-screen in
    both.  The cube draw has no instance table, so instance_cull culls
    nothing in either package (tests/test_torch_cull.py culls)."""
    r = tbrt.Renderer(tbrt.RendererConfig(64, 32, raster_backend="pallas"), device="cpu")
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    tf, t_warn = _frame(r, dataclasses.replace(pipe, **kw), mesh, u(0.7))
    jr = jbrt.Renderer(jbrt.RendererConfig(64, 32, raster_backend="pallas"))
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    jf, j_warn = _frame(jr, dataclasses.replace(jpipe, **{k: _as_jax(v) for k, v in kw.items()}), jmesh, ju(0.7))
    assert t_warn == j_warn
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999 and (tf.tri_id >= 0).any()
    np.testing.assert_allclose(tf.color_np()[same], jf.color_np()[same], rtol=0, atol=1e-4)
    assert (tf.stencil is None) == (jf.stencil is None) == ("stencil" not in kw)
    if tf.stencil is not None:
        assert (tf.stencil.numpy() == np.asarray(jf.stencil)).mean() >= 0.999 and int(tf.stencil.max()) >= 3


def test_out_of_slice_renderer_state_raises():
    # Under MSAA and supersampling stencil draws now, one layer per sample
    # (or at twice the extent); so does shade_compact, which at 64x32 (not
    # a multiple of 128 wide) shades full-screen, as in the JAX package.
    for kw, shape in ((dict(msaa=4), (4, 32, 64)), (dict(msaa=4, msaa_supersample=True), (64, 128))):
        r = tbrt.Renderer(tbrt.RendererConfig(64, 32, **kw), device="cpu")
        pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
        stamp = dataclasses.replace(pipe, stencil=tbrt.StencilState(enable=True, ref=5, pass_op="replace"))
        f = r.render_frame(stamp, mesh, u(0.0))
        assert tuple(f.stencil.shape) == shape
        assert torch.equal(f.stencil == 5, f.tri_id >= 0)
        r.begin_frame()
        r.draw(dataclasses.replace(pipe, shade_compact=0.5), mesh, u(0.0))
        compacted = r.end_frame()
        assert torch.equal(compacted.color_planar, r.render_frame(pipe, mesh, u(0.0)).color_planar)
    r = tbrt.Renderer(tbrt.RendererConfig(64, 32), device="cpu")
    tex = r.upload_texture(np.zeros((4, 4, 3), np.float32))
    assert isinstance(tex, tbrt.Texture) and tex.meta == jbrt.upload_texture(np.zeros((4, 4, 3), np.float32)).meta
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    # Instance tables are in the slice: one identity instance under a
    # shader that ignores the transform renders the plain draw.
    r.begin_frame()
    r.draw(pipe, mesh, u(0.0), instances={"transform": np.eye(4, dtype=np.float32)[None]})
    inst = r.end_frame()
    assert torch.equal(inst.tri_id, r.render_frame(pipe, mesh, u(0.0)).tri_id)
    assert inst.stencil is None  # no draw turned stencil on
    # The default shader name is not registered, in either package.
    r.begin_frame()
    with pytest.raises(ShaderError):
        r.draw(tbrt.Pipeline(), mesh)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tbrt.Renderer(tbrt.RendererConfig(8, 8)).device.type == "cuda"
    else:
        with pytest.raises(DeviceError):
            tbrt.Renderer(tbrt.RendererConfig(8, 8))


def test_convert_round_trips_the_cube():
    jr = jbrt.Renderer(jbrt.RendererConfig(64, 48, raster_backend="pallas"))
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    mesh = tbrt.convert.mesh_from_numpy({k: np.asarray(v) for k, v in jmesh.attributes.items()})
    uni = tbrt.convert.uniforms_from_numpy({k: np.asarray(v) for k, v in ju(0.4).items()})
    pipe = tbrt.convert.pipeline_from_dict(dataclasses.asdict(jpipe))
    assert dataclasses.asdict(pipe) == dataclasses.asdict(jpipe)
    for k, v in jmesh.attributes.items():
        np.testing.assert_array_equal(mesh.attributes[k].numpy(), np.asarray(v))
    for k, v in ju(0.4).items():
        assert uni[k].dtype == torch.float32
        np.testing.assert_array_equal(uni[k].numpy(), np.asarray(v))
    tr = tbrt.Renderer(tbrt.RendererConfig(64, 48), device="cpu")
    tf = tr.render_frame(pipe, mesh, uni)
    jf = jr.render_frame(jpipe, jmesh, ju(0.4))
    same = tf.tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999
    # An indexed mesh gathers its triangles through the indices.
    pos = np.asarray(jmesh.attributes["position"])[:6]
    idx = np.array([[0, 1, 2], [3, 4, 5], [0, 1, 2]], np.int32)
    m = tbrt.convert.mesh_from_numpy({"position": pos}, idx)
    assert m.num_triangles == 3 and m.indices.dtype == torch.int32
    with pytest.raises(ValueError):
        tbrt.convert.mesh_from_numpy({"position": pos}, np.array([[0, 1, 6]]))
