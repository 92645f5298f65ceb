"""The port as a package: no jax, the same knobs, out-of-slice errors."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch.utils.errors import DeviceError, FeatureNotPresentError, ShaderError

PORT = pathlib.Path(tbrt.__file__).resolve().parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys, based_renderer_tpu_torch, based_renderer_tpu_torch.ops.raster, "
        "based_renderer_tpu_torch.ops._build, based_renderer_tpu_torch.convert; "
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
    dict(stencil=tbrt.StencilState(enable=True)),
    dict(blend=tbrt.BlendState(enable=True)),
    dict(depth=tbrt.DepthState(bias_enable=True)),
    dict(shade_compact=0.5),
    dict(instance_cull=0.5),
    dict(raster_sublane=True),
    dict(raster_batch=8),
    dict(raster_two_pass=True),
    dict(raster_assemble="pallas"),
    dict(raster_tmpl="pallas"),
]


@pytest.mark.parametrize("kw", _OUT_OF_SLICE)
def test_out_of_slice_state_raises(kw):
    r = tbrt.Renderer(tbrt.RendererConfig(64, 32), device="cpu")
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    r.begin_frame()
    with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
        r.draw(dataclasses.replace(pipe, **kw), mesh, u(0.0))


def test_out_of_slice_renderer_state_raises():
    for kw in (dict(msaa=4), dict(msaa_supersample=True)):
        with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
            tbrt.Renderer(tbrt.RendererConfig(64, 32, **kw), device="cpu")
    r = tbrt.Renderer(tbrt.RendererConfig(64, 32), device="cpu")
    with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
        r.upload_texture(np.zeros((4, 4, 3), np.float32))
    pipe, mesh, u, _ = tbrt.demos.cube_demo(r)
    r.begin_frame()
    with pytest.raises(FeatureNotPresentError, match="ROADMAP"):
        r.draw(pipe, mesh, u(0.0), instances={"transform": np.eye(4, dtype=np.float32)[None]})
    # The default shader name is not registered, in either package.
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
