"""Generated meshes in the port (scene.generated_mesh): vertex data made by code.

Mirrors tests/test_genmesh.py.  The port's on-device generator
(geometry.procedural_mesh_device, torch ops in float32) is held against
the numpy twin (float64) and the JAX package's generator (float32) at the
JAX test's tolerances: 2e-5 on positions and 5e-3 on normals, whose sums
of six face normals drift more.  A sequence regenerates the mesh once per
call into buffers its program owns, so the program's key carries no
attribute ids.
"""

import jax
import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import geometry as jgeometry
from based_renderer_tpu_torch.models import demos, geometry
from based_renderer_tpu_torch.scene import generated_mesh


@pytest.mark.parametrize("triangles", [2000, 5000])
def test_device_generator_matches_numpy_twin_and_jax(triangles):
    d = geometry.procedural_mesh_data(triangles)
    flat = d["indices"].reshape(-1)
    got = geometry.procedural_mesh_device(triangles, device="cpu")()
    jax_got = jax.jit(jgeometry.procedural_mesh_device(triangles))()
    for k, want, tol in (("position", d["positions"][flat], 2e-5), ("normal", d["normal"][flat], 5e-3)):
        assert got[k].shape == want.shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_got[k]), rtol=0, atol=tol)


def test_device_generator_is_deterministic():
    gen = geometry.procedural_mesh_device(2000, device="cpu")
    a, b = gen(), gen()
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize(
    "attrs, match",
    [
        ({"position": torch.zeros((4, 3))}, "multiple-of-3"),
        ({"normal": torch.zeros((3, 3))}, "position"),
        ({"position": torch.zeros((3, 3)), "normal": torch.zeros((6, 3))}, "rows"),
    ],
)
def test_generated_mesh_validation(attrs, match):
    with pytest.raises(ValueError, match=match):
        generated_mesh(lambda: attrs)


def test_generated_mesh_normalizes_attributes():
    mesh = generated_mesh(lambda: {"position": torch.zeros((3, 3), dtype=torch.float64), "w": torch.ones(3)})
    assert mesh.attributes["position"].dtype == torch.float32
    assert tuple(mesh.attributes["w"].shape) == (3, 1)
    assert mesh.generator is not None and mesh.num_triangles == 1


def test_sequence_regenerates_per_call():
    """Sequence checksums through the generated mesh equal eager frames'
    sums, the frames are distinct, the generator runs once per call, and
    the program's key carries no attribute ids (its captured-id slot is
    empty: the big_mesh draw has no instances or static tensors)."""
    r = tbrt.Renderer(tbrt.RendererConfig(width=128, height=96, raster_backend="pallas"), device="cpu")
    pipe, mesh, uniforms, _ = demos.big_mesh_demo(r, triangles=2000, generated=True)
    assert mesh.generator is not None
    calls = []
    gen = mesh.generator
    mesh = tbrt.Mesh(attributes=mesh.attributes, indices=None, generator=lambda: calls.append(1) or gen())
    frames = [uniforms(0.016 * i) for i in range(3)]
    frame_sums = [float(r.render_frame(pipe, mesh, u).color_planar.sum()) for u in frames]
    useq = {k: torch.stack([torch.as_tensor(np.asarray(u[k])) for u in frames]) for k in frames[0]}
    sums = r.render_sequence(pipe, mesh, useq)
    np.testing.assert_allclose(sums.numpy(), frame_sums, rtol=1e-4)
    assert len(set(np.round(sums.numpy(), 1))) == 3
    r.render_sequence(pipe, mesh, useq)
    assert len(calls) == 2 and r.num_cached_programs == 1
    (key,) = r._sequences
    assert key[4] == (), f"generated-mesh attributes leaked into the captured ids: {key[4]}"


def test_uploaded_meshes_unchanged():
    data = geometry.cube_mesh_data()
    r = tbrt.Renderer(tbrt.RendererConfig(width=64, height=48), device="cpu")
    mesh = r.upload_mesh(data["positions"], color=data["color"])
    assert mesh.generator is None
