"""The port's entry points: entry() and dryrun_multichip(n), the
counterparts of the JAX package's __graft_entry__.py."""

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch import entry
from based_renderer_tpu_torch.parallel import launch, workers


def test_entry_frame_equals_render_frame():
    fn, args = entry.entry(width=128, height=96, device="cpu")
    color, depth_q, tri_id, stencil, overflowed, pair_budget_use = fn(*args)
    assert tuple(color.shape) == (4, 96, 128) and stencil is None and not bool(overflowed)
    assert 0 < float(pair_budget_use) <= 1
    r = tbrt.Renderer(tbrt.RendererConfig(128, 96), device="cpu")
    pipe, mesh, uniforms, _ = tbrt.demos.cube_demo(r)
    want = r.render_frame(pipe, mesh, uniforms(0.5), clear_color=(0.0, 0.0, 0.0, 0.0))
    assert torch.equal(tri_id, want.tri_id) and torch.equal(depth_q, want.depth_q)
    assert torch.equal(color, want.color_planar)
    assert (tri_id >= 0).any()
    # Against the JAX package's entry frame (each package's own vertex
    # matmul: tri_id on >= 99.9% of pixels, colour within 1e-4 there).
    jr = jbrt.Renderer(jbrt.RendererConfig(width=128, height=96, raster_backend="pallas"))
    jpipe, jmesh, ju, _ = jdemos.cube_demo(jr)
    jf = jr.render_frame(jpipe, jmesh, ju(0.5), clear_color=(0.0, 0.0, 0.0, 0.0))
    same = tri_id.numpy() == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(np.moveaxis(color.numpy(), 0, -1)[same], jf.color_np()[same], rtol=0, atol=1e-4)


def test_entry_defaults_to_the_card():
    """Without a device entry() renders on CUDA, and raises DeviceError
    where there is none."""
    if torch.cuda.is_available():
        _, args = entry.entry(width=64, height=32)
        assert args[0][0].mesh.attributes["position"].is_cuda
    else:
        with pytest.raises(tbrt.errors.DeviceError):
            entry.entry(width=64, height=32)


def test_dryrun_multichip_4():
    entry.dryrun_multichip(4)


def test_dryrun_multichip_8():
    entry.dryrun_multichip(8)


def test_launch_reports_a_failing_rank():
    """A rank that raises fails launch.run with its traceback, and no rank
    is left running."""
    spec = {"mesh": (2, 1), "config": {"width": 95, "height": 64}, "draws": [{"demo": "cube", "t": 0.5}]}
    with pytest.raises(RuntimeError, match="multiple of 8"):
        launch.run(workers.run_specs, (2, 1), ([spec],), backend="gloo", devices="cpu", timeout=120)
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        launch.run(workers.run_specs, (2, 1), ([spec],), backend="gloo", devices=["cpu"] * 3)
