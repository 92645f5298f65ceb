"""The port's present layer (Swapchain, FramePacer, render_loop),
utils.profiling and utils.cache, mirroring tests/test_present.py, and the
demo driver examples/render_demo_torch.py on the CPU.

Tolerances: the presented images of both packages' render_loop on the
cube demo agree within 1e-4 (colour); the Swapchain returns frames exactly
as rendered.  On the CPU the ring reads FrameResult.color_np(), as the
JAX package does; the CUDA path (device interleave, asynchronous copy into
page-locked slots, one event per frame) runs in chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu import present as jpresent
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu_torch import present, runtime
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.utils import image, profiling
from based_renderer_tpu_torch.utils.errors import PresentError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_renderer(width=64, height=48, **cfg):
    return tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, **cfg), device="cpu")


class FakeFrame:
    def __init__(self, w, h, v):
        self._img = np.full((h, w, 4), v, np.float32)

    def color_np(self):
        return self._img


def test_swapchain_ring_order():
    chain = present.Swapchain(depth=2)

    class F:
        def __init__(self, i):
            self.color = torch.full((2, 2, 4), float(i))

    assert chain.submit(F(0)) is None  # warming up
    img1 = chain.submit(F(1))
    assert img1 is not None and float(img1[0, 0, 0]) == 0.0  # oldest first
    img2 = chain.submit(F(2))
    assert float(img2[0, 0, 0]) == 1.0
    rest = chain.flush()
    assert [float(r[0, 0, 0]) for r in rest] == [2.0]
    assert chain.presented == 3


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_swapchain_depth_and_slot_lifetime(depth):
    """A frame comes out depth - 1 submits after it went in, oldest first,
    and a staged image stays valid for depth further presents."""
    n = 3 * depth + 2
    chain = present.Swapchain(depth=depth, extent=(8, 4))
    presented, values = [], []
    for i in range(n):
        img = chain.submit(FakeFrame(8, 4, float(i)))
        assert (img is None) == (i < depth - 1)
        if img is not None:
            presented.append(img)
            values.append(float(img[0, 0, 0]))
        live = presented[-(depth + 1):]
        assert [float(v[0, 0, 0]) for v in live] == values[-(depth + 1):]
    values += [float(img[0, 0, 0]) for img in chain.flush()]
    assert values == [float(i) for i in range(n)] and chain.presented == n


def test_frame_pacer_fixed_dt():
    pacer = present.FramePacer(fixed_dt=0.25)
    ts = [pacer.tick() for _ in range(4)]
    np.testing.assert_allclose(ts, [0.25, 0.5, 0.75, 1.0])


def test_render_loop_end_to_end():
    r = _cpu_renderer()
    demo = demos.cube_demo(r)
    seen = []
    last, pacer = present.render_loop(r, demo, frames=4, on_frame=lambda img, p: seen.append(img.copy()))
    assert last is not None and last.shape == (48, 64, 4)
    # Every frame reaches on_frame, the depth-2 swapchain's final in-flight
    # frame drained after the loop included.
    assert len(seen) == 4
    np.testing.assert_array_equal(seen[-1], last)
    pipe, mesh, uniforms, _ = demo
    np.testing.assert_array_equal(seen[2], r.render_frame(pipe, mesh, uniforms(3 * pacer.fixed_dt)).color_np())


def test_render_loop_single_frame_presents():
    r = _cpu_renderer()
    seen = []
    last, _ = present.render_loop(r, demos.triangle_demo(r), frames=1, on_frame=lambda img, p: seen.append(img.shape))
    assert len(seen) == 1 and last is not None


def test_render_loop_matches_jax():
    """Both packages' render_loop on the cube demo (each its own vertex
    matmul, raster_backend="pallas"): the presented images, frame by
    frame, within 1e-4."""
    tr = _cpu_renderer(raster_backend="pallas")
    jr = jbrt.Renderer(jbrt.RendererConfig(width=64, height=48, raster_backend="pallas"))
    tseen, jseen = [], []
    tlast, _ = present.render_loop(tr, demos.cube_demo(tr), frames=3, on_frame=lambda i, p: tseen.append(i.copy()))
    jlast, _ = jpresent.render_loop(jr, jdemos.cube_demo(jr), frames=3,
                                    on_frame=lambda i, p: jseen.append(np.array(i)))
    assert len(tseen) == len(jseen) == 3
    for t_img, j_img in zip(tseen + [tlast], jseen + [jlast]):
        np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-4)
    assert not np.array_equal(tseen[0], tseen[-1])  # the cube turns


def test_persistent_cache_util(tmp_path, monkeypatch):
    from based_renderer_tpu_torch.ops import _build
    from based_renderer_tpu_torch.utils import cache

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(runtime, "BUILD_DIR", runtime.BUILD_DIR)
    assert cache.DEFAULT_DIR == os.path.join(ROOT, "build")
    d = cache.enable_persistent_cache(str(tmp_path / "kernels"))
    assert d == str(tmp_path / "kernels") and (tmp_path / "kernels").exists()
    assert _build.library_path().parent == tmp_path / "kernels" / "torch_kernels"
    assert runtime.library_path().parent == tmp_path / "kernels" / "torch_runtime"


def test_swapchain_staging_and_resize():
    """Presented frames land in the swapchain's one staging block; resize
    rebuilds it (the swapchain-recreation analog)."""
    chain = present.Swapchain(depth=2, extent=(16, 8))
    assert chain.submit(FakeFrame(16, 8, 0.1)) is None
    img = chain.submit(FakeFrame(16, 8, 0.2))
    assert img is not None and img.shape == (8, 16, 4) and float(img[0, 0, 0]) == np.float32(0.1)
    assert chain._staging is not None  # the staging pool actually in use
    assert chain._staging.tensors is None  # CPU frames: nothing registered with CUDA
    with pytest.raises(PresentError):
        chain.submit(FakeFrame(4, 4, 0.3))
        chain.submit(FakeFrame(4, 4, 0.3))
        chain.flush()
    chain = present.Swapchain(depth=2, extent=(16, 8))
    chain.submit(FakeFrame(16, 8, 0.3))
    drained = chain.resize((4, 4))
    assert [d.shape for d in drained] == [(8, 16, 4)] and chain._staging is None
    assert float(drained[0][0, 0, 0]) == np.float32(0.3)  # a view keeps the released block alive
    chain.submit(FakeFrame(4, 4, 0.4))
    out = chain.flush()
    assert out[-1].shape == (4, 4, 4) and chain._staging.shape == (4, 4, 4)


def test_swapchain_rejects_non_frames():
    with pytest.raises(PresentError):
        present.Swapchain(depth=1).submit(42)
    with pytest.raises(ValueError):
        present.Swapchain(depth=0)


def test_render_loop_with_stage_timer():
    r = _cpu_renderer()
    timer = profiling.StageTimer()
    last, pacer = present.render_loop(r, demos.cube_demo(r), frames=4, timer=timer)
    assert last is not None and last.shape == (48, 64, 4)
    assert timer.counts["record+dispatch"] == 4 and timer.counts["present"] == 4
    assert "present" in timer.report()
    assert timer.outer == pytest.approx(sum(timer.totals.values()))


def test_stage_timer_wrap_nesting_and_reset():
    timer = profiling.StageTimer()
    inner = timer.wrap("inner", lambda x: x + 1, fence=torch.device("cpu"))
    outer = timer.wrap("outer", lambda x: inner(x) * 2)
    assert outer(1) == 4 and inner(1) == 2
    assert timer.counts == {"outer": 1, "inner": 2}
    # Only stages inside no other count towards outer: the nested call not.
    assert timer.outer == pytest.approx(timer.totals["outer"] + timer.totals["inner"] / 2, rel=0.5)
    assert timer.outer < timer.totals["outer"] + timer.totals["inner"]
    lines = timer.report().splitlines()
    assert len(lines) == 2 and all("ms/call" in line for line in lines)
    timer.reset()
    assert not timer.totals and timer.outer == 0.0


def test_wait_fences():
    profiling.wait(None)
    profiling.wait(torch.zeros(3))  # CPU work is done when the tensor exists
    profiling.wait(torch.device("cpu"))
    with pytest.raises(TypeError):
        profiling.wait(object())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as path:
        torch.ones(64).cumsum(0)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_demo_driver_cpu_writes_pngs(tmp_path):
    """examples/render_demo_torch.py --cpu as a subprocess: 2 frames, 2
    PNGs from the native present ring, the last equal to the frame."""
    out = tmp_path / "frames"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "render_demo_torch.py"), "cube", "--cpu", "--frames", "2",
         "--width", "64", "--height", "48", "--out", str(out), "--profile"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == ["frame_000000.png", "frame_000001.png"]
    assert "2 frames at 64x48 msaa=1" in proc.stdout and "2 presented" in proc.stdout
    assert "record+dispatch" in proc.stdout  # the --profile report
    r = _cpu_renderer()
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    want = r.render_frame(pipe, mesh, uniforms(2 / 60)).color_u8()
    np.testing.assert_array_equal(image.read_png(out / "frame_000001.png"), want)


def test_demo_driver_in_process(tmp_path):
    """main() returns the run's numbers; --srgb presents through the
    transfer function, byte for byte as FrameResult.color_u8."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import render_demo_torch
    finally:
        sys.path.pop(0)
    out = tmp_path / "srgb"
    res = render_demo_torch.main(["triangle", "--cpu", "--frames", "3", "--width", "32", "--height", "32",
                                  "--srgb", "--out", str(out)])
    assert res["frames"] == res["presented"] == 3 and res["loop_fps"] > 0
    assert not res["staging_pinned"] and res["report"] is None  # a CPU run stages nothing pinned
    r = _cpu_renderer(32, 32, framebuffer_srgb=True)
    pipe, mesh, uniforms, _ = demos.triangle_demo(r)
    want = r.render_frame(pipe, mesh, uniforms(0.05)).color_u8()
    np.testing.assert_array_equal(image.read_png(out / "frame_000002.png"), want)
    assert not np.array_equal(want, image.to_u8(r.render_frame(pipe, mesh, {}).color_np()))
    with pytest.raises(SystemExit):  # main_guard: a failure exits non-zero
        render_demo_torch.main(["no_such_demo", "--cpu", "--frames", "1"])


def test_demo_path_imports_no_jax():
    """The driver and the modules of its path load nothing of JAX or of
    the JAX package, even after a run."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/examples']\n"
        "import render_demo_torch\n"
        "from based_renderer_tpu_torch import present, runtime, shader\n"
        "from based_renderer_tpu_torch.utils import cache, profiling\n"
        "render_demo_torch.main(['triangle', '--cpu', '--frames', '1', '--width', '16', '--height', '16'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'based_renderer_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
