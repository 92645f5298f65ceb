"""The end-to-end metrics are statistics of the whole window: frame_ms is
the window's wall time over every frame completed in it, latency_p95_ms
the 95th percentile of every frame's latency, never a median of pieces."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import loops
from benchmark.reference.scenes import spinning_cube


def test_window_ms_is_the_whole_window_over_all_frames():
    assert loops.window_ms(10.0, 12.0, 400) == pytest.approx(5.0)


def test_tail_is_the_p95_of_all_frames():
    lat = [0.001] * 90 + [0.1] * 10  # a tenth of the frames stall
    assert loops.tail_ms(lat) == pytest.approx(100.0)
    assert loops.tail_ms(lat) > 10 * float(np.median(lat)) * 1e3


class _StubRenderer:
    """A renderer whose every 8th frame stalls for 40 ms, the others 4 ms."""

    def __init__(self, w=16, h=8):
        from based_renderer_tpu_torch.renderer import RendererConfig

        self.config = RendererConfig(w, h)
        self.n = 0

    def render_frame(self, pipeline, mesh, uniforms=None, instances=None):
        from based_renderer_tpu_torch.renderer import FrameResult

        self.n += 1
        time.sleep(0.04 if self.n % 8 == 0 else 0.004)
        h, w = self.config.height, self.config.width
        return FrameResult(color_planar=torch.zeros((4, h, w)), depth_q=torch.zeros((h, w), dtype=torch.int32),
                           tri_id=torch.zeros((h, w), dtype=torch.int32), overflowed=torch.zeros((), dtype=torch.bool))


def _cell(renderer, traffic, seconds=1.5):
    return loops.Cell(workload="stub", traffic=traffic, seed=1, seconds=seconds, trace=False,
                        device=torch.device("cpu"), renderer=renderer, pipeline=None, mesh=None, scene=spinning_cube,
                        scene_args={}, aspect=2.0, t_anim0=0.0, t_process=time.perf_counter(),
                        rng=np.random.default_rng(1))


def test_present_frame_ms_counts_the_stalls():
    traffic = {"loop": "present", "dt": 1 / 60, "swapchain_depth": 2, "ring_depth": 2, "warmup_s": 0.1,
               "warmup_frames": 4, "sample_span": 4, "compare_frames": 1, "trace_seconds": 0.1}
    m = loops.present(_cell(_StubRenderer(), traffic))
    # a frame costs (7 * 4 + 40) / 8 = 8.5 ms of sleep and some host work: the
    # stalls count in full, so the rate is far from the median frame's 4 ms
    assert 8.5 <= m.e2e["frame_ms"] < 12.0
    assert m.e2e["latency_p95_ms"] >= 40.0
    assert m.attempted >= 100 and m.failed == 0
    assert 0 < m.e2e["setup_s"]


def test_sequence_counts_only_whole_calls_inside_the_window():
    calls = []

    class Seq:
        config = _StubRenderer().config
        last_sequence_overflowed = torch.zeros((), dtype=torch.bool)

        def render_sequence(self, pipeline, mesh, uniforms_fn, num_frames, t0, dt, return_frames, instances=None):
            calls.append(time.perf_counter())
            time.sleep(0.05 * num_frames)
            h, w = self.config.height, self.config.width
            return torch.zeros(num_frames), torch.zeros((num_frames, 4, h, w))

    traffic = {"loop": "sequence", "dt": 1 / 60, "seconds_per_call": 4 / 60, "colour_bytes_per_call": 1e9,
               "warmup_s": 0.0, "warmup_calls": 1, "compare_frames": 2, "trace_seconds": 0.1}
    m = loops.sequence(_cell(Seq(), traffic, seconds=1.0))
    assert m.attempted % 4 == 0 and m.attempted // 4 == 4  # 0.2 s calls: four end inside 1 s, the fifth does not
    assert m.e2e["frame_ms"] == pytest.approx(50.0, rel=0.1)
    assert len(m.frames) == 2
