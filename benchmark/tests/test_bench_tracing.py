"""The readers of the program's own spans and of the present ring's stamps
(``harness/program_spans.py`` and the eight metrics that use it): exact
values from a made-up window, None where the program records nothing (a
program older than its tracing), and a real traced run of each cell on
the CPU at a small size."""

from types import SimpleNamespace

import pytest

from benchmark.conftest import SMALL
from benchmark.harness import core, spec
from benchmark.harness.trace import DeviceEvent, HostEvent, Trace

RING = ["ring_wait_ms", "ring_copy_ms", "ring_convert_ms"]
SPANS = ["present_fence_ms", "host_syncs_per_frame", "captures_in_window", "caller_uniforms_ms",
         "sequence_stack_ms"]
W0 = 1_000_000_000


def _readings(host, frames=4):
    return SimpleNamespace(trace=Trace((W0, W0 + 100_000_000), [], host), traced_frames=frames)


def _ev(name, start_ms, dur_ms):
    return HostEvent(name, W0 + int(start_ms * 1e6), W0 + int((start_ms + dur_ms) * 1e6))


@pytest.fixture
def ring_records(monkeypatch):
    """Four frames in the window and one before it, in the program's store."""
    from based_renderer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_RING_RECORDS", profiling.collections.deque(maxlen=16))
    for i, enter in enumerate([-5.0, 1.0, 21.0, 41.0, 61.0]):
        t = W0 + int(enter * 1e6)
        ms = 1_000_000
        # wait i ms, copy 2 ms, queue 1 ms, convert 3 ms, free 0.5 ms
        stamps = [t, t + i * ms, t + (i + 2) * ms, t + (i + 3) * ms, t + (i + 6) * ms, 0, t + int((i + 6.5) * ms)]
        profiling.keep_ring_records(0, [[i] + stamps])
    return profiling


def test_ring_readers_average_the_window_records(ring_records):
    r = _readings([])
    assert spec.reader("ring_wait_ms").read(r) == pytest.approx((1 + 2 + 3 + 4) / 4)
    assert spec.reader("ring_copy_ms").read(r) == pytest.approx(2.0)
    assert spec.reader("ring_convert_ms").read(r) == pytest.approx(3.5)


def test_span_readers_count_and_time_the_window_spans():
    host = [
        _ev("brt.caller.uniforms_fn", -3, 2),  # before the window
        _ev("brt.caller.uniforms_fn", 1, 2), _ev("brt.caller.uniforms_fn", 11, 4),
        _ev("brt.sync.upload", 4, 0.5), _ev("brt.sync.upload", 14, 0.5), _ev("brt.sync.tile_count", 15, 0.1),
        _ev("brt.sync.present_fence", 20, 3), _ev("brt.sync.present_fence", 30, 1),
        _ev("brt.synchronous", 40, 1),  # not under brt.sync.
        _ev("brt.sequence.stack", 50, 2), _ev("brt.frame.capture", 60, 9), _ev("aten::copy_", 5, 1),
    ]
    r = _readings(host)
    read = {m: spec.reader(m).read(r) for m in SPANS}
    assert read["caller_uniforms_ms"] == pytest.approx(6 / 4)
    assert read["host_syncs_per_frame"] == pytest.approx(5 / 4)
    assert read["present_fence_ms"] == pytest.approx(2.0)
    assert read["sequence_stack_ms"] == pytest.approx(0.5)
    assert read["captures_in_window"] == 1


def test_a_window_of_replays_reads_no_capture():
    r = _readings([_ev("brt.frame.replay", 1, 1)])
    assert spec.reader("captures_in_window").read(r) == 0
    assert spec.reader("host_syncs_per_frame").read(r) == 0
    assert spec.reader("caller_uniforms_ms").read(r) is None  # no such span: nothing to read


@pytest.mark.parametrize("metric", RING + SPANS)
def test_a_program_without_spans_or_records_reads_none(metric, monkeypatch):
    """The parent of the tracing: no brt.* span, no ring store."""
    from based_renderer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "ring_records", raising=False)
    assert spec.reader(metric).read(_readings([_ev("benchmark.on_frame", 1, 10), _ev("aten::sum", 2, 1)])) is None
    assert spec.reader(metric).read(SimpleNamespace(trace=None, traced_frames=0)) is None


def test_idle_time_goes_to_the_innermost_span():
    from benchmark.idle_by_span import idle_by_span

    ms = 1_000_000
    busy = [DeviceEvent("k", "kernel", W0 + 10 * ms, W0 + 20 * ms), DeviceEvent("k", "kernel", W0 + 60 * ms,
                                                                              W0 + 100 * ms)]
    host = [_ev("benchmark.on_frame", 0, 50), _ev("brt.ring.submit", 5, 30), _ev("brt.sync.upload", 25, 5),
            _ev("aten::copy_", 26, 1), _ev("brt.sequence", 55, 10)]
    got = idle_by_span(Trace((W0, W0 + 100 * ms), busy, host))
    # idle: 0-10, 20-60; the upload's 25-30 is not the submit's own time
    assert got == {"benchmark.on_frame": 5 * ms + 15 * ms, "brt.ring.submit": 5 * ms + 10 * ms,
                   "brt.sync.upload": 5 * ms, "none": 5 * ms, "brt.sequence": 5 * ms}


@pytest.mark.parametrize("workload", ["cube_1080p.present", "cube_1080p.sequence"])
def test_a_traced_cpu_run_reads_each_new_metric(bench, workload):
    from based_renderer_tpu_torch.utils import profiling

    profiling._RING_RECORDS.clear()
    r = core.run(bench, workload, 2**31 + 29, 3.0, True, "cpu", core.time.perf_counter(),
                 overrides=SMALL["cube_1080p"])
    assert r.correct
    wanted = {m["name"] for m in spec.metrics(bench, workload, True)} & set(RING + SPANS)
    # a CPU swapchain reads its frames without a CUDA event: no fence to time
    cpu_silent = {"present_fence_ms"}
    assert wanted - cpu_silent <= set(r.metrics), sorted(wanted - set(r.metrics))
    if workload.endswith("present"):
        assert {"ring_wait_ms", "ring_copy_ms", "ring_convert_ms"} <= set(r.metrics)
        assert r.metrics["ring_convert_ms"]["value"] > 0
        # the present cell's frame time and tail, per layer: read from the untraced window
        assert r.metrics["frame_ms.present"]["value"] > 0
        assert r.metrics["latency_p95_ms.present"]["value"] > 0
    else:
        assert r.metrics["captures_in_window"]["value"] == 0
        assert r.metrics["caller_uniforms_ms"]["value"] > 0
        assert r.metrics["sequence_stack_ms"]["value"] > 0
    profiling._RING_RECORDS.clear()


# ---- on the card: the clocks the ring readers rely on, and the cost ----------


def _cuda_profile():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _events(prof, prefix="brt."):
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix) and e.device_type().name == "CPU"), key=lambda x: x[1])


@pytest.mark.chip
def test_on_the_card_ring_stamps_lie_inside_their_submit_spans(cuda_device):
    """The profiler stamps host events on the system clock, as the ring
    does: each 1080p frame's enter -> copy-done interval lies inside its
    brt.ring.submit span, within 1 ms."""
    import time

    import numpy as np
    import torch

    from based_renderer_tpu_torch import runtime
    from based_renderer_tpu_torch.utils import profiling

    profiling._RING_RECORDS.clear()
    ring = runtime.PresentRing(1920, 1080, depth=2)
    img = np.zeros((1080, 1920, 4), np.float32)
    stamps = []
    with _cuda_profile() as prof:
        for _ in range(24):
            with torch.profiler.record_function("clock.probe"):
                stamps.append(time.time_ns())
            ring.submit(img)
        ring.flush()
    ring.close()
    probes = _events(prof, "clock.probe")
    clock_ns = max(abs(t - a) for t, (_, a, _) in zip(stamps, probes))
    spans = [s for s in _events(prof) if s[0] == "brt.ring.submit"]
    rec = sorted((x for x in profiling.ring_records() if x.ring == ring.serial), key=lambda x: x.index)
    assert len(spans) == len(rec) == 24
    offset = max(max(a - x.enter_ns, x.copied_ns - b, 0) for (_, a, b), x in zip(spans, rec))
    print(f"\ntracing clocks: record_function start vs time.time_ns() within {clock_ns} ns; "
          f"largest ring record offset outside its brt.ring.submit span {offset} ns")
    assert offset <= 1_000_000 and clock_ns <= 1_000_000
    profiling._RING_RECORDS.clear()


@pytest.mark.chip
def test_on_the_card_spans_cost_little_while_off(cuda_device):
    """A span while no profiler records, in ns on this host, and the spans a
    1080p cube frame makes in render_loop and in render_sequence."""
    import time

    import torch

    from based_renderer_tpu_torch import present, runtime
    from based_renderer_tpu_torch.models import demos
    from based_renderer_tpu_torch.renderer import Renderer, RendererConfig
    from based_renderer_tpu_torch.utils import profiling

    n = 200_000
    for _ in range(2):  # the second pass is the reading
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("brt.render_frame"):
                pass
        off_ns = (time.perf_counter_ns() - t0) / n
    r = Renderer(RendererConfig(1920, 1080), device=cuda_device)
    demo = demos.cube_demo(r)
    ring = runtime.PresentRing(1920, 1080, depth=2)
    frames, calls = 24, 2
    present.render_loop(r, demo, frames=4, on_frame=lambda img, p: ring.submit(img))
    r.render_sequence(demo[0], demo[1], uniforms_fn=demo[2], num_frames=60, return_frames=True)
    with _cuda_profile() as prof:
        present.render_loop(r, demo, frames=frames, on_frame=lambda img, p: ring.submit(img))
        ring.flush()
    loop_spans = len(_events(prof)) / frames
    with _cuda_profile() as prof:
        for _ in range(calls):
            r.render_sequence(demo[0], demo[1], uniforms_fn=demo[2], num_frames=60, return_frames=True)
        torch.cuda.synchronize()
    seq = _events(prof)
    seq_spans = len(seq) / (60 * calls)
    ring.close()
    names = sorted({s[0] for s in seq})
    print(f"\ntracing cost: a span off {off_ns:.1f} ns; {loop_spans:.2f} spans a present frame "
          f"({off_ns * loop_spans / 1e3:.3f} us), {seq_spans:.3f} a sequence frame "
          f"({off_ns * seq_spans / 1e3:.4f} us); sequence spans {names}")
    assert off_ns < 2_000
    assert "brt.frame.capture" not in names and "brt.sync.upload" in names
