"""The port's own tracing: ``utils.profiling.span`` at the layer boundaries
of the timed path, and the present ring's per-frame stamps.

With no profiler recording, no span enters ``record_function`` and no
ring record is kept.  Under a CPU ``torch.profiler`` each path emits its
``brt.*`` spans with the stated nesting and counts, each ring record lies
inside its ``brt.ring.submit`` span on the profiler's clock, the frames
equal untraced frames bit for bit, and the Chrome trace of
``profiling.trace`` carries the ring's thread as a track.  Frames are
64x48, or 128x96 where the compacted draw needs whole (8, 128) tiles.
"""

import json

import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu_torch import present, renderer as renderer_mod, runtime
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.utils import profiling

FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_records():
    profiling._RING_RECORDS.clear()
    yield
    profiling._RING_RECORDS.clear()


def _renderer(width=64, height=48, **cfg):
    return tbrt.Renderer(tbrt.RendererConfig(width=width, height=height, **cfg), device="cpu")


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(prof) -> list:
    """[(name, start_ns, end_ns, parent name or None)] of the brt.* spans,
    by start; the parent is the innermost brt.* span around a span."""
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("brt.")),
                   key=lambda s: (s[1], -s[2]))
    out, open_ = [], []
    for name, a, b in spans:
        while open_ and open_[-1][2] < b:
            open_.pop()
        out.append((name, a, b, open_[-1][0] if open_ else None))
        open_.append((name, a, b))
    return out


def _count(spans, name, parent="any") -> int:
    return sum(1 for s in spans if s[0] == name and (parent == "any" or s[3] == parent))


def _loop(r, frames=FRAMES):
    """render_loop over the cube into a PresentRing: the images it presented."""
    ring = runtime.PresentRing(r.config.width, r.config.height, depth=2)
    seen = []

    def on_frame(img, pacer):
        seen.append(img.copy())
        ring.submit(img)

    present.render_loop(r, demos.cube_demo(r), frames=frames, on_frame=on_frame)
    ring.close()
    return seen


def _sequence(r, frames=FRAMES):
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    return r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=frames, t0=0.25, return_frames=True)


def _textured(r, t=0.4):
    pipe, mesh, uniforms, _ = demos.textured_cube_demo(r)
    return r.render_frame(pipe, mesh, uniforms(t))


def _frame(r, t=0.4):
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    return r.render_frame(pipe, mesh, uniforms(t))


# ---- off: one flag check, no record_function, no record -------------------


@pytest.mark.parametrize("path", ["frame", "loop", "sequence", "textured", "debug"])
def test_no_profiler_no_record_function_and_no_record(path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while no profiler records")

    r = _renderer(128, 96, raster_backend="pallas") if path == "textured" else _renderer(debug=path == "debug")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.recording() and profiling.span("brt.render_frame") is profiling.OFF
    {"frame": _frame, "debug": _frame, "loop": _loop, "sequence": _sequence, "textured": _textured}[path](r)
    assert profiling.ring_records() == []


# ---- on: the spans, their nesting and counts ----------------------------------


def test_frame_spans_nest_under_render_frame():
    r = _renderer()
    _frame(r, 0.1)  # the key's first call, outside the profile
    with _profile() as prof:
        for k in range(FRAMES):
            _frame(r, 0.2 + k / 10)
    s = _spans(prof)
    assert _count(s, "brt.render_frame", None) == FRAMES
    for name in ("brt.frame.key", "brt.frame.load", "brt.frame.replay"):
        assert _count(s, name, "brt.render_frame") == _count(s, name) == FRAMES, name
    # a CPU program runs eagerly: nothing is captured or cloned, nothing synchronises
    assert {x[0] for x in s} == {"brt.render_frame", "brt.frame.key", "brt.frame.load", "brt.frame.replay"}


def test_compacted_textured_frame_reads_its_tile_count():
    r = _renderer(128, 96, raster_backend="pallas")
    _textured(r, 0.1)
    compacted = profiling.ROUTES_TAKEN["compacted_draws"]
    with _profile() as prof:
        for k in range(2):
            _textured(r, 0.3 + k / 10)
    assert profiling.ROUTES_TAKEN["compacted_draws"] == compacted + 2
    s = _spans(prof)
    assert _count(s, "brt.render_frame", None) == 2
    assert _count(s, "brt.sync.tile_count", "brt.render_frame") == _count(s, "brt.sync.tile_count") == 2
    # the frame is two segments split at the count: pass 1 with pass 2's start, then the compacted draw
    assert _count(s, "brt.frame.replay", "brt.render_frame") == 4


def test_debug_frame_marks_its_reads():
    r = _renderer(debug=True)
    _frame(r, 0.1)
    with _profile() as prof:
        _frame(r, 0.2)
        _sequence(r)
    s = _spans(prof)
    assert _count(s, "brt.sync.debug", "brt.render_frame") == 1
    assert _count(s, "brt.sync.debug", None) == 1  # render_sequence's, after its brt.sequence


def test_render_loop_spans_and_ring_records():
    r = _renderer()
    _frame(r, 0.0)
    with _profile() as prof:
        _loop(r)
    s = _spans(prof)
    assert _count(s, "brt.caller.uniforms_fn", None) == FRAMES  # once a frame, beside render_frame
    assert _count(s, "brt.render_frame", None) == FRAMES
    assert _count(s, "brt.frame.replay", "brt.render_frame") == FRAMES
    assert _count(s, "brt.ring.submit", None) == FRAMES
    rec = profiling.ring_records()
    assert [x.index for x in rec] == list(range(FRAMES)) and len({x.ring for x in rec}) == 1
    for x in rec:
        assert 0 < x.enter_ns <= x.room_ns <= x.copied_ns <= x.popped_ns <= x.converted_ns <= x.freed_ns
        assert x.written_ns == 0  # no output directory


def test_sequence_spans():
    r = _renderer()
    _sequence(r)
    with _profile() as prof:
        _sequence(r)
        _sequence(r)
    s = _spans(prof)
    assert _count(s, "brt.sequence", None) == 2
    assert _count(s, "brt.caller.uniforms_fn", "brt.sequence") == _count(s, "brt.caller.uniforms_fn") == 2
    assert _count(s, "brt.sequence.stack", "brt.sequence") == 2
    assert _count(s, "brt.sequence.frame", "brt.sequence") == 2 * FRAMES
    assert _count(s, "brt.frame.replay", "brt.sequence.frame") == _count(s, "brt.frame.replay") == 2 * FRAMES


def test_ring_record_lies_inside_its_submit_span():
    """Each frame's enter -> copy-done interval lies inside its
    brt.ring.submit span on the profiler's clock, within 1 ms."""
    ring = runtime.PresentRing(64, 48, depth=2)
    img = np.random.default_rng(0).random((48, 64, 4), dtype=np.float32)
    with _profile() as prof:
        for _ in range(8):
            ring.submit(img)
        ring.flush()
    ring.close()
    spans = [x for x in _spans(prof) if x[0] == "brt.ring.submit"]
    rec = [x for x in profiling.ring_records() if x.ring == ring.serial]
    assert len(spans) == len(rec) == 8
    for (_, a, b, _), x in zip(spans, sorted(rec, key=lambda x: x.index)):
        assert a - 1_000_000 <= x.enter_ns <= x.copied_ns <= b + 1_000_000


def test_records_are_drained_only_once_traced():
    ring = runtime.PresentRing(8, 4, depth=1)
    img = np.zeros((4, 8, 4), np.float32)
    for _ in range(3):
        ring.submit(img)
    ring.flush()
    assert profiling.ring_records() == []
    with _profile():
        ring.submit(img)
    ring.submit(img)
    ring.close()  # drains what the traced ring presented since
    assert [x.index for x in profiling.ring_records()] == [0, 1, 2, 3, 4]


def test_upload_span_marks_only_blocking_host_to_device_copies():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    host = torch.zeros(4)
    with _profile():
        assert renderer_mod._upload_span(cpu, host) is profiling.OFF
        assert renderer_mod._upload_span(cuda, host) is not profiling.OFF
    assert renderer_mod._upload_span(cuda, host) is profiling.OFF  # no profiler


# ---- tracing changes no pixel ------------------------------------------------


@pytest.mark.parametrize("path", ["frame", "loop", "sequence", "textured"])
def test_frames_with_tracing_equal_frames_without(path):
    def run():
        r = _renderer(128, 96, raster_backend="pallas") if path == "textured" else _renderer()
        out = {"frame": _frame, "loop": _loop, "sequence": _sequence, "textured": _textured}[path](r)
        if isinstance(out, tbrt.FrameResult):
            return [out.color_planar, out.depth_q, out.tri_id]
        return [torch.as_tensor(np.asarray(x)) for x in out]

    plain = run()
    with _profile():
        traced = run()
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


# ---- the operator's Chrome trace --------------------------------------------


def test_chrome_trace_carries_the_ring_thread(tmp_path):
    r = _renderer()
    ring = runtime.PresentRing(64, 48, depth=2)
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as path:
        present.render_loop(r, demos.cube_demo(r), frames=FRAMES, on_frame=lambda img, p: ring.submit(img))
        ring.flush()
    ring.close()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["args"]["name"]: e["tid"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
             and str(e["args"].get("name", "")).startswith("brt.ring")}
    worker = names[f"brt.ring {ring.serial} worker"]
    convert = [e for e in events if e.get("name") == "ring convert" and e["tid"] == worker]
    assert sorted(e["args"]["frame"] for e in convert) == list(range(FRAMES))
    submits = [e for e in events if e.get("name") == "brt.ring.submit"]
    assert len(submits) == FRAMES
    # on the trace's time base: each frame converts after its submit began
    first = min(e["ts"] for e in submits)
    last = max(e["ts"] + e["dur"] for e in events if e.get("name") == "brt.render_frame")
    assert all(first <= e["ts"] for e in convert) and min(e["ts"] for e in convert) <= last


def test_span_is_a_record_function_while_recording():
    assert profiling.span("brt.x") is profiling.OFF
    with _profile() as prof:
        assert profiling.recording()
        with profiling.span("brt.x"):
            torch.ones(4).sum()
    assert not profiling.recording()
    assert [x[0] for x in _spans(prof)] == ["brt.x"]

