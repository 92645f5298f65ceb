"""The general generator of traffic: one loop per kind of mix, driven by
the mix's data file (``benchmark/traffic/<name>.json``, key ``loop``).

``present``: the interactive demo loop, closed and unpaced.  The program's
``present.render_loop`` drives a proxy renderer (which times each
``render_frame`` and keeps its results) and hands each image to
``on_frame``, which submits it to a native ``runtime.PresentRing`` with no
output directory.  A frame counts when its image reaches ``on_frame``
inside the window; its latency runs from the ``render_frame`` call that
took its uniforms to that moment.  The loop is stopped from ``on_frame``
once the window has closed; frames still in flight are not counted.

``sequence``: headless animation rendering.  Repeated calls of
``Renderer.render_sequence(..., return_frames=True)``, each starting where
the last ended, the colours left on the device, the checksums fetched to
the host and the overflow flag kept.  Only whole calls that end inside the
window count.

Every draw passes the scene's instance table (``instances=``; None for a
scene that gives none).  Both open with the key's first call (the eager
warm-up and the capture, synchronised: ``capture_s``) and a warm-up of
``warmup_s`` seconds, then measure for the run's seconds.  A traced run then profiles
``trace_seconds`` more of the same traffic (``trace.py``); the host spans
are read from the untraced window.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import trace as tr


@dataclass
class Cell:
    """What a loop is handed: the program set up for one cell."""

    workload: str
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    renderer: object
    pipeline: object
    mesh: object
    scene: object  # the scene module
    scene_args: dict
    aspect: float
    t_anim0: float  # the animation time of the first frame, from the seed
    t_process: float  # perf_counter() at process start
    rng: np.random.Generator
    instances: dict | None = None  # the scene's instance table, passed with every draw


@dataclass
class Measured:
    """What a loop brings back."""

    e2e: dict  # end-to-end metric name -> value
    spans: dict  # host span name -> [seconds]
    capture_s: float
    frames: list  # outputs to compare: {"t": ..., "color": ..., ["tri_id", "depth_q"]}
    attempted: int
    failed: int
    memory_peak: int
    trace: object = None  # trace.Trace of the traced window
    traced_frames: int = 0
    traced_times: list = field(default_factory=list)  # animation time of each traced frame


def window_ms(start: float, last_end: float, frames: int) -> float:
    """Milliseconds a frame over the whole window: from its start to the
    moment its last counted frame completed, over every frame counted."""
    return (last_end - start) / frames * 1e3


def tail_ms(latencies: list, q: float = 95) -> float:
    """The q-th percentile of every frame's latency, in milliseconds."""
    return float(np.percentile(np.asarray(latencies, dtype=np.float64), q)) * 1e3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" else 0


class _WindowClosed(Exception):
    pass


class _Proxy:
    """The renderer ``render_loop`` is handed: times each ``render_frame``
    on the host, unfenced, and keeps the last results by frame number."""

    def __init__(self, renderer, traced: bool):
        self._r = renderer
        self.config = renderer.config
        self.traced = traced
        self.calls: list[float] = []  # perf_counter() at each call
        self.returns: list[float] = []
        self.results = collections.deque(maxlen=8)  # (frame number, FrameResult)
        self.overflowed: list = []

    def render_frame(self, *args, **kwargs):
        n = len(self.calls)
        with tr.span("benchmark.render_frame", self.traced):
            t0 = time.perf_counter()
            frame = self._r.render_frame(*args, **kwargs)
            t1 = time.perf_counter()
        self.calls.append(t0)
        self.returns.append(t1)
        self.results.append((n, frame))
        self.overflowed.append(frame.overflowed)
        return frame

    def result(self, n: int):
        for k, f in self.results:
            if k == n:
                return f
        raise LookupError(f"frame {n} is no longer kept")


def _keep(frame, image, t) -> dict:
    return {"t": t, "tri_id": frame.tri_id, "depth_q": frame.depth_q, "color": np.array(image, copy=True)}


def present(c: Cell) -> Measured:
    from based_renderer_tpu_torch import present as present_mod
    from based_renderer_tpu_torch import runtime

    tf = c.traffic
    r, dev = c.renderer, c.device
    if abs(present_mod.FramePacer().fixed_dt - tf["dt"]) > 1e-12:
        raise ValueError(f"render_loop advances {present_mod.FramePacer().fixed_dt} s a frame; the mix says {tf['dt']}")
    cfg = r.config
    times: list[float] = []  # animation time of each frame the loop renders

    def uniforms(t):
        times.append(c.t_anim0 + t)
        return c.scene.uniforms(c.t_anim0 + t, c.aspect, c.scene_args)

    _sync(dev)
    t0 = time.perf_counter()
    r.render_frame(c.pipeline, c.mesh, c.scene.uniforms(c.t_anim0, c.aspect, c.scene_args), instances=c.instances)
    _sync(dev)
    capture_s = time.perf_counter() - t0

    ring = runtime.PresentRing(cfg.width, cfg.height, depth=tf["ring_depth"])
    proxy = _Proxy(r, c.trace)
    sample = set((c.rng.choice(tf["sample_span"], size=tf["compare_frames"], replace=False)).tolist())
    st = {"phase": "warm", "arrived": 0, "start": None, "end": None, "t_loop": time.perf_counter()}
    arrivals, latencies, submits, on_frames, kept = [], [], [], [], []
    tracer = tr.Tracer(dev) if c.trace else None
    out = {}

    def on_frame(img, pacer):
        now = time.perf_counter()
        j = st["arrived"]
        st["arrived"] += 1
        phase = st["phase"]
        if phase == "window" and now > st["end"]:
            phase = st["phase"] = "trace" if tracer is not None else "stop"
            if tracer is not None:
                tracer.start()
                st["trace_end"] = tracer.t_start + tf["trace_seconds"]
        elif phase == "trace" and now > st["trace_end"]:
            out["trace"] = tracer.stop()
            phase = "stop"
        if phase == "stop":
            kept.append(_keep(proxy.result(j), img, times[j]))
            _sync(dev)  # no copy into the swapchain's staging is in flight when the loop unwinds
            raise _WindowClosed
        with tr.span("benchmark.on_frame", c.trace):
            if phase == "window":
                arrivals.append(now)
                latencies.append(now - proxy.calls[j])
                if j - st["first"] in sample:
                    kept.append(_keep(proxy.result(j), img, times[j]))
            t1 = time.perf_counter()
            ring.submit(img)
            t2 = time.perf_counter()
        if phase == "window":
            submits.append(t2 - t1)
        on_frames.append((now, time.perf_counter()))
        if phase == "warm" and now - st["t_loop"] >= tf["warmup_s"] and st["arrived"] >= tf["warmup_frames"]:
            st["phase"] = "window"
            st["first"] = st["arrived"]
            st["start"] = time.perf_counter()
            st["end"] = st["start"] + c.seconds

    demo = (c.pipeline, c.mesh, uniforms, c.instances)
    try:
        present_mod.render_loop(proxy, demo, frames=1 << 40, on_frame=on_frame, swapchain_depth=tf["swapchain_depth"])
    except _WindowClosed:
        pass
    _sync(dev)
    peak = _peak(dev)
    ring.flush()
    ring.close()

    start, end = st["start"], st["end"]
    n = len(arrivals)
    if not n:
        raise RuntimeError(f"no frame reached on_frame inside the {c.seconds} s window")
    first = st["first"]
    # host spans of the frames rendered inside the window
    inside = [k for k in range(len(proxy.calls)) if start <= proxy.calls[k] and proxy.returns[k] <= end]
    spans = {"render_frame": [proxy.returns[k] - proxy.calls[k] for k in inside], "ring_submit": submits,
             "swapchain": []}
    for k in inside:
        if k + 1 < len(proxy.calls) and proxy.calls[k + 1] <= end:
            gap = proxy.calls[k + 1] - proxy.returns[k]
            gap -= sum(b - a for a, b in on_frames if a >= proxy.returns[k] and b <= proxy.calls[k + 1])
            spans["swapchain"].append(gap)
    failed = int(torch.stack(proxy.overflowed[first : first + n]).sum()) if n else 0
    m = Measured(
        e2e={
            "frame_ms": window_ms(start, arrivals[-1], n),
            "latency_p95_ms": tail_ms(latencies),
            "peak_mem_gib": peak / 2**30,
            "setup_s": start - c.t_process,
        },
        spans=spans,
        capture_s=capture_s,
        frames=kept,
        attempted=n,
        failed=failed,
        memory_peak=peak,
    )
    if "trace" in out:
        m.trace = out["trace"]
        traced = [k for k in range(len(proxy.calls)) if tracer.t_start <= proxy.calls[k] <= tracer.t_stop]
        m.traced_frames = len(traced)
        m.traced_times = [times[k] for k in traced]
    return m


def frames_per_call(tf: dict, frame_bytes: int) -> int:
    """Frames in one call: ``seconds_per_call`` of animation, fewer where
    their colours would pass ``colour_bytes_per_call``."""
    n = int(round(tf["seconds_per_call"] / tf["dt"]))
    return max(1, min(n, int(tf["colour_bytes_per_call"] // frame_bytes)))


def sequence_times(t0: float, dt: float, n: int) -> list:
    """The animation time of each frame of a call, as render_sequence
    computes it (float32 arithmetic)."""
    return [float(np.float32(t0) + np.float32(dt) * np.float32(i)) for i in range(n)]


def sequence(c: Cell) -> Measured:
    tf = c.traffic
    r, dev = c.renderer, c.device
    cfg = r.config
    n = frames_per_call(tf, 4 * 4 * cfg.width * cfg.height)
    dt = tf["dt"]
    # The frames of each call that the comparison may read, from the seed:
    # copied out on the device so that no call's colours outlive it.
    pick = sorted(c.rng.choice(n, size=min(tf["compare_frames"], n), replace=False).tolist())

    def uniforms(t):
        return c.scene.uniforms(float(t), c.aspect, c.scene_args)

    calls = [0]
    overflowed = []

    def call():
        k = calls[0]
        calls[0] += 1
        t0 = c.t_anim0 + k * n * dt
        with tr.span("benchmark.render_sequence", c.trace):
            sums, colors = r.render_sequence(c.pipeline, c.mesh, uniforms_fn=uniforms, num_frames=n, t0=t0,
                                             dt=dt, return_frames=True, instances=c.instances)
            kept = colors[pick]
            del colors
            sums.cpu()
        overflowed.append(r.last_sequence_overflowed)
        return t0, kept

    _sync(dev)
    t_cap = time.perf_counter()
    call()
    capture_s = time.perf_counter() - t_cap
    warm = 0
    while warm < tf["warmup_calls"] or time.perf_counter() - t_cap < tf["warmup_s"]:
        call()
        warm += 1
    first = calls[0]
    start = time.perf_counter()
    end_at = start + c.seconds
    ends, last = [], None
    while True:
        got = call()
        t_end = time.perf_counter()
        if t_end > end_at:
            del got
            break
        ends.append(t_end)
        last = got
    counted = len(ends)
    if not counted:
        raise RuntimeError(f"no render_sequence call of {n} frames ended inside the {c.seconds} s window")
    m = Measured(
        e2e={"frame_ms": window_ms(start, ends[-1], counted * n), "setup_s": start - c.t_process},
        spans={},
        capture_s=capture_s,
        frames=[],
        attempted=counted * n,
        failed=n * int(torch.stack(overflowed[first : first + counted]).sum()),
        memory_peak=_peak(dev),
    )
    m.e2e["peak_mem_gib"] = m.memory_peak / 2**30
    t0, colors = last
    times = sequence_times(t0, dt, n)
    m.frames = [{"t": times[i], "color": colors[j]} for j, i in enumerate(pick)]
    del last, colors
    if c.trace:
        tracer = tr.Tracer(dev)
        tracer.start()
        traced_from = calls[0]
        while True:
            call()
            if time.perf_counter() - tracer.t_start >= tf["trace_seconds"]:
                break
        m.trace = tracer.stop()
        m.traced_frames = (calls[0] - traced_from) * n
        m.traced_times = [t for k in range(traced_from, calls[0])
                          for t in sequence_times(c.t_anim0 + k * n * dt, dt, n)]
        m.memory_peak = _peak(dev)
    return m


LOOPS = {"present": present, "sequence": sequence}
