"""What the program records about itself in a traced window: its ``brt.*``
spans, which ``utils.profiling.span`` puts into the profiler's host events,
and the present ring's per-frame stamps, which ``utils.profiling`` keeps
(ns on the system clock, the clock of the profiler's host events).

Each returns None where the program records nothing: no traced window, or
a program without spans or ring records (one older than its tracing).
"""

from __future__ import annotations


def spans(r, name: str | None = None) -> list | None:
    """The program's spans (``HostEvent``) that start inside the traced
    window, of ``name`` or of names under ``name.`` when given; None when
    the window holds no ``brt.*`` span at all."""
    if r.trace is None:
        return None
    w0, w1 = r.trace.window_ns
    inside = [e for e in r.trace.host if e.name.startswith("brt.") and w0 <= e.start_ns <= w1]
    if not inside:
        return None
    if name is None:
        return inside
    return [e for e in inside if e.name == name or e.name.startswith(name + ".")]


def total_ms(events) -> float:
    return sum(e.end_ns - e.start_ns for e in events) / 1e6


def per_frame_ms(r, name: str) -> float | None:
    """Time in spans ``name`` over the traced frames, in ms a frame; None
    where there is no such span."""
    x = spans(r, name)
    if not x or not r.traced_frames:
        return None
    return total_ms(x) / r.traced_frames


def ring_records(r) -> list | None:
    """The present rings' records of the frames submitted inside the traced
    window, or None where there are none."""
    if r.trace is None:
        return None
    from based_renderer_tpu_torch.utils import profiling

    kept = getattr(profiling, "ring_records", None)
    if kept is None:
        return None
    w0, w1 = r.trace.window_ns
    inside = [x for x in kept() if w0 <= x.enter_ns <= w1]
    return inside or None


def ring_mean_ms(r, first: str, last: str) -> float | None:
    """The mean of ``last - first`` over the window's ring records, in ms."""
    x = ring_records(r)
    if x is None:
        return None
    return sum(getattr(rec, last) - getattr(rec, first) for rec in x) / len(x) / 1e6
