"""The traced window of a ``--trace 1`` run: ``torch.profiler`` around a
span the harness marks, and what the device did inside it.

The window opens and closes on a synchronised device, so the work inside
it is exactly the work the host enqueued inside it.  Device events are the
profiler's kernel, memcpy and memset records, clipped to the window;
annotations the profiler mirrors onto the device timeline are not work
and are left out.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

WINDOW = "benchmark.traced_window"
_WORK = ("kernel", "memcpy", "memset")


class DeviceEvent(NamedTuple):
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start_ns: int
    end_ns: int


class HostEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    window_ns: tuple[int, int]
    device: list  # DeviceEvent inside the window
    host: list  # HostEvent (CPU ops, runtime calls and the harness's spans)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device events, as merged intervals."""
        merged: list[list[int]] = []
        for e in sorted(self.device, key=lambda e: e.start_ns):
            if merged and e.start_ns <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end_ns)
            else:
                merged.append([e.start_ns, e.end_ns])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels(self) -> list:
        return [e for e in self.device if e.kind == "kernel"]

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        total: dict = collections.defaultdict(int)
        for e in self.device:
            total[e.name[:160]] += e.end_ns - e.start_ns
        return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds]] of the longest idle gaps of the
        device, each named by the innermost host event that covers most of
        it."""
        busy = self.busy_intervals()
        edges = [self.window_ns[0]] + [x for ab in busy for x in ab] + [self.window_ns[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda e: e.start_ns)
        out = []
        for a, b in gaps:
            best, key = "idle", None
            for e in host:
                if e.start_ns >= b:
                    break
                overlap = min(b, e.end_ns) - max(a, e.start_ns)
                if overlap > 0:
                    k = (overlap, -(e.end_ns - e.start_ns))
                    if key is None or k > key:
                        best, key = e.name[:160], k
            out.append([best, (b - a) / 1e9])
        return out


def _kind(e, annotations: set) -> str | None:
    """'kernel', 'memcpy', 'memset' for device work; None for the
    annotations the profiler mirrors onto the device timeline."""
    name = e.name()
    if name in annotations or name == WINDOW:
        return None
    try:
        if e.is_user_annotation():
            return None
    except (AttributeError, RuntimeError):
        pass
    try:
        act = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        act = ""
    if "annotation" in act:
        return None
    for k in _WORK:
        if k in act:
            return k
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _user_annotation(e) -> bool:
    """A record_function span (the harness's, or the program's)."""
    try:
        return bool(e.is_user_annotation())
    except (AttributeError, RuntimeError):
        return e.name().startswith("benchmark.")


def _ns(e) -> tuple[int, int]:
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
    return int(start), int(start + dur)


class Tracer:
    """Profiles from ``start`` to ``stop``; ``stop`` returns the Trace."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._prof = None
        self._mark = None
        self.t_start = self.t_stop = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> Trace:
        self._sync()
        self.t_stop = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        window = None
        for e in events:
            if e.name() == WINDOW and e.device_type() == torch.autograd.DeviceType.CPU:
                window = _ns(e)
        if window is None:
            raise RuntimeError("the profiler kept no record of the traced window")
        dev, host = [], []
        cpu = torch.autograd.DeviceType.CPU
        annotations = {e.name() for e in events if e.device_type() == cpu and _user_annotation(e)}
        for e in events:
            a, b = _ns(e)
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() != WINDOW:
                    host.append(HostEvent(e.name(), a, b))
                continue
            kind = _kind(e, annotations)
            if kind is None:
                continue
            a, b = max(a, window[0]), min(b, window[1])
            if b > a:
                dev.append(DeviceEvent(e.name(), kind, a, b))
        self._prof = None
        return Trace(window, dev, host)


def span(name: str, on: bool):
    """A host span the profiler records when tracing is on."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()
