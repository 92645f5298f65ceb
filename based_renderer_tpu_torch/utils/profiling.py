"""Profiling: the program's spans, the present ring's stamps, torch.profiler
traces and stage timing (the FPS-overlay analog).

``span(name)`` marks a layer boundary of the program.  While a
``torch.profiler`` records, it is a ``record_function``: the span's start,
end and parent land in the profiler's own host events, on the clock its
device events use, and a count is the number of spans of a name.  While
none records it is one check of the profiler's enabled flag, which returns
a shared no-op context.  Every name starts with ``brt.``; ``brt.caller.*``
marks time spent in the caller's callbacks.

The native present ring stamps each frame on its own thread (ns on the
system clock, the clock the profiler stamps host events on).  While a
profiler records, a ``runtime.PresentRing`` drains those stamps here
(``ring_records``), and again when it is flushed and closed.

Each frame and each ``render_sequence`` call counts on the device how full
its pair budget was (``FrameResult.pair_budget_use``).  While a profiler
records, the renderer hands that () tensor here with the call's stamp
(``keep_budget_use``), and nothing reads it on the host: a reader takes
``budget_use_records`` after the traced window.  So too the binner's work:
each draw's true (tile, triangle) pair count, summed on the device over a
call's draws and frames, kept with the triangles handed to the binner
(``keep_bin_pairs``, ``bin_pairs_records``).

``ROUTES_TAKEN`` counts the routes a frame took, by name: each kernel
route of ``ops._build.ROUTES`` at its wrapper's launch, and the
renderer's ``compacted_draws`` (a draw shaded per covered tile) and
``fused_shading`` (a draw shaded by its shader's fused body).  It counts
eager frames and graph captures, never a replay: it tells which route a
frame took, not how often a kernel ran.

``trace`` wraps a block in ``torch.profiler`` and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``) into a directory, with the
ring's stamps as a track of their own; ``StageTimer`` measures the wall
time of named stages, each fenced on the device work it enqueued, the
``block_until_ready`` analog: a CUDA event recorded on the current stream
and synchronised.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: The context a span returns while no profiler records.
OFF = contextlib.nullcontext()

#: The routes taken in this process, by name (see the module docstring).
ROUTES_TAKEN: collections.Counter = collections.Counter()


def recording() -> bool:
    """Whether a torch profiler records now."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The program's span ``name``: a ``record_function`` while a profiler
    records, else the no-op ``OFF``."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return torch.profiler.record_function(name)


class RingRecord(NamedTuple):
    """One frame of a present ring, stamped in ns on the system clock; a
    stamp the frame did not reach (``written`` without an output
    directory) is 0."""

    ring: int  # the ring's serial number in this process
    index: int  # the frame's index in its ring
    enter_ns: int  # submit entered
    room_ns: int  # a place in the ring was free
    copied_ns: int  # the frame's copy was made
    popped_ns: int  # the worker took the frame
    converted_ns: int  # f32 -> u8 done
    written_ns: int  # the PNG written
    freed_ns: int  # the frame's copy freed


#: The rings' drained records, oldest first; bounded.
_RING_RECORDS: collections.deque = collections.deque(maxlen=1 << 16)


def keep_ring_records(ring: int, rows) -> None:
    """Keep a ring's drained stamps: rows of (index, enter, room, copied,
    popped, converted, written, freed)."""
    _RING_RECORDS.extend(RingRecord(ring, *(int(v) for v in row)) for row in rows)


def ring_records() -> list:
    """Every ring record kept, oldest first."""
    return list(_RING_RECORDS)


class BudgetUse(NamedTuple):
    """One frame's or one sequence call's pair budget use, as the renderer
    returned it."""

    called_ns: int  # the call entered, ns on the system clock
    use: torch.Tensor  # () float64 on the device: > 1 where a pair budget overflowed


#: The calls' budget use while a profiler recorded, oldest first; bounded.
_BUDGET_USE: collections.deque = collections.deque(maxlen=1 << 12)


def keep_budget_use(called_ns: int, use: torch.Tensor) -> None:
    """Keep a call's () budget-use tensor as it is, with no host read."""
    _BUDGET_USE.append(BudgetUse(called_ns, use))


def budget_use_records() -> list:
    """Every budget use kept, oldest first."""
    return list(_BUDGET_USE)


class BinPairs(NamedTuple):
    """One frame's or one sequence call's binning work, as the renderer
    counted it."""

    called_ns: int  # the call entered, ns on the system clock
    pairs: torch.Tensor  # () int64 on the device: true (tile, triangle) pairs of every draw and frame
    triangles: int  # the triangles handed to the binner, over the same draws and frames


#: The calls' binning work while a profiler recorded, oldest first; bounded.
_BIN_PAIRS: collections.deque = collections.deque(maxlen=1 << 12)


def keep_bin_pairs(called_ns: int, pairs, triangles: int) -> None:
    """Keep a call's binning work: ``pairs`` its draws' () pair counts on
    the device, summed there into a tensor of the record's own (a replay
    overwrites the graph's), with no host read."""
    if pairs:
        total = torch.stack(list(pairs)).sum(dtype=torch.int64)
        _BIN_PAIRS.append(BinPairs(called_ns, total, int(triangles)))


def bin_pairs_records() -> list:
    """Every binning record kept, oldest first."""
    return list(_BIN_PAIRS)


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a profiler trace of the block:
    ``with profiling.trace("build/trace", r.device) as path: ...``.

    Records CUDA activity when ``device`` is a CUDA device (``None``: when
    CUDA is available) and host activity always; on exit writes the Chrome
    trace to ``path``, a new file in ``log_dir``, with the present rings'
    frames submitted inside the block as tracks of their own (flush a ring
    inside the block to have its last frames there)."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    t0 = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    records = [r for r in ring_records() if t0 <= r.enter_ns <= t1]
    if records:
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += _ring_track(records, doc.get("baseTimeNanoseconds", 0))
        with open(path, "w") as f:
            json.dump(doc, f)


#: A ring record's phases on the Chrome track: (name, first stamp, last
#: stamp, which of the ring's two threads).
_PHASES = (("ring wait", "enter_ns", "room_ns", "submit"), ("ring copy", "room_ns", "copied_ns", "submit"),
           ("ring convert", "popped_ns", "converted_ns", "worker"), ("ring write", "converted_ns", "written_ns", "worker"),
           ("ring free", "written_ns", "freed_ns", "worker"))


def _ring_track(records, base_ns: int) -> list:
    """Chrome trace events of ring records: per ring a submit and a worker
    thread, named, with one complete event per phase a frame went through;
    ``ts`` in us after ``base_ns`` (the trace's ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    events, threads = [], {}
    for r in records:
        for name, a, b, side in _PHASES:
            start, end = getattr(r, a), getattr(r, b)
            if name == "ring free" and not start:  # no PNG: the free follows the conversion
                start = r.converted_ns
            if not start or not end:
                continue
            tid = threads.setdefault((r.ring, side), (1 << 30) + 2 * r.ring + (side == "worker"))
            events.append({"ph": "X", "cat": "brt.ring", "name": name, "pid": pid, "tid": tid,
                           "ts": (start - base_ns) / 1e3, "dur": (end - start) / 1e3, "args": {"frame": r.index}})
    for (ring, side), tid in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"brt.ring {ring} {side}"}})
    return events


def wait(fence) -> None:
    """Block until the device work behind ``fence`` is done: for a CUDA
    tensor, an event recorded on its device's current stream and
    synchronised; for a CUDA ``torch.device``, the whole device.  CPU
    tensors and devices, and ``None``, are already done."""
    if isinstance(fence, torch.Tensor):
        if fence.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(fence.device))
            event.synchronize()
    elif isinstance(fence, torch.device):
        if fence.type == "cuda":
            torch.cuda.synchronize(fence)
    elif fence is not None:
        raise TypeError(f"cannot fence on {type(fence).__name__}")


class StageTimer:
    """Accumulates wall time per named stage, fencing device async work.

    ``totals`` holds seconds per stage and ``counts`` calls per stage;
    ``outer`` sums the stages that ran inside no other stage, so a caller
    that nests stages (``wrap`` around functions that call each other)
    can tell the covered share of a frame from the rest."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.outer = 0.0
        self._depth = 0

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.outer = 0.0

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """Time the block; before stopping the clock, wait for ``fence``
        (see :func:`wait`)."""
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            wait(fence)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self._depth == 0:
                self.outer += dt

    def wrap(self, name: str, fn, fence=None):
        """``fn`` timed as stage ``name``, waiting for ``fence`` before the
        call too, so the stage does not absorb work queued ahead of it
        (a CUDA ``torch.device`` fences everything on the card)."""

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            wait(fence)
            with self.stage(name, fence=fence):
                return fn(*args, **kwargs)

        return timed

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total  {tot / n * 1e3:8.3f} ms/call  x{n}")
        return "\n".join(lines)
