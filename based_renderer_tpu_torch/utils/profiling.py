"""Profiling: torch.profiler traces and stage timing (the FPS-overlay analog).

``trace`` wraps a block in ``torch.profiler`` and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``) into a directory;
``StageTimer`` measures the wall time of named stages, each fenced on the
device work it enqueued, the ``block_until_ready`` analog: a CUDA event
recorded on the current stream and synchronised.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a profiler trace of the block:
    ``with profiling.trace("build/trace", r.device) as path: ...``.

    Records CUDA activity when ``device`` is a CUDA device (``None``: when
    CUDA is available) and host activity always; on exit writes the Chrome
    trace to ``path``, a new file in ``log_dir``."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


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
