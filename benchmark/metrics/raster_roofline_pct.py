"""raster_roofline_pct: the least time of the raster stage's work over the
device time of the raster kernels in the traced window.

The work is counted by ``harness/work.py`` from the traced frames' own
inputs (visibility planes written once per sample, each triangle that
reaches the raster read once, one test per bbox sample), never from the
program's binner.  The raster kernels are the symbols with ``raster`` in
their name: B1, B2 (and B7), B4 and B5 of ``csrc/``.  The run's notes say
which bound binds; the share is None where no raster kernel ran.
"""

from benchmark.harness import work


def kernel_seconds(r) -> float:
    return sum(e.end_ns - e.start_ns for e in r.trace.kernels() if "raster" in e.name.lower()) / 1e9


def read(r):
    if r.trace is None or not r.traced_times:
        return None
    t = kernel_seconds(r)
    if t <= 0:
        return None
    b, ops = r.raster_work()
    return 100.0 * work.least_seconds(b, ops)[0] / t
