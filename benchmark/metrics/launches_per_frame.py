"""launches_per_frame: kernels the profiler saw in the traced window over
the frames enqueued in it (a replayed graph's kernels each count)."""


def read(r):
    if r.trace is None or not r.traced_frames:
        return None
    n = len(r.trace.kernels())
    return n / r.traced_frames if n else None
