"""device_idle_pct: 100 less the share of the traced window's wall time that
the union of the device's kernel, memcpy and memset intervals covers."""


def read(r):
    if r.trace is None or not r.trace.device or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
