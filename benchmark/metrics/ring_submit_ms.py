"""ring_submit_ms: host time per frame inside ``PresentRing.submit``, which
copies the image and blocks while ``depth`` frames wait on the conversion
thread, over the window's frames."""


def read(r):
    x = r.spans.get("ring_submit")
    return sum(x) / len(x) * 1e3 if x else None
