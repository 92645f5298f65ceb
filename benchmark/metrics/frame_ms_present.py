"""frame_ms.present: ``frame_ms`` of a present cell, read from the
traced run's untraced window: its wall time over every frame whose image
reached ``on_frame`` in it.  The host's shared memory bandwidth moves it
from run to run by more than an end-to-end bound may hold (``PERF.md``
§2), so it is a per-layer reading there."""


def read(r):
    return r.e2e.get("frame_ms")
