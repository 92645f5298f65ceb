"""latency_p95_ms.present: the 95th percentile, over every frame of the
traced run's untraced window, of the time from the ``render_frame`` call
that took a frame's uniforms to its image reaching ``on_frame``: a
present cell's tail, per layer for the reason ``frame_ms.present`` is."""


def read(r):
    return r.e2e.get("latency_p95_ms")
