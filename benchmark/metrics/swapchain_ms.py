"""swapchain_ms: host time per loop iteration outside ``render_frame`` and
outside ``on_frame``: ``Swapchain.submit`` (the interleave, the async copy,
the fence wait on the oldest frame) and the pacer's tick, from the gaps
between the proxy's spans less the ``on_frame`` spans inside them."""


def read(r):
    x = r.spans.get("swapchain")
    return sum(x) / len(x) * 1e3 if x else None
