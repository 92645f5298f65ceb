"""render_frame_host_ms: host time inside ``render_frame`` per frame, unfenced
(the key's lookup, the input slots' copies, the replay's enqueue, the
results' clones), from the proxy's spans over the window's frames."""


def read(r):
    x = r.spans.get("render_frame")
    return sum(x) / len(x) * 1e3 if x else None
