"""shade_ms: device ms a traced frame spends in the fused Blinn-Phong
shading kernel (``csrc/shade_blinn_phong.cu``): the device time of the
kernels named ``shade_blinn_phong_kernel`` in the traced window, over the
frames enqueued in it.  It reads the program's one-pass shading,
composite and MSAA resolve of a Blinn-Phong draw.  None where no such
kernel ran: a program without the fused pass, or frames whose draws do
not take it."""

SYMBOL = "shade_blinn_phong_kernel"


def read(r):
    if r.trace is None or not r.traced_frames:
        return None
    ns = sum(e.end_ns - e.start_ns for e in r.trace.kernels() if SYMBOL in e.name)
    return ns / 1e6 / r.traced_frames if ns else None
