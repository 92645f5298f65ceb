"""pair_budget_use_pct: the fullest share of its pair budget that a frame's
true (tile, triangle) pair stream needed, over the calls made in the traced
window, in %.  Above 100 a draw overflowed its ``raster_pairs_factor`` or
``raster_slots_factor`` budget and dropped triangles; below it, the room
left.

The program counts it on the device (``FrameResult.pair_budget_use``; a
``render_sequence`` call folds its frames with a max) and, while a profiler
records, keeps each call's () tensor with the call's stamp, unread
(``utils.profiling.budget_use_records``).  It is read here, after the
window.  None where the program keeps no such records (one older than the
count), or none from inside the window."""


def read(r):
    if r.trace is None:
        return None
    from based_renderer_tpu_torch.utils import profiling

    kept = getattr(profiling, "budget_use_records", None)
    if kept is None:
        return None
    w0, w1 = r.trace.window_ns
    inside = [float(x.use) for x in kept() if w0 <= x.called_ns <= w1]
    return 100.0 * max(inside) if inside else None
