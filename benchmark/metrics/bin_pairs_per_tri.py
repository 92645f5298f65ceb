"""bin_pairs_per_tri: the true (tile, triangle) pairs the binner expanded,
over the triangles handed to it, across the calls made in the traced
window.  The binning work a tile size or a binning change would cut: every
pair is a slot sorted, a record assembled and a raster lane's triangle.

The program counts each draw's pairs on the device (``ops/binning``'s true
pair count) and, while a profiler records, keeps each call's sum over its
draws and frames with the triangles binned, unread
(``utils.profiling.bin_pairs_records``).  It is read here, after the
window.  None where the program keeps no such records (one older than the
count), or none from inside the window."""


def read(r):
    if r.trace is None:
        return None
    from based_renderer_tpu_torch.utils import profiling

    kept = getattr(profiling, "bin_pairs_records", None)
    if kept is None:
        return None
    w0, w1 = r.trace.window_ns
    inside = [x for x in kept() if w0 <= x.called_ns <= w1]
    triangles = sum(x.triangles for x in inside)
    if not triangles:
        return None
    return sum(int(x.pairs) for x in inside) / triangles
