"""host_syncs_per_frame: the program's host waits on the device per traced
frame: its ``brt.sync.*`` spans (pageable uploads, the compacted draw's
tile count, debug reads, the present fence) in the traced window."""

from benchmark.harness import program_spans


def read(r):
    x = program_spans.spans(r, "brt.sync")
    if x is None or not r.traced_frames:
        return None
    return len(x) / r.traced_frames
