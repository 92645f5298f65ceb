"""ring_copy_ms: the present ring's allocation and copy of a frame under
its lock, per frame submitted in the traced window: the native submit's
copy-done stamp less its room stamp."""

from benchmark.harness import program_spans


def read(r):
    return program_spans.ring_mean_ms(r, "room_ns", "copied_ns")
