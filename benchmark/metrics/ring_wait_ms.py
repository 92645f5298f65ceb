"""ring_wait_ms: the present ring's wait for a free place, per frame
submitted in the traced window: the native submit's room stamp less its
enter stamp (``brt_present_submit``, stamped in C++)."""

from benchmark.harness import program_spans


def read(r):
    return program_spans.ring_mean_ms(r, "enter_ns", "room_ns")
