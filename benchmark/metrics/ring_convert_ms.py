"""ring_convert_ms: the present ring's worker thread per frame submitted in
the traced window, from taking the frame to freeing its copy: the f32 ->
u8 conversion, the PNG where there is an output directory, and the free
(``present_worker``, stamped in C++)."""

from benchmark.harness import program_spans


def read(r):
    return program_spans.ring_mean_ms(r, "popped_ns", "freed_ns")
