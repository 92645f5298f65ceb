"""captures_in_window: CUDA graph captures (and their eager warm-up frames)
inside the traced window, from the program's ``brt.frame.capture`` spans;
0 where the window replays only what set-up captured."""

from benchmark.harness import program_spans


def read(r):
    x = program_spans.spans(r, "brt.frame.capture")
    return None if x is None else len(x)
