"""caller_uniforms_ms: host time per traced frame inside the caller's
``uniforms_fn`` (``brt.caller.uniforms_fn``: once a frame in
``render_loop``, once a call for all its frames in ``render_sequence``).
In the benchmark's cells that is the frozen scene's code, not the
program's."""

from benchmark.harness import program_spans


def read(r):
    return program_spans.per_frame_ms(r, "brt.caller.uniforms_fn")
