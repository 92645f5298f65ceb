"""sequence_stack_ms: host time per traced frame in ``render_sequence``'s
stacking of the per-frame uniforms and their upload
(``brt.sequence.stack``)."""

from benchmark.harness import program_spans


def read(r):
    return program_spans.per_frame_ms(r, "brt.sequence.stack")
