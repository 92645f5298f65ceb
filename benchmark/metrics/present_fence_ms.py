"""present_fence_ms: host time a presented frame waits on its swapchain
fence (the event after its device-to-host copy), from the program's
``brt.sync.present_fence`` spans in the traced window."""

from benchmark.harness import program_spans


def read(r):
    x = program_spans.spans(r, "brt.sync.present_fence")
    return program_spans.total_ms(x) / len(x) if x else None
