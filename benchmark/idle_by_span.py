"""The device's idle time in a cell's traced window, by the innermost span
the host was in: the program's ``brt.*`` spans, and where the host was in
none of them, the harness's ``benchmark.*`` span.

    python3 benchmark/idle_by_span.py --workload <cell> --seed <n> [--seconds <s>]

run from the root of a checkout on a machine with a CUDA device.  It
drives the cell as ``run.py --trace 1`` does (set-up, ``--seconds`` of
traffic, then the traced window), compares nothing, and prints one line
per span name: the idle ms inside that span's own time (outside its
children) and its share of the window's idle time, then the frames in the
window and the window's wall time over them (the frame time with the
profiler on).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import guard  # noqa: E402

guard.keep_jax_out(os.environ)

#: The spans idle time is attributed to: the program's, then the harness's.
PREFIXES = ("brt.", "benchmark.")


def idle_by_span(trace) -> dict:
    """{innermost span name, or "none": idle ns} over the window.  A brt.*
    span is innermost over any benchmark.* span around it; spans of one
    kind nest, since they come from one thread."""
    w0, w1 = trace.window_ns
    busy = trace.busy_intervals()
    idle, at = [], w0
    for a, b in busy:
        if a > at:
            idle.append((at, min(a, w1)))
        at = max(at, b)
    if at < w1:
        idle.append((at, w1))
    spans = [e for e in trace.host if e.name.startswith(PREFIXES) and e.end_ns > w0 and e.start_ns < w1]
    # elementary pieces between every boundary; each takes its innermost span
    cuts = sorted({w0, w1} | {t for e in spans for t in (e.start_ns, e.end_ns) if w0 < t < w1}
                  | {t for ab in idle for t in ab})
    starts = sorted(spans, key=lambda e: (e.start_ns, -e.end_ns))
    out: dict = collections.defaultdict(int)
    open_: list = []
    k = 0
    idle_starts = [a for a, _ in idle]
    for x, y in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k].start_ns <= x:
            open_.append(starts[k])
            k += 1
        open_ = [e for e in open_ if e.end_ns > x]
        i = bisect.bisect_right(idle_starts, x) - 1
        if i < 0 or idle[i][1] < y:
            continue  # busy
        inner = {p: [e for e in open_ if e.name.startswith(p)] for p in PREFIXES}
        name = "none"
        for p in PREFIXES:
            if inner[p]:
                name = max(inner[p], key=lambda e: (e.start_ns, -e.end_ns)).name
                break
        out[name] += y - x
    return dict(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, default=3)
    a = p.parse_args(argv)

    from benchmark.harness import core, spec
    import torch

    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA device", file=sys.stderr)
        return 2
    meas = core.measure(spec.load(), a.workload, a.seed, a.seconds, True, "cuda", T_PROCESS)
    trace = meas.m.trace
    idle = idle_by_span(trace)
    total = sum(idle.values())
    print(f"{a.workload} seed {a.seed}: window {trace.window_s * 1e3:.3f} ms, idle {total / 1e6:.3f} ms "
          f"({100 * total / (trace.window_s * 1e9):.1f}%), {meas.m.traced_frames} frames, "
          f"{trace.window_s * 1e3 / max(meas.m.traced_frames, 1):.4f} ms a frame with the profiler on")
    for name, ns in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:40s} {ns / 1e6:10.3f} ms  {100 * ns / total:5.1f}% of idle")
    frames = max(meas.m.traced_frames, 1)
    w0, w1 = trace.window_ns
    spans = collections.defaultdict(list)
    for e in trace.host:
        if e.name.startswith(PREFIXES) and w0 <= e.start_ns <= w1:
            spans[e.name].append(e.end_ns - e.start_ns)
    print("spans in the window: name, per frame, ms a frame")
    for name, d in sorted(spans.items()):
        print(f"  {name:40s} {len(d) / frames:8.3f} {sum(d) / frames / 1e6:10.4f}")
    from based_renderer_tpu_torch.utils import profiling

    rec = [x for x in getattr(profiling, "ring_records", list)() if w0 <= x.enter_ns <= w1]
    if rec:
        print(f"ring phases, mean ms over {len(rec)} frames:", ", ".join(
            f"{a[:-3]}->{b[:-3]} {sum(getattr(x, b) - getattr(x, a) for x in rec) / len(rec) / 1e6:.4f}"
            for a, b in (("enter_ns", "room_ns"), ("room_ns", "copied_ns"), ("copied_ns", "popped_ns"),
                         ("popped_ns", "converted_ns"), ("converted_ns", "freed_ns"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
