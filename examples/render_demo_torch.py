#!/usr/bin/env python
"""Demo driver of the PyTorch + CUDA port: the frame-loop application.

Runs one of the built-in demos for N frames with double-buffered present
and FPS reporting: record -> submit -> present through
``present.render_loop``, with the native C++ present ring
(``runtime.PresentRing``) converting every frame and writing it as a PNG
when ``--out`` is given.  Runs on the CUDA device unless ``--cpu``; the
native runtime is required (it builds with g++ at first use).

    python examples/render_demo_torch.py cube --frames 120 --width 1920 --height 1080
    python examples/render_demo_torch.py big_mesh --out build/frames --profile
    python examples/render_demo_torch.py --list
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("demo", nargs="?", default="cube")
    ap.add_argument("--list", action="store_true", help="list demos and exit")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--msaa", type=int, default=1, choices=(1, 4))
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--vsync", action="store_true", help="pace at fixed_dt")
    ap.add_argument("--srgb", action="store_true",
                    help="present through the sRGB transfer function (the *_SRGB swapchain-format analog)")
    ap.add_argument("--backend", default="auto", choices=("auto", "xla", "pallas"))
    ap.add_argument("--profile", action="store_true", help="fence and time the render/present stages (StageTimer)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run into DIR (view in Perfetto)")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU instead of the CUDA device")
    return ap.parse_args(argv)


def run(args) -> dict:
    """One run of the demo; returns frames, presented (the ring's count),
    t (the last frame's animation time), fps (the pacer's last window),
    loop_fps (frames over the whole loop, the ring's flush included),
    staging_pinned (every presented CUDA image lay in page-locked memory),
    the stage report (or None) and the last image."""
    import torch

    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch import present, runtime
    from based_renderer_tpu_torch.models import demos
    from based_renderer_tpu_torch.utils import profiling

    cfg = brt.RendererConfig(width=args.width, height=args.height, msaa=args.msaa,
                             raster_backend=args.backend, framebuffer_srgb=args.srgb)
    r = brt.Renderer(cfg, device="cpu" if args.cpu else None)
    demo = demos.DEMOS[args.demo](r)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    ring = runtime.PresentRing(cfg.width, cfg.height, depth=2, out_dir=args.out, srgb=cfg.framebuffer_srgb)
    pinned = []

    def on_frame(img, pacer):
        if r.device.type == "cuda":
            pinned.append(torch.from_numpy(img).is_pinned())
        ring.submit(img)

    timer = profiling.StageTimer() if args.profile else None
    trace_cm = profiling.trace(args.trace, r.device) if args.trace else contextlib.nullcontext()
    try:
        t0 = time.perf_counter()
        with trace_cm as trace_path:
            last, pacer = present.render_loop(r, demo, frames=args.frames, on_frame=on_frame, vsync=args.vsync,
                                              timer=timer)
        ring.flush()
        loop_s = time.perf_counter() - t0
        presented = ring.presented
    finally:
        ring.close()
    if args.trace:
        print(f"trace written to {trace_path}")
    loop_fps = args.frames / loop_s
    print(f"{args.demo}: {args.frames} frames at {cfg.width}x{cfg.height} msaa={cfg.msaa} -> {pacer.fps:.1f} fps "
          f"(pacer), {loop_fps:.2f} fps over the loop, {presented} presented on {r.device}")
    report = timer.report() if timer is not None else None
    if report is not None:
        print(report)
    return {"frames": args.frames, "presented": presented, "t": pacer.t, "fps": pacer.fps, "loop_fps": loop_fps,
            "staging_pinned": bool(pinned) and all(pinned), "report": report, "last": last}


def main(argv=None):
    args = parse(argv)
    if args.list:
        from based_renderer_tpu_torch.models import demos

        print("\n".join(demos.DEMOS))
        return None
    from based_renderer_tpu_torch.utils.errors import main_guard

    return main_guard(run, args)


if __name__ == "__main__":
    main()
