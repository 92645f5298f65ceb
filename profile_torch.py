"""Where one demo frame of the PyTorch port spends its time, on one GPU.

Run from the root of a checkout, e.g.:
    python3 profile_torch.py big_mesh 3840 2160 --msaa 4
    python3 profile_torch.py cube 1920 1080 --msaa 4 --supersample --pairs 128
    python3 profile_torch.py textured_cube 1920 1080

For ``--frames`` frames of ``Renderer.render_frame`` it prints:
  * ms/frame on the host clock with a synchronise around each frame (median);
  * per-stage medians: each stage function of the frame (instancing, the
    vertex and fragment shaders, triangle gather, near clip, setup,
    binning with the record assembly inside it, the record assembly alone
    (either entry) and the template transpose, the raster kernel, the
    texture taps inside the fragment shader, the covered-tile count and
    the compacted shading pass around the fragment shader) is wrapped with
    a synchronise before and after, so a stage's time includes its launch
    cost; "rest" is the frame less the outermost stages (uniform upload,
    composite, MSAA resolve);
  * under torch.profiler, over the same number of frames: device-kernel
    time per frame, the busy share (that device time over the sync'd
    ms/frame above: the profiled window's own wall time includes the
    profiler's start-up), kernel launches per frame and the five largest
    kernels by device time.
Each line names the card (nvidia-smi name and power limit).  Needs a GPU;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

import based_renderer_tpu_torch as brt
from based_renderer_tpu_torch import renderer as renderer_mod
from based_renderer_tpu_torch import shader as shader_lib
from based_renderer_tpu_torch.ops import binassem, raster
from based_renderer_tpu_torch.ops import texture as tex_ops



def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class StageTimer:
    """Synchronised host timers around wrapped functions, per frame."""

    def __init__(self):
        self.frame = defaultdict(float)
        self.depth = 0
        self.outer = 0.0

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                self.frame[name] += dt
                if self.depth == 0:
                    self.outer += dt

        return timed


def install(timer: StageTimer, shader_name: str):
    """Wrap the frame's stage functions where the frame looks them up."""
    for mod, names in (
        (renderer_mod, ("expand_instances", "gather_triangles", "clip_near", "setup_triangles", "_compact_tiles",
                        "_shade_tiles")),
        (raster, ("bin_triangles", "rasterize_binned")),
        (binassem, ("assemble_records", "assemble_records_rows", "transpose_templates")),
        (tex_ops, ("sample_texture", "sample_separable")),
    ):
        for n in names:
            setattr(mod, n, timer.wrap(n, getattr(mod, n)))
    shd = shader_lib.get(shader_name)
    shader_lib.register(
        dataclasses.replace(shd, vertex=timer.wrap("vertex", shd.vertex), fragment=timer.wrap("fragment", shd.fragment))
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("demo", choices=sorted(brt.demos.DEMOS))
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("--msaa", type=int, default=1)
    ap.add_argument("--supersample", action="store_true")
    ap.add_argument("--pairs", type=float, default=None, help="override raster_pairs_factor")
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: torch.cuda.is_available() is false; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    cfg = brt.RendererConfig(args.width, args.height, msaa=args.msaa, msaa_supersample=args.supersample)
    r = brt.Renderer(cfg)
    pipe, mesh, uniforms, inst = brt.demos.DEMOS[args.demo](r)
    if args.pairs is not None:
        pipe = dataclasses.replace(pipe, raster_pairs_factor=args.pairs)
    label = f"{args.demo} {args.width}x{args.height} msaa={args.msaa}{' supersample' if args.supersample else ''}"

    for i in range(2):  # warm-up: kernel build, allocator
        r.render_frame(pipe, mesh, uniforms(0.05 * i), instances=inst)
    torch.cuda.synchronize()

    walls = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        f = r.render_frame(pipe, mesh, uniforms(0.05 * i), instances=inst)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if bool(f.overflowed):
        raise SystemExit(f"{label}: the frame overflowed its pair budget")
    frame_ms = statistics.median(walls)
    print(f"[frame] {label}: {frame_ms:.3f} ms/frame sync'd (median of {args.frames}) | {name}", flush=True)

    timer = StageTimer()
    install(timer, pipe.shader)
    per_stage, rest = defaultdict(list), []
    for i in range(args.frames):
        timer.frame.clear()
        timer.outer = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_frame(pipe, mesh, uniforms(0.05 * i), instances=inst)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        for k, v in timer.frame.items():
            per_stage[k].append(v)
        rest.append(total - timer.outer)
    stages = sorted(((statistics.median(v), k) for k, v in per_stage.items()), reverse=True)
    print(
        f"[stages] {label}, ms (median of {args.frames}, each sync'd): "
        + ", ".join(f"{k} {v:.3f}" for v, k in stages)
        + f", rest {statistics.median(rest):.3f} | {name}",
        flush=True,
    )

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.frames):
            r.render_frame(pipe, mesh, uniforms(0.05 * i), instances=inst)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.frames
    launches = sum(e.count for e in kernels) / args.frames
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    print(
        f"[profiler] {label}: device kernels {dev_ms:.3f} ms per frame, busy share {dev_ms / frame_ms:.3f} "
        f"of the sync'd frame, {launches:.0f} launches per frame | top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / args.frames:.3f} ms x{e.count // args.frames}" for e in top)
        + f" | {name}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
