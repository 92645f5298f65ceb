"""Where one demo frame of the PyTorch port spends its time, on one GPU.

Run from the root of a checkout, e.g.:
    python3 profile_torch.py big_mesh 3840 2160 --msaa 4
    python3 profile_torch.py cube 1920 1080 --msaa 4 --supersample --pairs 128
    python3 profile_torch.py textured_cube 1920 1080 --sequence 20

For ``--frames`` frames it prints:
  * ms/frame on the host clock with a synchronise around each frame
    (median), for the eager frame (``Renderer._run_frame``) and for
    ``Renderer.render_frame``, which replays the key's captured CUDA
    graphs after its first call;
  * under torch.profiler, over the same number of replayed
    ``render_frame`` frames: device-kernel time per frame, its busy share
    of the sync'd replayed ms/frame and launches per frame;
  * with ``--sequence N``: ``Renderer.render_sequence`` of N frames, each
    replaying the captured CUDA graphs: ms/frame (best of 3 phase-shifted
    calls, host clock around the call and a synchronise, over N), and
    under torch.profiler one more call's device-kernel time per frame, its
    busy share (that device time over the profiled call's wall time) and
    launches per frame;
  * per-stage medians of the eager frame (a replay calls no stage
    function): each stage function (instancing, the vertex and fragment
    shaders, a shader's fused body counted as the fragment stage,
    triangle gather, near clip, setup,
    binning with the record assembly inside it, the binner's per-triangle
    templates alone (``binning._templates``: the edge values and the float
    planes, S2 on the card), the record assembly alone
    (either entry) and the template transpose, the raster kernel, the
    texture taps inside the fragment shader, the covered-tile order and
    the compacted shading pass around the fragment shader) is wrapped with
    a synchronise before and after, so a stage's time includes its launch
    cost; "rest" is the frame less the outermost stages (uniform upload,
    composite, MSAA resolve);
  * under torch.profiler, over the same number of eager frames:
    device-kernel time per frame, the busy share (that device time over
    the sync'd eager ms/frame above: the profiled window's own wall time
    includes the profiler's start-up), kernel launches per frame and the
    five largest kernels by device time.
Each line names the card (nvidia-smi name and power limit).  Needs a GPU;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

import based_renderer_tpu_torch as brt
from based_renderer_tpu_torch import renderer as renderer_mod
from based_renderer_tpu_torch import shader as shader_lib
from based_renderer_tpu_torch.ops import binassem, binning, compact, raster
from based_renderer_tpu_torch.ops import texture as tex_ops
from based_renderer_tpu_torch.utils.profiling import StageTimer



def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def install(timer: StageTimer, shader_name: str):
    """Wrap the frame's stage functions where the frame looks them up, each
    synchronised with the card before and after (a stage's time includes
    its launch cost)."""
    card_fence = torch.device("cuda")
    for mod, names in (
        (renderer_mod, ("expand_instances", "gather_triangles", "clip_near", "setup_triangles", "_shade_tiles")),
        (compact, ("covered_tile_order",)),
        (raster, ("bin_triangles", "rasterize_binned")),
        (binning, ("_templates",)),
        (binassem, ("assemble_records", "assemble_records_rows", "transpose_templates")),
        (tex_ops, ("sample_texture", "sample_separable")),
    ):
        for n in names:
            setattr(mod, n, timer.wrap(n, getattr(mod, n), fence=card_fence))
    shd = shader_lib.get(shader_name)
    # A fused body (shading, composite and resolve in one kernel) is the
    # frame's fragment shading stage too.
    fused = shd.fused and timer.wrap("fragment", shd.fused, fence=card_fence)
    shader_lib.register(
        dataclasses.replace(shd, vertex=timer.wrap("vertex", shd.vertex, fence=card_fence),
                            fragment=timer.wrap("fragment", shd.fragment, fence=card_fence), fused=fused)
    )


def kernel_summary(prof, frames: int):
    """(device-kernel ms per frame, launches per frame, the kernels by device time)."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    launches = sum(e.count for e in kernels) / frames
    return dev_ms, launches, sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)


def top5(kernels, frames: int) -> str:
    return "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / frames:.3f} ms x{e.count // frames}"
                     for e in kernels[:5])


def profile_sequence(r, pipe, mesh, uniforms, inst, n: int, label: str, name: str):
    """render_sequence of n frames: replay ms/frame and the busy share."""
    static = {k: v for k, v in uniforms(0.0).items() if isinstance(v, brt.Texture)}

    def useq(phase):
        frames = [uniforms(phase + 0.05 * i) for i in range(n)]
        return {k: torch.stack([torch.as_tensor(f[k]) for f in frames]).to(r.device) for k in frames[0]
                if k not in static}

    def call(u):
        return r.render_sequence(pipe, mesh, u, instances=inst, static_uniforms=static)

    call(useq(0.5))  # warm-up and capture
    walls = []
    for k in range(3):
        u = useq(1e-3 * (k + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(u)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / n)
    if bool(r.last_sequence_overflowed):
        raise SystemExit(f"{label}: the sequence overflowed its pair budget")
    u = useq(0.25)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call(u)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev_ms, launches, kernels = kernel_summary(prof, n)
    print(
        f"[sequence] {label}: {n} frames replayed, {min(walls):.3f} ms/frame (best of 3 calls, sync'd) | profiled "
        f"call {wall:.3f} ms/frame: device kernels {dev_ms:.3f} ms per frame, busy share {dev_ms / wall:.3f}, "
        f"{launches:.0f} launches per frame | top: {top5(kernels, n)} | {name}",
        flush=True,
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
    ap.add_argument("--sequence", type=int, default=0, metavar="N", help="also replay render_sequence of N frames")
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

    def eager(i):
        """The eager frame at t = 0.05 i: the result tuple."""
        r.begin_frame()
        r.draw(pipe, mesh, uniforms(0.05 * i), instances=inst)
        return r._run_frame(*r.close_frame())

    def replayed(i):
        return r.render_frame(pipe, mesh, uniforms(0.05 * i), instances=inst)

    for i in range(2):  # warm-up: kernel build, allocator; the key's capture
        eager(i)
        replayed(i)
    torch.cuda.synchronize()

    frame_ms = {}
    for kind, fn in (("eager _run_frame", eager), ("render_frame (replayed)", replayed)):
        walls = []
        for i in range(args.frames):
            t0 = time.perf_counter()
            out = fn(i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if bool(out[4] if isinstance(out, tuple) else out.overflowed):
            raise SystemExit(f"{label}: the frame overflowed its pair budget")
        frame_ms[kind] = statistics.median(walls)
        print(f"[frame] {label}, {kind}: {frame_ms[kind]:.3f} ms/frame sync'd (median of {args.frames}) | {name}",
              flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.frames):
            replayed(i)
        torch.cuda.synchronize()
    dev_ms, launches, kernels = kernel_summary(prof, args.frames)
    replay_ms = frame_ms["render_frame (replayed)"]
    print(
        f"[replayed] {label}: render_frame under the profiler: device kernels {dev_ms:.3f} ms per frame, busy share "
        f"{dev_ms / replay_ms:.3f} of the sync'd replayed frame, {launches:.0f} launches per frame | "
        f"top: {top5(kernels, args.frames)} | {name}",
        flush=True,
    )
    if args.sequence:
        profile_sequence(r, pipe, mesh, uniforms, inst, args.sequence, label, name)

    timer = StageTimer()
    install(timer, pipe.shader)
    per_stage, rest = defaultdict(list), []
    for i in range(args.frames):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(i)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        for k, v in timer.totals.items():
            per_stage[k].append(v * 1e3)
        rest.append(total - timer.outer * 1e3)
    stages = sorted(((statistics.median(v), k) for k, v in per_stage.items()), reverse=True)
    print(
        f"[stages] {label}, eager _run_frame, ms (median of {args.frames}, each sync'd): "
        + ", ".join(f"{k} {v:.3f}" for v, k in stages)
        + f", rest {statistics.median(rest):.3f} | {name}",
        flush=True,
    )

    eager_ms = frame_ms["eager _run_frame"]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.frames):
            eager(i)
        torch.cuda.synchronize()
    dev_ms, launches, kernels = kernel_summary(prof, args.frames)
    print(
        f"[profiler] {label}, eager _run_frame: device kernels {dev_ms:.3f} ms per frame, busy share "
        f"{dev_ms / eager_ms:.3f} of the sync'd frame, {launches:.0f} launches per frame | "
        f"top: {top5(kernels, args.frames)} | {name}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
