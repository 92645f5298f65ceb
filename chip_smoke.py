"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the
result lines):
  1. device: CUDA present, the card's name and power limit (nvidia-smi);
  2. build: compiles csrc/*.cu with nvcc at first use (one nvcc per source,
     started together), ptxas registers and shared memory per kernel;
  3. raster_tile (B1) vs its plain version on the same binned records (cube
     1920x1080, a 16384-triangle stress stream with exact depth ties and
     tiles of > 128 records, an init chain, greater_equal + depth clamp +
     scissor): tri_id and depth_q exact, float planes within 1e-6; then B1
     with stencil on the stress stream (increment overdraw, the ops zoo
     with masks and clear 0x40, never with a fail op, a stamp -> equal
     init chain carrying init.stencil; depth test on and off), stencil
     exact, and the two-pass route (B6, mapped onto raster_tile.cu) on the
     same inputs equal to B1 and to the plain version;
  4. assemble_records (B3) vs its plain version on the 1M-triangle
     big_mesh stream at 1920x1080 (16-row records), on the 4K MSAA-4x
     stream (24-row records) and on the culled instanced stream (10k cubes
     at 1920x1080 under instance_cull 0.9: per-triangle original ids,
     which the records must carry): int records exact, float records
     bitwise; then transpose_templates (B8) on big_mesh's field-major templates
     (K = 6: W8 48, out_width 64) and on the same triangles with 33
     channels (W8 136, out_width 192), bitwise against its plain version and
     against its library call (one copy_ into a zeroed buffer), and the
     rows entry of assemble_records.cu reading the transposed rows, on the
     1080p, the 4K MSAA and the culled streams, bitwise against its plain
     version and against the per-field entry;
  5. raster_sublane (B2) vs its plain version and vs raster_tile on the
     B3-assembled 1M-triangle stream (group 64), the 10k-instance stream
     (group 32, depth_clip False), the stress tie stream under the four
     ordered compares, and a band-binned stream (bin_rows 4); the batched
     route (B7, mapped onto raster_sublane.cu) vs B2's plain version and vs
     raster_tile on the 1M-triangle stream (batch 16) and on the stress tie
     stream under the four ordered compares at tiles 32x16, 64x64, 128x32
     and 128x128, an init chain, and clamp with scissor; B2 and B7 at
     1366x768 (a width the kernel's 16-byte stores cannot serve, so its
     scalar stores) on the stress tie stream and an init chain, every
     plane bitwise equal to the plain version and to raster_tile;
  6. raster_msaa4 (B4) vs its plain version on the MSAA cube stream at
     1920x1080 and on the padded stress stream (an init chain,
     greater_equal + depth clamp + scissor, depth test off);
     raster_msaa4_sublane (B5) vs its plain version and vs B4 on the 4K
     MSAA big_mesh stream (group 64) and on the stress tie stream under the
     four ordered compares: per-sample tri_id and depth_q exact, floats
     within 1e-6; B4 with per-sample stencil vs its plain version on the
     MSAA stress stream and the MSAA cube, stencil exact;
  7. oracle: tri_id and depth_q equal the port's own copy of the numpy
     oracle (based_renderer_tpu_torch/reference/oracle.py) for the cube and
     the stress stream through raster_tile, for big_mesh (2000 triangles)
     through the dense path, and per sample (rasterize_msaa4) for the MSAA
     cube through B4 and the MSAA big_mesh (2000 triangles) through B3 + B5,
     stencil streams (with the stencil plane) through B1 and the two-pass
     route, per-sample stencil through B4, and a depth-biased stream
     through setup and B1, at 1920x1080;
  8. end to end: Renderer.render_frame with big_mesh (1M triangles) at
     1920x1080 and 3840x2160, instanced (10k cubes) at 1920x1080, cube at
     1920x1080 and triangle at 800x600, and the three MSAA runs: big_mesh at
     3840x2160 with msaa=4 (BASELINE config 5), the cube at 1920x1080 with
     msaa=4 and with msaa_supersample; the launches of each frame are
     asserted (dense frames assemble_records and raster_sublane once, MSAA
     big_mesh assemble_records and raster_msaa4_sublane once, the MSAA cube
     raster_msaa4 once, cube, triangle and supersampled cube raster_tile
     once); the render-state frames at 1920x1080, plain and MSAA-4x (three
     draws: the cube stamping the stencil, the 10k instances drawn
     two-pass where the stencil is not the stamp, the cube again with depth
     bias and constant-alpha blending), and big_mesh with raster_batch 16;
     big_mesh 1920x1080 with raster_tmpl="pallas" (B8, the rows entry and
     B2 once a frame; its frame equals the default big_mesh frame), the
     textured cube at 1920x1080 (BASELINE config 3: B1 once and one
     compacted draw a frame), the textured full-screen quad at 1920x1080
     (B1 once a frame, the separable sampler on every frame) and the
     textured cube with msaa=4 (B4 once and one compacted draw a frame);
     the 10k instances with instance_cull 0.9 (B3 and B2 once a frame),
     and at msaa=4 unculled and culled (B3 and B5 once a frame; the culled
     draw with pair and slot budgets of 1.3 and 0.7 per triangle); no frame
     overflows; one kernel-path frame of each of the last ten runs equals
     the plain-path frame (tri_id, depth_q and stencil exact, colour within
     1e-5); culled frames equal unculled ones the same way, and the worst
     visible share of the timed culled frames is printed; median ms/frame
     on the kernel path and on the plain path;
  9. sequences: render_sequence_multi, each frame replaying captured CUDA
     graphs, for the cube, the textured cube (compacted), the 10k
     instances unculled and culled, big_mesh at 1080p (uploaded and
     generated), big_mesh at 4K MSAA-4x and the three-draw render-state
     frame, at the sizes of phase 8: 4 frames with return_frames equal to
     eager render_frame (colour within 1e-5), checksums sum(color),
     distinct frames, no overflow; the first call launches each kernel
     twice a frame's count (the eager warm-up and the capture), and a
     later call launches none eagerly while the profiler sees each
     kernel's symbol once a frame per launch of the eager frame; ms/frame
     as bench.py times it (20 frames less 4, best of 3 phase-shifted
     calls) beside the eager event-timed ms/frame;
 10. the demo driver: examples/render_demo_torch.py's main() in this
     process (after the sequences, so no destructor lands in a capture),
     through present.render_loop and the native runtime's PresentRing
     (runtime/native/brt_runtime.cpp, built with g++; zlib.h checked
     first): the cube at 1920x1080 for 60 frames with --out and --profile,
     again with --out and without it, 10 frames under --srgb, and
     big_mesh (1M triangles) for 20 frames with and without --out; the
     PNG count and PresentRing.presented equal the frame count, the last
     PNG (decoded with zlib) equals render_frame(t_last).color_u8() byte
     for byte, B1 launched once a frame (cube), B3 and B2 once a frame
     (big_mesh), every presented image lay in page-locked staging; then a
     shader file (the cube's vertex-colour program as torch source,
     shader.load_file) renders the 1080p cube through B1 bitwise equal
     to the built-in shader's frame; fps over each loop and the
     StageTimer report of the --profile run.
Every kernel time is the median of 7 CUDA-event windows around the
wrapper in this run, with the spread and the SM clock nvidia-smi read right
after, and beside it the kernel's own device time (kernel-only: the same
launches under torch.profiler, the kernel symbol's self device time over
its count), which leaves out the wrapper's host work.  Then one JSON line
of per-kernel numbers (ms, kernel_ms, and each kernel's bound: the larger
of its bytes over 3.35 TB/s, the winning records' float rows included for
the rasters, and its integer operations over the card's int32 rate; B8's
library call; B3's two entries report the culled instanced stream), the
nvidia-smi name/power line, and last the device line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FLOAT_TOL = 1e-6
WINDOWS = 7
KERNEL_ITERS = 10  # launches under the profiler for a kernel's device-only time
W, H = 1920, 1080
W4K, H4K = 3840, 2160
KERNELS = (
    "raster_tile",
    "raster_sublane",
    "assemble_records",
    "raster_msaa4",
    "raster_msaa4_sublane",
    "raster_two_pass",
    "raster_batched",
    "transpose_templates",
    "assemble_records_rows",
)
# Per-frame counts: every kernel of KERNELS, then the draws shaded per
# covered tile (renderer.COMPACTED_DRAWS: no kernel, the compaction proof).
COUNTS = (*KERNELS, "compacted_draws")
# The CUDA kernels' symbols, for their device-only times under the profiler.
B1, B2, B4, B5 = "raster_tile_kernel", "raster_sublane_kernel", "raster_msaa4_kernel", "raster_msaa4_sublane_kernel"


# The cube's vertex-colour program as a shader file (shader.load_file).
SHADER_FILE = """
ATTRIBUTES = ("color",)

def vertex(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}

def fragment(frag, uniforms):
    rgb = frag["color"]
    return torch.cat([rgb, torch.ones((*rgb.shape[:-1], 1), dtype=rgb.dtype, device=rgb.device)], -1)
"""


def per_frame(**n) -> tuple:
    """A per-frame count tuple in COUNTS order from names (0 elsewhere)."""
    unknown = set(n) - set(COUNTS)
    if unknown:
        raise ValueError(f"unknown counters {sorted(unknown)}")
    return tuple(n.get(k, 0) for k in COUNTS)
COLOR_TOL = 1e-5
# The least time for a kernel's work: bytes over the H100 SXM's HBM3 rate
# (3.35 TB/s), or its integer instructions over the int32 issue rate of 132
# SMs x 64 INT32 lanes at the 1980 MHz boost clock (Hopper white paper), the
# larger of the two.  The raster and assembly kernels do integer work only.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def winning_records(tri_id, init_tri_id, tile) -> int:
    """Records that won at least one pixel (or sample) in one raster call:
    distinct (bin, tri_id) pairs among the pixels whose tri_id is set and
    is not the one they kept from ``init_tri_id``.  ``tri_id`` is ([S,]
    H, W); a bin is a (tile_w x tile_h) tile of the call's grid, so a
    record (one triangle in one bin) counts once however many pixels it
    wins."""
    h, w = tri_id.shape[-2:]
    won = tri_id >= 0
    if init_tri_id is not None:
        won &= tri_id != init_tri_id
    dev = tri_id.device
    ty = torch.arange(h, device=dev) // tile[1]
    tx = torch.arange(w, device=dev) // tile[0]
    bins = (ty[:, None] * -(-w // tile[0]) + tx[None, :]).expand(tri_id.shape)
    keys = (bins.to(torch.int64) << 32) | tri_id.to(torch.int64)
    return int(torch.unique(keys[won]).numel())


def raster_bound(binned, vis, tile, num_channels, int_rows, ops_per_item, per_pixel, stencil=False, init=None):
    """Bound of a raster kernel whose output is ``vis`` ([S,] H, W planes):
    every output plane written once ((2 + 4 + K) planes, and the stencil
    plane when ``stencil``, per sample), the init planes read once when
    ``init`` (the init VisBuffer: tri_id, depth_q, b0, b1, b2, and the
    stencil), the int record rows it stages (int_rows rows of the live
    slots: B1 14, B2 13, B4 20, B5 19), tile_start/tile_count read once,
    and for every record that won in this call (winning_records) its float
    plane rows (9 + 3K), plus, for the sublane kernels (not
    ``per_pixel``), which do not stage it, its tri_id row.  Integer work:
    ``ops_per_item`` per (record, pixel) test when ``per_pixel`` (the
    sequential kernels), per (record, tile row) span solve otherwise."""
    samples = vis.tri_id.numel()
    live = int(binned.tile_count.sum())
    planes = 6 + num_channels + int(stencil) + (5 + int(stencil) if init is not None else 0)
    winners = winning_records(vis.tri_id, None if init is None else init.tri_id, tile)
    bytes_ = planes * samples * 4 + int_rows * live * 4 + 2 * binned.tile_count.numel() * 4
    bytes_ += winners * 4 * (9 + 3 * num_channels + int(not per_pixel))
    items = live * tile[1] * (tile[0] if per_pixel else 1)
    return bound(bytes_, items * ops_per_item)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, symbol: str, iters: int = KERNEL_ITERS) -> float:
    """Device-only ms of one launch of the CUDA kernel named ``symbol``:
    ``iters`` calls of fn under torch.profiler, the kernel's self device
    time over its count.  The window around the wrapper (``timed``) also
    holds the host's operand checks and allocations; this does not."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):  # the profiler may drop launches' records (never add one): try again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if e.device_type == cuda and symbol in e.key]
        count = sum(e.count for e in found)
        if 0 < count <= iters:
            return sum(e.self_device_time_total for e in found) / 1e3 / count
    raise AssertionError(f"the profiler saw {count} launches of {symbol}, expected {iters}")


def timed(fn, iters: int = 1, kernel: str | None = None) -> dict:
    """Median, min and max ms of fn() over WINDOWS CUDA-event windows of
    ``iters`` launches each (after one warm-up), the SM clock after, and,
    for a kernel wrapper, the kernel's device-only ms (kernel_ms)."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    t = {"ms": statistics.median(per), "min": min(per), "max": max(per), "sm": nvidia_smi("clocks.sm")}
    if kernel is not None:
        t["kernel_ms"] = kernel_ms(fn, kernel)
    return t


def fmt(t: dict) -> str:
    own = f", kernel-only {t['kernel_ms']:.4f} ms" if "kernel_ms" in t else ""
    return f"{t['ms']:.4f} ms [{t['min']:.4f}..{t['max']:.4f}, SM {t['sm']}]{own}"


def stress_clip(seed: int = 0, n: int = 16384) -> tuple[np.ndarray, np.ndarray]:
    """n small random triangles (tests/test_pallas.py _many_tris_mesh shape)
    with random per-vertex depths partly outside [0, 1]; every 8th one is
    drawn twice in a row, so the stream has exact depth ties."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, size=(n, 1, 2)).astype(np.float32)
    d = rng.uniform(-0.05, 0.05, size=(n, 3, 2)).astype(np.float32)
    z = rng.uniform(-0.2, 1.2, size=(n, 3, 1)).astype(np.float32)
    clip = np.concatenate([c + d, z, np.ones((n, 3, 1), np.float32)], -1)
    color = rng.uniform(0, 1, size=(n, 3, 3)).astype(np.float32)
    order = np.repeat(np.arange(n), np.where(np.arange(n) % 8 == 0, 2, 1))
    return clip[order], color[order]


class Checker:
    """Holds a kernel's output against another on the same inputs: tri_id
    and depth_q exact, float planes within FLOAT_TOL; keeps the worst diff."""

    def __init__(self):
        self.worst = {}

    def __call__(self, kernel: str, label: str, got, want):
        torch.cuda.synchronize()
        gv, gf = (got, []) if len(got) == 6 else (got[0], list(got[1:]))
        wv, wf = (want, []) if len(want) == 6 else (want[0], list(want[1:]))
        if (gv.stencil is None) != (wv.stencil is None):
            raise AssertionError(f"{label}: one stencil plane is missing")
        for k in ("tri_id", "depth_q", "stencil"):
            a, b = getattr(gv, k), getattr(wv, k)
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{label}: {k} differs at {int((a != b).sum())} pixels")
        pairs = [(gv.b0, wv.b0), (gv.b1, wv.b1), (gv.b2, wv.b2), *zip(gf, wf)]
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        if not diff <= FLOAT_TOL:
            raise AssertionError(f"{label}: float planes differ by {diff}")
        self.worst[kernel] = max(self.worst.get(kernel, 0.0), diff)


def main() -> int:
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the vertex matmuls stay full f32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    device_name = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {device_name}", flush=True)

    sys.path.insert(0, str(ROOT))
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch import renderer as renderer_mod
    from based_renderer_tpu_torch.ops import _build, binassem, binning, raster
    from based_renderer_tpu_torch.ops import texture as tex_ops
    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.clip import clip_near
    from based_renderer_tpu_torch.ops.cull import compact_instances, instance_visibility
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import expand_instances, gather_triangles
    from based_renderer_tpu_torch.reference import oracle

    dev = torch.device("cuda")
    check = Checker()
    times = {}
    bounds = {}
    # Each kernel's launch counter, in COUNTS order, then the compaction count.
    counters = (
        (raster, "KERNEL_LAUNCHES"),
        (raster, "SUBLANE_LAUNCHES"),
        (binassem, "LAUNCHES"),
        (raster, "MSAA_LAUNCHES"),
        (raster, "MSAA_SUBLANE_LAUNCHES"),
        (raster, "TWO_PASS_LAUNCHES"),
        (raster, "BATCH_LAUNCHES"),
        (binassem, "TRANSPOSE_LAUNCHES"),
        (binassem, "ROWS_LAUNCHES"),
        (renderer_mod, "COMPACTED_DRAWS"),
    )

    def counts():
        return tuple(getattr(m, a) for m, a in counters)

    def reset_counts():
        for m, a in counters:
            setattr(m, a, 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(
        line.split("ptxas info    :")[-1].strip()
        for line in _build.BUILD_LOG.splitlines()
        if "Compiling entry" in line or "registers" in line
    )
    print(f"[build] {_build.library_path().name} in {build_s:.2f} s | {ptxas or 'cached'}", flush=True)

    # ---- 3. raster_tile vs plain -----------------------------------------
    def cube_tris(width, height, t):
        r = brt.Renderer(brt.RendererConfig(width, height), device=dev)
        pipe, mesh, uniforms, _ = brt.demos.cube_demo(r)
        u = {k: v.to(dev) for k, v in uniforms(t).items()}
        clip, var = brt.shader.get(pipe.shader).vertex(mesh.attributes, u)
        clip_tri, var_tri = clip_near(*gather_triangles(clip, var, None))
        return clip_tri, var_tri["color"]

    def binned_for(clip, color, width, height, tile=(128, 32), scissor=None, max_pairs=None, msaa4=False, **kw):
        pad = fp.MSAA4_BBOX_PAD_FP if msaa4 else 0
        ts = setup_triangles(clip, width, height, scissor=scissor, bbox_pad_fp=pad)
        b = bin_triangles(ts, width, height, *tile, max_pairs=max_pairs, channels=color, msaa4=msaa4, **kw)
        if bool(b.overflowed):
            raise AssertionError("binner overflowed")
        return b

    def b1_vs_plain(label, binned, width, height, init=None, msaa4=False, **kw):
        """B1 (or B4 under ``msaa4``) against its plain version."""
        kw = dict(num_channels=3, msaa4=msaa4, **kw)
        got = raster.rasterize_binned(binned, width, height, init=None if init is None else init[0], **kw)
        want = raster.rasterize_binned_reference(binned, width, height, init=None if init is None else init[1], **kw)
        check("raster_msaa4" if msaa4 else "raster_tile", label, got, want)
        return got, want

    cube_clip, cube_col = cube_tris(W, H, 0.5)
    cube_b = binned_for(cube_clip, cube_col, W, H)
    cube_vis = b1_vs_plain("cube", cube_b, W, H)[0][0]
    s_clip_np, s_col_np = stress_clip()
    s_clip = torch.tensor(s_clip_np, device=dev)
    s_col = torch.tensor(s_col_np, device=dev)
    n_stress = s_clip.shape[0]
    stress_b = binned_for(s_clip, s_col, W, H, max_pairs=16 * n_stress)
    max_count = int(stress_b.tile_count.max())
    if max_count <= 128:
        raise AssertionError(f"stress stream's fullest tile has {max_count} records")
    b1_vs_plain("stress", stress_b, W, H)
    half = n_stress // 2
    first_b = binned_for(s_clip[:half], s_col[:half], W, H)
    first = b1_vs_plain("init-a", first_b, W, H)
    second_b = bin_triangles(
        setup_triangles(s_clip[half:], W, H), W, H, 128, 32, channels=s_col[half:], id_offset=half
    )
    b1_vs_plain("init-b", second_b, W, H, init=(first[0][0], first[1][0]))
    sc = (97, 61, 1803, 1001)
    sc_b = binned_for(s_clip, s_col, W, H, tile=(64, 64), scissor=sc, max_pairs=16 * n_stress)
    b1_vs_plain("ge-clamp-scissor", sc_b, W, H, tile_w=64, tile_h=64,
                depth_compare="greater_equal", depth_clip="clamp", depth_clear=0.0, scissor=sc)
    times["raster_tile"] = timed(lambda: raster.rasterize_binned(cube_b, W, H, num_channels=3), 20, B1)
    times["raster_tile_plain"] = timed(lambda: raster.rasterize_binned_reference(cube_b, W, H, num_channels=3))
    bounds["raster_tile"] = raster_bound(cube_b, cube_vis, (128, 32), 3, 14, 12, True)
    t_stress = timed(lambda: raster.rasterize_binned(stress_b, W, H, num_channels=3), 5, B1)
    print(
        f"[raster_tile vs plain] cube, stress ({n_stress} tris, fullest tile {max_count} records), "
        f"init chain, greater_equal+clamp+scissor: ints exact, max float diff "
        f"{check.worst['raster_tile']:.3g} (tol {FLOAT_TOL}) | cube kernel {fmt(times['raster_tile'])}, "
        f"plain {fmt(times['raster_tile_plain'])} | stress kernel {fmt(t_stress)} | {card}",
        flush=True,
    )

    # B1 with stencil, and the two-pass route (B6) on the same inputs.
    ST = brt.StencilState
    increment = ST(enable=True, compare="always", pass_op="increment_clamp", depth_fail_op="increment_wrap")
    zoo = ST(enable=True, compare="greater_equal", ref=0x35, compare_mask=0xF0, write_mask=0x66,
             pass_op="replace", fail_op="invert", depth_fail_op="decrement_clamp")
    stencil_cases = (("increment", increment, 0), ("ops zoo", zoo, 0x40),
                     ("never", ST(enable=True, compare="never", fail_op="increment_clamp"), 0))
    stamp = ST(enable=True, compare="always", ref=1, pass_op="replace")
    masked = ST(enable=True, compare="equal", ref=1, pass_op="increment_clamp", fail_op="invert")

    def b1_b6_vs_plain(label, binned, width, height, init=None, **kw):
        """B1 against its plain version, then the two-pass route (B6)
        against both; ``init`` is a (kernel, plain) VisBuffer pair."""
        got, want = b1_vs_plain(label, binned, width, height, init=init, **kw)
        tp = raster.rasterize_binned(binned, width, height, num_channels=3, two_pass=True,
                                     init=None if init is None else init[0], **kw)
        check("raster_two_pass", f"{label} vs raster_tile", tp, got)
        check("raster_two_pass", f"{label} vs plain", tp, want)
        return got, want

    for name, st, clear in stencil_cases:
        for test in (True, False):
            got, _ = b1_b6_vs_plain(f"stencil {name}, depth test {test}", stress_b, W, H, stencil=st,
                                    stencil_clear=clear, depth_test=test, depth_write=test)
            if name == "increment" and int(got[0].stencil.max()) < 2:
                raise AssertionError("the stress stream's stencil overdraw count stayed below 2")
    st_a = b1_b6_vs_plain("stamp", first_b, W, H, stencil=stamp)
    b1_b6_vs_plain("equal after stamp", second_b, W, H, init=(st_a[0][0], st_a[1][0]), stencil=masked)
    st_init = st_a[0][0]
    st_kw = dict(num_channels=3, init=st_init, stencil=zoo, stencil_clear=0x40)
    t_b1_st = timed(lambda: raster.rasterize_binned(stress_b, W, H, **st_kw), 5, B1)
    t_b1_st_plain = timed(lambda: raster.rasterize_binned_reference(stress_b, W, H, **st_kw))
    b_b1_st = raster_bound(stress_b, raster.rasterize_binned(stress_b, W, H, **st_kw)[0], (128, 32), 3, 14, 20, True,
                           stencil=True, init=st_init)
    print(
        f"[raster_tile with stencil, two-pass route] stress at {W}x{H}: increment, ops zoo (clear 0x40), "
        f"never, each with depth test on and off, stamp -> equal init chain with init.stencil: tri_id, "
        f"depth_q, stencil exact, two-pass == raster_tile == plain | stress + init + ops zoo kernel "
        f"{fmt(t_b1_st)} (bound {b_b1_st[0]:.4f} ms, {b_b1_st[1]}), plain {fmt(t_b1_st_plain)}, "
        f"stress without stencil {fmt(t_stress)} | {card}",
        flush=True,
    )

    # ---- 4. assemble_records vs plain: 1M triangles at 1080p, 4K MSAA ----
    def dense_setup(r, demo, t, **kw):
        pipe, mesh, uniforms, inst = getattr(brt.demos, demo)(r, **kw)
        u = {k: v.to(dev) for k, v in uniforms(t).items()}
        attrs, tri_idx = expand_instances(mesh, inst)
        clip, var = brt.shader.get(pipe.shader).vertex(attrs, u)
        clip_tri, var_tri = gather_triangles(clip, var, tri_idx)
        width, height = r.config.width, r.config.height
        pad = fp.MSAA4_BBOX_PAD_FP if r.config.msaa == 4 else 0
        ts = setup_triangles(clip_tri, width, height, cull_mode=pipe.cull_mode, front_face=pipe.front_face,
                             bbox_pad_fp=pad)
        channels = torch.cat([var_tri[k] for k in sorted(var_tri)], dim=-1)
        n = clip_tri.shape[0]
        budget = dict(
            max_pairs=max(int(n * pipe.raster_pairs_factor), 1024),
            slots=max(int(n * pipe.raster_slots_factor), 1024),
            channels=channels,
        )
        return (pipe, mesh, uniforms, inst), ts, budget

    def b3_vs_plain(label, ts, width, height, kw, msaa4, ids=0):
        """B3's per-field entry against its plain version on the pair stream of
        ``ts``; ``ids`` is the first triangle id or a (T,) int32 tensor of
        per-triangle ids (a culled draw's original ids)."""
        ps = binning.pair_stream(ts, width, height, 128, 8, kw["max_pairs"], ids, kw["channels"], True, kw["slots"])
        if bool(ps.overflowed):
            raise AssertionError(f"{label} pair stream overflowed")
        fw = binning.frecord_width(kw["channels"].shape[-1])
        args = (ps.tmpl, *binning.padded_slots(ps), ps.total, fw, msaa4)
        rec_k, frec_k = binassem.assemble_records(*args)
        rec_p, frec_p = binassem.assemble_records_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(rec_k, rec_p):
            raise AssertionError(f"assemble_records {label}: int records differ at {int((rec_k != rec_p).sum())} entries")
        if not torch.equal(frec_k.view(torch.int32), frec_p.view(torch.int32)):
            raise AssertionError(f"assemble_records {label}: float records differ by {float((frec_k - frec_p).abs().max())}")
        check.worst["assemble_records"] = max(check.worst.get("assemble_records", 0.0), float((frec_k - frec_p).abs().max()))
        t_k = timed(lambda: binassem.assemble_records(*args), 10, "assemble_records_kernel")
        t_p = timed(lambda: binassem.assemble_records_reference(*args))
        # Bytes: the slot inputs (t_slot, ox, oy), the per-triangle fields of
        # each triangle some slot names read once (culled and empty
        # triangles own no slot and are never read), its int32 id too when
        # the ids are per triangle, both record arrays written once; ~60
        # integer instructions per slot.
        n_slots = rec_k.shape[1]
        read_t = int(torch.unique(args[1]).numel())
        per_tri = 4 * (3 + 3 + 3 + 3 + 2 + ps.tmpl.planes.shape[1]) + 8 * 3 + 4 * torch.is_tensor(ids)
        b = bound(n_slots * (24 + 4 * (rec_k.shape[0] + fw)) + read_t * per_tri, 60 * n_slots)
        return ps, rec_k, t_k, t_p, b

    big_r = brt.Renderer(brt.RendererConfig(W, H))
    big_demo, big_ts, big_kw = dense_setup(big_r, "big_mesh_demo", 0.2)
    ps, rec_k, t_b3_big, t_b3_big_plain, b_b3_big = b3_vs_plain("big_mesh 1080p", big_ts, W, H, big_kw, False)
    big4m_r = brt.Renderer(brt.RendererConfig(W4K, H4K, msaa=4))
    big4m_demo, big4m_ts, big4m_kw = dense_setup(big4m_r, "big_mesh_demo", 0.2)
    ps4m, rec4m, t_b3m, t_b3m_plain, b_b3m = b3_vs_plain("big_mesh 4K MSAA", big4m_ts, W4K, H4K, big4m_kw, True)
    if rec4m.shape[0] != 24:
        raise AssertionError(f"MSAA records have {rec4m.shape[0]} rows")

    def culled_setup(r, t, frac):
        """The instanced demo's pass 1 under instance_cull ``frac``, as the
        renderer runs it: the visible instances compacted into
        ceil(frac * I) slots, then the stream of their triangles with each
        one's original id.  Returns (setup, budgets, ids, visible count)."""
        pipe, mesh, uniforms, inst = brt.demos.instanced_demo(r)
        u = {k: v.to(dev) for k, v in uniforms(t).items()}
        shd = brt.shader.get(pipe.shader)
        num_inst = inst["transform"].shape[0]
        visible = instance_visibility(shd, mesh, inst, u, r.config.width, r.config.height)
        inst_c, orig_idx, of = compact_instances(inst, visible, max(math.ceil(num_inst * frac), 1))
        if bool(of):
            raise AssertionError(f"instance cull {frac} overflowed: {int(visible.sum())} of {num_inst} visible")
        tpi = mesh.num_triangles
        ids = (orig_idx[:, None] * tpi + torch.arange(tpi, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
        attrs, tri_idx = expand_instances(mesh, inst_c)
        clip, var = shd.vertex(attrs, u)
        clip_tri, var_tri = gather_triangles(clip, var, tri_idx)
        ts = setup_triangles(clip_tri, r.config.width, r.config.height, cull_mode=pipe.cull_mode,
                             front_face=pipe.front_face)
        n = clip_tri.shape[0]
        kw = dict(max_pairs=max(int(n * pipe.raster_pairs_factor), 1024),
                  slots=max(int(n * pipe.raster_slots_factor), 1024),
                  channels=torch.cat([var_tri[k] for k in sorted(var_tri)], dim=-1))
        return ts, kw, ids, int(visible.sum())

    # The JAX package measured instance_cull 0.85 (its demos.py:157-163).
    # At 0.85 the binner overflows: its slot budget is 0.6 per triangle of
    # the culled stream, 61,200 slots for 102,000 triangles, and a frame
    # of the orbit has ~62,800 live pairs.  0.9 holds them.
    CULL = 0.9
    cull_ts, cull_kw, cull_ids, n_visible = culled_setup(brt.Renderer(brt.RendererConfig(W, H)), 0.3, CULL)
    ps_c, rec_c, times["assemble_records"], times["assemble_records_plain"], bounds["assemble_records"] = b3_vs_plain(
        "instanced culled 1080p", cull_ts, W, H, cull_kw, False, cull_ids
    )
    live = int(ps_c.total)
    if not torch.equal(rec_c[13, :live], cull_ids[ps_c.t_slot[:live]]):
        raise AssertionError("the culled records do not carry the original triangle ids")
    print(
        f"[assemble_records vs plain] big_mesh 1M tris 1920x1080: {rec_k.shape[1]} slots ({int(ps.total)} live), "
        f"K={big_kw['channels'].shape[-1]}: int records exact, float records bitwise | kernel "
        f"{fmt(t_b3_big)} (bound {b_b3_big[0]:.4f} ms), plain {fmt(t_b3_big_plain)} | 3840x2160 MSAA-4x, "
        f"24-row records: {rec4m.shape[1]} slots ({int(ps4m.total)} live), exact and bitwise | kernel {fmt(t_b3m)} "
        f"(bound {b_b3m[0]:.4f} ms), plain {fmt(t_b3m_plain)} | instanced 10k at 1920x1080, instance_cull {CULL}: "
        f"{n_visible} of 10000 instances visible, {cull_ids.shape[0]} triangles with per-triangle ids, "
        f"{rec_c.shape[1]} slots ({int(ps_c.total)} live): exact and bitwise | kernel {fmt(times['assemble_records'])} "
        f"(bound {bounds['assemble_records'][0]:.4f} ms), plain {fmt(times['assemble_records_plain'])} | {card}",
        flush=True,
    )

    # ---- 4b. transpose_templates (B8) and the rows entry of B3 -----------
    def b8_vs_plain(label, tmpl):
        """B8 bitwise against its plain version and against its library
        call, one strided copy into a zeroed buffer; its bound is the bytes
        it must move: W8 * T ints read, T * out_width ints written."""
        fused_t, row_width = binning.templates_field_major(tmpl)
        w8, t = fused_t.shape
        got = binassem.transpose_templates(fused_t, row_width)
        want = binassem.transpose_templates_reference(fused_t, row_width)
        lib = torch.zeros((t, row_width), dtype=torch.int32, device=dev)
        lib[:, :w8].copy_(fused_t.T)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(lib, want):
            raise AssertionError(f"transpose_templates {label}: differs from the plain version or the library call")
        t_k = timed(lambda: binassem.transpose_templates(fused_t, row_width), 10, "transpose_templates_kernel")
        t_p = timed(lambda: binassem.transpose_templates_reference(fused_t, row_width), 10)
        t_l = timed(lambda: lib[:, :w8].copy_(fused_t.T), 10)
        return got, (w8, t, row_width), t_k, t_p, t_l, bound(4 * (w8 * t + t * row_width), 0)

    def rows_vs_plain(label, ps, fused, num_channels, msaa4, per_field):
        """The rows entry of B3 against its plain version and against the
        per-field entry's records on the same padded slots, bitwise."""
        fw = binning.frecord_width(num_channels)
        args = (fused, *binning.padded_slots(ps), ps.total, fw, num_channels, msaa4)
        rec_k, frec_k = binassem.assemble_records_rows(*args)
        rec_p, frec_p = binassem.assemble_records_rows_reference(*args)
        torch.cuda.synchronize()
        for name, (rec, frec) in (("plain version", (rec_p, frec_p)), ("per-field entry", per_field)):
            if not torch.equal(rec_k, rec) or not torch.equal(frec_k.view(torch.int32), frec.view(torch.int32)):
                raise AssertionError(f"assemble_records_rows {label}: records differ from the {name}")
        check.worst["assemble_records_rows"] = max(check.worst.get("assemble_records_rows", 0.0),
                                                   float((frec_k - frec_p).abs().max()))
        t_k = timed(lambda: binassem.assemble_records_rows(*args), 10, "assemble_records_rows_kernel")
        t_p = timed(lambda: binassem.assemble_records_rows_reference(*args))
        # Bytes: the slot inputs, the used columns (21 + the planes) of each
        # template row some slot names, read once, both record arrays
        # written once; ~60 integer instructions per slot, as B3.
        n_slots = rec_k.shape[1]
        read_t = int(torch.unique(args[1]).numel())
        used = 4 * (binassem.TEMPLATE_COLUMNS + 3 * (3 + num_channels))
        return t_k, t_p, bound(n_slots * (24 + 4 * (rec_k.shape[0] + fw)) + read_t * used, 60 * n_slots)

    fused, b8_shape, times["transpose_templates"], times["transpose_templates_plain"], t_b8_lib, \
        bounds["transpose_templates"] = b8_vs_plain("big_mesh 1080p", ps.tmpl)
    k33 = torch.randn((big_ts.valid.shape[0], 3, 33), generator=torch.Generator(device=dev).manual_seed(33),
                      device=dev)
    _, b8_shape33, t_b8_33, t_b8_33_plain, t_b8_33_lib, b_b8_33 = b8_vs_plain(
        "big_mesh 1080p K=33", binning._templates(big_ts, 0, k33, True))
    if b8_shape33[0] != 136 or b8_shape33[2] != 192:
        raise AssertionError(f"K=33 templates are {b8_shape33}")
    del k33
    k_rows = big_kw["channels"].shape[-1]
    per_field = binassem.assemble_records(ps.tmpl, *binning.padded_slots(ps), ps.total, binning.frecord_width(k_rows))
    t_rows_big, t_rows_big_plain, b_rows_big = rows_vs_plain("big_mesh 1080p", ps, fused, k_rows, False, per_field)
    fused4m = binassem.transpose_templates(*binning.templates_field_major(ps4m.tmpl))
    per_field4m = binassem.assemble_records(ps4m.tmpl, *binning.padded_slots(ps4m), ps4m.total,
                                            binning.frecord_width(k_rows), True)
    t_rows4m, t_rows4m_plain, _ = rows_vs_plain("big_mesh 4K MSAA", ps4m, fused4m, k_rows, True, per_field4m)
    # The culled stream: the ids ride in the template row's tri_id column.
    k_inst = cull_kw["channels"].shape[-1]
    fused_c = binassem.transpose_templates(*binning.templates_field_major(ps_c.tmpl))
    per_field_c = binassem.assemble_records(ps_c.tmpl, *binning.padded_slots(ps_c), ps_c.total,
                                            binning.frecord_width(k_inst))
    times["assemble_records_rows"], times["assemble_records_rows_plain"], bounds["assemble_records_rows"] = \
        rows_vs_plain("instanced culled 1080p", ps_c, fused_c, k_inst, False, per_field_c)
    del fused, fused4m, per_field, per_field4m, fused_c, per_field_c
    check.worst["transpose_templates"] = 0.0  # held bitwise above
    print(
        f"[transpose_templates vs plain, vs library] big_mesh 1M tris 1920x1080, (W8, T, out_width) {b8_shape}: "
        f"bitwise | kernel {fmt(times['transpose_templates'])} (bound {bounds['transpose_templates'][0]:.4f} ms), "
        f"plain {fmt(times['transpose_templates_plain'])}, library copy_ {fmt(t_b8_lib)} | K=33 {b8_shape33}: "
        f"bitwise | kernel {fmt(t_b8_33)} (bound {b_b8_33[0]:.4f} ms), plain {fmt(t_b8_33_plain)}, library "
        f"{fmt(t_b8_33_lib)} | {card}",
        flush=True,
    )
    print(
        f"[assemble_records_rows vs plain, vs per-field] big_mesh 1080p (16 rows), 4K MSAA-4x (24 rows) and the "
        f"culled instanced stream (per-triangle ids) from the transposed template rows: records bitwise equal to "
        f"the plain version and to the per-field entry | big_mesh 1080p kernel {fmt(t_rows_big)} (bound "
        f"{b_rows_big[0]:.4f} ms), plain {fmt(t_rows_big_plain)}, per-field entry {fmt(t_b3_big)} | 4K MSAA "
        f"kernel {fmt(t_rows4m)}, plain {fmt(t_rows4m_plain)} | instanced culled kernel "
        f"{fmt(times['assemble_records_rows'])} (bound {bounds['assemble_records_rows'][0]:.4f} ms), plain "
        f"{fmt(times['assemble_records_rows_plain'])}, per-field entry {fmt(times['assemble_records'])} | {card}",
        flush=True,
    )

    # ---- 5. raster_sublane vs plain and vs raster_tile -------------------
    def b2_checks(label, binned, width, height, **kw):
        got = raster.rasterize_binned(binned, width, height, sublane=True, **kw)
        check("raster_sublane", f"{label} vs plain", got, raster.rasterize_binned_sublane_reference(binned, width, height, **kw))
        b1_kw = {k: v for k, v in kw.items() if k not in ("sublane_group", "bin_rows")}
        if "bin_rows" not in kw:
            check("raster_sublane", f"{label} vs raster_tile", got, raster.rasterize_binned(binned, width, height, **b1_kw))
        return got

    big_b = bin_triangles(big_ts, W, H, 128, 8, assemble="pallas", **big_kw)
    k_big = big_kw["channels"].shape[-1]
    dense_kw = dict(tile_w=128, tile_h=8, num_channels=k_big)
    big_vis = b2_checks("big_mesh 1080p", big_b, W, H, sublane_group=64, **dense_kw)[0]
    times["raster_sublane"] = timed(lambda: raster.rasterize_binned(big_b, W, H, sublane=True, sublane_group=64, **dense_kw), 10, B2)
    times["raster_sublane_plain"] = timed(lambda: raster.rasterize_binned_sublane_reference(big_b, W, H, **dense_kw))
    times["raster_tile_dense"] = timed(lambda: raster.rasterize_binned(big_b, W, H, **dense_kw), 10, B1)
    bounds["raster_sublane"] = raster_bound(big_b, big_vis, (128, 8), k_big, 13, 40, False)

    inst_r = brt.Renderer(brt.RendererConfig(W, H))
    inst_demo, inst_ts, inst_kw = dense_setup(inst_r, "instanced_demo", 0.3)
    inst_b = bin_triangles(inst_ts, W, H, 128, 8, assemble="pallas", **inst_kw)
    inst_rkw = dict(tile_w=128, tile_h=8, num_channels=inst_kw["channels"].shape[-1], depth_clip=False)
    inst_vis = b2_checks("instanced 1080p", inst_b, W, H, sublane_group=32, **inst_rkw)[0]
    t_inst_b2 = timed(lambda: raster.rasterize_binned(inst_b, W, H, sublane=True, sublane_group=32, **inst_rkw), 10, B2)
    t_inst_b1 = timed(lambda: raster.rasterize_binned(inst_b, W, H, **inst_rkw), 10, B1)
    b_inst = raster_bound(inst_b, inst_vis, (128, 8), inst_rkw["num_channels"], 13, 40, False)

    # The two-pass route (B6) on the instanced stream: not_equal 1 over the
    # cube's stamp, as the render-state frame draws it.
    cube_stamp = raster.rasterize_binned(cube_b, W, H, num_channels=3, stencil=stamp)[0]
    inst_st_kw = dict(inst_rkw, init=cube_stamp, stencil=ST(enable=True, compare="not_equal", ref=1))
    tp = raster.rasterize_binned(inst_b, W, H, two_pass=True, **inst_st_kw)
    check("raster_two_pass", "instanced vs raster_tile", tp, raster.rasterize_binned(inst_b, W, H, **inst_st_kw))
    check("raster_two_pass", "instanced vs plain", tp, raster.rasterize_binned_reference(inst_b, W, H, **inst_st_kw))
    times["raster_two_pass"] = timed(lambda: raster.rasterize_binned(inst_b, W, H, two_pass=True, **inst_st_kw), 10, B1)
    times["raster_two_pass_plain"] = timed(
        lambda: raster.rasterize_binned_reference(inst_b, W, H, two_pass=True, **inst_st_kw)
    )
    bounds["raster_two_pass"] = raster_bound(inst_b, tp[0], (128, 8), inst_rkw["num_channels"], 14, 20, True,
                                             stencil=True, init=cube_stamp)

    for compare in ("less", "less_equal", "greater", "greater_equal"):
        clear = 0.0 if compare.startswith("greater") else 1.0
        b2_checks(f"stress {compare}", stress_b, W, H, num_channels=3, depth_compare=compare, depth_clear=clear)
    stress_ts = setup_triangles(s_clip, W, H)
    band_b = bin_triangles(stress_ts, W, -(-H // 8) * 8, 128, 4, max_pairs=32 * n_stress, channels=s_col,
                           col_major_ids=True, anchor_rows=8)
    if bool(band_b.overflowed):
        raise AssertionError("band-binned stress stream overflowed")
    band = b2_checks("stress bin_rows=4", band_b, W, H, tile_w=128, tile_h=8, num_channels=3, bin_rows=4)
    unbanded = raster.rasterize_vis(stress_ts, W, H, tile_w=128, tile_h=8, max_pairs=16 * n_stress,
                                    channels=s_col, sublane=True)
    check("raster_sublane", "stress bin_rows=4 vs unbanded", band, unbanded)
    print(
        f"[raster_sublane vs plain, vs raster_tile] big_mesh 1080p ({big_b.records.shape[1]} slots), "
        f"instanced 1080p, stress under less/less_equal/greater/greater_equal, stress bin_rows=4: "
        f"ints exact, max float diff {check.worst['raster_sublane']:.3g} (tol {FLOAT_TOL}) | big_mesh "
        f"sublane {fmt(times['raster_sublane'])} (bound {bounds['raster_sublane'][0]:.4f} ms, "
        f"{winning_records(big_vis.tri_id, None, (128, 8))} winning records), plain "
        f"{fmt(times['raster_sublane_plain'])}, raster_tile {fmt(times['raster_tile_dense'])} | instanced sublane "
        f"{fmt(t_inst_b2)} (bound {b_inst[0]:.4f} ms, {winning_records(inst_vis.tri_id, None, (128, 8))} winning "
        f"records), raster_tile {fmt(t_inst_b1)} | {card}",
        flush=True,
    )
    print(
        f"[raster_two_pass vs raster_tile, vs plain] instanced 1080p with stencil not_equal 1 over the cube's "
        f"stamp: ints and stencil exact | kernel {fmt(times['raster_two_pass'])} (bound "
        f"{bounds['raster_two_pass'][0]:.4f} ms), plain {fmt(times['raster_two_pass_plain'])} | {card}",
        flush=True,
    )

    # The batched route (B7) vs B2's plain version and vs raster_tile.
    def b7_checks(label, binned, width, height, **kw):
        got = raster.rasterize_binned(binned, width, height, batch=16, **kw)
        check("raster_batched", f"{label} vs plain", got,
              raster.rasterize_binned_reference(binned, width, height, batch=16, **kw))
        check("raster_batched", f"{label} vs raster_tile", got, raster.rasterize_binned(binned, width, height, **kw))
        return got

    big_b7_vis = b7_checks("big_mesh 1080p", big_b, W, H, **dense_kw)[0]
    times["raster_batched"] = timed(lambda: raster.rasterize_binned(big_b, W, H, batch=16, **dense_kw), 10, B2)
    times["raster_batched_plain"] = timed(lambda: raster.rasterize_binned_reference(big_b, W, H, batch=16, **dense_kw))
    bounds["raster_batched"] = raster_bound(big_b, big_b7_vis, (128, 8), k_big, 13, 40, False)
    for tile in ((32, 16), (64, 64), (128, 32), (128, 128)):
        tile_b = binned_for(s_clip, s_col, W, H, tile=tile, max_pairs=32 * n_stress)
        for compare in ("less", "less_equal", "greater", "greater_equal"):
            b7_checks(f"stress {tile} {compare}", tile_b, W, H, tile_w=tile[0], tile_h=tile[1], num_channels=3,
                      depth_compare=compare, depth_clear=0.0 if compare.startswith("greater") else 1.0)
    b7_a = b7_checks("init-a", first_b, W, H, num_channels=3)
    b7_checks("init-b", second_b, W, H, num_channels=3, init=b7_a[0])
    b7_checks("ge-clamp-scissor", sc_b, W, H, tile_w=64, tile_h=64, num_channels=3, depth_compare="greater_equal",
              depth_clip="clamp", depth_clear=0.0, scissor=sc)
    def bitwise(label, got, *wants):
        """Every plane of got equals every plane of each of wants, bit for bit."""
        torch.cuda.synchronize()

        def planes(out):
            vis, floats = (out, []) if len(out) == 6 else (out[0], list(out[1:]))
            return [vis.tri_id, vis.depth_q, vis.b0, vis.b1, vis.b2, *floats]

        for want in wants:
            for i, (a, b) in enumerate(zip(planes(got), planes(want), strict=True)):
                if not torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)):
                    raise AssertionError(f"{label}: plane {i} differs bitwise")

    # A width that is not a multiple of 4 takes the kernel's scalar stores.
    WO, HO = 1366, 768
    odd_b = binned_for(s_clip, s_col, WO, HO, max_pairs=16 * n_stress)
    odd_first = binned_for(s_clip[:half], s_col[:half], WO, HO)
    odd_second = bin_triangles(setup_triangles(s_clip[half:], WO, HO), WO, HO, 128, 32, channels=s_col[half:],
                               id_offset=half)
    for compare in ("less", "greater_equal"):
        okw = dict(num_channels=3, depth_compare=compare, depth_clear=0.0 if compare == "greater_equal" else 1.0)
        plain = raster.rasterize_binned_sublane_reference(odd_b, WO, HO, **okw)
        tile = raster.rasterize_binned(odd_b, WO, HO, **okw)
        bitwise(f"B2 {WO}x{HO} {compare}", raster.rasterize_binned(odd_b, WO, HO, sublane=True, **okw), plain, tile)
        bitwise(f"B7 {WO}x{HO} {compare}", raster.rasterize_binned(odd_b, WO, HO, batch=16, **okw), plain, tile)
    odd_a = raster.rasterize_binned(odd_first, WO, HO, sublane=True, num_channels=3)
    bitwise(f"B2 {WO}x{HO} init-a", odd_a, raster.rasterize_binned_sublane_reference(odd_first, WO, HO, num_channels=3))
    odd_init_kw = dict(num_channels=3, init=odd_a[0])
    odd_plain = raster.rasterize_binned_sublane_reference(odd_second, WO, HO, **odd_init_kw)
    odd_tile = raster.rasterize_binned(odd_second, WO, HO, **odd_init_kw)
    bitwise(f"B2 {WO}x{HO} init-b", raster.rasterize_binned(odd_second, WO, HO, sublane=True, **odd_init_kw),
            odd_plain, odd_tile)
    bitwise(f"B7 {WO}x{HO} init-b", raster.rasterize_binned(odd_second, WO, HO, batch=16, **odd_init_kw),
            odd_plain, odd_tile)
    print(
        f"[raster_sublane, raster_batched at {WO}x{HO}] stress ties under less and greater_equal, init chain: "
        f"every plane bitwise equal to the plain version and to raster_tile | {card}",
        flush=True,
    )
    print(
        f"[raster_batched vs plain, vs raster_tile] big_mesh 1080p batch 16, stress ties under "
        f"less/less_equal/greater/greater_equal at tiles 32x16, 64x64, 128x32, 128x128, init chain, "
        f"greater_equal+clamp+scissor: ints exact, max float diff {check.worst['raster_batched']:.3g} (tol "
        f"{FLOAT_TOL}) | big_mesh kernel {fmt(times['raster_batched'])} (bound {bounds['raster_batched'][0]:.4f} ms), "
        f"plain {fmt(times['raster_batched_plain'])}, sublane {fmt(times['raster_sublane'])} | {card}",
        flush=True,
    )

    # ---- 6. raster_msaa4 (B4) and raster_msaa4_sublane (B5) --------------
    cube_mb = binned_for(cube_clip, cube_col, W, H, msaa4=True)
    cube_m_vis = b1_vs_plain("cube", cube_mb, W, H, msaa4=True)[0][0]
    stress_mb = binned_for(s_clip, s_col, W, H, max_pairs=16 * n_stress, msaa4=True)
    b1_vs_plain("stress", stress_mb, W, H, msaa4=True)
    first_mb = binned_for(s_clip[:half], s_col[:half], W, H, msaa4=True)
    first = b1_vs_plain("init-a", first_mb, W, H, msaa4=True)
    second_mb = binned_for(s_clip[half:], s_col[half:], W, H, id_offset=half, msaa4=True)
    b1_vs_plain("init-b", second_mb, W, H, init=(first[0][0], first[1][0]), msaa4=True)
    sc_mb = binned_for(s_clip, s_col, W, H, tile=(64, 64), scissor=sc, max_pairs=16 * n_stress, msaa4=True)
    b1_vs_plain("ge-clamp-scissor", sc_mb, W, H, tile_w=64, tile_h=64, msaa4=True,
                depth_compare="greater_equal", depth_clip="clamp", depth_clear=0.0, scissor=sc)
    b1_vs_plain("depth test off", stress_mb, W, H, depth_test=False, depth_write=False, msaa4=True)
    times["raster_msaa4"] = timed(lambda: raster.rasterize_binned(cube_mb, W, H, num_channels=3, msaa4=True), 20, B4)
    times["raster_msaa4_plain"] = timed(
        lambda: raster.rasterize_binned_msaa4_reference(cube_mb, W, H, num_channels=3)
    )
    bounds["raster_msaa4"] = raster_bound(cube_mb, cube_m_vis, (128, 32), 3, 20, 44, True)
    t_b4_stress = timed(lambda: raster.rasterize_binned(stress_mb, W, H, num_channels=3, msaa4=True), 5, B4)
    # B4 with per-sample stencil.
    for name, st, clear in stencil_cases:
        got, _ = b1_vs_plain(f"stencil {name}", stress_mb, W, H, msaa4=True, stencil=st, stencil_clear=clear)
        if name == "increment" and int(got[0].stencil.max()) < 2:
            raise AssertionError("the MSAA stress stream's stencil overdraw count stayed below 2")
    b1_vs_plain("stencil increment, depth test off", stress_mb, W, H, msaa4=True, stencil=increment,
                depth_test=False, depth_write=False)
    got, _ = b1_vs_plain("cube stencil increment", cube_mb, W, H, msaa4=True, stencil=increment)
    st_s = got[0].stencil
    if not (st_s[0] != st_s[1]).any() and not (st_s[0] != st_s[2]).any():
        raise AssertionError("the MSAA cube's stencil layers agree everywhere")
    m_a = b1_vs_plain("stamp", first_mb, W, H, msaa4=True, stencil=stamp)
    b1_vs_plain("equal after stamp", second_mb, W, H, init=(m_a[0][0], m_a[1][0]), msaa4=True, stencil=masked)
    m_kw = dict(num_channels=3, msaa4=True, init=m_a[0][0], stencil=zoo, stencil_clear=0x40)
    t_b4_st = timed(lambda: raster.rasterize_binned(stress_mb, W, H, **m_kw), 5, B4)
    t_b4_st_plain = timed(lambda: raster.rasterize_binned_reference(stress_mb, W, H, **m_kw))
    b_b4_st = raster_bound(stress_mb, raster.rasterize_binned(stress_mb, W, H, **m_kw)[0], (128, 32), 3, 20, 52, True,
                           stencil=True, init=m_a[0][0])

    def b5_checks(label, binned, width, height, **kw):
        got = raster.rasterize_binned(binned, width, height, sublane=True, msaa4=True, **kw)
        check("raster_msaa4_sublane", f"{label} vs plain", got,
              raster.rasterize_binned_msaa4_sublane_reference(binned, width, height, **kw))
        b4_kw = {k: v for k, v in kw.items() if k != "sublane_group"}
        check("raster_msaa4_sublane", f"{label} vs raster_msaa4", got,
              raster.rasterize_binned(binned, width, height, msaa4=True, **b4_kw))
        return got

    big4m_b = bin_triangles(big4m_ts, W4K, H4K, 128, 8, assemble="pallas", msaa4=True, **big4m_kw)
    if bool(big4m_b.overflowed):
        raise AssertionError("big_mesh 4K MSAA stream overflowed")
    dense4m_kw = dict(tile_w=128, tile_h=8, num_channels=k_big)
    big4m_vis = b5_checks("big_mesh 4K MSAA", big4m_b, W4K, H4K, sublane_group=64, **dense4m_kw)[0]
    stress8_mb = binned_for(s_clip, s_col, W, H, tile=(128, 8), max_pairs=16 * n_stress, msaa4=True)
    for compare in ("less", "less_equal", "greater", "greater_equal"):
        clear = 0.0 if compare.startswith("greater") else 1.0
        b5_checks(f"stress {compare}", stress8_mb, W, H, tile_w=128, tile_h=8, num_channels=3,
                  depth_compare=compare, depth_clear=clear)
    times["raster_msaa4_sublane"] = timed(
        lambda: raster.rasterize_binned(big4m_b, W4K, H4K, sublane=True, msaa4=True, sublane_group=64, **dense4m_kw), 5, B5
    )
    times["raster_msaa4_sublane_plain"] = timed(
        lambda: raster.rasterize_binned_msaa4_sublane_reference(big4m_b, W4K, H4K, **dense4m_kw)
    )
    t_b4_big4m = timed(lambda: raster.rasterize_binned(big4m_b, W4K, H4K, msaa4=True, **dense4m_kw), 5, B4)
    bounds["raster_msaa4_sublane"] = raster_bound(big4m_b, big4m_vis, (128, 8), k_big, 19, 160, False)
    print(
        f"[raster_msaa4 vs plain] cube, stress ({n_stress} tris), init chain, greater_equal+clamp+scissor, "
        f"depth test off, at {W}x{H}: per-sample ints exact, max float diff {check.worst['raster_msaa4']:.3g} "
        f"(tol {FLOAT_TOL}) | cube kernel {fmt(times['raster_msaa4'])}, plain {fmt(times['raster_msaa4_plain'])} | "
        f"stress kernel {fmt(t_b4_stress)} | {card}",
        flush=True,
    )
    print(
        f"[raster_msaa4 with per-sample stencil vs plain] stress: increment, ops zoo, never, increment with "
        f"depth test off, stamp -> equal init chain; the MSAA cube (sample layers differ): per-sample "
        f"tri_id, depth_q, stencil exact | stress + init + ops zoo kernel {fmt(t_b4_st)} (bound "
        f"{b_b4_st[0]:.4f} ms, {b_b4_st[1]}), plain {fmt(t_b4_st_plain)} | {card}",
        flush=True,
    )
    print(
        f"[raster_msaa4_sublane vs plain, vs raster_msaa4] big_mesh 4K MSAA ({big4m_b.records.shape[1]} slots, "
        f"{int(big4m_b.tile_count.sum())} live), stress under less/less_equal/greater/greater_equal: per-sample "
        f"ints exact, max float diff {check.worst['raster_msaa4_sublane']:.3g} (tol {FLOAT_TOL}) | big_mesh 4K "
        f"MSAA sublane {fmt(times['raster_msaa4_sublane'])}, plain {fmt(times['raster_msaa4_sublane_plain'])}, "
        f"raster_msaa4 {fmt(t_b4_big4m)} | {card}",
        flush=True,
    )

    # ---- 7. oracle (the port's own copy) --------------------------------
    def oracle_equal(label, got, want):
        for k in ("tri_id", "depth_q", "stencil"):
            if k not in want:
                continue
            g = getattr(got, k).cpu().numpy()
            if not np.array_equal(g, want[k]):
                raise AssertionError(f"oracle {label}: {k} differs at {int((g != want[k]).sum())} pixels")

    for label, clip in (("cube", cube_clip), ("stress[:2048]", s_clip[:2048])):
        got, overflowed = raster.rasterize_vis(
            setup_triangles(clip, W, H), W, H, max_pairs=max(16 * clip.shape[0], 4096), return_overflow=True
        )
        if bool(overflowed):
            raise AssertionError(f"oracle {label}: binner overflowed")
        oracle_equal(label, got, oracle.rasterize(clip.cpu().numpy(), W, H))
    got, overflowed = raster.rasterize_vis(
        setup_triangles(cube_clip, W, H, bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP), W, H, max_pairs=4096, msaa4=True,
        return_overflow=True,
    )
    if bool(overflowed):
        raise AssertionError("oracle MSAA cube: binner overflowed")
    oracle_equal("MSAA cube", got, oracle.rasterize_msaa4(cube_clip.cpu().numpy(), W, H))

    def toy_big_mesh(cfg, want_launches):
        toy_r = brt.Renderer(cfg)
        pipe, mesh, uniforms, _ = brt.demos.big_mesh_demo(toy_r, triangles=2000)
        # The toy mesh's triangles span more tiles at 1080p than its 4.0 pair
        # budget holds (it overflows there, in both packages); 16 holds them.
        pipe = dataclasses.replace(pipe, raster_pairs_factor=16.0)
        u = uniforms(0.2)
        before = counts()
        frame = toy_r.render_frame(pipe, mesh, u)
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != want_launches or bool(frame.overflowed):
            raise AssertionError(f"oracle big_mesh {cfg.msaa}x: launches {got}, overflowed {bool(frame.overflowed)}")
        clip, _ = brt.shader.get(pipe.shader).vertex(mesh.attributes, {k: v.to(dev) for k, v in u.items()})
        return frame, clip.reshape(-1, 3, 4).cpu().numpy()

    frame, clip = toy_big_mesh(brt.RendererConfig(W, H), per_frame(raster_sublane=1, assemble_records=1))
    oracle_equal("big_mesh 2000", frame, oracle.rasterize(clip, W, H, cull_mode="back"))
    frame, clip = toy_big_mesh(brt.RendererConfig(W, H, msaa=4), per_frame(assemble_records=1, raster_msaa4_sublane=1))
    oracle_equal("MSAA big_mesh 2000", frame, oracle.rasterize_msaa4(clip, W, H, cull_mode="back"))
    # Stencil through B1 and the two-pass route, per sample through B4, and
    # a depth-biased stream through the port's setup and B1.
    s2k = s_clip[:2048]
    s2k_np = s2k.cpu().numpy()
    for name, st, clear in stencil_cases:
        want = oracle.rasterize(s2k_np, W, H, stencil=st, stencil_clear=clear)
        for two_pass in (False, True):
            got, overflowed = raster.rasterize_vis(setup_triangles(s2k, W, H), W, H, max_pairs=16 * 2048, stencil=st,
                                                   stencil_clear=clear, two_pass=two_pass, return_overflow=True)
            if bool(overflowed):
                raise AssertionError(f"oracle stencil {name}: binner overflowed")
            oracle_equal(f"stencil {name} two_pass={two_pass}", got, want)
    got = raster.rasterize_vis(setup_triangles(cube_clip, W, H, bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP), W, H,
                               max_pairs=4096, msaa4=True, stencil=increment)
    oracle_equal("MSAA cube stencil", got, oracle.rasterize_msaa4(cube_clip.cpu().numpy(), W, H, stencil=increment))
    bias = (-500.0, 1.25, 0.001)
    got = raster.rasterize_vis(setup_triangles(s2k, W, H, depth_bias=bias), W, H, max_pairs=16 * 2048)
    oracle_equal("depth bias", got, oracle.rasterize(s2k_np, W, H, depth_bias=bias))
    print(
        f"[oracle] cube ({cube_clip.shape[0]} tris) and stress[:2048] through raster_tile, big_mesh "
        f"(2000 tris, back-face cull) through assemble_records + raster_sublane; per sample: the MSAA cube "
        f"through raster_msaa4, MSAA big_mesh (2000 tris) through assemble_records + raster_msaa4_sublane; "
        f"stress[:2048] under increment, ops zoo and never through raster_tile and the two-pass route, the "
        f"MSAA cube's per-sample stencil through raster_msaa4, stress[:2048] biased {bias} through setup and "
        f"raster_tile; at {W}x{H}: tri_id, depth_q and stencil bit-exact",
        flush=True,
    )

    # ---- 8. end to end --------------------------------------------------
    def render(r, draws, us):
        """One frame of ``draws`` [(pipe, mesh, uniforms_fn, instances)] with uniforms ``us``."""
        r.begin_frame()
        for (pipe, mesh, _, inst), u in zip(draws, us):
            r.draw(pipe, mesh, u, instances=inst)
        return r.end_frame()

    def run_frames(label, r, draws, frames, per_frame):
        """Median ms/frame over ``frames`` frames; each frame must add
        ``per_frame`` to the counts (see COUNTS)."""
        times_, overflow, finite, covered = [], None, None, None
        for i in range(frames):
            us = [d[2](0.05 * i) for d in draws]
            before = counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            f = render(r, draws, us)
            end.record()
            got = tuple(a - b for a, b in zip(counts(), before))
            if got != per_frame:
                raise AssertionError(f"{label} frame {i}: launches {got}, expected {per_frame}")
            times_.append((start, end))
            ok = torch.isfinite(f.color_planar).all()
            cov = (f.tri_id >= 0).sum()
            overflow = f.overflowed if overflow is None else overflow | f.overflowed
            finite = ok if finite is None else finite & ok
            covered = cov if covered is None else torch.minimum(covered, cov)
        torch.cuda.synchronize()
        if bool(overflow) or not bool(finite) or int(covered) <= 0:
            raise AssertionError(f"{label}: overflowed={bool(overflow)} finite={bool(finite)} covered={int(covered)}")
        w, h = r.config.width, r.config.height
        if tuple(f.color_planar.shape) != (4, h, w):
            raise AssertionError(f"{label}: color shape {tuple(f.color_planar.shape)}")
        return statistics.median(s.elapsed_time(e) for s, e in times_), int(covered)

    class plain_path:
        """Within it, the renderer runs every kernel's plain version."""

        swaps = (
            (raster, "rasterize_binned", raster.rasterize_binned_reference),
            (binassem, "assemble_records", binassem.assemble_records_reference),
            (binassem, "transpose_templates", binassem.transpose_templates_reference),
            (binassem, "assemble_records_rows", binassem.assemble_records_rows_reference),
        )

        def __enter__(self):
            self.kernels = [getattr(m, a) for m, a, _ in self.swaps]
            for m, a, plain in self.swaps:
                setattr(m, a, plain)

        def __exit__(self, *exc):
            for (m, a, _), kernel in zip(self.swaps, self.kernels):
                setattr(m, a, kernel)

    def render_state_draws(r):
        """Three draws: the cube stamps stencil 1; the 10k instances draw
        two-pass where the stencil is not 1; the cube again, depth write
        off, winning over its own coplanar copy only through its depth
        bias, blended at constant alpha 0.5."""
        cube_pipe, cube_mesh, cube_u, _ = brt.demos.cube_demo(r)
        inst_pipe, inst_mesh, inst_u, inst = brt.demos.instanced_demo(r)
        field = dataclasses.replace(inst_pipe, raster_sublane=False, raster_two_pass=True,
                                    stencil=ST(enable=True, compare="not_equal", ref=1))
        decal = dataclasses.replace(
            cube_pipe,
            depth=brt.DepthState(compare="less", write=False, bias_enable=True, bias_constant=-64.0),
            blend=brt.BlendState(enable=True, src_factor="constant_alpha", dst_factor="one_minus_constant_alpha",
                                 constants=(0.0, 0.0, 0.0, 0.5)),
        )
        return [
            (dataclasses.replace(cube_pipe, stencil=stamp), cube_mesh, cube_u, None),
            (field, inst_mesh, inst_u, inst),
            (decal, cube_mesh, cube_u, None),
        ]

    def frames_equal(label, got, want):
        """tri_id, depth_q and stencil exact; returns the max colour diff."""
        for k in ("tri_id", "depth_q", "stencil"):
            a, b = getattr(got, k), getattr(want, k)
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{label}: {k} differs")
        return float((got.color_planar - want.color_planar).abs().max())

    def kernel_vs_plain(label, r, draws, decal_from=None):
        """One frame on the kernel path against the plain path: tri_id,
        depth_q and stencil exact, colour within COLOR_TOL.  ``decal_from``:
        the first triangle id of the last draw, which must win pixels."""
        us = [d[2](0.0) for d in draws]
        got = render(r, draws, us)
        with plain_path():
            want = render(r, draws, us)
        torch.cuda.synchronize()
        diff = frames_equal(f"{label} kernel vs plain frame", got, want)
        if not diff <= COLOR_TOL:
            raise AssertionError(f"{label} kernel vs plain frame: colour differs by {diff}")
        if decal_from is not None:
            if not bool((got.stencil == 1).any()) or not bool((got.tri_id >= decal_from).any()):
                raise AssertionError(f"{label}: no stamp in the stencil, or the biased decal won no pixel")
        return diff

    big4k_r = brt.Renderer(brt.RendererConfig(W4K, H4K))
    cube_r = brt.Renderer(brt.RendererConfig(W, H))
    tri_r = brt.Renderer(brt.RendererConfig(800, 600))
    cube_m_r = brt.Renderer(brt.RendererConfig(W, H, msaa=4))
    cube_ss_r = brt.Renderer(brt.RendererConfig(W, H, msaa=4, msaa_supersample=True))
    rs_r = brt.Renderer(brt.RendererConfig(W, H))
    rs_m_r = brt.Renderer(brt.RendererConfig(W, H, msaa=4))
    # The cube's own pair budget (4.0 per triangle, at least 1024 pairs)
    # holds its 1080p frames but not the 3840x2160 raster of the
    # supersampled frame (~2100 pairs), in both packages; 128 holds them.
    ss_pipe, *ss_rest = brt.demos.cube_demo(cube_ss_r)
    ss_demo = (dataclasses.replace(ss_pipe, raster_pairs_factor=128.0), *ss_rest)
    batch_pipe, *batch_rest = brt.demos.big_mesh_demo(big_r)
    batch_demo = (dataclasses.replace(batch_pipe, raster_sublane=False, raster_batch=16), *batch_rest)
    tmpl_demo = (dataclasses.replace(batch_pipe, raster_tmpl="pallas"), *batch_rest)
    tex_r = brt.Renderer(brt.RendererConfig(W, H))
    tex_m_r = brt.Renderer(brt.RendererConfig(W, H, msaa=4))
    full_r = brt.Renderer(brt.RendererConfig(W, H))
    inst_m_r = brt.Renderer(brt.RendererConfig(W, H, msaa=4))
    inst_m_demo = brt.demos.instanced_demo(inst_m_r)

    def culled(demo, **budgets):
        return (dataclasses.replace(demo[0], instance_cull=CULL, **budgets), *demo[1:])

    # Under MSAA the padded bboxes add pairs and extra tiles, and the
    # culled stream has fewer triangles to budget them by.
    msaa_budgets = dict(raster_pairs_factor=1.3, raster_slots_factor=0.7)

    # label, renderer, draws, kernel frames, plain frames, counts per frame (COUNTS order)
    dense = per_frame(raster_sublane=1, assemble_records=1)
    dense_msaa = per_frame(assemble_records=1, raster_msaa4_sublane=1)
    runs = [
        ("big_mesh 1920x1080", big_r, [big_demo], 10, 2, dense),
        ("big_mesh 3840x2160", big4k_r, [brt.demos.big_mesh_demo(big4k_r)], 5, 1, dense),
        ("instanced 1920x1080", inst_r, [inst_demo], 10, 2, dense),
        ("cube 1920x1080", cube_r, [brt.demos.cube_demo(cube_r)], 20, 5, per_frame(raster_tile=1)),
        ("triangle 800x600", tri_r, [brt.demos.triangle_demo(tri_r)], 20, 5, per_frame(raster_tile=1)),
        ("big_mesh 3840x2160 MSAA-4x", big4m_r, [big4m_demo], 5, 1,
         per_frame(assemble_records=1, raster_msaa4_sublane=1)),
        ("cube 1920x1080 MSAA-4x", cube_m_r, [brt.demos.cube_demo(cube_m_r)], 20, 5, per_frame(raster_msaa4=1)),
        ("cube 1920x1080 supersampled", cube_ss_r, [ss_demo], 10, 3, per_frame(raster_tile=1)),
        ("render-state 1920x1080", rs_r, render_state_draws(rs_r), 10, 2,
         per_frame(raster_tile=2, assemble_records=1, raster_two_pass=1)),
        ("render-state 1920x1080 MSAA-4x", rs_m_r, render_state_draws(rs_m_r), 5, 1,
         per_frame(assemble_records=1, raster_msaa4=3)),
        ("big_mesh 1920x1080 batched", big_r, [batch_demo], 10, 1, per_frame(assemble_records=1, raster_batched=1)),
        ("big_mesh 1920x1080 tmpl", big_r, [tmpl_demo], 10, 1,
         per_frame(transpose_templates=1, assemble_records_rows=1, raster_sublane=1)),
        ("textured_cube 1920x1080", tex_r, [brt.demos.textured_cube_demo(tex_r)], 20, 3,
         per_frame(raster_tile=1, compacted_draws=1)),
        ("textured_fullscreen 1920x1080", full_r, [brt.demos.textured_fullscreen_demo(full_r)], 20, 3,
         per_frame(raster_tile=1)),
        ("textured_cube 1920x1080 MSAA-4x", tex_m_r, [brt.demos.textured_cube_demo(tex_m_r)], 10, 2,
         per_frame(raster_msaa4=1, compacted_draws=1)),
        ("instanced 1920x1080 culled", inst_r, [culled(inst_demo)], 10, 2, dense),
        ("instanced 1920x1080 MSAA-4x", inst_m_r, [inst_m_demo], 5, 1, dense_msaa),
        ("instanced 1920x1080 MSAA-4x culled", inst_m_r, [culled(inst_m_demo, **msaa_budgets)], 5, 1, dense_msaa),
    ]
    separable = [0]
    sample_separable = tex_ops.sample_separable

    def counted_separable(*a, **kw):
        separable[0] += 1
        return sample_separable(*a, **kw)

    tex_ops.sample_separable = counted_separable
    reset_counts()
    results = {label: run_frames(label, r, draws, n, per) for label, r, draws, n, _, per in runs}
    main_launches = dict(zip(COUNTS, counts()))
    expected = {k: sum(n * per[i] for _, _, _, n, _, per in runs) for i, k in enumerate(COUNTS)}
    if main_launches != expected:
        raise AssertionError(f"main path launches {main_launches}, expected {expected}")
    if separable[0] != 20:  # the textured_fullscreen frames, one separable tap each
        raise AssertionError(f"the separable sampler ran {separable[0]} times, expected 20")
    tex_ops.sample_separable = sample_separable

    # The tmpl route's frame equals the default big_mesh frame.
    u_big = big_demo[2](0.0)
    tmpl_diff = frames_equal("big_mesh tmpl vs default", render(big_r, [tmpl_demo], [u_big]),
                             render(big_r, [big_demo], [u_big]))
    if not tmpl_diff <= COLOR_TOL:
        raise AssertionError(f"big_mesh tmpl vs default frame: colour differs by {tmpl_diff}")
    # The cube's 12 triangles are 24 after the near clipper: the decal's
    # ids start after the cube's and the 120,000 instance triangles.
    frame_diffs = {label: kernel_vs_plain(label, r, draws, decal_from=24 + 120_000 if "render-state" in label else None)
                   for label, r, draws, *_ in runs[-10:]}
    # The culled draw equals the unculled one (B3 + B2, and B3 + B5 under
    # MSAA), and the visible share of every timed frame stays in the budget.
    cull_diffs, worst_share = {}, 0.0
    for label, r, demo, budgets in (("1080p", inst_r, inst_demo, {}), ("1080p MSAA-4x", inst_m_r, inst_m_demo,
                                                                         msaa_budgets)):
        for i in (0, 7):
            us = [demo[2](0.05 * i)]
            got, want = render(r, [culled(demo, **budgets)], us), render(r, [demo], us)
            if bool(got.overflowed) or bool(want.overflowed):
                raise AssertionError(f"instanced {label} culled frame {i} overflowed")
            d = frames_equal(f"instanced {label} culled vs unculled frame {i}", got, want)
            if not d <= COLOR_TOL:
                raise AssertionError(f"instanced {label} culled vs unculled frame {i}: colour differs by {d}")
            cull_diffs[f"{label} t={0.05 * i:.2f}"] = d
    shd = brt.shader.get(inst_demo[0].shader)
    for i in range(10):
        u = {k: v.to(dev) for k, v in inst_demo[2](0.05 * i).items()}
        vis = instance_visibility(shd, inst_demo[1], inst_demo[3], u, W, H)
        worst_share = max(worst_share, int(vis.sum()) / vis.shape[0])
    with plain_path():
        plain = {label: run_frames(label, r, draws, n, (0,) * len(KERNELS) + per[len(KERNELS):])[0]
                 for label, r, draws, _, n, per in runs}
    print(
        "[end-to-end] median ms/frame kernel/plain (frames): "
        + "; ".join(
            f"{label} {results[label][0]:.3f}/{plain[label]:.3f} ({n}/{pn}, min covered {results[label][1]} samples)"
            for label, _, _, n, pn, _ in runs
        )
        + f" | kernel vs plain frame, max colour diff (tol {COLOR_TOL}): "
        + ", ".join(f"{label} {d:.3g}" for label, d in frame_diffs.items())
        + f" | big_mesh tmpl vs default frame: tri_id, depth_q exact, colour diff {tmpl_diff:.3g}"
        + f" | instance_cull {CULL} vs unculled frames: tri_id, depth_q exact, colour diff "
        + ", ".join(f"{k} {d:.3g}" for k, d in cull_diffs.items())
        + f"; worst visible share of the timed frames {worst_share:.4f}"
        + f" | launches {main_launches} | {card}",
        flush=True,
    )

    # ---- 9. sequences: captured CUDA graphs, replayed once per frame -----
    # symbol -> the COUNTS names whose launches run it
    symbols = {B1: ("raster_tile", "raster_two_pass"), B2: ("raster_sublane", "raster_batched"),
               B4: ("raster_msaa4",), B5: ("raster_msaa4_sublane",), "assemble_records_kernel": ("assemble_records",),
               "assemble_records_rows_kernel": ("assemble_records_rows",),
               "transpose_templates_kernel": ("transpose_templates",)}
    nk = len(KERNELS)

    def seq_inputs(draws, n, phase):
        """render_sequence_multi's draws for n frames at t = phase + 0.05 i:
        each draw's uniforms stacked on the device, its textures static."""
        out = []
        for pipe, mesh, uf, inst in draws:
            frames = [uf(phase + 0.05 * i) for i in range(n)]
            static = {k: v for k, v in frames[0].items() if isinstance(v, brt.Texture)}
            useq = {k: torch.stack([torch.as_tensor(np.asarray(f[k])) for f in frames]).to(dev)
                    for k in frames[0] if k not in static}
            out.append({"pipeline": pipe, "mesh": mesh, "uniforms_seq": useq, "instances": inst,
                        "static_uniforms": static})
        return out

    def replay_launches(r, draws, n):
        """Kernel launches by symbol under torch.profiler during one call of
        n frames that captures nothing (the program of sequence_run's first
        call, return_frames and all, is cached)."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        inputs = seq_inputs(draws, n, 0.01)
        reset_counts()
        with torch.profiler.profile(activities=acts) as prof:
            r.render_sequence_multi(inputs, return_frames=True)
            torch.cuda.synchronize()
        if counts()[:nk] != (0,) * nk:
            raise AssertionError(f"a replay-only call launched kernels eagerly: {counts()}")
        cuda = torch.autograd.DeviceType.CUDA
        return {sym: sum(e.count for e in prof.key_averages() if e.device_type == cuda and sym in e.key)
                for sym in symbols}

    def time_sequence(r, draws, n, reps=3):
        """bench.py's timing: best of ``reps`` phase-shifted calls of n frames,
        host clock around the call and the checksums' fetch."""
        r.render_sequence_multi(seq_inputs(draws, n, 0.5)).cpu()
        best = float("inf")
        for k in range(reps):
            inputs = seq_inputs(draws, n, 1e-3 * (k + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums = r.render_sequence_multi(inputs)
            s = sums.cpu()
            best = min(best, time.perf_counter() - t0)
        if bool(r.last_sequence_overflowed) or len(set(np.round(s.numpy(), 1))) <= min(5, n // 4):
            raise AssertionError(f"timed sequence overflowed={bool(r.last_sequence_overflowed)} or frames not distinct")
        return best

    def sequence_run(label, r, draws, per):
        """A sequence of 4 frames with return_frames against eager frames, the
        launches at capture and at replay, and the differenced ms/frame."""
        r._sequences.clear()
        reset_counts()
        sums, frames = r.render_sequence_multi(seq_inputs(draws, 4, 0.0), return_frames=True)
        torch.cuda.synchronize()
        # Capture time: one eager warm-up frame and one captured frame, and
        # pass 1 (every kernel) lies in the first segment.
        if counts()[:nk] != tuple(2 * x for x in per[:nk]):
            raise AssertionError(f"{label} sequence: launches at capture {counts()}, expected twice {per}")
        if bool(r.last_sequence_overflowed) or r.num_cached_programs != 1:
            raise AssertionError(f"{label} sequence: overflowed or {r.num_cached_programs} programs")
        worst = 0.0
        for i in range(4):
            f = render(r, draws, [d[2](0.05 * i) for d in draws])
            worst = max(worst, float((frames[i] - f.color_planar).abs().max()))
            if float(sums[i]) != float(frames[i].sum()):
                raise AssertionError(f"{label} sequence: checksum {i} is not sum(color)")
        if not worst <= COLOR_TOL or len(set(sums.tolist())) != 4:
            raise AssertionError(f"{label} sequence: colour differs from eager by {worst}, or frames repeat")
        got = replay_launches(r, draws, 4)
        want = {sym: 4 * sum(per[COUNTS.index(c)] for c in names) for sym, names in symbols.items()}
        if got != want:
            raise AssertionError(f"{label} sequence replays launched {got}, expected {want}")
        t4, t20 = time_sequence(r, draws, 4), time_sequence(r, draws, 20)
        r._sequences.clear()
        return worst, (t20 - t4) / 16 * 1e3, t4 * 1e3, t20 * 1e3

    gen_demo = brt.demos.big_mesh_demo(big_r, generated=True)
    eager_gen = run_frames("big_mesh 1920x1080 generated", big_r, [gen_demo], 5, dense)[0]
    by_label = {label: (r, draws, per) for label, r, draws, _, _, per in runs}
    seq_labels = ("cube 1920x1080", "textured_cube 1920x1080", "instanced 1920x1080", "instanced 1920x1080 culled",
                  "big_mesh 1920x1080", "big_mesh 3840x2160 MSAA-4x", "render-state 1920x1080")
    seq_results = {}
    for label in seq_labels:
        r, draws, per = by_label[label]
        seq_results[label] = sequence_run(label, r, draws, per) + (results[label][0],)
    seq_results["big_mesh 1920x1080 generated"] = sequence_run("big_mesh 1920x1080 generated", big_r, [gen_demo],
                                                               dense) + (eager_gen,)
    print(
        "[sequences] render_sequence_multi replaying captured CUDA graphs (render-state: three draws), 4 frames "
        f"with return_frames equal to eager render_frame (colour tol {COLOR_TOL}), checksums sum(color), frames "
        "distinct, no overflow; launches at capture twice the eager frame's (warm-up + capture), at replay the "
        "eager frame's per frame (profiler symbols); ms/frame differenced (20 - 4 frames, best of 3 phase-shifted "
        "calls) / eager event-timed: "
        + "; ".join(f"{label} {ms:.3f}/{eager:.3f} (4: {t4:.2f} ms, 20: {t20:.2f} ms, max colour diff {d:.3g})"
                    for label, (d, ms, t4, t20, eager) in seq_results.items())
        + f" | {card}",
        flush=True,
    )

    # ---- 10. the demo driver: examples/render_demo_torch.py, in this process --
    from based_renderer_tpu_torch import runtime
    from based_renderer_tpu_torch import shader as shader_lib
    from based_renderer_tpu_torch.utils import image

    zlib_h = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"], input="#include <zlib.h>\n",
                            capture_output=True, text=True)
    if zlib_h.returncode != 0:
        raise AssertionError(f"zlib.h is missing, the native runtime's PNG writer cannot build: {zlib_h.stderr}")
    t0 = time.perf_counter()
    runtime.build()
    rt_s = time.perf_counter() - t0
    sys.path.insert(0, str(ROOT / "examples"))
    import render_demo_torch as driver
    demo_root = ROOT / "build" / "chip_demo"
    shutil.rmtree(demo_root, ignore_errors=True)

    def drive(label, demo, frames, per, out=None, srgb=False, profile=False):
        """One run of the driver's main(); with ``out``, the PNGs written,
        the ring's count, the launches and the last PNG against render_frame."""
        argv = [demo, "--frames", str(frames), "--width", str(W), "--height", str(H)]
        argv += (["--out", str(demo_root / out)] if out else []) + (["--srgb"] if srgb else [])
        argv += ["--profile"] if profile else []
        reset_counts()
        res = driver.main(argv)
        launched = counts()[:nk]
        if res["presented"] != frames or not res["staging_pinned"]:
            raise AssertionError(f"{label}: presented {res['presented']} of {frames}, or staging not page-locked")
        if launched != tuple(frames * x for x in per[:nk]):
            raise AssertionError(f"{label}: launches {launched}, expected {frames} x {per[:nk]}")
        if out:
            pngs = sorted((demo_root / out).iterdir())
            if [p.name for p in pngs] != [f"frame_{i:06d}.png" for i in range(frames)]:
                raise AssertionError(f"{label}: wrote {len(pngs)} PNGs for {frames} frames")
            r = brt.Renderer(brt.RendererConfig(W, H, framebuffer_srgb=srgb))
            pipe, mesh, uniforms, inst = brt.demos.DEMOS[demo](r)
            want = r.render_frame(pipe, mesh, uniforms(res["t"]), instances=inst).color_u8()
            if not np.array_equal(image.read_png(pngs[-1]), want):
                raise AssertionError(f"{label}: the last PNG differs from render_frame's color_u8")
        return res

    cube_tile = per_frame(raster_tile=1)
    demo_runs = {
        "cube --out --profile": drive("cube --out --profile", "cube", 60, cube_tile, out="cube", profile=True),
        "cube --out": drive("cube --out", "cube", 60, cube_tile, out="cube_again"),
        "cube": drive("cube", "cube", 60, cube_tile),
        "cube --out --srgb": drive("cube --out --srgb", "cube", 10, cube_tile, out="cube_srgb", srgb=True),
        "big_mesh --out": drive("big_mesh --out", "big_mesh", 20, dense, out="big_mesh"),
        "big_mesh": drive("big_mesh", "big_mesh", 20, dense),
    }
    # A shader file: the cube's vertex-colour program as torch source,
    # loaded at run time, renders the cube through B1 bitwise as the
    # built-in shader does.
    shader_dir = demo_root / "shaders"
    shader_dir.mkdir(parents=True)
    (shader_dir / "disk_vertex_color.py").write_text(SHADER_FILE)
    disk = shader_lib.load_file(shader_dir / "disk_vertex_color.py")
    pipe, mesh, uniforms, _ = brt.demos.cube_demo(cube_r)
    builtin = cube_r.render_frame(pipe, mesh, uniforms(0.7))
    reset_counts()
    loaded = cube_r.render_frame(dataclasses.replace(pipe, shader=disk.name), mesh, uniforms(0.7))
    torch.cuda.synchronize()
    if counts()[:nk] != cube_tile[:nk]:
        raise AssertionError(f"file shader frame launches {counts()}, expected B1 once")
    for k in ("tri_id", "depth_q", "color_planar"):
        if not torch.equal(getattr(loaded, k), getattr(builtin, k)):
            raise AssertionError(f"file shader frame: {k} differs from the built-in shader's")
    print(
        f"[demo-driver] examples/render_demo_torch.py main() in this process at {W}x{H} (native runtime "
        f"{runtime.library_path().name}, g++ {rt_s:.2f} s, zlib.h present): PNG count = frames = "
        "PresentRing.presented, last PNG (zlib-decoded) = render_frame(t_last).color_u8() byte for byte (linear and "
        "sRGB), B1 x frames (cube) and B3 + B2 x frames (big_mesh), staging page-locked; fps over the whole loop "
        "(pacer's last window): "
        + "; ".join(f"{label} {res['frames']} frames {res['loop_fps']:.2f} ({res['fps']:.2f})"
                    for label, res in demo_runs.items())
        + f" | shader file {disk.name} at {W}x{H} through B1: tri_id, depth_q, colour bitwise = built-in | {card}",
        flush=True,
    )
    print("[demo-driver stages] cube --out --profile, StageTimer: "
          + " ; ".join(" ".join(line.split()) for line in demo_runs["cube --out --profile"]["report"].splitlines())
          + f" | {card}", flush=True)

    sources = {
        "raster_tile": ("raster_tile.cu", "based_renderer_tpu/ops/raster_pallas.py:58"),
        "raster_sublane": ("raster_sublane.cu", "based_renderer_tpu/ops/raster_pallas.py:711"),
        "assemble_records": ("assemble_records.cu", "based_renderer_tpu/ops/binassem.py:97"),
        "raster_msaa4": ("raster_msaa4.cu", "based_renderer_tpu/ops/raster_pallas.py:1467"),
        "raster_msaa4_sublane": ("raster_msaa4_sublane.cu", "based_renderer_tpu/ops/raster_pallas.py:1160"),
        "raster_two_pass": ("raster_tile.cu", "based_renderer_tpu/ops/raster_pallas.py:282"),
        "raster_batched": ("raster_sublane.cu", "based_renderer_tpu/ops/raster_pallas.py:504"),
        "transpose_templates": ("transpose_templates.cu", "based_renderer_tpu/ops/binassem.py:49"),
        "assemble_records_rows": ("assemble_records.cu", "based_renderer_tpu/ops/binassem.py:97"),
    }
    # B8's function is one PyTorch copy into a zeroed buffer; no single
    # PyTorch call computes a per-tile raster or the record assembly.
    library = {"transpose_templates": t_b8_lib["ms"]}
    print(json.dumps({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": f"based_renderer_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": main_launches[k],
            "max_abs_err": check.worst[k],
            "ms": times[k]["ms"],
            "kernel_ms": times[k]["kernel_ms"],
            "plain_ms": times[f"{k}_plain"]["ms"],
            "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": library.get(k),
        }
        for k, (src, replaces) in sources.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
