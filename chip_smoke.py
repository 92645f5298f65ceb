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
     1080p, the 4K MSAA and the culled streams and on big_mesh 1080p with 32
     random channels (128-wide rows), bitwise against its plain version and
     against the per-field entry;
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
 6b. shade_blinn_phong (csrc/shade_blinn_phong.cu) vs its plain version
     at 128x96 on random planes (MSAA-4x resolved and per sample, no
     MSAA, the per-vertex colour, the clear colour or earlier draws'
     colour), then through the renderer against its plain shading path: a
     two-draw big_mesh frame at 128x96 MSAA-4x, one without MSAA, and one
     1M-triangle big_mesh frame at 3840x2160 MSAA-4x eager and replayed;
     tri_id and depth_q exact, colour within 1e-5, the share of
     bitwise-equal pixels; the kernel launched once a fused draw (eager:
     the wrapper's counter; replayed: its symbol under the profiler),
     never on the plain route; the 4K draw's kernel timed (window and
     kernel-only) beside its plain version and its bound;
  7. oracle: tri_id and depth_q equal the port's own copy of the numpy
     oracle (based_renderer_tpu_torch/reference/oracle.py) for the cube and
     the stress stream through raster_tile, for big_mesh (2000 triangles)
     through the dense path, and per sample (rasterize_msaa4) for the MSAA
     cube through B4 and the MSAA big_mesh (2000 triangles) through B3 + B5,
     stencil streams (with the stencil plane) through B1 and the two-pass
     route, per-sample stencil through B4, and a depth-biased stream
     through setup and B1, at 1920x1080;
 7b. adversarial: every stream of the port's
     based_renderer_tpu_torch/reference/adversarial.py (slivers engaging
     DEPTH_GRAD_CLAMP, the clamp-boundary sliver, guard-band vertices and
     their fuzz, zshift 0 and >= 18, a ground plane cut by the near clip,
     degenerate triangles, the shared-edge quad, random triangles, the
     empty draw; at 1920x1080 also a seeded mix, seeds ADV_FUZZ_SEEDS), at
     96x64 and 1920x1080, through B1, the two-pass route, the batched route
     and B4 at tiles 128x32, 64x64 and 32x16, B2 at 128x32 and, like B5, at
     128x8 from B3's records, B3's per-field entry, B8 and B3's rows entry
     (zero-size operands on the empty draw): each route against its plain
     version on the same binned records (ints exact, floats within 1e-6,
     B3/B8/rows bitwise) and against the oracle (tri_id, depth_q and
     stencil exact, per sample under MSAA) under every compare each route
     takes, depth clamp, back and front culling, the stencil and (the
     shared edge, each half alone and both) the depth test off, as
     adversarial_configs lists; the setup and the near clip on the card
     bitwise equal to the CPU's; each case asserts its regime; the oracle
     runs in 6 worker processes meanwhile.  Then the empty draw and the 10k
     instances all culled (instance_cull 0.9) through render_frame (the
     key's capture, then a replay) and render_sequence_multi (captured
     CUDA graphs): nothing covered, no
     overflow, the clear colour; the next frame and the next sequence
     equal the same drawn on a fresh renderer;
 7c. adversarial state: the same streams (at 96x64 every one, with mixed
     fuzz seeds 0 and 1; at 1920x1080 the small ones, guard_band fuzz 0
     and fuzz seed 1) under the raster states of reference/adversarial.py:
     scissor rects (aligned, off-grid with odd edges, one pixel, to the far
     edge, the full frame), depth-bias triples (constants of both signs,
     slopes at the +/-2^29 clip, binding clamps, depths pushed past [0, 1]
     under clip and clamp), band binning (1, 2, 4, 8 rows at 128x8; 8, 16
     at 128x32), shard windows (the quadrant, one cutting the tile to 8x8,
     one at the far edges, one on the 128-px grid) and 2x2 supersampling
     through Renderer.render_frame (capture, then replay) with flat_ndc,
     with and without a scissor, and a Shard of it; combined: the scissor
     with 4-row bands and under MSAA, bias on the clamp slivers under
     greater_equal with the depth clamp, a window with a scissor.  Every
     CUDA route that takes the state (B1, B6, B7, B2 and B5 from B3's
     records, the tmpl route, B4, B3/B8/rows) against its plain version
     and the oracle masked by the scissor or cropped to the window, per
     sample under MSAA; setup under scissor and bias and the binner's
     window records on the card bitwise equal to the CPU's; band records
     from the XLA assembly, B3 and the tmpl route equal, each banded frame
     equal to the unbanded one; supersampled replays equal the eager
     frame and the oracle at 2W x 2H, a shard the frame cropped.  The int32
     wrap triple (the JAX package and the port wrap, the oracle does not)
     holds the kernels to their plain versions only.  Each regime value is
     engaged by some case at each size (adversarial.assert_*_engaged);
  8. end to end: Renderer.render_frame, through the key's program (its
     first frame captures it as CUDA graphs, the others replay), with
     big_mesh (1M triangles) at
     1920x1080 and 3840x2160, instanced (10k cubes) at 1920x1080, cube at
     1920x1080 and triangle at 800x600, and the three MSAA runs: big_mesh at
     3840x2160 with msaa=4 (BASELINE config 5), the cube at 1920x1080 with
     msaa=4 and with msaa_supersample; the launches of each frame are
     asserted (the capture frame twice the eager frame's counts, for its
     warm-up and its capture, a replay none; the eager frames of the same
     runs through Renderer._run_frame once a frame: dense frames
     assemble_records and raster_sublane once, MSAA
     big_mesh assemble_records and raster_msaa4_sublane once, every
     big_mesh frame (blinn_phong) shade_blinn_phong once, the MSAA cube
     raster_msaa4 once, cube, triangle and supersampled cube raster_tile
     once); the render-state frames at 1920x1080, plain and MSAA-4x (three
     draws: the cube stamping the stencil, the 10k instances drawn
     two-pass where the stencil is not the stamp, the cube again with depth
     bias and constant-alpha blending), and big_mesh with raster_batch 16;
     big_mesh 1920x1080 with raster_tmpl="pallas" (B8, the rows entry,
     B2 and S1 once a frame; its frame equals the default big_mesh frame), the
     textured cube at 1920x1080 (BASELINE config 3: B1 once and one
     compacted draw a frame), the textured full-screen quad at 1920x1080
     (B1 once a frame, the separable sampler on every frame) and the
     textured cube with msaa=4 (B4 once and one compacted draw a frame);
     the 10k instances with instance_cull 0.9 (B3 and B2 once a frame),
     and at msaa=4 unculled and culled (B3 and B5 once a frame; the culled
     draw with pair and slot budgets of 1.3 and 0.7 per triangle); no frame
     overflows; each run's replayed frame equals _run_frame on the same
     inputs (tri_id, depth_q and stencil exact, colour within 1e-5), and
     the profiler sees the eager frame's kernel launches in it and no
     counter moves; a FrameResult held across two later frames equals its
     eager frame, and a new cube mesh of the same shapes (scaled 0.5)
     renders through the cached program; one replayed frame of each of the
     last ten runs equals the plain-path frame (eager: a replay ignores the
     swap; the profiler sees no kernel symbol in it) the same way; culled
     frames equal unculled ones the same way, and the worst visible share
     of the timed culled frames is printed; median ms/frame replayed (the
     capture frame left out), eager and on the plain path, each
     program's reserved memory (memory_reserved around its capture,
     caches emptied) and the phase's peak;
  9. sequences: render_sequence_multi, each frame replaying captured CUDA
     graphs, for the cube, the textured cube (compacted), the 10k
     instances unculled and culled, big_mesh at 1080p (uploaded and
     generated), big_mesh at 4K MSAA-4x and the three-draw render-state
     frame, at the sizes of phase 8: 4 frames with return_frames equal to
     the eager _run_frame (colour within 1e-5), checksums sum(color),
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
     for byte, the counters see the first frame's warm-up and capture (B1
     twice for the cube, B3, B2 and S1 twice for big_mesh) and the profiler,
     over the --srgb run, B1 once a frame and once for the warm-up, every
     presented image lay in page-locked staging; then a shader file (the
     cube's vertex-colour program as torch source, shader.load_file)
     renders the 1080p cube through B1, in a program of its own, bitwise
     equal to the built-in shader's frame; then present.render_loop with
     the present ring writing PNGs, switched at frame 31 to a front-culled
     cube: a new key captured with earlier frames' copies in flight, 60
     PNGs, the last equal to that frame's color_u8; fps over each loop and
     the StageTimer report of the --profile run;
 11. multi-device: parallel.TiledRenderer on 4 ranks (parallel/launch.py)
     sharing this card over gloo: (a) the cube at 1920x1080 over (y=1,
     x=4), B1; (b) big_mesh (1M triangles) at 3840x2160 over (y=2, x=2),
     1920x1080 windows, B3 + B2 + S1; (c) big_mesh at 1920x1080 over (y=1, x=1,
     g=4), a quarter of the triangles per rank, depth-composited per draw;
     (d) the dry run's MSAA-4x frame (scissored cube, stencil write,
     stencil-tested blend) at 1920x1080 over (y=1, x=4), B4 with stencil;
     (e) a cube sequence of 8 frames over (y=1, x=4), replaying each
     rank's captured graphs.  Runs (a)-(d) render one frame of the key
     first (meshes of their own): a tile-only rank's compared and timed
     frames replay its captured program, the geometry axis's run eagerly.
     Each rank's launches and its one program are asserted; on rank 0
     the gathered frame equals the single-device frame on this card
     (tri_id, depth_q and stencil bitwise, colour within 1e-5, and bitwise
     against a frame drawn at the tile the windows cut to), the sequence's
     checksums within rtol 1e-5 and its frames within 1e-5; per-rank
     event-timed ms/frame while all four render, beside the single-device
     ms/frame, and for (c) the composite's time per draw, one line a run.
     Then entry()'s frame equals render_frame's bitwise, and
     dryrun_multichip(8) runs on 8 gloo CPU ranks.
Every kernel time is the median of 7 CUDA-event windows around the
wrapper in this run, with the spread and the SM clock nvidia-smi read right
after, and beside it the kernel's own device time (kernel-only: the same
launches under torch.profiler, the kernel symbol's self device time over
its count), which leaves out the wrapper's host work.  Then one JSON line
of per-kernel numbers (ms, kernel_ms, and each kernel's bound: the larger
of its bytes over 3.35 TB/s, the winning records' float rows included for
the rasters, and its integer operations over the card's int32 rate; B8's
library call; B3's two entries report the culled instanced stream; S1's
the 4K MSAA-4x draw of phase 6b), the nvidia-smi name/power line, and
last the device line.
When main() ends, passed or failed, the script stops and reaps every
process it started, multiprocessing's resource tracker and any orphan of
a child included (it is their subreaper), and names each on stderr.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

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
    "shade_blinn_phong",
)
# Per-frame counts: every kernel of KERNELS, then the draws shaded per
# covered tile (renderer.COMPACTED_DRAWS: no kernel, the compaction proof).
COUNTS = (*KERNELS, "compacted_draws")
# The CUDA kernels' symbols, for their device-only times under the profiler.
B1, B2, B4, B5 = "raster_tile_kernel", "raster_sublane_kernel", "raster_msaa4_kernel", "raster_msaa4_sublane_kernel"
S1 = "shade_blinn_phong_kernel"


# The cube's vertex-colour program as a shader file (shader.load_file).
SHADER_FILE = """
ATTRIBUTES = ("color",)

def vertex(attrs, uniforms):
    return mvp_transform(attrs, uniforms), {"color": attrs["color"]}

def fragment(frag, uniforms):
    rgb = frag["color"]
    return torch.cat([rgb, torch.ones((*rgb.shape[:-1], 1), dtype=rgb.dtype, device=rgb.device)], -1)
"""


def dense_setup(r, demo, t, dev, **kw):
    """A demo's draw through the vertex stage and setup, as the renderer runs
    it on ``r``'s frame: ((pipe, mesh, uniforms, instances), setup, the
    binner's budgets and channels)."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import expand_instances, gather_triangles

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


def culled_setup(r, t, frac, dev):
    """The instanced demo's pass 1 under instance_cull ``frac``, as the
    renderer runs it: the visible instances compacted into
    ceil(frac * I) slots, then the stream of their triangles with each
    one's original id.  Returns (setup, budgets, ids, visible count)."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops.cull import compact_instances, instance_visibility
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import expand_instances, gather_triangles

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


def rows_bound(t_slot, rw: int, fw: int, num_channels: int) -> tuple[float, str]:
    """Bound of B3's rows entry on the padded slots ``t_slot``: the slot
    inputs (t_slot, ox, oy), the used columns (21 + the planes) of each
    template row some slot names, read once, both record arrays (rw int
    and fw float rows) written once; ~60 integer instructions per slot,
    as B3."""
    from based_renderer_tpu_torch.ops.binassem import TEMPLATE_COLUMNS

    n_slots = t_slot.shape[0]
    read_t = int(torch.unique(t_slot).numel())
    used = 4 * (TEMPLATE_COLUMNS + 3 * (3 + num_channels))
    return bound(n_slots * (24 + 4 * (rw + fw)) + read_t * used, 60 * n_slots)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the reaper of its orphaned descendants (Linux
    prctl), so a process that a child started and left behind is still
    this script's child when stop_children runs."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def _children() -> dict[int, str]:
    """{pid: command line} of this process's live child processes."""
    me, kids = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    kids[int(d)] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, IndexError, ValueError):  # it exited meanwhile
            continue
    return kids


def stop_children(grace: float = 10.0) -> None:
    """Stop and reap every process this script started that still runs:
    worker pools and ranks, multiprocessing's resource tracker (it exits
    when its pipe closes; it ignores SIGTERM), and anything orphaned below
    them.  Each one found is named on stderr; raises if one survives
    SIGKILL."""
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    for p in multiprocessing.active_children():
        print(f"chip_smoke: stopping child process {p.pid}: {p.name}", file=sys.stderr, flush=True)
        p.terminate()
        p.join(grace)
        if p.is_alive():
            p.kill()
            p.join()
    gc.collect()  # a semaphore finalized after the tracker stopped would start a new one
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)
        tracker._fd = None
    deadline = time.monotonic() + grace
    named = set()
    while True:
        kids = _children()
        for pid, cmd in kids.items():
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                continue
            if done:
                continue
            if pid not in named:
                print(f"chip_smoke: stopping child process {pid}: {cmd[:200]}", file=sys.stderr, flush=True)
                named.add(pid)
                os.kill(pid, signal.SIGTERM)
            elif time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
        if not kids:
            return
        if time.monotonic() > deadline + grace:
            raise RuntimeError(f"chip_smoke: child processes {sorted(kids)} did not stop")
        time.sleep(0.05)


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


# ---- phase 7b: the spec's adversarial streams ---------------------------
ADV_SIZES = ((96, 64), (W, H))
ADV_TILES = ((128, 32), (64, 64), (32, 16))
ADV_FUZZ_SEEDS = (1, 2, 3)  # the 1080p mixed fuzz (reference/adversarial.py fuzz)
ADV_K = 3  # random per-vertex channels, so the float planes are compared too
ORDERED = ("less", "less_equal", "greater", "greater_equal")
COMPARES = ("never", "less", "equal", "less_equal", "greater", "not_equal", "greater_equal", "always")


def _oracle_job(job):
    """One run of the port's numpy oracle in a worker process (phase 7b):
    (clip, width, height, msaa4, keyword arguments) -> its int planes."""
    clip, width, height, msaa4, kw = job
    from based_renderer_tpu_torch.reference import oracle

    out = (oracle.rasterize_msaa4 if msaa4 else oracle.rasterize)(clip, width, height, **kw)
    return {k: out[k] for k in ("tri_id", "depth_q", "stencil") if k in out}


class AdvConfig(NamedTuple):
    """One raster configuration of a phase 7b case."""

    compare: str = "less"
    cull: str = "none"
    depth_test: bool = True
    stencil: object = None  # a StencilState, or None
    msaa: bool = True  # also the MSAA-4x routes, against the per-sample oracle
    depth_clip: object = True  # True, False or "clamp"


def adversarial_configs(stream: str, label: str, big: bool, increment) -> list[AdvConfig]:
    """The configurations of one case of phase 7b; the first is the case's
    base ("less"), which runs every tile.

    At 96x64 every case runs all eight compares (the MSAA oracle under the
    ordered four), depth clamp instead of clip, back and front culling and
    the stencil.  At 1080p, where the numpy oracle costs ~0.1 s a
    full-screen triangle, every case runs "less", the small streams and one
    fuzz seed with the MSAA oracle too; the random, guard-band fuzz and
    mixed-fuzz streams also cull back and front, and the first fuzz seed
    runs the other seven compares, depth clamp and the stencil.  shared_edge
    also runs with the depth test off (each half alone and both)."""
    fuzz0 = f"fuzz seed {ADV_FUZZ_SEEDS[0]}"
    full_screen = big and stream in ("random", "guard_band", "fuzz") and label != "guard_band"
    out = [AdvConfig(msaa=not full_screen or label == fuzz0)]
    if stream == "shared_edge":
        out.append(AdvConfig(depth_test=False))
    if not big or label == fuzz0:
        out += [AdvConfig(compare=c, msaa=c in ORDERED and not big) for c in COMPARES if c != "less"]
        out += [AdvConfig(depth_clip="clamp", msaa=not big), AdvConfig(stencil=increment, msaa=not big)]
    if not big or label in ("random seed 0", "guard_band fuzz 0", fuzz0):
        out += [AdvConfig(cull=cull, msaa=not big) for cull in ("back", "front")]
    return out


def bitwise(label, a, b):
    """Raise unless a == b bit for bit (floats compared as their bits)."""
    torch.cuda.synchronize()
    if a.shape != b.shape:
        raise AssertionError(f"{label}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: differs at {int((a != b).sum())} entries")


def compare_oracle(stats, label, vis, want, stencil=False):
    """Raise unless the planes of ``vis`` equal the oracle's (``want``):
    tri_id and depth_q, and the stencil with ``stencil``; counts the
    pixels (samples) compared in stats["pixels"]."""
    for k in ("tri_id", "depth_q") + (("stencil",) if stencil else ()):
        g = getattr(vis, k).cpu().numpy()
        if not np.array_equal(g, want[k]):
            raise AssertionError(f"{label}: {k} differs from the oracle at {int((g != want[k]).sum())} pixels")
    stats["pixels"] += vis.tri_id.numel()


def setup_pair(clip_np, clip_d, width, height, **kw):
    """The setup on the card, held bitwise against the same on the CPU."""
    from based_renderer_tpu_torch.ops.setup import setup_triangles

    ts = setup_triangles(clip_d, width, height, **kw)
    ref = setup_triangles(torch.from_numpy(clip_np), width, height, **kw)
    for name, a, b in zip(ts._fields, ts, ref):
        bitwise(f"setup {name} on the card vs the CPU", a.cpu(), b)
    return ts


def pair_budget(ts, tile, origin=(0, 0)) -> int:
    """A pair budget the stream cannot overflow at this tile: the tiles of
    every valid triangle's bbox (on the grid from ``origin``), and a
    floor."""
    tw, th = tile
    bb = ts.bbox.to(torch.int64)[ts.valid]
    ox, oy = origin
    nx = torch.div(bb[:, 2] - 1 - ox, tw, rounding_mode="floor") - torch.div(bb[:, 0] - ox, tw, rounding_mode="floor") + 1
    ny = torch.div(bb[:, 3] - 1 - oy, th, rounding_mode="floor") - torch.div(bb[:, 1] - oy, th, rounding_mode="floor") + 1
    return 4096 + ts.valid.shape[0] + int((nx * ny).sum())


def b3_b8_rows_bitwise(stats, label, ts, width, height, col, msaa4, max_pairs, tile=(128, 8), **pair_kw):
    """B3's per-field entry, B8 and B3's rows entry on the pair stream at
    ``tile`` (``pair_kw``: a window origin, band ids), each bitwise against
    its plain version, the rows entry also against the per-field entry.
    With no triangles (which the binner never hands them) the three
    wrappers get zero-size operands: no slot, no template."""
    from based_renderer_tpu_torch.ops import binassem, binning

    dev = ts.valid.device
    if ts.valid.shape[0]:
        ps = binning.pair_stream(ts, width, height, *tile, max_pairs, 0, col, True, None, **pair_kw)
        if bool(ps.overflowed):
            raise AssertionError(f"{label}: pair stream overflowed")
        tmpl, slots, total = ps.tmpl, binning.padded_slots(ps), ps.total
    else:
        tmpl = binning._templates(ts, 0, col, True)
        slots = tuple(torch.zeros((0,), dtype=torch.int64, device=dev) for _ in range(3))
        total = torch.zeros((), dtype=torch.int64, device=dev)
    fw = binning.frecord_width(ADV_K)
    per_field = binassem.assemble_records(tmpl, *slots, total, fw, msaa4)
    for a, b in zip(per_field, binassem.assemble_records_reference(tmpl, *slots, total, fw, msaa4)):
        bitwise(f"{label} assemble_records", a, b)
    fused_t, row_width = binning.templates_field_major(tmpl)
    fused = binassem.transpose_templates(fused_t, row_width)
    bitwise(f"{label} transpose_templates", fused, binassem.transpose_templates_reference(fused_t, row_width))
    rows = binassem.assemble_records_rows(fused, *slots, total, fw, ADV_K, msaa4)
    rows_plain = binassem.assemble_records_rows_reference(fused, *slots, total, fw, ADV_K, msaa4)
    for a, b, c in zip(rows, rows_plain, per_field):
        bitwise(f"{label} assemble_records_rows vs plain", a, b)
        bitwise(f"{label} assemble_records_rows vs per-field", a, c)
    stats["routes"].update(("assemble_records", "transpose_templates", "assemble_records_rows"))


def adversarial_phase(dev, check, card: str, sizes=ADV_SIZES, fuzz_seeds=ADV_FUZZ_SEEDS, workers: int = 6) -> dict:
    """Phase 7b: every stream of reference/adversarial.py at each size of
    ``sizes`` through every CUDA route, each held against its plain
    version on the same binned records (``check``: ints exact, floats
    within FLOAT_TOL; B3, B8 and the rows entry bitwise) and against the
    port's oracle (tri_id, depth_q and stencil exact, per sample under
    MSAA), under the configurations of adversarial_configs at tiles
    ADV_TILES for the first configuration of a case (32x16 for the others;
    B2 and B5 at 128x8 from B3's records, B2 also at 128x32).
    The setup and the near clip on the card equal theirs on the CPU bit for
    bit; every case asserts its regime (adversarial.assert_engaged).  The
    oracle runs in ``workers`` processes while the card works.  Returns
    the phase's counts for its line."""
    import concurrent.futures
    import multiprocessing

    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops import raster
    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.clip import clip_near
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.reference import adversarial as adv

    t0 = time.perf_counter()
    increment = brt.StencilState(enable=True, compare="always", pass_op="increment_clamp",
                                 depth_fail_op="increment_wrap")
    stats = {"cases": 0, "configs": 0, "pixels": 0, "routes": set(), "regimes": {}}

    def clear(compare):
        return 0.0 if compare.startswith("greater") else 1.0

    def oracle_kw(cfg):
        return dict(cull_mode=cfg.cull, depth_test=cfg.depth_test, depth_write=cfg.depth_test,
                    depth_compare=cfg.compare, depth_clear=clear(cfg.compare), depth_clip=cfg.depth_clip,
                    stencil=cfg.stencil)

    plan = []  # (size, stream, label, clip, configs)
    for width, height in sizes:
        big = (width, height) != (96, 64)
        for stream, label, clip in adv.cases(width, height, fuzz_seeds=fuzz_seeds if big else ()):
            plan.append(((width, height), stream, label, clip, adversarial_configs(stream, label, big, increment)))

    def vs_oracle(label, vis, want, stencil):
        compare_oracle(stats, f"[adversarial] {label}", vis, want, stencil)

    def b3_b8_rows(label, ts, width, height, col, msaa4):
        b3_b8_rows_bitwise(stats, f"[adversarial] {label}", ts, width, height, col, msaa4,
                           pairs(ts, width, height))

    def pairs(ts, width, height):
        """A pair budget no stream here can overflow: every triangle in every
        tile of the frame at its most tiles (32x16)."""
        return max(4096, ts.valid.shape[0] * -(-width // 32) * -(-height // 16))

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        jobs = {}
        for (width, height), stream, label, clip, configs in plan:
            for cfg in configs:
                kw = oracle_kw(cfg)
                clips = [clip] if stream != "shared_edge" or cfg.depth_test else [clip[:1], clip[1:], clip]
                for part, c in enumerate(clips):
                    for m in (False, True) if cfg.msaa else (False,):
                        jobs[(width, height, label, cfg, part, m)] = pool.submit(
                            _oracle_job, (c, width, height, m, kw))

        for (width, height), stream, label, clip, configs in plan:
            tag = f"{label} {width}x{height}"
            t_n = clip.shape[0]
            if stream == "near_plane":  # the cut on the card equals the CPU's
                raw = torch.from_numpy(adv.near_plane_raw(width, height)).to(dev)
                bitwise(f"{tag} clip_near on the card vs the CPU", clip_near(raw, {})[0].cpu(), torch.from_numpy(clip))
            rng = np.random.default_rng(t_n + width)
            col = torch.from_numpy(rng.uniform(0, 1, size=(t_n, 3, ADV_K)).astype(np.float32)).to(dev)
            clip_d = torch.from_numpy(clip).to(dev)
            binned = {}

            def bins(cull, tile, msaa4=False, assemble="xla", parts=(None,)):
                """B1/B2/B4/B5 inputs (cached per cull, tile and layout): the
                setup of each part of the stream (None: all of it), binned."""
                key = (cull, tile, msaa4, assemble, parts)
                if key not in binned:
                    out = []
                    for part in parts:
                        c_np = clip if part is None else clip[part : part + 1]
                        c_d = clip_d if part is None else clip_d[part : part + 1]
                        cc = col if part is None else col[part : part + 1]
                        ts = setup_pair(c_np, c_d, width, height, cull_mode=cull,
                                        bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP if msaa4 else 0)
                        b = bin_triangles(ts, width, height, *tile, max_pairs=pairs(ts, width, height), channels=cc,
                                          msaa4=msaa4, assemble=assemble)
                        if bool(b.overflowed):
                            raise AssertionError(f"[adversarial] {tag}: binner overflowed")
                        out.append((ts, b))
                    binned[key] = out
                return binned[key]

            for msaa4 in (False, True):
                ts = bins("none", (128, 8), msaa4)[0][0]
                b3_b8_rows(f"{tag} msaa4={msaa4}", ts, width, height, col, msaa4)
            for cfg in configs:
                compare, cull, depth_test, stencil, msaa, depth_clip = cfg
                ctag = f"{tag} {cfg}"
                kw = dict(depth_test=depth_test, depth_write=depth_test, depth_compare=compare,
                          depth_clear=clear(compare), depth_clip=depth_clip, num_channels=ADV_K, stencil=stencil)
                ordered = depth_test and compare in ORDERED and stencil is None
                parts = (None,) if stream != "shared_edge" or depth_test else (0, 1, None)
                for m in (False, True) if msaa else (False,):
                    wants = [jobs.pop((width, height, label, cfg, p, m)).result() for p in range(len(parts))]
                    # Every tile for the first configuration, the smallest for the others.
                    tiles = (ADV_TILES if not m else ((128, 32), (32, 16))) if cfg == configs[0] else ((32, 16),)
                    for tile in tiles:
                        tkw = dict(kw, tile_w=tile[0], tile_h=tile[1], msaa4=m)
                        covered = []
                        for (ts, b), want in zip(bins(cull, tile, m, parts=parts), wants):
                            name = "raster_msaa4" if m else "raster_tile"
                            got = raster.rasterize_binned(b, width, height, **tkw)
                            plain = raster.rasterize_binned_reference(b, width, height, **tkw)
                            check(name, f"{ctag} {tile} vs plain", got, plain)
                            vs_oracle(f"{ctag} {name} {tile}", got[0], want, stencil is not None)
                            stats["routes"].add(name)
                            covered.append(got[0].tri_id)
                            if not m:
                                tp = raster.rasterize_binned(b, width, height, two_pass=True, **tkw)
                                check("raster_two_pass", f"{ctag} {tile} vs raster_tile", tp, got)
                                check("raster_two_pass", f"{ctag} {tile} vs plain", tp, plain)
                                stats["routes"].add("raster_two_pass")
                            if ordered and not m:
                                bkw = dict(tkw, stencil=None, msaa4=False)
                                b7 = raster.rasterize_binned(b, width, height, batch=16, **bkw)
                                check("raster_batched", f"{ctag} {tile} vs plain", b7,
                                      raster.rasterize_binned_reference(b, width, height, batch=16, **bkw))
                                check("raster_batched", f"{ctag} {tile} vs raster_tile", b7, got)
                                stats["routes"].add("raster_batched")
                            if ordered and tile[0] == 128 and not m:
                                b2 = raster.rasterize_binned(b, width, height, sublane=True, **bkw)
                                check("raster_sublane", f"{ctag} {tile} vs plain", b2,
                                      raster.rasterize_binned_sublane_reference(b, width, height, **bkw))
                                vs_oracle(f"{ctag} raster_sublane {tile}", b2[0], want, False)
                        if len(parts) == 3:  # shared_edge, depth test off: the fill rule
                            layers = [covered] if not m else [[c[s] for c in covered] for s in range(4)]
                            for a, b_, ab in layers:
                                adv.assert_shared_edge(a, b_, ab)
                    if ordered:  # B2 / B5 on B3's records at 128x8, as the dense path runs them
                        (ts, b), want = bins(cull, (128, 8), m, "pallas")[0], wants[0]
                        skw = dict(kw, tile_w=128, tile_h=8, stencil=None, msaa4=m)
                        name = "raster_msaa4_sublane" if m else "raster_sublane"
                        got = raster.rasterize_binned(b, width, height, sublane=True, **skw)
                        plain = (raster.rasterize_binned_msaa4_sublane_reference if m
                                 else raster.rasterize_binned_sublane_reference)
                        check(name, f"{ctag} 128x8 from B3 vs plain", got, plain(b, width, height, **{
                            k: v for k, v in skw.items() if k != "msaa4"}))
                        vs_oracle(f"{ctag} {name} 128x8 from B3", got[0], want, False)
                        stats["routes"].add(name)
                        if not m and cfg == configs[0] and t_n:  # B8 + B3 rows + B2, the tmpl route
                            tts = setup_triangles(clip_d, width, height, cull_mode=cull)
                            tb = bin_triangles(tts, width, height, 128, 8, max_pairs=pairs(tts, width, height),
                                               channels=col, assemble="pallas", tmpl="pallas")
                            for a_, b_ in zip(tb[:2], b[:2]):
                                bitwise(f"{ctag} tmpl records vs per-field records", a_, b_)
                            vs_oracle(f"{ctag} tmpl route", raster.rasterize_binned(
                                tb, width, height, sublane=True, **skw)[0], want, False)
                    if cfg == configs[0] and not m:
                        ts_all, b_all = bins(cull, (128, 32))[0]
                        live = int(b_all.tile_count.sum())
                        seen = adv.assert_engaged(stream, ts_all, wants[-1]["tri_id"], b_all.records, live)
                        stats["regimes"][f"{label} {width}x{height}"] = seen
                stats["configs"] += 1
            stats["cases"] += 1
            del binned
        if jobs:
            raise AssertionError(f"[adversarial] {len(jobs)} oracle runs were never compared")
    stats["seconds"] = time.perf_counter() - t0
    return stats


def empty_and_culled_draws(dev, counts, reset_counts, names) -> dict:
    """Phase 7b's draws with nothing to draw, through the renderer on the
    card: the cube pipeline on a mesh of no triangles, and the 10k
    instanced cubes moved out of the frustum under instance_cull 0.9 (every
    compacted slot a culled instance), each by render_frame (twice: the
    key's capture, then a replay) and by render_sequence_multi (captured
    CUDA graphs): no CUDA error, no
    overflow, no coverage (the clear colour everywhere); the kernels still
    launch, over tiles of no records.  The next frame, and the next
    sequence, equal the same drawn on a fresh renderer.  Returns the
    launches of each empty frame's capture (its eager warm-up and the
    capture)."""
    import based_renderer_tpu_torch as brt

    def fresh():
        return brt.Renderer(brt.RendererConfig(W, H), device=dev)

    def nothing(label, tri_id, overflowed, color, clear_color):
        torch.cuda.synchronize()
        clear = torch.tensor(clear_color, device=dev).reshape(4, 1, 1)
        if tri_id is not None and bool((tri_id >= 0).any()):
            raise AssertionError(f"[adversarial] {label}: covered {int((tri_id >= 0).sum())} pixels")
        if bool(overflowed):
            raise AssertionError(f"[adversarial] {label}: overflowed")
        if not torch.equal(color, clear.expand_as(color)):
            raise AssertionError(f"[adversarial] {label}: colour is not the clear colour everywhere")

    def same(label, got, want):
        torch.cuda.synchronize()
        for k in ("tri_id", "depth_q", "color_planar"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"[adversarial] {label}: {k} differs from the frame drawn alone")

    r = fresh()
    pipe, mesh, uniforms, _ = brt.demos.cube_demo(r)
    empty = r.upload_mesh(np.zeros((0, 3), np.float32), color=np.zeros((0, 3), np.float32))
    ipipe, imesh, iu, inst = brt.demos.instanced_demo(r)
    ipipe = dataclasses.replace(ipipe, instance_cull=0.9)
    away = inst["transform"].clone().reshape(-1, 4, 4)
    away[:, :3, 3] += torch.tensor([1e5, 0.0, 0.0], device=dev)
    gone = {**inst, "transform": away.reshape(-1, 16)}
    clear_color = r.config.clear_color
    launches = {}
    for label, args in (("empty draw", (pipe, empty, uniforms(0.1))), ("culled instances", (ipipe, imesh, iu(0.3)))):
        for call in range(2):  # the first call captures the key's frame, the second replays it
            reset_counts()
            f = r.render_frame(*args, instances=gone if label == "culled instances" else None)
            nothing(f"{label} render_frame call {call}", f.tri_id, f.overflowed, f.color_planar, clear_color)
            if call == 0:
                launches[label] = {k: v for k, v in zip(names, counts()) if v}
            elif any(counts()):
                raise AssertionError(f"[adversarial] {label}: the second render_frame launched {counts()} eagerly")
        if not launches[label]:
            raise AssertionError(f"[adversarial] {label}: no kernel launched")
        same(f"frame after the {label}", r.render_frame(pipe, mesh, uniforms(0.3)),
             fresh().render_frame(pipe, mesh, uniforms(0.3)))

    def seq(draws, t0):
        out = []
        for p, m, uf, i in draws:
            frames = [uf(t0 + 0.05 * k) for k in range(4)]
            useq = {k: torch.stack([torch.as_tensor(np.asarray(fr[k])) for fr in frames]).to(dev) for k in frames[0]}
            out.append({"pipeline": p, "mesh": m, "uniforms_seq": useq, "instances": i, "static_uniforms": {}})
        return out

    for label, draws in (("empty draw", [(pipe, empty, uniforms, None)]),
                         ("culled instances", [(ipipe, imesh, iu, gone)])):
        for call in range(2):  # the first call captures, the second replays
            _, frames = r.render_sequence_multi(seq(draws, 0.1 * call), return_frames=True)
            for i in range(frames.shape[0]):
                nothing(f"{label} sequence call {call} frame {i}", None, r.last_sequence_overflowed, frames[i],
                        clear_color)
        cube = seq([(pipe, mesh, uniforms, None)], 0.2)
        sums, frames = r.render_sequence_multi(cube, return_frames=True)
        other = fresh()
        want_sums, want_frames = other.render_sequence_multi(cube, return_frames=True)
        torch.cuda.synchronize()
        if not torch.equal(frames, want_frames) or not torch.equal(sums, want_sums):
            raise AssertionError(f"[adversarial] the cube sequence after the {label} sequence differs from it alone")
    return launches


# ---- phase 7c: the adversarial streams under raster state ---------------
STATE_SIZES = ((96, 64), (W, H))
# At 1080p the small streams, one guard-band fuzz and one mixed fuzz: the
# numpy oracle costs ~0.1 s a full-screen triangle there.
STATE_BIG_LABELS = ("guard_band fuzz 0", "fuzz seed 1")
STATE_FUZZ_SEEDS = {(96, 64): (0, 1), (W, H): (1,)}
# What runs at 1080p besides the windows: the scissors that cut, the bias
# triples (the full-screen streams only the first two) under their last
# depth-clip mode, one band height a tile.
STATE_BIG_SCISSORS = ("off-grid", "one pixel", "far edge")
STATE_BIG_BIAS = ("slope clip +", "clamp -", "past 1.0")
STATE_BIG_BANDS = (((128, 8), (4,)), ((128, 32), (16,)))
# Streams drawn supersampled through the renderer, per size (at 1080p the
# oracle runs at 3840x2160: small streams only).
STATE_SS = {
    (96, 64): ("slivers seed 0", "guard_band", "guard_band fuzz 0", "guard_band fuzz 1", "zshift_steep",
               "near_plane", "fuzz seed 0", "fuzz seed 1"),
    (W, H): ("slivers seed 0", "guard_band", "zshift_steep"),
}
SS_COLOR = (0.2, 0.6, 0.9, 1.0)


def state_plan(sizes=STATE_SIZES):
    """(size, stream, label, clip) of every case of phase 7c."""
    from based_renderer_tpu_torch.reference import adversarial as adv

    plan = []
    for width, height in sizes:
        big = (width, height) != (96, 64)
        for stream, label, clip in adv.cases(width, height, fuzz_seeds=STATE_FUZZ_SEEDS.get((width, height), (1,))):
            full_screen = stream in ("random", "guard_band", "fuzz") and label != "guard_band"
            if not big or not full_screen or label in STATE_BIG_LABELS:
                plan.append(((width, height), stream, label, clip))
    return plan


def state_bias(stream: str, label: str, big: bool):
    """The (label, kind, triple, depth_clip) bias configurations of a case
    held to the oracle, then the wrap triple's (kernels against their plain
    versions only: the oracle's int64 sum does not wrap)."""
    from based_renderer_tpu_torch.reference import adversarial as adv

    full_screen = stream in ("random", "guard_band", "fuzz") and label != "guard_band"
    big_bias = STATE_BIG_BIAS[:2] if full_screen else STATE_BIG_BIAS
    out = [(lab, kind, triple, c) for lab, kind, triple, clips in adv.bias_triples() for c in clips
           if not big or (lab in big_bias and (c == clips[-1]))]
    lab, kind, triple, clips = adv.BIAS_WRAP
    return out, [(lab, kind, triple, c) for c in clips]


def adversarial_state_phase(dev, check, card: str, sizes=STATE_SIZES, workers: int = 6) -> dict:
    """Phase 7c: the streams of reference/adversarial.py under a scissor,
    depth bias, band binning, a shard window and 2x2 supersampling, at
    each size of ``sizes`` (96x64: every stream, with two mixed fuzz seeds;
    1920x1080: the small streams, guard_band fuzz 0 and fuzz seed 1),
    through every CUDA route that takes the state.  Each route is held
    against its plain version on the same records (``check``: ints exact,
    floats within FLOAT_TOL; B3, B8 and the rows entry bitwise) and
    against the port's oracle, masked by the scissor (scissor_expect) or
    cropped to the window (window_expect), per sample under MSAA.  The
    setup under a scissor or a bias on the card equals the CPU's bit for
    bit, and so do the binner's window records.  Band-binned records from
    the XLA assembly, from B3 and through the tmpl route (B8 + B3 rows)
    are equal, and each band-binned frame equals the unbanded one.  The
    combinations: the scissor with 4-row bands and under MSAA (its odd
    edges cut samples), a bias on the clamp slivers under greater_equal
    with the depth clamp, a window with a scissor.  Supersampled frames go
    through Renderer(msaa=4, msaa_supersample=True) with flat_ndc, with and
    without a scissor: the replayed frame equals the eager one and the
    oracle at 2W x 2H; a Shard of it equals the frame cropped.  The int32
    wrap triple (adversarial.BIAS_WRAP) holds each kernel to its plain
    version only.  Each regime value must be engaged by some case at each
    size.  The oracle runs in ``workers`` processes.  Returns the counts
    for the phase's line."""
    import concurrent.futures
    import multiprocessing

    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops import raster
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.reference import adversarial as adv
    from based_renderer_tpu_torch.renderer import shard_tile

    t0 = time.perf_counter()
    one_q = fp.DEPTH_ONE_Q
    stats = {"cases": 0, "configs": 0, "pixels": 0, "routes": set(), "engaged": {}, "t": {}}
    plan = state_plan(sizes)
    pad4 = fp.MSAA4_BBOX_PAD_FP

    def engaged(size, regime, fn, *args):
        """Count a case that engages ``regime`` (the assert_*_engaged of
        adversarial.py passes), and every case that runs it."""
        key = (size, regime)
        hits, runs = stats["engaged"].get(key, (0, 0))
        try:
            fn(*args)
            hits += 1
        except AssertionError:
            pass
        stats["engaged"][key] = (hits, runs + 1)

    def kw_of(compare="less", depth_clip=True, bias=None):
        return dict(depth_compare=compare, depth_clear=0.0 if compare.startswith("greater") else 1.0,
                    depth_clip=depth_clip, depth_bias=bias)

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        jobs = {}

        def submit(key, clip, width, height, msaa4, **kw):
            jobs[key] = pool.submit(_oracle_job, (clip, width, height, msaa4, kw))

        for (width, height), stream, label, clip in plan:
            big = (width, height) != (96, 64)
            for m in (False, True):
                submit((width, height, label, "base", m), clip, width, height, m, **kw_of())
                for lab, _, triple, c in state_bias(stream, label, big)[0]:
                    submit((width, height, label, lab, c, m), clip, width, height, m, **kw_of(depth_clip=c, bias=triple))
                for c in {c for _, kind, _, c in state_bias(stream, label, big)[0] if kind == "range" and c is not True}:
                    if not m:
                        submit((width, height, label, "unbiased", c), clip, width, height, False, **kw_of(depth_clip=c))
                if stream in ("slivers", "clamp_boundary"):
                    for lab in ("slope clip -", "clamp +"):
                        triple = dict((b[0], b[2]) for b in adv.bias_triples())[lab]
                        submit((width, height, label, "ge", lab, m), clip, width, height, m,
                               **kw_of("greater_equal", "clamp", triple))
            if label in STATE_SS.get((width, height), ()):
                submit((width, height, label, "ss"), clip, 2 * width, 2 * height, False, **kw_of())

        def want_of(*key):
            return jobs.pop(key).result()

        for (width, height), stream, label, clip in plan:
            size = f"{width}x{height}"
            tag = f"[adversarial state] {label} {size}"
            big = (width, height) != (96, 64)
            rng = np.random.default_rng(clip.shape[0] + width + 7)
            col = torch.from_numpy(rng.uniform(0, 1, size=(clip.shape[0], 3, ADV_K)).astype(np.float32)).to(dev)
            clip_d = torch.from_numpy(clip).to(dev)
            base, base4 = want_of(width, height, label, "base", False), want_of(width, height, label, "base", True)

            def binned(ts, extent, tile, origin=(0, 0), **bk):
                b = bin_triangles(ts, *extent, *tile, max_pairs=pair_budget(ts, tile, origin), channels=col,
                                  origin=origin, **bk)
                if bool(b.overflowed):
                    raise AssertionError(f"{tag}: binner overflowed")
                return b

            def routes(ctag, ts, ts4, want, want4, compare="less", depth_clip=True, scissor=None, origin=(0, 0),
                       extent=None, full=True, sublane=True, bands=()):
                """The CUDA routes that take the state, each against its
                plain version and ``want`` (``want4`` per sample); ``want``
                None: the plain versions only.  B1 and B4 always; B2 and B5
                (from B3's records) with ``sublane`` where the tile grid
                allows; ``full`` adds the two-pass, batched and tmpl routes
                and B3/B8/rows; ``bands`` the band-binned B2 under the same
                state."""
                ew, eh = extent or (width, height)
                local = None if scissor is None else (scissor[0] - origin[0], scissor[1] - origin[1],
                                                      scissor[2] - origin[0], scissor[3] - origin[1])
                kw = dict(depth_compare=compare, depth_clear=0.0 if compare.startswith("greater") else 1.0,
                          depth_clip=depth_clip, num_channels=ADV_K, scissor=local)
                ordered = compare in ORDERED

                def held(name, label_, got, plain, want_, also=None):
                    check(name, f"{ctag} {label_} vs plain", got, plain)
                    if also is not None:
                        check(name, f"{ctag} {label_} vs {also[0]}", got, also[1])
                    if want_ is not None:
                        compare_oracle(stats, f"{ctag} {label_}", got[0], want_)
                    stats["routes"].add(name)
                    return got

                # B1, B6 and B4 at the default tile for the full set and at
                # 1080p; at 96x64 the others take 32x16 (fewer records a
                # tile: the plain versions loop over them).
                tile = shard_tile((128, 32) if full or big else (32, 16), (ew, eh))
                b = binned(ts, (ew, eh), tile, origin)
                tkw = dict(kw, tile_w=tile[0], tile_h=tile[1])
                b1_plain = raster.rasterize_binned_reference(b, ew, eh, **tkw)
                b1 = held("raster_tile", f"B1 {tile}", raster.rasterize_binned(b, ew, eh, **tkw), b1_plain, want)
                if origin != (0, 0):  # the same through rasterize_vis(origin=...)
                    vis = raster.rasterize_vis(ts, ew, eh, tile_w=tile[0], tile_h=tile[1], channels=col,
                                               max_pairs=pair_budget(ts, tile, origin), origin=origin,
                                               **{k: v for k, v in kw.items() if k != "num_channels"})
                    check("raster_tile", f"{ctag} rasterize_vis(origin={origin}) vs rasterize_binned", vis, b1)
                if full:
                    held("raster_two_pass", f"B6 {tile}", raster.rasterize_binned(b, ew, eh, two_pass=True, **tkw),
                         b1_plain, None, ("B1", b1))
                    if ordered:
                        t7 = shard_tile((64, 64), (ew, eh))
                        b7 = binned(ts, (ew, eh), t7, origin)
                        k7 = dict(kw, tile_w=t7[0], tile_h=t7[1], batch=16)
                        held("raster_batched", f"B7 {t7}", raster.rasterize_binned(b7, ew, eh, **k7),
                             raster.rasterize_binned_reference(b7, ew, eh, **k7), want)
                sub_ok = sublane and ordered and adv.window_sublane_ok(origin, (ew, eh), width)
                sub = (128, math.gcd(8, eh))
                if sub_ok:
                    b3 = binned(ts, (ew, eh), sub, origin, assemble="pallas")
                    skw = dict(kw, tile_w=sub[0], tile_h=sub[1])
                    b2 = held("raster_sublane", f"B2 {sub} from B3", raster.rasterize_binned(b3, ew, eh, sublane=True, **skw),
                              raster.rasterize_binned_sublane_reference(b3, ew, eh, **skw), want)
                    if full:
                        bt = binned(ts, (ew, eh), sub, origin, assemble="pallas", tmpl="pallas")
                        for a_, b_ in zip(bt[:2], b3[:2]):
                            bitwise(f"{ctag} tmpl records vs B3 records", a_, b_)
                        held("raster_sublane", "B2 tmpl route", raster.rasterize_binned(bt, ew, eh, sublane=True, **skw),
                             raster.rasterize_binned_sublane_reference(bt, ew, eh, **skw), want, ("B2", b2))
                    for rows in bands:
                        band_routes(ctag, ts, (ew, eh), sub, rows, kw, want, b2, origin)
                if full:
                    for m, t_ in ((False, ts), (True, ts4)):
                        b3_b8_rows_bitwise(stats, f"{ctag} msaa4={m}", t_, ew, eh, col, m,
                                           pair_budget(t_, tile, origin), tile=tile, origin=origin)
                b4 = binned(ts4, (ew, eh), tile, origin, msaa4=True)
                mkw = dict(tkw, msaa4=True)
                held("raster_msaa4", f"B4 {tile}", raster.rasterize_binned(b4, ew, eh, **mkw),
                     raster.rasterize_binned_reference(b4, ew, eh, **mkw), want4)
                if sub_ok:
                    b5 = binned(ts4, (ew, eh), sub, origin, msaa4=True, assemble="pallas")
                    k5 = dict(kw, tile_w=sub[0], tile_h=sub[1])
                    held("raster_msaa4_sublane", f"B5 {sub} from B3",
                         raster.rasterize_binned(b5, ew, eh, sublane=True, msaa4=True, **k5),
                         raster.rasterize_binned_msaa4_sublane_reference(b5, ew, eh, **k5), want4)
                stats["configs"] += 1

            def band_routes(ctag, ts, extent, tile, rows, kw, want, whole, origin=(0, 0)):
                """B2 over ``rows``-row bands from the XLA assembly, from B3
                and through the tmpl route: the three record streams equal,
                each frame equal to its plain version, to the unbanded frame
                ``whole`` and to ``want``."""
                ew, eh = extent
                bin_h = -(-eh // tile[1]) * tile[1]
                bk = dict(col_major_ids=True, anchor_rows=tile[1])
                streams = {asm: binned(ts, (ew, bin_h), (tile[0], rows), origin, assemble=a, tmpl=t, **bk)
                           for asm, a, t in (("xla", "xla", "xla"), ("B3", "pallas", "xla"), ("tmpl", "pallas", "pallas"))}
                live = int(streams["xla"].tile_count.sum())  # the assemblies pad the stream differently
                for asm in ("B3", "tmpl"):
                    got, ref = streams[asm], streams["xla"]
                    for a_, b_ in ((got.records[:, :live], ref.records[:, :live]),
                                   (got.frecords[:, :live], ref.frecords[:, :live]), *zip(got[2:4], ref[2:4])):
                        bitwise(f"{ctag} bands {rows} {asm} records vs XLA", a_, b_)
                bkw = dict(kw, tile_w=tile[0], tile_h=tile[1], bin_rows=rows)
                for asm, bs in streams.items():
                    check("raster_sublane", f"{ctag} bands {rows} {asm} vs plain",
                          got := raster.rasterize_binned(bs, ew, eh, sublane=True, **bkw),
                          raster.rasterize_binned_sublane_reference(bs, ew, eh, **bkw))
                    check("raster_sublane", f"{ctag} bands {rows} {asm} vs unbanded", got, whole)
                    if want is not None:
                        compare_oracle(stats, f"{ctag} bands {rows} {asm}", got[0], want)
                if ts.valid.shape[0]:
                    b3_b8_rows_bitwise(stats, f"{ctag} bands {rows}", ts, ew, bin_h, col, False,
                                       pair_budget(ts, (tile[0], rows), origin), tile=(tile[0], rows), origin=origin,
                                       **bk)
                stats["routes"].add("raster_sublane")
                return streams["xla"]

            def setups(**kw):
                return (setup_pair(clip, clip_d, width, height, **kw),
                        setup_pair(clip, clip_d, width, height, bbox_pad_fp=pad4, **kw))

            clock = [time.perf_counter()]

            def lap(state):
                """Add the seconds since the last lap to the state's total."""
                now = time.perf_counter()
                key = f"{state} {size}"
                stats["t"][key] = stats["t"].get(key, 0.0) + now - clock[0]
                clock[0] = now

            ts, ts4 = setups()
            # -- scissor: every rect; the off-grid one through every route, with 4-row bands
            for name, rect in adv.scissors(width, height):
                if big and name not in STATE_BIG_SCISSORS:
                    continue
                engaged(size, f"scissor {name}", adv.assert_scissor_engaged, rect, base["tri_id"])
                sts, sts4 = setups(scissor=rect)
                routes(f"{tag} scissor {name}", sts, sts4, adv.scissor_expect(base, rect, one_q),
                       adv.scissor_expect(base4, rect, one_q), scissor=rect, full=name == "off-grid",
                       sublane=not big or name == "off-grid", bands=(4,) if name == "off-grid" else ())
            lap("scissor")
            # -- depth bias
            held_bias, wrap = state_bias(stream, label, big)
            unbiased = {True: base}
            for lab, kind, triple, c in held_bias:
                want, want4 = want_of(width, height, label, lab, c, False), want_of(width, height, label, lab, c, True)
                if c not in unbiased and kind == "range":
                    unbiased[c] = want_of(width, height, label, "unbiased", c)
                engaged(size, f"bias {lab}", adv.assert_bias_engaged, kind, ts, triple, want, unbiased.get(c))
                bts, bts4 = setups(depth_bias=triple)
                # Every route for the slopes at the clip under the depth clamp,
                # the rasters for the other slopes, the bias clamps and the
                # clamped depth range, B1 and B4 for the rest.
                routes(f"{tag} bias {lab} clip={c}", bts, bts4, want, want4, depth_clip=c,
                       full=kind == "slope_clip" and c == "clamp",
                       sublane=kind in ("slope_clip", "clamp") or c == "clamp")
            for lab, kind, triple, c in wrap:
                engaged(size, f"bias {lab}", adv.assert_bias_engaged, kind, ts, triple)
                bts, bts4 = setups(depth_bias=triple)
                routes(f"{tag} bias {lab} clip={c}", bts, bts4, None, None, depth_clip=c, full=not big)
            if stream in ("slivers", "clamp_boundary"):  # bias on the clamp slivers, greater_equal, depth clamp
                for lab in ("slope clip -", "clamp +"):
                    triple = dict((b[0], b[2]) for b in adv.bias_triples())[lab]
                    bts, bts4 = setups(depth_bias=triple)
                    routes(f"{tag} bias {lab} greater_equal clamp", bts, bts4,
                           want_of(width, height, label, "ge", lab, False), want_of(width, height, label, "ge", lab, True),
                           compare="greater_equal", depth_clip="clamp", full=False)
            lap("bias")
            # -- band binning at every BAND_ROWS
            skw = dict(depth_compare="less", depth_clear=1.0, depth_clip=True, num_channels=ADV_K, scissor=None)
            for tile, all_rows in STATE_BIG_BANDS if big else adv.BAND_ROWS:
                b3 = binned(ts, (width, height), tile, assemble="pallas")
                whole = raster.rasterize_binned(b3, width, height, sublane=True, tile_w=tile[0], tile_h=tile[1], **skw)
                for rows in all_rows:
                    xla = band_routes(f"{tag} tile {tile}", ts, (width, height), tile, rows, skw, base, whole)
                    engaged(size, f"bands {tile[0]}x{tile[1]}/{rows}", adv.assert_bands_engaged, xla, width, height,
                            tile, rows)
                    stats["configs"] += 1
            lap("bands")
            # -- shard windows: the binner's window records on the card equal the CPU's
            ts_cpu = setup_triangles(torch.from_numpy(clip), width, height)
            for name, origin, extent in adv.windows(width, height):
                engaged(size, f"window {name}", adv.assert_window_engaged, origin, extent, base["tri_id"])
                tile = shard_tile((128, 32), extent)
                on_card = binned(ts, extent, tile, origin)
                on_cpu = bin_triangles(ts_cpu, *extent, *tile, max_pairs=pair_budget(ts_cpu, tile, origin),
                                       channels=col.cpu(), origin=origin)
                for a_, b_ in zip(on_card[:5], on_cpu[:5]):
                    bitwise(f"{tag} window {name} records on the card vs the CPU", a_.cpu(), b_)
                routes(f"{tag} window {name}", ts, ts4, adv.window_expect(base, origin, extent),
                       adv.window_expect(base4, origin, extent), origin=origin, extent=extent,
                       full=not big or name == "cut to 8")
            if not big:  # a window with the off-grid scissor (in frame pixels)
                rect = dict(adv.scissors(width, height))["off-grid"]
                name, origin, extent = adv.windows(width, height)[1]
                sts, sts4 = setups(scissor=rect)
                routes(f"{tag} window {name} scissor off-grid", sts, sts4,
                       adv.window_expect(adv.scissor_expect(base, rect, one_q), origin, extent),
                       adv.window_expect(adv.scissor_expect(base4, rect, one_q), origin, extent),
                       scissor=rect, origin=origin, extent=extent, full=False)
            lap("window")
            # -- supersampling through the renderer
            if label in STATE_SS.get((width, height), ()):
                supersample_runs(dev, stats, tag, clip, width, height, want_of(width, height, label, "ss"), engaged)
                lap("supersample")
            stats["cases"] += 1
        if jobs:
            raise AssertionError(f"[adversarial state] {len(jobs)} oracle runs were never compared")
    for (size, regime), (hits, runs) in stats["engaged"].items():
        if hits == 0:
            raise AssertionError(f"[adversarial state] {regime} at {size}: engaged by none of {runs} cases")
    stats["seconds"] = time.perf_counter() - t0
    return stats


def supersample_runs(dev, stats, tag, clip, width, height, want, engaged) -> None:
    """One stream drawn by Renderer(msaa=4, msaa_supersample=True) with the
    flat_ndc shader (clip positions drawn as given, no near clip), without
    and with the off-grid scissor: render_frame twice (the key's capture,
    then a replay), the replay equal to the eager frame (_run_frame on the
    same draw) and its tri_id and depth_q to the oracle at 2W x 2H (masked
    by the rect scaled by 2); a Shard of the "cut to 8" window equal to the
    eager frame cropped (colour at framebuffer pixels, the raster planes
    at twice them)."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.reference import adversarial as adv
    from based_renderer_tpu_torch.renderer import Shard, shard_tile

    size = f"{width}x{height}"
    engaged(size, "supersample", adv.assert_supersample_engaged,
            setup_triangles(torch.from_numpy(clip), 2 * width, 2 * height), want["tri_id"])
    r = brt.Renderer(brt.RendererConfig(width, height, msaa=4, msaa_supersample=True), device=dev)
    mesh = r.upload_mesh(clip.reshape(-1, 4))
    rect = dict(adv.scissors(width, height))["off-grid"]
    _, origin, extent = adv.windows(width, height)[1]
    (x0, y0), (ew, eh) = origin, extent
    for sc in (None, rect):
        ctag = f"{tag} supersample scissor={sc}"
        # A pair budget of every triangle in every tile of the 2x raster, at
        # the frame's tile and at the one the shard's window cuts it to.
        tw, th = shard_tile((128, 32), (2 * ew, 2 * eh))
        tiles = max(-(-2 * width // 128) * -(-2 * height // 32), -(-2 * ew // tw) * -(-2 * eh // th))
        pipe = brt.Pipeline(shader="flat_ndc", scissor=sc, near_clip=False, raster_pairs_factor=float(tiles + 1))
        u = {"color": SS_COLOR}
        r.render_frame(pipe, mesh, u)
        replay = r.render_frame(pipe, mesh, u)
        r.begin_frame()
        r.draw(pipe, mesh, u)
        eager = r._run_frame(*r.close_frame())
        r.begin_frame()
        r.draw(pipe, mesh, u)
        part = r._run_frame(*r.close_frame(), shard=Shard(origin, extent))
        torch.cuda.synchronize()
        for k, i in (("color_planar", 0), ("depth_q", 1), ("tri_id", 2)):
            if not torch.equal(getattr(replay, k), eager[i]):
                raise AssertionError(f"{ctag}: replayed {k} differs from the eager frame")
        if bool(replay.overflowed) or bool(eager[4]) or bool(part[4]):
            raise AssertionError(f"{ctag}: overflowed")
        w_ = want if sc is None else adv.scissor_expect(want, tuple(2 * v for v in sc), fp.DEPTH_ONE_Q)
        compare_oracle(stats, f"{ctag} at 2x", replay, w_)
        if not torch.equal(part[0], eager[0][..., y0 : y0 + eh, x0 : x0 + ew]):
            raise AssertionError(f"{ctag}: the shard's colour is not the frame's, cropped")
        for i in (1, 2):
            if not torch.equal(part[i], eager[i][..., 2 * y0 : 2 * (y0 + eh), 2 * x0 : 2 * (x0 + ew)]):
                raise AssertionError(f"{ctag}: the shard's raster planes are not the frame's, cropped")
        stats["configs"] += 1
    stats["routes"].add("supersampled render_frame")


def symbol_launches_of(fn, symbol: str, want: int) -> tuple:
    """(fn()'s result, the launches of the CUDA kernel ``symbol`` that it
    made on the card, a graph's replay included), under torch.profiler;
    tried again while fewer than ``want`` are seen (the profiler may drop a
    launch's record, it never adds one)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type == cuda and symbol in e.key)
        if n >= want:
            break
    return out, n


def shade_phase(dev, card: str) -> dict:
    """Phase 6b: the fused Blinn-Phong kernel (S1) against its plain
    version, alone and through the renderer (the plain route: ``_on_card``
    false), with its launches counted on each route; the 4K MSAA-4x draw's
    times and bounds.  Prints the phase's line and returns S1's numbers for
    the kernels line: the worst gap to its plain version, its times, the
    plain version's and its bound."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch import renderer as renderer_mod
    from based_renderer_tpu_torch import shader as shader_lib
    from based_renderer_tpu_torch.ops import shade

    worst = {"kernel": 0.0, "frames": 0.0}
    g = torch.Generator().manual_seed(6)
    u = [torch.tensor(v, device=dev) for v in ([3.0, -3.0, -3.0], [0.0, 0.0, -2.2], [0.55, 0.65, 0.8], 32.0, 0.1)]
    # (samples, channels, from the clear colour, resolve)
    for samples, k, clear, resolve in ((4, 6, True, True), (4, 6, False, False), (4, 9, False, True),
                                       (1, 6, True, False), (1, 9, False, False)):
        plane = (samples, 96, 128) if samples == 4 else (96, 128)
        interp = (torch.randn((k, *plane), generator=g) * 2).to(dev)
        invw = (torch.rand(plane, generator=g) + 0.1).to(dev)
        invw[..., 3, 5:40] = 0
        tri = torch.randint(-1, 60, plane, generator=g, dtype=torch.int32).to(dev)
        color = (torch.rand(4, generator=g) if clear else torch.rand((*plane[:-2], 4, 96, 128), generator=g)).to(dev)
        args = (interp, invw, tri, 10, 50, color, *u)
        got = shade.shade_blinn_phong(*args, resolve=resolve)
        want = shade.shade_blinn_phong_reference(*args, resolve=resolve)
        worst["kernel"] = max(worst["kernel"], float((got - want).abs().max()))

    class plain_route:
        def __enter__(self):
            self.on_card = renderer_mod._on_card
            renderer_mod._on_card = lambda t: False

        def __exit__(self, *exc):
            renderer_mod._on_card = self.on_card

    def eager(r, pipe, mesh, us):
        r.begin_frame()
        for x in us:
            r.draw(pipe, mesh, x)
        return r._run_frame(*r.close_frame())

    def launched(label, fn, fused, kernel):
        """fn()'s result; it must add ``fused`` fused draws and ``kernel``
        calls of S1's wrapper."""
        draws, calls = renderer_mod.FUSED_SHADED_DRAWS, shade.LAUNCHES
        out = fn()
        got = (renderer_mod.FUSED_SHADED_DRAWS - draws, shade.LAUNCHES - calls)
        if got != (fused, kernel):
            raise AssertionError(f"shade {label}: fused draws and S1 wrapper calls {got}, expected {(fused, kernel)}")
        return out

    def compare(label, got, want):
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"shade {label}: tri_id or depth_q differ from the plain route's")
        gap = float((got[0] - want[0]).abs().max())
        worst["frames"] = max(worst["frames"], gap)
        return gap, float((got[0] == want[0]).all(dim=0).float().mean())

    small = []
    for msaa, ts in ((4, (0.3, 2.1)), (1, (0.3,))):
        r = brt.Renderer(brt.RendererConfig(128, 96, msaa=msaa), device=dev)
        pipe, mesh, uf, _ = brt.demos.big_mesh_demo(r, triangles=2000)
        label = f"128x96 msaa={msaa}"
        got = launched(label, lambda: eager(r, pipe, mesh, [uf(t) for t in ts]), len(ts), len(ts))
        with plain_route():
            want = launched(f"{label} plain", lambda: eager(r, pipe, mesh, [uf(t) for t in ts]), 0, 0)
        small.append(compare(label, got, want))

    # The 4K frame: eager, the key's capture (its warm-up and the capture
    # call the wrapper), a replay (no call; the graph launches S1 once).
    r = brt.Renderer(brt.RendererConfig(W4K, H4K, msaa=4), device=dev)
    pipe, mesh, uf, _ = brt.demos.big_mesh_demo(r)
    got_eager = launched("4K eager", lambda: eager(r, pipe, mesh, [uf(0.3)]), 1, 1)
    launched("4K capture", lambda: r.render_frame(pipe, mesh, uf(1.0)), 2, 2)
    f, replay_s1 = symbol_launches_of(lambda: launched("4K replay", lambda: r.render_frame(pipe, mesh, uf(0.3)), 0, 0),
                                      S1, 1)
    got_replay = (f.color_planar, f.depth_q, f.tri_id)
    with plain_route():
        want, plain_s1 = symbol_launches_of(lambda: launched("4K plain", lambda: eager(r, pipe, mesh, [uf(0.3)]), 0, 0),
                                            S1, 0)
    if (replay_s1, plain_s1) != (1, 0):
        raise AssertionError(f"shade 4K: the profiler saw S1 {replay_s1} times in a replay (1 expected) and "
                             f"{plain_s1} on the plain route (0 expected)")
    big = {"eager": compare("4K eager", got_eager, want), "replayed": compare("4K replayed", got_replay, want)}
    if not max(worst.values()) <= COLOR_TOL:
        raise AssertionError(f"shade: colour differs from the plain version by {worst}")

    # The 4K draw's planes, shaded alone: the kernel, its plain version.
    r.begin_frame()
    r.draw(pipe, mesh, uf(0.3))
    draws, clear, clear_depth = r.close_frame()
    fv = r._visibility(draws, clear_depth)
    _, off, ntri, interp, invw, vis, uniforms = fv.per_draw[0]
    clear_t = torch.tensor(clear, dtype=torch.float32, device=dev)
    uv = [shader_lib._blinn_phong_uniform(uniforms, key, interp) for key in shader_lib._BLINN_PHONG_DEFAULTS]
    args = (interp, invw, vis.tri_id, off, off + ntri, clear_t, *uv)
    t_kernel = timed(lambda: shade.shade_blinn_phong(*args, resolve=True), 10, S1)
    t_plain = timed(lambda: shade.shade_blinn_phong_reference(*args, resolve=True))
    samples = vis.tri_id.numel()
    won = int(((vis.tri_id >= off) & (vis.tri_id < off + ntri)).sum())
    k = interp.shape[0]
    out_bytes = 4 * 4 * samples // 4
    every = bound(samples * (4 + 4 + 4 * k) + out_bytes, 0)
    needed = bound(samples * 4 + won * (4 + 4 * k) + out_bytes, 0)
    line = (f"[shade_blinn_phong vs plain] random planes at 128x96 (MSAA-4x resolved and per sample, no MSAA, "
            f"vertex colour, clear or earlier colour): max gap {worst['kernel']:.3g}; big_mesh frames vs the plain "
            f"route, tri_id and depth_q exact: 128x96 two draws MSAA-4x gap {small[0][0]:.3g} (bitwise pixels "
            f"{100 * small[0][1]:.3f}%), no MSAA {small[1][0]:.3g} ({100 * small[1][1]:.3f}%), {W4K}x{H4K} MSAA-4x "
            f"eager {big['eager'][0]:.3g} ({100 * big['eager'][1]:.3f}%), replayed {big['replayed'][0]:.3g} "
            f"({100 * big['replayed'][1]:.3f}%) (tol {COLOR_TOL}); S1 launched once a fused draw eagerly, twice at "
            f"the capture, once from a replay's graph (profiler), never on the plain route | 4K draw "
            f"({100 * won / samples:.2f}% of samples won) kernel {fmt(t_kernel)}, plain {fmt(t_plain)}, bound "
            f"{needed[0]:.4f} ms for the samples it needs, {every[0]:.4f} ms reading every sample | {card}")
    print(line, flush=True)
    return {"worst": worst["kernel"], "kernel": t_kernel, "plain": t_plain, "bound": needed}


def main() -> int:
    started = time.perf_counter()
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
    from based_renderer_tpu_torch.ops import shade as shade_ops
    from based_renderer_tpu_torch.ops import texture as tex_ops
    from based_renderer_tpu_torch.ops import fixedpoint as fp
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.clip import clip_near
    from based_renderer_tpu_torch.ops.cull import instance_visibility
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import gather_triangles
    from based_renderer_tpu_torch.reference import adversarial, oracle

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
        (shade_ops, "LAUNCHES"),
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
    big_demo, big_ts, big_kw = dense_setup(big_r, "big_mesh_demo", 0.2, dev)
    ps, rec_k, t_b3_big, t_b3_big_plain, b_b3_big = b3_vs_plain("big_mesh 1080p", big_ts, W, H, big_kw, False)
    big4m_r = brt.Renderer(brt.RendererConfig(W4K, H4K, msaa=4))
    big4m_demo, big4m_ts, big4m_kw = dense_setup(big4m_r, "big_mesh_demo", 0.2, dev)
    ps4m, rec4m, t_b3m, t_b3m_plain, b_b3m = b3_vs_plain("big_mesh 4K MSAA", big4m_ts, W4K, H4K, big4m_kw, True)
    if rec4m.shape[0] != 24:
        raise AssertionError(f"MSAA records have {rec4m.shape[0]} rows")

    # The JAX package measured instance_cull 0.85 (its demos.py:157-163).
    # At 0.85 the binner overflows: its slot budget is 0.6 per triangle of
    # the culled stream, 61,200 slots for 102,000 triangles, and a frame
    # of the orbit has ~62,800 live pairs.  0.9 holds them.
    CULL = 0.9
    cull_ts, cull_kw, cull_ids, n_visible = culled_setup(brt.Renderer(brt.RendererConfig(W, H)), 0.3, CULL, dev)
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
        return t_k, t_p, rows_bound(args[1], rec_k.shape[0], fw, num_channels)

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
    # K = 32, random channels: the widest rows the kernel stages (126 used
    # columns of 128, 67,584 bytes of shared memory a block).
    k32 = torch.randn((big_ts.valid.shape[0], 3, 32), generator=torch.Generator(device=dev).manual_seed(32),
                      device=dev)
    ps32 = binning.pair_stream(big_ts, W, H, 128, 8, big_kw["max_pairs"], 0, k32, True, big_kw["slots"])
    fused32_t, width32 = binning.templates_field_major(ps32.tmpl)
    if width32 != 128 or bool(ps32.overflowed):
        raise AssertionError(f"K=32 template rows are {width32} wide (overflowed {bool(ps32.overflowed)})")
    fused32 = binassem.transpose_templates(fused32_t, width32)
    per_field32 = binassem.assemble_records(ps32.tmpl, *binning.padded_slots(ps32), ps32.total,
                                            binning.frecord_width(32))
    t_rows32, t_rows32_plain, b_rows32 = rows_vs_plain("big_mesh 1080p K=32", ps32, fused32, 32, False, per_field32)
    del k32, ps32, fused32_t, fused32, per_field32
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
        f"[assemble_records_rows vs plain, vs per-field] big_mesh 1080p (16 rows), 4K MSAA-4x (24 rows), big_mesh "
        f"1080p with K=32 random channels (128-wide rows) and the culled instanced stream (per-triangle ids) from "
        f"the transposed template rows: records bitwise equal to the plain version and to the per-field entry | "
        f"big_mesh 1080p kernel {fmt(t_rows_big)} (bound {b_rows_big[0]:.4f} ms), plain {fmt(t_rows_big_plain)}, "
        f"per-field entry {fmt(t_b3_big)} | 4K MSAA kernel {fmt(t_rows4m)}, plain {fmt(t_rows4m_plain)} | K=32 "
        f"kernel {fmt(t_rows32)} (bound {b_rows32[0]:.4f} ms), plain {fmt(t_rows32_plain)} | instanced culled kernel "
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
    inst_demo, inst_ts, inst_kw = dense_setup(inst_r, "instanced_demo", 0.3, dev)
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

    # ---- 6b. shade_blinn_phong vs plain ---------------------------------
    s1 = shade_phase(dev, card)
    times["shade_blinn_phong"], times["shade_blinn_phong_plain"] = s1["kernel"], s1["plain"]
    bounds["shade_blinn_phong"] = s1["bound"]
    check.worst["shade_blinn_phong"] = s1["worst"]

    # ---- 7. oracle (the port's own copy) --------------------------------
    def oracle_equal(label, got, want):
        for k in ("tri_id", "depth_q", "stencil"):
            if k not in want:
                continue
            g = getattr(got, k).cpu().numpy()
            if not np.array_equal(g, want[k]):
                raise AssertionError(f"oracle {label}: {k} differs at {int((g != want[k]).sum())} pixels")

    for label, clip in (("cube", cube_clip), ("stress[:2048]", s_clip[:2048])):
        got, overflowed, _ = raster.rasterize_vis(
            setup_triangles(clip, W, H), W, H, max_pairs=max(16 * clip.shape[0], 4096), return_overflow=True
        )
        if bool(overflowed):
            raise AssertionError(f"oracle {label}: binner overflowed")
        oracle_equal(label, got, oracle.rasterize(clip.cpu().numpy(), W, H))
    got, overflowed, _ = raster.rasterize_vis(
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
        frame = toy_r.render_frame(pipe, mesh, u)  # the key's warm-up and capture, then its replay
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != tuple(2 * x for x in want_launches) or bool(frame.overflowed):
            raise AssertionError(f"oracle big_mesh {cfg.msaa}x: launches {got}, overflowed {bool(frame.overflowed)}")
        clip, _ = brt.shader.get(pipe.shader).vertex(mesh.attributes, {k: v.to(dev) for k, v in u.items()})
        return frame, clip.reshape(-1, 3, 4).cpu().numpy()

    frame, clip = toy_big_mesh(brt.RendererConfig(W, H),
                               per_frame(raster_sublane=1, assemble_records=1, shade_blinn_phong=1))
    oracle_equal("big_mesh 2000", frame, oracle.rasterize(clip, W, H, cull_mode="back"))
    frame, clip = toy_big_mesh(brt.RendererConfig(W, H, msaa=4),
                               per_frame(assemble_records=1, raster_msaa4_sublane=1, shade_blinn_phong=1))
    oracle_equal("MSAA big_mesh 2000", frame, oracle.rasterize_msaa4(clip, W, H, cull_mode="back"))
    # Stencil through B1 and the two-pass route, per sample through B4, and
    # a depth-biased stream through the port's setup and B1.
    s2k = s_clip[:2048]
    s2k_np = s2k.cpu().numpy()
    for name, st, clear in stencil_cases:
        want = oracle.rasterize(s2k_np, W, H, stencil=st, stencil_clear=clear)
        for two_pass in (False, True):
            got, overflowed, _ = raster.rasterize_vis(setup_triangles(s2k, W, H), W, H, max_pairs=16 * 2048,
                                                      stencil=st, stencil_clear=clear, two_pass=two_pass,
                                                      return_overflow=True)
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
        f"raster_tile; at {W}x{H}: tri_id, depth_q and stencil bit-exact; the adversarial streams "
        f"({', '.join(adversarial.STREAMS)}, fuzz) follow in [adversarial]",
        flush=True,
    )

    # ---- 7b. the spec's adversarial streams ------------------------------
    adv = adversarial_phase(dev, check, card)
    t0 = time.perf_counter()
    empty_launches = empty_and_culled_draws(dev, counts, reset_counts, COUNTS)
    empty_s = time.perf_counter() - t0
    print(
        f"[adversarial] streams {', '.join(adversarial.STREAMS)} and the mixed fuzz (seeds "
        f"{', '.join(map(str, ADV_FUZZ_SEEDS))} at {W}x{H}), at {' and '.join(f'{w}x{h}' for w, h in ADV_SIZES)}: "
        f"{adv['cases']} cases, {adv['configs']} configurations (compares, culls, depth clamp, depth test off, "
        f"stencil), tiles {', '.join(f'{w}x{h}' for w, h in ADV_TILES)}; routes {', '.join(sorted(adv['routes']))}: each against "
        f"its plain version (ints exact, floats within {FLOAT_TOL}, B3/B8/rows bitwise) and the oracle (tri_id, "
        f"depth_q, stencil exact), setup and the near clip bitwise = the CPU's; {adv['pixels']} pixels (samples) "
        f"compared with the oracle; regimes: "
        + "; ".join(f"{k}: {v}" for k, v in adv["regimes"].items())
        + f" | empty draw and culled instances through render_frame and captured render_sequence_multi: nothing "
        f"covered, no overflow, the next frame and sequence = drawn alone; launches {empty_launches} "
        f"({empty_s:.1f} s) | phase {adv['seconds']:.1f} s | {card}",
        flush=True,
    )

    # ---- 7c. the adversarial streams under raster state ------------------
    st = adversarial_state_phase(dev, check, card)
    regimes = "; ".join(f"{regime} at {size}: {hits}/{runs}" for (size, regime), (hits, runs) in st["engaged"].items())
    print(
        f"[adversarial state] scissor ({', '.join(n for n, _ in adversarial.scissors(W, H))}), depth bias "
        f"({', '.join(b[0] for b in adversarial.bias_triples())}; {adversarial.BIAS_WRAP[0]} against the plain "
        f"versions only), bands ({'; '.join(f'{t[0]}x{t[1]}: {r}' for t, r in adversarial.BAND_ROWS)}), windows "
        f"({', '.join(n for n, _, _ in adversarial.windows(W, H))}) and supersampling, at "
        f"{' and '.join(f'{w}x{h}' for w, h in STATE_SIZES)}: {st['cases']} cases, {st['configs']} configurations; "
        f"routes {', '.join(sorted(st['routes']))}: each against its plain version (ints exact, floats within "
        f"{FLOAT_TOL}, B3/B8/rows bitwise) and the oracle masked or cropped (tri_id, depth_q exact); setup under "
        f"scissor and bias and the window records bitwise = the CPU's; {st['pixels']} pixels (samples) compared "
        f"with the oracle; regimes engaged (cases engaging/run): {regimes} | seconds by state: "
        + ", ".join(f"{k} {v:.1f}" for k, v in st["t"].items())
        + f" | phase {st['seconds']:.1f} s | {card}",
        flush=True,
    )

    # ---- 8. end to end --------------------------------------------------
    nk = len(KERNELS)
    # symbol -> the COUNTS names whose launches run it
    symbols = {B1: ("raster_tile", "raster_two_pass"), B2: ("raster_sublane", "raster_batched"),
               B4: ("raster_msaa4",), B5: ("raster_msaa4_sublane",), "assemble_records_kernel": ("assemble_records",),
               "assemble_records_rows_kernel": ("assemble_records_rows",),
               "transpose_templates_kernel": ("transpose_templates",), S1: ("shade_blinn_phong",)}

    def symbol_launches(per, frames=1):
        """The kernel launches by symbol of ``frames`` frames of per-frame counts ``per``."""
        return {sym: frames * sum(per[COUNTS.index(c)] for c in names) for sym, names in symbols.items()}

    def profiled(fn, want=None):
        """(fn()'s result, its kernel launches by symbol under torch.profiler).
        With ``want``, retried while the profiler dropped launches' records
        (it never adds one)."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        cuda = torch.autograd.DeviceType.CUDA
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                out = fn()
                torch.cuda.synchronize()
            got = {sym: sum(e.count for e in prof.key_averages() if e.device_type == cuda and sym in e.key)
                   for sym in symbols}
            if want is None or got == want or any(got[k] > want[k] for k in want):
                break
        return out, got

    def record(r, draws, us):
        r.begin_frame()
        for (pipe, mesh, _, inst), u in zip(draws, us):
            r.draw(pipe, mesh, u, instances=inst)

    def render(r, draws, us):
        """One frame of ``draws`` [(pipe, mesh, uniforms_fn, instances)] with
        uniforms ``us``, through end_frame: the key's program, captured as
        CUDA graphs on its first call and replayed after that."""
        record(r, draws, us)
        return r.end_frame()

    def eager(r, draws, us):
        """The same frame eagerly, on the same inputs (Renderer._run_frame)."""
        record(r, draws, us)
        return renderer_mod.FrameResult(*r._run_frame(*r.close_frame()))

    def run_frames(label, r, draws, frames, per, replayed=True):
        """Median event-timed ms/frame over ``frames`` frames, the least
        covered count, the counts launched, and the reserved memory (MiB)
        a new program took.  Eager (``replayed`` False: _run_frame), each
        frame must add ``per`` to the counts (COUNTS order).  Through
        render_frame, a frame that makes its key's program adds twice the
        kernels of ``per`` (the eager warm-up and the capture) and is left
        out of the median; a replay adds none."""
        times_, overflow, finite, covered, mib = [], None, None, None, None
        launched = (0,) * len(COUNTS)
        for i in range(frames):
            us = [d[2](0.05 * i) for d in draws]
            programs = r.num_cached_programs
            if replayed and programs != len(r._programs) + len(r._sequences):
                raise AssertionError(f"{label}: num_cached_programs {programs} is not the frame and sequence programs")
            if replayed and i == 0:
                # Earlier phases' cyclic garbage holds CUDA memory, which a
                # capture collects: collect it first.
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
            before = counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            f = render(r, draws, us) if replayed else eager(r, draws, us)
            end.record()
            got = tuple(a - b for a, b in zip(counts(), before))
            launched = tuple(a + b for a, b in zip(launched, got))
            new = r.num_cached_programs - programs
            if replayed:
                want = tuple(2 * new * x for x in per[:nk])
                if got[:nk] != want:
                    raise AssertionError(f"{label} frame {i}: launches {got[:nk]}, expected {want} "
                                         f"({new} new programs)")
                if new and i == 0:
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    mib = (torch.cuda.memory_reserved() - reserved) / 2**20
            elif got != per or new:
                raise AssertionError(f"{label} eager frame {i}: launches {got}, expected {per}, {new} new programs")
            if not (replayed and new):
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
        ms = statistics.median(s.elapsed_time(e) for s, e in times_)
        return {"ms": ms, "covered": int(covered), "launched": launched, "mib": mib}

    class plain_path:
        """Within it, the renderer runs every kernel's plain version."""

        swaps = (
            (raster, "rasterize_binned", raster.rasterize_binned_reference),
            (binassem, "assemble_records", binassem.assemble_records_reference),
            (binassem, "transpose_templates", binassem.transpose_templates_reference),
            (binassem, "assemble_records_rows", binassem.assemble_records_rows_reference),
            (shade_ops, "shade_blinn_phong", shade_ops.shade_blinn_phong_reference),
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
        """One frame on the kernel path (render_frame: a replay) against the
        plain path (eager: a replay would ignore the swap), in which the
        profiler sees no kernel symbol: tri_id, depth_q and stencil exact,
        colour within COLOR_TOL.  ``decal_from``: the first triangle id of
        the last draw, which must win pixels."""
        us = [d[2](0.0) for d in draws]
        got = render(r, draws, us)
        with plain_path():
            want, syms = profiled(lambda: eager(r, draws, us))
        if any(syms.values()):
            raise AssertionError(f"{label}: the plain-path frame launched kernels {syms}")
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
    # big_mesh's blinn_phong draws shade through S1 (its fused body)
    big = per_frame(raster_sublane=1, assemble_records=1, shade_blinn_phong=1)
    runs = [
        ("big_mesh 1920x1080", big_r, [big_demo], 10, 2, big),
        ("big_mesh 3840x2160", big4k_r, [brt.demos.big_mesh_demo(big4k_r)], 5, 1, big),
        ("instanced 1920x1080", inst_r, [inst_demo], 10, 2, dense),
        ("cube 1920x1080", cube_r, [brt.demos.cube_demo(cube_r)], 20, 5, per_frame(raster_tile=1)),
        ("triangle 800x600", tri_r, [brt.demos.triangle_demo(tri_r)], 20, 5, per_frame(raster_tile=1)),
        ("big_mesh 3840x2160 MSAA-4x", big4m_r, [big4m_demo], 5, 1,
         per_frame(assemble_records=1, raster_msaa4_sublane=1, shade_blinn_phong=1)),
        ("cube 1920x1080 MSAA-4x", cube_m_r, [brt.demos.cube_demo(cube_m_r)], 20, 5, per_frame(raster_msaa4=1)),
        ("cube 1920x1080 supersampled", cube_ss_r, [ss_demo], 10, 3, per_frame(raster_tile=1)),
        ("render-state 1920x1080", rs_r, render_state_draws(rs_r), 10, 2,
         per_frame(raster_tile=2, assemble_records=1, raster_two_pass=1)),
        ("render-state 1920x1080 MSAA-4x", rs_m_r, render_state_draws(rs_m_r), 5, 1,
         per_frame(assemble_records=1, raster_msaa4=3)),
        ("big_mesh 1920x1080 batched", big_r, [batch_demo], 10, 1,
         per_frame(assemble_records=1, raster_batched=1, shade_blinn_phong=1)),
        ("big_mesh 1920x1080 tmpl", big_r, [tmpl_demo], 10, 1,
         per_frame(transpose_templates=1, assemble_records_rows=1, raster_sublane=1, shade_blinn_phong=1)),
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
    # The main path: every run through render_frame, each key's first frame
    # a capture (the counters count its eager warm-up and its capture), the
    # others replays (launches under the profiler, below).
    reset_counts()
    results = {label: run_frames(label, r, draws, n, per) for label, r, draws, n, _, per in runs}
    main_launches = dict(zip(COUNTS, counts()))
    expected = dict(zip(COUNTS, (sum(x) for x in zip(*(res["launched"] for res in results.values())))))
    if main_launches != expected or not all(main_launches[k] for k in KERNELS):
        raise AssertionError(f"main path launches {main_launches}, expected {expected}, every kernel at least once")
    if separable[0] != 2:  # the textured_fullscreen key's warm-up and capture
        raise AssertionError(f"the separable sampler ran {separable[0]} times on the main path, expected 2")
    peak_mib = torch.cuda.max_memory_reserved() / 2**20
    held_mib = torch.cuda.memory_reserved() / 2**20
    # The same frames eagerly (_run_frame): the counters move every frame.
    separable[0] = 0
    eager_ms = {label: run_frames(label, r, draws, n, per, replayed=False)["ms"] for label, r, draws, n, _, per in runs}
    if separable[0] != 20:  # the textured_fullscreen frames, one separable tap each
        raise AssertionError(f"the separable sampler ran {separable[0]} times in the eager frames, expected 20")
    tex_ops.sample_separable = sample_separable

    # Each run: a replayed frame = _run_frame on the same inputs, and the
    # profiler sees the eager frame's launches in it, none eager.
    replay_diffs = {}
    for label, r, draws, _, _, per in runs:
        us = [d[2](0.37) for d in draws]
        render(r, draws, us)  # a compacted draw's budget at t = 0.37 may be new: capture its segment first
        before = counts()
        got, syms = profiled(lambda: render(r, draws, us), symbol_launches(per))
        if counts()[:nk] != before[:nk]:
            raise AssertionError(f"{label}: a replayed frame launched kernels eagerly")
        if syms != symbol_launches(per):
            raise AssertionError(f"{label}: a replayed frame launched {syms}, the eager frame {symbol_launches(per)}")
        d = frames_equal(f"{label} replayed vs eager frame", got, eager(r, draws, us))
        if not d <= COLOR_TOL:
            raise AssertionError(f"{label} replayed vs eager frame: colour differs by {d}")
        replay_diffs[label] = d

    # A held FrameResult outlives two later frames of its key; a new mesh of
    # the same shapes (the cube scaled) goes through the cached program.
    cube_draws = {label: draws for label, _, draws, *_ in runs}["cube 1920x1080"]
    uf = cube_draws[0][2]
    held = render(cube_r, cube_draws, [uf(0.11)])
    held_want = eager(cube_r, cube_draws, [uf(0.11)])
    later = [render(cube_r, cube_draws, [uf(t)]) for t in (0.6, 0.9)]
    held_diff = frames_equal("held FrameResult after two later frames", held, held_want)
    if not held_diff <= COLOR_TOL or torch.equal(held.tri_id, later[-1].tri_id):
        raise AssertionError(f"held FrameResult: colour differs by {held_diff}, or the later frames are the same")
    from based_renderer_tpu_torch.models import geometry

    cube = geometry.cube_mesh_data()
    scaled = cube_r.upload_mesh(cube["positions"] * np.float32(0.5), color=cube["color"])
    scaled_draws = [(cube_draws[0][0], scaled, uf, None)]
    programs = cube_r.num_cached_programs
    f_scaled = render(cube_r, scaled_draws, [uf(0.11)])
    scaled_diff = frames_equal("scaled cube through the cached key", f_scaled, eager(cube_r, scaled_draws, [uf(0.11)]))
    covered_scaled, covered_held = int((f_scaled.tri_id >= 0).sum()), int((held.tri_id >= 0).sum())
    if cube_r.num_cached_programs != programs or not scaled_diff <= COLOR_TOL or covered_scaled >= covered_held:
        raise AssertionError(f"scaled cube: {cube_r.num_cached_programs - programs} new programs, colour diff "
                             f"{scaled_diff}, covered {covered_scaled} of the cube's {covered_held}")

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
        plain = {label: run_frames(label, r, draws, n, (0,) * nk + per[nk:], replayed=False)["ms"]
                 for label, r, draws, _, n, per in runs}
    print(
        "[end-to-end] render_frame through per-key programs (captured CUDA graphs, replayed after the key's first "
        "frame); median event-timed ms/frame replayed / eager _run_frame / plain path (frames; the capture frame "
        "left out), the program's reserved MiB: "
        + "; ".join(
            f"{label} {results[label]['ms']:.3f}/{eager_ms[label]:.3f}/{plain[label]:.3f} ({n}/{n}/{pn}, "
            f"{results[label]['mib'] or 0.0:.1f} MiB, min covered {results[label]['covered']} samples)"
            for label, _, _, n, pn, _ in runs
        )
        + f" | reserved after the runs {held_mib:.1f} MiB, peak {peak_mib:.1f} MiB"
        + f" | replayed = eager frame on the same inputs (tri_id, depth_q, stencil exact; the profiler sees the eager "
        f"frame's launches, none eager), max colour diff: " + ", ".join(f"{k} {d:.3g}" for k, d in replay_diffs.items())
        + f" | held FrameResult after two later frames = its eager frame (colour diff {held_diff:.3g}); the cube "
        f"scaled 0.5 through the cached key = eager (colour diff {scaled_diff:.3g}, covered {covered_scaled} of "
        f"{covered_held})"
        + f" | kernel (replayed) vs plain (eager, no kernel symbol) frame, max colour diff (tol {COLOR_TOL}): "
        + ", ".join(f"{label} {d:.3g}" for label, d in frame_diffs.items())
        + f" | big_mesh tmpl vs default frame: tri_id, depth_q exact, colour diff {tmpl_diff:.3g}"
        + f" | instance_cull {CULL} vs unculled frames: tri_id, depth_q exact, colour diff "
        + ", ".join(f"{k} {d:.3g}" for k, d in cull_diffs.items())
        + f"; worst visible share of the timed frames {worst_share:.4f}"
        + f" | launches (warm-up + capture) {main_launches} | {card}",
        flush=True,
    )

    # ---- 9. sequences: captured CUDA graphs, replayed once per frame -----

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
        inputs = seq_inputs(draws, n, 0.01)
        reset_counts()
        _, got = profiled(lambda: r.render_sequence_multi(inputs, return_frames=True))
        if counts()[:nk] != (0,) * nk:
            raise AssertionError(f"a replay-only call launched kernels eagerly: {counts()}")
        return got

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
        if bool(r.last_sequence_overflowed) or len(r._sequences) != 1:
            raise AssertionError(f"{label} sequence: overflowed or {len(r._sequences)} sequence programs")
        worst = 0.0
        for i in range(4):
            f = eager(r, draws, [d[2](0.05 * i) for d in draws])
            worst = max(worst, float((frames[i] - f.color_planar).abs().max()))
            if float(sums[i]) != float(frames[i].sum()):
                raise AssertionError(f"{label} sequence: checksum {i} is not sum(color)")
        if not worst <= COLOR_TOL or len(set(sums.tolist())) != 4:
            raise AssertionError(f"{label} sequence: colour differs from eager by {worst}, or frames repeat")
        got = replay_launches(r, draws, 4)
        want = symbol_launches(per, 4)
        if got != want:
            raise AssertionError(f"{label} sequence replays launched {got}, expected {want}")
        t4, t20 = time_sequence(r, draws, 4), time_sequence(r, draws, 20)
        r._sequences.clear()
        return worst, (t20 - t4) / 16 * 1e3, t4 * 1e3, t20 * 1e3

    gen_demo = brt.demos.big_mesh_demo(big_r, generated=True)
    eager_gen = run_frames("big_mesh 1920x1080 generated", big_r, [gen_demo], 5, big, replayed=False)["ms"]
    by_label = {label: (r, draws, per) for label, r, draws, _, _, per in runs}
    seq_labels = ("cube 1920x1080", "textured_cube 1920x1080", "instanced 1920x1080", "instanced 1920x1080 culled",
                  "big_mesh 1920x1080", "big_mesh 3840x2160 MSAA-4x", "render-state 1920x1080")
    seq_results = {}
    for label in seq_labels:
        r, draws, per = by_label[label]
        seq_results[label] = sequence_run(label, r, draws, per) + (eager_ms[label],)
    seq_results["big_mesh 1920x1080 generated"] = sequence_run("big_mesh 1920x1080 generated", big_r, [gen_demo],
                                                               big) + (eager_gen,)
    print(
        "[sequences] render_sequence_multi replaying captured CUDA graphs (render-state: three draws), 4 frames "
        f"with return_frames equal to eager _run_frame (colour tol {COLOR_TOL}), checksums sum(color), frames "
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

    def drive(label, demo, frames, per, out=None, srgb=False, profile=False, symbols_too=False):
        """One run of the driver's main(): its renderer captures the key's
        frame on the first frame (the counters count the eager warm-up and
        the capture) and replays it after; with ``symbols_too`` the run is
        under the profiler, which must see every frame's launches (the
        warm-up's and one replay a frame).  With ``out``, the PNGs written,
        the ring's count and the last PNG against render_frame."""
        argv = [demo, "--frames", str(frames), "--width", str(W), "--height", str(H)]
        argv += (["--out", str(demo_root / out)] if out else []) + (["--srgb"] if srgb else [])
        argv += ["--profile"] if profile else []
        reset_counts()
        if symbols_too:
            want = symbol_launches(per, frames + 1)
            res, syms = profiled(lambda: driver.main(argv), want)
            if syms != want:
                raise AssertionError(f"{label}: the profiler saw {syms}, expected {want}")
        else:
            res = driver.main(argv)
        launched = counts()[:nk]
        if res["presented"] != frames or not res["staging_pinned"]:
            raise AssertionError(f"{label}: presented {res['presented']} of {frames}, or staging not page-locked")
        if launched != tuple(2 * x for x in per[:nk]):
            raise AssertionError(f"{label}: launches {launched}, expected 2 x {per[:nk]} (warm-up and capture)")
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
        "cube --out --srgb": drive("cube --out --srgb", "cube", 10, cube_tile, out="cube_srgb", srgb=True,
                                   symbols_too=True),
        "big_mesh --out": drive("big_mesh --out", "big_mesh", 20, big, out="big_mesh"),
        "big_mesh": drive("big_mesh", "big_mesh", 20, big),
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
    programs = cube_r.num_cached_programs
    # A name of its own: a key of its own, never the built-in shader's graphs.
    if disk.name == pipe.shader:
        raise AssertionError(f"the shader file registered the built-in name {disk.name!r}")
    loaded = cube_r.render_frame(dataclasses.replace(pipe, shader=disk.name), mesh, uniforms(0.7))
    torch.cuda.synchronize()
    if counts()[:nk] != tuple(2 * x for x in cube_tile[:nk]) or cube_r.num_cached_programs != programs + 1:
        raise AssertionError(f"file shader frame launches {counts()}, expected B1 twice (warm-up and capture) in a "
                             f"new program ({cube_r.num_cached_programs - programs} new)")
    for k in ("tri_id", "depth_q", "color_planar"):
        if not torch.equal(getattr(loaded, k), getattr(builtin, k)):
            raise AssertionError(f"file shader frame: {k} differs from the built-in shader's")

    # A capture in the middle of present.render_loop: from frame 31 the
    # cube is drawn front-culled, a new key, captured while the earlier
    # frames' copies to the host are in flight and the present ring's
    # thread converts and writes PNGs (it makes no CUDA call).
    from based_renderer_tpu_torch import present

    class Switching:
        """render_loop's renderer: ``r``, drawing ``other`` from frame ``at + 1`` on."""

        def __init__(self, r, other, at):
            self.r, self.config, self.other, self.at, self.n = r, r.config, other, at, 0

        def render_frame(self, pipe, mesh, u, instances=None):
            self.n += 1
            return self.r.render_frame(self.other if self.n > self.at else pipe, mesh, u, instances=instances)

    sw_r = brt.Renderer(brt.RendererConfig(W, H))
    sw_pipe, sw_mesh, sw_u, _ = brt.demos.cube_demo(sw_r)
    front = dataclasses.replace(sw_pipe, cull_mode="front")
    sw_dir = demo_root / "switch"
    sw_dir.mkdir(parents=True)
    ring = runtime.PresentRing(W, H, depth=2, out_dir=str(sw_dir))
    reset_counts()
    try:
        _, sw_pacer = present.render_loop(Switching(sw_r, front, 30), (sw_pipe, sw_mesh, sw_u, None), frames=60,
                                          on_frame=lambda img, _: ring.submit(img))
        ring.flush()
        sw_presented = ring.presented
    finally:
        ring.close()
    sw_launched = counts()[:nk]
    sw_pngs = sorted(sw_dir.iterdir())
    sw_want = sw_r.render_frame(front, sw_mesh, sw_u(sw_pacer.t)).color_u8()
    if (sw_presented != 60 or len(sw_pngs) != 60 or sw_r.num_cached_programs != 2
            or sw_launched != tuple(4 * x for x in cube_tile[:nk])):
        raise AssertionError(f"mid-loop capture: presented {sw_presented}, {len(sw_pngs)} PNGs, "
                             f"{sw_r.num_cached_programs} programs, launches {sw_launched} (expected two captures)")
    if not np.array_equal(image.read_png(sw_pngs[-1]), sw_want):
        raise AssertionError("mid-loop capture: the last PNG differs from the front-culled frame's color_u8")
    print(
        f"[demo-driver] examples/render_demo_torch.py main() in this process at {W}x{H} (native runtime "
        f"{runtime.library_path().name}, g++ {rt_s:.2f} s, zlib.h present): PNG count = frames = "
        "PresentRing.presented, last PNG (zlib-decoded) = render_frame(t_last).color_u8() byte for byte (linear and "
        "sRGB), the counters B1 / B3 + B2 + S1 twice (the first frame's warm-up and capture, then replays), the profiler "
        "B1 x (frames + 1) over --srgb (the warm-up and one replay a frame), staging page-locked; fps over the whole "
        "loop (pacer's last window): "
        + "; ".join(f"{label} {res['frames']} frames {res['loop_fps']:.2f} ({res['fps']:.2f})"
                    for label, res in demo_runs.items())
        + f" | shader file {disk.name} at {W}x{H} through B1, a program of its own: tri_id, depth_q, colour bitwise "
        f"= built-in | a new key captured at frame 31 of a 60-frame render_loop with copies in flight and the "
        f"present ring writing: 60 PNGs, the last = the front-culled frame byte for byte, two captures | {card}",
        flush=True,
    )
    print("[demo-driver stages] cube --out --profile, StageTimer: "
          + " ; ".join(" ".join(line.split()) for line in demo_runs["cube --out --profile"]["report"].splitlines())
          + f" | {card}", flush=True)

    # ---- 11. multi-device rendering: 4 ranks sharing this card over gloo --
    # parallel.TiledRenderer on 4 processes (parallel/launch.py), all on
    # cuda:0: NCCL refuses two ranks on one device, so the ranks run over
    # gloo, which stages CUDA tensors through the host.  No time here is a
    # multi-GPU time.
    from based_renderer_tpu_torch import entry
    from based_renderer_tpu_torch.parallel import launch, workers

    torch.cuda.empty_cache()
    # A 480x1080 window cuts the 128x32 tile to 32x8, 16 times the tiles a
    # triangle spans: the pair budgets of these small draws (the 1024 floor)
    # overflow, in the JAX package too, so they get more pairs a triangle
    # (4096: the dry run's single full-window triangles span ~2000 tiles).
    def with_pairs(spec, factor):
        return {**spec, "draws": [{**d, "pipe": {**d.get("pipe", {}), "raster_pairs_factor": factor}}
                                  for d in spec["draws"]]}

    def before(spec):
        """The spec with one earlier frame of its key (its draws, meshes of
        their own): each rank's compared frame goes through a program made
        before it, a replay where the shard has no geometry axis."""
        return {**spec, "before": [spec["draws"]]}

    cube_spec = {"demo": "cube", "t": 0.5, "pipe": {"raster_pairs_factor": 512.0}}
    big_spec = {"demo": "big_mesh", "t": 0.3}
    tiled_runs = {
        "(a) cube 1920x1080 over (y=1, x=4)": (
            before({"mesh": (1, 4), "config": {"width": W, "height": H}, "draws": [cube_spec], "timing": 20}),
            per_frame(raster_tile=1)),
        "(b) big_mesh 3840x2160 over (y=2, x=2)": (
            before({"mesh": (2, 2), "config": {"width": W4K, "height": H4K}, "draws": [big_spec], "timing": 5}),
            big),
        "(c) big_mesh 1920x1080 over (y=1, x=1, g=4)": (
            before({"mesh": (1, 1, 4), "geometry_axis": "g", "config": {"width": W, "height": H},
                    "draws": [big_spec], "timing": 5}), big),
        "(d) MSAA-4x stencil + blend 1920x1080 over (y=1, x=4)": (
            before({**with_pairs(workers.dryrun_msaa_spec(W, H, (1, 4)), 4096.0), "timing": 10}),
            per_frame(raster_msaa4=3)),
        # The first call of a sequence runs its frame eagerly once and
        # captures it once: twice the frame's launches, whatever N is.
        "(e) cube sequence of 8 frames 1920x1080 over (y=1, x=4)": (
            {"mesh": (1, 4), "config": {"width": W, "height": H}, "draws": [cube_spec],
             "sequence": {"times": [0.05 * i for i in range(8)]}, "return_frames": True, "timing": 5},
            per_frame(raster_tile=2)),
    }
    t0 = time.perf_counter()
    ranks = launch.run(workers.run_specs, (1, 4), ([spec for spec, _ in tiled_runs.values()],), backend="gloo",
                       devices="cuda:0", timeout=900)
    tiled_s = time.perf_counter() - t0
    for i, (label, (spec, per)) in enumerate(tiled_runs.items()):
        res = [rank[i] for rank in ranks]
        # Tile-only frames: the earlier frame's warm-up and capture, then
        # the compared frame replays (no eager launch).  The geometry axis:
        # two eager frames.  The sequence: its own warm-up and capture.
        if "sequence" in spec:
            want, want_frame = dict(zip(KERNELS, per)), dict(zip(KERNELS, per))
        elif spec.get("geometry_axis"):
            want, want_frame = dict(zip(KERNELS, (2 * x for x in per))), dict(zip(KERNELS, per))
        else:
            want, want_frame = dict(zip(KERNELS, (2 * x for x in per))), dict.fromkeys(KERNELS, 0)
        for rank, r in enumerate(res):
            if r["launches"] != want or r["frame_launches"] != want_frame or r["programs"] != 1:
                raise AssertionError(f"{label}: rank {rank} launched {r['launches']} ({r['frame_launches']} in the "
                                     f"compared frame), {r['programs']} programs; expected {want} ({want_frame}), 1")
            if r["overflowed"]:
                raise AssertionError(f"{label}: rank {rank} overflowed")
        r0 = res[0]
        if "sequence" in spec:
            if not np.allclose(r0["sums"], r0["want_sums"], rtol=1e-5, atol=0) or len(set(r0["sums"].tolist())) < 8:
                raise AssertionError(f"{label}: checksums {r0['sums']} against one device's {r0['want_sums']}")
            if any(not np.array_equal(r["sums"], r0["sums"]) for r in res):
                raise AssertionError(f"{label}: the ranks' checksums differ")
            if not r0["frames_max_diff"] <= COLOR_TOL:
                raise AssertionError(f"{label}: frames differ from one device's by {r0['frames_max_diff']}")
            checks = (f"checksums within rtol 1e-5 of one device's (max rel diff "
                      f"{float(np.max(np.abs(r0['sums'] / r0['want_sums'] - 1))):.3g}), frames max diff "
                      f"{r0['frames_max_diff']:.3g} (bitwise {r0['frames_equal']})")
        else:
            for ref in ("vs_single", "vs_single_tile"):
                c = r0[ref]
                if not (c["tri_id"] and c["depth_q"] and c["stencil"] and c["covered"] > 0):
                    raise AssertionError(f"{label}: tri_id, depth_q or stencil differ from one device's ({ref}: {c})")
                if not c["color"] <= COLOR_TOL:
                    raise AssertionError(f"{label}: colour differs from one device's by {c['color']} ({ref})")
            checks = (f"tri_id, depth_q, stencil bitwise = one device's; colour max diff "
                      f"{r0['vs_single']['color']:.3g} (bitwise at the shard tile: "
                      f"{r0['vs_single_tile']['color_bitwise']})")
        ms = ", ".join(f"{r['ms']:.3f}" for r in res)
        merge = ""
        if "merge_ms_per_draw" in r0:
            merge = " | composite ms/draw per rank " + ", ".join(f"{r['merge_ms_per_draw']:.3f}" for r in res)
        launched = {k: v for k, v in r0["launches"].items() if v}
        how = ("a sequence" if "sequence" in spec else "the frame eager (geometry axis)" if spec.get("geometry_axis")
               else "the frame replayed")
        print(f"[tiled] {label}, 4 ranks sharing cuda:0 over gloo, {how}: launches per rank {launched}; {checks}; "
              f"ms/frame per rank (CUDA events, all 4 rendering) [{ms}] vs one device alone {r0['single_ms']:.3f}{merge} | {card}",
              flush=True)
    # entry(): the port's counterpart of __graft_entry__.entry().
    fn, args = entry.entry()
    got = fn(*args)
    pipe, mesh, uniforms, _ = brt.demos.cube_demo(cube_r)
    want_entry = cube_r.render_frame(pipe, mesh, uniforms(0.5), clear_color=(0.0, 0.0, 0.0, 0.0))
    for k, a in zip(("color_planar", "depth_q", "tri_id"), got[:3]):
        if not torch.equal(a, getattr(want_entry, k)):
            raise AssertionError(f"entry(): {k} differs from render_frame's")
    t0 = time.perf_counter()
    entry.dryrun_multichip(8)
    dry_s = time.perf_counter() - t0
    print(f"[entry] launch.run of the five tiled runs {tiled_s:.1f} s | entry() frame at {W}x{H} bitwise = "
          f"render_frame's | dryrun_multichip(8) on 8 gloo CPU ranks passed in {dry_s:.1f} s | the script so far "
          f"{time.perf_counter() - started:.1f} s | {card}", flush=True)

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
        "shade_blinn_phong": ("shade_blinn_phong.cu", "none: the JAX package shades with array code, fused by XLA"),
    }
    # B8's function is one PyTorch copy into a zeroed buffer; no single
    # PyTorch call computes a per-tile raster, the record assembly or the
    # shading.
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
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
