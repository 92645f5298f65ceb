"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the
result lines):
  1. device: CUDA present, the card's name and power limit (nvidia-smi);
  2. build: compiles csrc/*.cu with nvcc at first use;
  3. kernel vs plain: the raster kernel against its plain PyTorch version
     on the same binned records (cube 1920x1080, a 16384-triangle stress
     stream with exact depth ties and tiles of > 128 records, an init
     chain, greater_equal + depth clamp + scissor): tri_id and depth_q
     exact, float planes within 1e-6;
  4. oracle: tri_id and depth_q equal the numpy oracle's
     (based_renderer_tpu/reference/oracle.py, loaded by path: numpy only);
  5. end to end: Renderer at 1920x1080 with the cube demo and at 800x600
     with the triangle demo, 120 frames each, every frame through the
     kernel; median ms/frame of the kernel path and of the plain path.
Then one JSON line of per-kernel numbers, and last the device line.
Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FLOAT_TOL = 1e-6
FRAMES = 120


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def main() -> int:
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the vertex matmul stays full f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)

    sys.path.insert(0, str(ROOT))
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops import _build, raster
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.clip import clip_near
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import gather_triangles

    dev = torch.device("cuda")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = " ".join(line.strip() for line in _build.BUILD_LOG.splitlines() if "registers" in line or "smem" in line)
    print(f"[build] {_build.library_path().name} in {build_s:.2f} s | {ptxas or 'cached'}", flush=True)

    # ---- 3. kernel vs plain ---------------------------------------------
    def cube_tris(width, height, t):
        r = brt.Renderer(brt.RendererConfig(width, height), device=dev)
        pipe, mesh, uniforms, _ = brt.demos.cube_demo(r)
        u = {k: v.to(dev) for k, v in uniforms(t).items()}
        clip, var = brt.shader.get(pipe.shader).vertex(mesh.attributes, u)
        clip_tri, var_tri = clip_near(*gather_triangles(clip, var, None))
        return clip_tri, var_tri["color"]

    def binned_for(clip, color, width, height, tile=(128, 32), scissor=None, max_pairs=None):
        ts = setup_triangles(clip, width, height, scissor=scissor)
        b = bin_triangles(ts, width, height, *tile, max_pairs=max_pairs, channels=color)
        if bool(b.overflowed):
            raise AssertionError("binner overflowed")
        return b

    worst = {"float": 0.0}

    def compare(label, binned, width, height, init=None, **kw):
        args = (binned, width, height)
        kw = dict(num_channels=3, **kw)
        got = raster.rasterize_binned(*args, init=None if init is None else init[0], **kw)
        want = raster.rasterize_binned_reference(*args, init=None if init is None else init[1], **kw)
        torch.cuda.synchronize()
        (gv, gi, gw), (wv, wi, ww) = got, want
        for k in ("tri_id", "depth_q"):
            if not torch.equal(getattr(gv, k), getattr(wv, k)):
                bad = int((getattr(gv, k) != getattr(wv, k)).sum())
                raise AssertionError(f"{label}: {k} differs at {bad} pixels")
        diff = max(
            float((a - b).abs().max())
            for a, b in ((gv.b0, wv.b0), (gv.b1, wv.b1), (gv.b2, wv.b2), (gw, ww), (gi, wi))
        )
        if not diff <= FLOAT_TOL:
            raise AssertionError(f"{label}: float planes differ by {diff}")
        worst["float"] = max(worst["float"], diff)
        return got, want

    W, H = 1920, 1080
    cube_clip, cube_col = cube_tris(W, H, 0.5)
    cube_b = binned_for(cube_clip, cube_col, W, H)
    compare("cube", cube_b, W, H)
    s_clip_np, s_col_np = stress_clip()
    s_clip = torch.tensor(s_clip_np, device=dev)
    s_col = torch.tensor(s_col_np, device=dev)
    n_stress = s_clip.shape[0]
    stress_b = binned_for(s_clip, s_col, W, H, max_pairs=16 * n_stress)
    max_count = int(stress_b.tile_count.max())
    if max_count <= 128:
        raise AssertionError(f"stress stream's fullest tile has {max_count} records")
    compare("stress", stress_b, W, H)
    half = n_stress // 2
    first = compare("init-a", binned_for(s_clip[:half], s_col[:half], W, H), W, H)
    second_b = bin_triangles(
        setup_triangles(s_clip[half:], W, H), W, H, 128, 32, channels=s_col[half:], id_offset=half
    )
    compare("init-b", second_b, W, H, init=(first[0][0], first[1][0]))
    sc = (97, 61, 1803, 1001)
    sc_b = binned_for(s_clip, s_col, W, H, tile=(64, 64), scissor=sc, max_pairs=16 * n_stress)
    compare("ge-clamp-scissor", sc_b, W, H, tile_w=64, tile_h=64,
            depth_compare="greater_equal", depth_clip="clamp", depth_clear=0.0, scissor=sc)
    ms_cube = cuda_ms(lambda: raster.rasterize_binned(cube_b, W, H, num_channels=3), 50)
    plain_cube = cuda_ms(lambda: raster.rasterize_binned_reference(cube_b, W, H, num_channels=3), 10)
    ms_stress = cuda_ms(lambda: raster.rasterize_binned(stress_b, W, H, num_channels=3), 20)
    plain_stress = cuda_ms(lambda: raster.rasterize_binned_reference(stress_b, W, H, num_channels=3), 3)
    print(
        f"[kernel-vs-plain] cube, stress ({n_stress} tris, fullest tile {max_count} records), "
        f"init chain, greater_equal+clamp+scissor: ints exact, max float diff {worst['float']:.3g} "
        f"(tol {FLOAT_TOL}) | raster ms kernel/plain: cube {ms_cube:.4f}/{plain_cube:.4f}, "
        f"stress {ms_stress:.4f}/{plain_stress:.4f} | {card}",
        flush=True,
    )

    # ---- 4. oracle ------------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "brt_oracle", ROOT / "based_renderer_tpu" / "reference" / "oracle.py"
    )
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    for label, clip in (("cube", cube_clip), ("stress[:2048]", s_clip[:2048])):
        want = oracle.rasterize(clip.cpu().numpy(), W, H)
        got, overflowed = raster.rasterize_vis(
            setup_triangles(clip, W, H), W, H, max_pairs=max(16 * clip.shape[0], 4096), return_overflow=True
        )
        if bool(overflowed):
            raise AssertionError(f"oracle {label}: binner overflowed")
        for k in ("tri_id", "depth_q"):
            g = getattr(got, k).cpu().numpy()
            if not np.array_equal(g, want[k]):
                raise AssertionError(f"oracle {label}: {k} differs at {int((g != want[k]).sum())} pixels")
    print(f"[oracle] cube ({cube_clip.shape[0]} tris) and stress[:2048] at {W}x{H}: tri_id, depth_q bit-exact", flush=True)

    # ---- 5. end to end --------------------------------------------------
    def run_frames(width, height, demo, frames):
        r = brt.Renderer(brt.RendererConfig(width, height))
        pipe, mesh, uniforms, _ = getattr(brt.demos, demo)(r)
        times, overflow, finite, covered = [], None, None, None
        for i in range(frames):
            u = uniforms(0.05 * i)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            f = r.render_frame(pipe, mesh, u)
            end.record()
            times.append((start, end))
            ok = torch.isfinite(f.color_planar).all()
            cov = (f.tri_id >= 0).sum()
            overflow = f.overflowed if overflow is None else overflow | f.overflowed
            finite = ok if finite is None else finite & ok
            covered = cov if covered is None else torch.minimum(covered, cov)
        torch.cuda.synchronize()
        if bool(overflow) or not bool(finite) or int(covered) <= 0:
            raise AssertionError(f"{demo}: overflowed={bool(overflow)} finite={bool(finite)} covered={int(covered)}")
        if tuple(f.color_planar.shape) != (4, height, width):
            raise AssertionError(f"{demo}: color shape {tuple(f.color_planar.shape)}")
        return statistics.median(s.elapsed_time(e) for s, e in times), int(covered)

    raster.KERNEL_LAUNCHES = 0
    cube_ms, cube_cov = run_frames(W, H, "cube_demo", FRAMES)
    if raster.KERNEL_LAUNCHES != FRAMES:
        raise AssertionError(f"cube frames launched the kernel {raster.KERNEL_LAUNCHES} times, not {FRAMES}")
    tri_ms, tri_cov = run_frames(800, 600, "triangle_demo", FRAMES)
    launches = raster.KERNEL_LAUNCHES
    if launches != 2 * FRAMES:
        raise AssertionError(f"the two demos launched the kernel {launches} times, not {2 * FRAMES}")

    kernel_fn = raster.rasterize_binned
    raster.rasterize_binned = raster.rasterize_binned_reference  # the plain path, for timing only
    try:
        plain_cube_ms, _ = run_frames(W, H, "cube_demo", FRAMES)
        plain_tri_ms, _ = run_frames(800, 600, "triangle_demo", FRAMES)
    finally:
        raster.rasterize_binned = kernel_fn
    if raster.KERNEL_LAUNCHES != launches:
        raise AssertionError("the plain path launched the kernel")
    print(
        f"[end-to-end] {FRAMES} frames each, kernel launches {launches}; median ms/frame "
        f"kernel/plain: cube 1920x1080 {cube_ms:.3f}/{plain_cube_ms:.3f} (min covered {cube_cov} px), "
        f"triangle 800x600 {tri_ms:.3f}/{plain_tri_ms:.3f} (covered {tri_cov} px) | {card}",
        flush=True,
    )

    print(json.dumps({"kernels": [{
        "name": "raster_tile",
        "route": "cuda",
        "source": "based_renderer_tpu_torch/csrc/raster_tile.cu",
        "replaces": "based_renderer_tpu/ops/raster_pallas.py:58",
        "launches": launches,
        "max_abs_err": worst["float"],
        "ms": ms_cube,
        "plain_ms": plain_cube,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
