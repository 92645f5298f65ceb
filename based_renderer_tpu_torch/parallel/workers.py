"""Functions that parallel/launch.py runs on every rank, and the frames they
are held against: the rank side of the multi-device tests, of
``chip_smoke.py``'s tiled phase and of ``entry.dryrun_multichip``.  Its
public functions are launch targets (``run_specs``, ``merge_check``,
``dryrun``) and the helpers their callers share (``override``,
``dryrun_msaa_spec``, ``factor2``).

A frame is described by a picklable spec, so that one description drives
the ranks, the single-device frame it is compared with and, in the tests,
the JAX package's frame:

    {"mesh": (ny, nx) or (ny, nx, ng), "geometry_axis": None or "g",
     "config": RendererConfig fields, "clear": begin_frame's keywords,
     "draws": [draw, ...],
     "sequence": None, {"times": [t, ...]} or {"n": N, "t0": t0, "dt": dt},
     "return_frames": bool, "expect": None or an exception's class name,
     "arrays": bool, "timing": frames to time (0: none),
     "before": [[draw, ...], ...]: frames each rank renders first, on the
     same TiledRenderer (the single device renders only the last)}

A draw is {"demo": name, "kw": demo keywords, "t": time, "pipe": overrides}
(a demo of models/demos.py with its uniforms at t), or {"scale": s,
"attrs": {...}, "uniforms": {...}, "pipe": overrides} (the triangle of
models/geometry.py, scaled by s, under a default Pipeline).  ``pipe``
overrides pipeline fields; a dict value overrides the fields of a nested
state (``{"depth": {"compare": "greater"}}``).  A sequence takes the one
demo draw's uniforms at the listed times (stacked, uniforms_seq) or its
uniforms function (uniforms_fn, N frames from t0 by dt).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import demos, geometry
from ..ops import _build
from ..pipeline import Pipeline
from ..renderer import FrameResult, Renderer, RendererConfig, shard_tile
from ..utils import profiling
from .launch import make_mesh
from .tiled import TiledRenderer

def override(obj, changes: dict):
    """``obj`` (a dataclass of either package) with ``changes``; a dict value
    overrides the fields of the nested dataclass it names."""
    changes = {
        k: override(getattr(obj, k), v) if isinstance(v, dict) and dataclasses.is_dataclass(getattr(obj, k)) else v
        for k, v in changes.items()
    }
    return dataclasses.replace(obj, **changes)


def _scene(target, draws) -> list:
    """[(pipeline, mesh, uniforms, instances)] of the draw specs, uploaded on
    ``target`` (a Renderer or a TiledRenderer)."""
    out = []
    for d in draws:
        if "demo" in d:
            pipe, mesh, uniforms, inst = demos.DEMOS[d["demo"]](target, **d.get("kw", {}))
            u = uniforms(d["t"])
        else:
            pos = geometry.triangle_mesh_data()["positions"] * np.float32(d.get("scale", 1.0))
            mesh = target.upload_mesh(pos, **{k: np.asarray(v, np.float32) for k, v in d.get("attrs", {}).items()})
            pipe, u, inst = Pipeline(), dict(d.get("uniforms", {})), None
        out.append((override(pipe, d.get("pipe", {})), mesh, u, inst))
    return out


def _prepare(target, spec):
    """A function that renders the spec's frame (a FrameResult) or sequence
    ((checksums, colours or None)) on ``target``, with its meshes, instance
    tables and uniforms made once.  The frame function takes an optional
    ``tile_extent``: every draw then rasterizes at the tile a shard of that
    extent uses."""
    seq = spec.get("sequence")
    if seq:
        d = spec["draws"][0]
        pipe, mesh, uniforms, inst = demos.DEMOS[d["demo"]](target, **d.get("kw", {}))
        pipe = override(pipe, d.get("pipe", {}))
        kw = dict(instances=inst, return_frames=spec.get("return_frames", False))
        if "times" in seq:
            frames = [uniforms(t) for t in seq["times"]]
            useq = {k: torch.stack([torch.as_tensor(np.asarray(f[k])) for f in frames]) for k in frames[0]}
            kw["uniforms_seq"] = useq
        else:
            kw.update(uniforms_fn=uniforms, num_frames=seq["n"], t0=seq["t0"], dt=seq["dt"])

        def run_sequence():
            out = target.render_sequence(pipe, mesh, **kw)
            return out if kw["return_frames"] else (out, None)

        return run_sequence
    cfg = target.config
    scale = 2 if (cfg.msaa == 4 and cfg.msaa_supersample) else 1
    draws = _scene(target, spec["draws"])

    def run_frame(tile_extent=None):
        target.begin_frame(**spec.get("clear", {}))
        for pipe, mesh, u, inst in draws:
            if tile_extent is not None:
                tile = shard_tile(pipe.raster_tile, (tile_extent[0] * scale, tile_extent[1] * scale))
                pipe = dataclasses.replace(pipe, raster_tile=tile)
            target.draw(pipe, mesh, u, inst)
        return target.end_frame()

    return run_frame


def _compare(got: FrameResult, want: FrameResult) -> dict:
    """tri_id, depth_q and stencil equal, and the colours' largest difference."""
    same_stencil = (got.stencil is None) == (want.stencil is None)
    if same_stencil and got.stencil is not None:
        same_stencil = torch.equal(got.stencil, want.stencil)
    return {
        "tri_id": torch.equal(got.tri_id, want.tri_id),
        "depth_q": torch.equal(got.depth_q, want.depth_q),
        "stencil": same_stencil,
        "color": float((got.color_planar - want.color_planar).abs().max()),
        "color_bitwise": torch.equal(got.color_planar, want.color_planar),
        "covered": int((want.tri_id >= 0).sum()),
    }


def _numpy(f: FrameResult) -> dict:
    out = {"color": f.color_np(), "tri_id": f.tri_id.cpu().numpy(), "depth_q": f.depth_q.cpu().numpy()}
    out["stencil"] = None if f.stencil is None else f.stencil.cpu().numpy()
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms_per_frame(fn, n: int, device) -> float:
    """Milliseconds per call of ``fn`` over n calls (the caller warms it
    up): CUDA events on the card, the host clock on the CPU."""
    _sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def run_spec(world_mesh, spec) -> dict:
    """One spec on this rank: its kernel launches (all of them, and those
    of the spec's own frame or call after the ``before`` frames), its
    program count (and with ``timing``, its ms per frame, and per draw the
    geometry merge's), and on rank 0 the comparison with the
    single-device frame on the same device (and the whole frame as numpy
    when ``spec["arrays"]``).  An exception of the class
    ``spec["expect"]`` is caught and reported."""
    mesh = make_mesh(spec["mesh"], world_mesh.device_type)
    cfg = RendererConfig(**spec.get("config", {}))
    is_seq = bool(spec.get("sequence"))
    before = profiling.ROUTES_TAKEN.copy()
    try:
        tr = TiledRenderer(cfg, mesh, spec.get("geometry_axis"))
        for draws in spec.get("before", []):
            _prepare(tr, {**spec, "draws": draws})()
        render = _prepare(tr, spec)
        mid = profiling.ROUTES_TAKEN.copy()
        got = render()
    except Exception as e:  # an expected rejection is the result; anything else fails the run
        if type(e).__name__ != spec.get("expect"):
            raise
        return {"raised": type(e).__name__, "message": str(e)}
    if spec.get("expect"):
        raise AssertionError(f"expected {spec['expect']}, nothing was raised")
    after = profiling.ROUTES_TAKEN
    dev = tr.device
    res = {"launches": {k: after[k] - before[k] for k in _build.ROUTES},
           "frame_launches": {k: after[k] - mid[k] for k in _build.ROUTES}, "shard": tuple(tr.shard[:2]),
           "programs": tr.num_cached_programs}
    if is_seq:
        sums, frames = got
        res["overflowed"] = bool(tr.last_sequence_overflowed)
        res["sums"] = sums.cpu().numpy()
        if frames is not None:
            n, _, h, w = frames.shape
            full = tr.gather_windows(frames.reshape(n * 4, h, w))
            frames = full.reshape(n, 4, *full.shape[-2:])
    else:
        res["window"] = tuple(got.tri_id.shape)
        res["overflowed"] = bool(got.overflowed)
        full = tr.full_frame(got)
    per_call = 1  # frames per call of render
    if is_seq:
        per_call = len(spec["sequence"]["times"]) if "times" in spec["sequence"] else spec["sequence"]["n"]
    timing = spec.get("timing", 0)
    if timing:
        render()  # a warm-up outside both clocks
        tr.clock_merges()
        dist.barrier()
        res["ms"] = _ms_per_frame(render, timing, dev) / per_call
        if tr.merge_calls:
            res["merge_calls"] = tr.merge_calls
            res["merge_ms_per_draw"] = tr.merge_ms / tr.merge_calls
    dist.barrier()
    if dist.get_rank() == 0:
        single = Renderer(cfg, device=dev)
        render_single = _prepare(single, spec)
        want = render_single()
        if is_seq:
            res["want_sums"] = want[0].cpu().numpy()
            if frames is not None:
                res["frames_equal"] = torch.equal(frames, want[1])
                res["frames_max_diff"] = float((frames - want[1]).abs().max())
        else:
            res["vs_single"] = _compare(full, want)
            res["vs_single_tile"] = _compare(full, render_single(tr.shard.extent))
            if spec.get("arrays"):
                res["arrays"] = _numpy(full)
        if timing:
            render_single()  # a warm-up outside the clock
            res["single_ms"] = _ms_per_frame(render_single, timing, dev) / per_call
    dist.barrier()
    return res


def run_specs(world_mesh, specs) -> list:
    """launch.run's target: every spec in order, on every rank."""
    return [run_spec(world_mesh, spec) for spec in specs]


def merge_check(world_mesh, input_sets, depth_states) -> list:
    """parallel.tiled.merge_vis_over_axis over the "g" group, on this rank's
    slice of each input set (numpy (ng, ...) arrays: tri_id, depth_q, b0,
    b1, b2, interp, invw), once per depth state (a dict of DepthState
    fields): per set, per state, the merged planes as numpy."""
    from ..ops.raster import VisBuffer
    from ..pipeline import DepthState
    from .tiled import merge_vis_over_axis

    group = world_mesh.get_group("g")
    g = dist.get_rank(group)
    out = []
    for inputs in input_sets:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[g])) for k, v in inputs.items()}
        vis = VisBuffer(*(mine[k] for k in ("tri_id", "depth_q", "b0", "b1", "b2")))
        merged_sets = []
        for state in depth_states:
            merged, (interp, invw) = merge_vis_over_axis(vis, [mine["interp"], mine["invw"]], group,
                                                          DepthState(**state))
            planes = {k: getattr(merged, k).numpy() for k in ("tri_id", "depth_q", "b0", "b1", "b2")}
            merged_sets.append({**planes, "interp": interp.numpy(), "invw": invw.numpy()})
        out.append(merged_sets)
    return out


def dryrun(world_mesh, n_devices: int) -> None:
    """The JAX package's _dryrun_body (__graft_entry__.py:90-185) on a world
    of n ranks: the cube over the world's mesh (tiles, and a geometry axis
    if it has one), then over a pure tile
    mesh a coverage-MSAA-4x frame of a scissored cube, a stencil-writing
    triangle and a stencil-tested alpha-blended triangle."""
    dev_type = world_mesh.device_type
    shape = dict(zip(world_mesh.mesh_dim_names, world_mesh.shape))
    width, height = 32 * shape["x"], 16 * shape["y"]
    cfg = RendererConfig(width=width, height=height, raster_backend="pallas")
    tr = TiledRenderer(cfg, world_mesh, geometry_axis="g" if "g" in shape else None)
    pipe, scene_mesh, uniforms, _ = demos.cube_demo(tr)
    tr.begin_frame()
    tr.draw(pipe, scene_mesh, uniforms(0.5))
    f = tr.full_frame(tr.end_frame())
    color = f.color_np()
    if color.shape != (height, width, 4) or not np.isfinite(color).all():
        raise AssertionError(f"dry run frame 1: colour {color.shape}, finite {np.isfinite(color).all()}")
    if not bool((f.tri_id >= 0).any()):
        raise AssertionError("cube not visible in dry run")

    ny2, nx2 = factor2(n_devices)
    w2, h2 = 32 * nx2, 16 * ny2
    spec = dryrun_msaa_spec(w2, h2, (ny2, nx2))
    tr2 = TiledRenderer(RendererConfig(**spec["config"]), make_mesh(spec["mesh"], dev_type))
    f2 = tr2.full_frame(_prepare(tr2, spec)())
    c2 = f2.color_np()
    if c2.shape != (h2, w2, 4) or not np.isfinite(c2).all():
        raise AssertionError(f"dry run frame 2: colour {c2.shape}, finite {np.isfinite(c2).all()}")
    if tuple(f2.tri_id.shape) != (4, h2, w2):
        raise AssertionError(f"dry run frame 2: tri_id {tuple(f2.tri_id.shape)}, not per-sample layers")
    if not bool((f2.stencil == 7).any()):
        raise AssertionError("stencil write not visible")


def factor2(n: int) -> tuple:
    """(ny, nx) with ny the largest divisor of n not above sqrt(n)."""
    ny = math.isqrt(n)
    while n % ny:
        ny -= 1
    return ny, n // ny


def dryrun_msaa_spec(width: int, height: int, mesh) -> dict:
    """The dry run's second frame: coverage MSAA-4x, a cube scissored 4 px
    in from every edge, a triangle writing stencil 7, and a triangle
    tested against it and alpha-blended."""
    flat = {"shader": "flat_ndc", "depth": {"test": False, "write": False}}
    return {
        "mesh": tuple(mesh),
        "config": {"width": width, "height": height, "msaa": 4, "raster_backend": "pallas"},
        "draws": [
            {"demo": "cube", "t": 0.5, "pipe": {"scissor": (4, 4, width - 4, height - 4)}},
            {"uniforms": {"color": (1.0, 0.0, 0.0, 1.0)},
             "pipe": {**flat, "stencil": {"enable": True, "compare": "always", "ref": 7, "pass_op": "replace"}}},
            {"uniforms": {"color": (0.0, 1.0, 0.0, 0.5)},
             "pipe": {**flat, "stencil": {"enable": True, "compare": "equal", "ref": 7},
                      "blend": {"enable": True, "src_factor": "src_alpha", "dst_factor": "one_minus_src_alpha"}}},
        ],
    }
