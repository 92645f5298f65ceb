"""One run of one cell: set the program up from the cell's files, drive its
traffic, compare what it made with the reference, and read the metrics.

``run`` takes the device as an argument so that the CPU tests can drive a
whole run at a small size; ``benchmark/run.py`` is the entry point that
insists on the chip.
"""

from __future__ import annotations

import copy
import gc
import os
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import render as ref_render
from . import compare, loops, spec
from .loops import Cell, Measured
from .work import least_seconds
from .work import raster_work as stage_work

#: Where the program's build caches live: fixed directories inside the checkout.
CACHE_DIR = spec.ROOT / "build"


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict  # name -> {"value", "unit"}
    device: dict
    checks: dict  # name -> {"value", "limit"}
    breakdown: dict | None = None
    notes: list = field(default_factory=list)  # lines for standard error

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks  # last, as the numbers compared
        return out


def point_caches(environ=os.environ) -> None:
    """Every build and kernel cache of the program in fixed directories of
    the checkout, so that only a checkout's first run builds."""
    environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))


def merge(base: dict, overrides: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (overrides or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def check_pipeline(pipe, stated: dict) -> None:
    """The demo's pipeline has the state the configuration states and the
    reference implements.  ``depth_clip`` is true where the configuration
    does not state it; the other depth fields are the reference's own."""
    got = {"shader": pipe.shader, "cull_mode": pipe.cull_mode, "front_face": pipe.front_face,
           "near_clip": pipe.near_clip, "perspective_correct": pipe.perspective_correct,
           "depth": [pipe.depth.test, pipe.depth.write, pipe.depth.compare, pipe.depth.clip],
           "blend": pipe.blend.enable, "stencil": pipe.stencil.enable, "depth_bias": pipe.depth.bias_enable}
    want = {"shader": stated["shader"], "cull_mode": stated["cull_mode"], "front_face": stated["front_face"],
            "near_clip": stated["near_clip"], "perspective_correct": True,
            "depth": [True, True, "less", stated.get("depth_clip", True)],
            "blend": False, "stencil": False, "depth_bias": False}
    if got != want:
        raise spec.SpecError(f"the demo's pipeline {got} is not the one the configuration states {want}")


def _device_line(dev: torch.device, peak: int, trace=None) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
    return out


class Readings:
    """What a per-layer metric's reader reads (``benchmark/metrics/``)."""

    def __init__(self, m: Measured, raster_work):
        self.e2e = m.e2e
        self.spans = m.spans
        self.capture_s = m.capture_s
        self.trace = m.trace
        self.traced_frames = m.traced_frames
        self.traced_times = m.traced_times
        self._raster_work = raster_work
        self._work = None

    def raster_work(self):
        """(bytes, integer operations) the raster stage of the traced frames
        needs in all, from the frames' inputs."""
        if self._work is None:
            self._work = self._raster_work(self.traced_times)
        return self._work


@dataclass
class Measurement:
    """A cell's traffic driven and the program's state freed: what the
    comparison and the readers need."""

    m: Measured
    cfg: dict
    traffic: dict
    scene: object
    attrs: dict  # the benchmark's mesh attributes, on the device
    instances: dict | None  # the scene's instance table, on the device
    device: torch.device
    stamps: dict  # set-up phases, seconds since process start


def measure(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device, t_process: float,
            overrides: dict | None = None) -> Measurement:
    """Set the program up for the cell, drive its traffic, then free the
    program.  ``overrides`` (tests only) replaces keys of the
    configuration, and under ``"traffic"`` of the mix."""
    cell = spec.cell(bench, workload)
    overrides = dict(overrides or {})
    traffic = merge(spec.traffic(cell["traffic"]), overrides.pop("traffic", None))
    cfg = merge(spec.config(bench, cell["config"]), overrides)
    run_loop = loops.LOOPS[traffic["loop"]]

    point_caches()
    from based_renderer_tpu_torch.models import demos
    from based_renderer_tpu_torch.renderer import Renderer, RendererConfig
    from based_renderer_tpu_torch.scene import Mesh
    from based_renderer_tpu_torch.utils import cache

    stamps = {"imported": time.perf_counter() - t_process}
    cache.enable_persistent_cache(str(CACHE_DIR))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    stamps["device"] = time.perf_counter() - t_process
    scene = ref_render.scene(cfg["scene"])
    args = cfg.get("scene_args", {})
    w, h = cfg["width"], cfg["height"]
    renderer = Renderer(RendererConfig(w, h, msaa=cfg["msaa"]), device=dev)
    pipeline = demos.DEMOS[cfg["demo"]](renderer, **cfg.get("demo_args", {}))[0]
    check_pipeline(pipeline, cfg["reference"])
    attrs = scene.mesh(seed, args, dev)
    instances = ref_render.scene_instances(scene, seed, args, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["scene"] = time.perf_counter() - t_process
    c = Cell(workload=workload, traffic=traffic, seed=seed, seconds=seconds, trace=trace, device=dev,
             renderer=renderer, pipeline=pipeline, mesh=Mesh(attributes=dict(attrs), indices=None), scene=scene,
             scene_args=args, aspect=w / h, t_anim0=scene.start_time(seed), t_process=t_process,
             rng=np.random.default_rng([seed, 3]), instances=instances)
    m = run_loop(c)
    stamps["capture"] = m.capture_s
    stamps["window_start"] = m.e2e["setup_s"]

    # The window has closed and the peak is read: free the program's state
    # before the reference runs on the same device.
    del c, renderer, pipeline
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Measurement(m, cfg, traffic, scene, attrs, instances, dev, stamps)


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device, t_process: float,
        overrides: dict | None = None) -> Result:
    """One run of the cell: its metrics, and ``correct`` from the comparison."""
    limits = spec.limits(workload)
    wanted = spec.metrics(bench, workload, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in wanted} if trace else {}
    meas = measure(bench, workload, seed, seconds, trace, device, t_process, overrides)
    m, cfg, scene, attrs, instances, dev = meas.m, meas.cfg, meas.scene, meas.attrs, meas.instances, meas.device
    w, h = cfg["width"], cfg["height"]
    args = cfg.get("scene_args", {})
    t_cmp = time.perf_counter()
    values = compare.numbers(m.frames, compare.reference_for(cfg, scene, attrs, w / h, instances=instances))
    ok, checks = compare.judge(values, limits)
    result = Result(correct=ok and m.failed == 0 and m.attempted > 0, attempted=m.attempted, failed=m.failed,
                    metrics={}, device=_device_line(dev, m.memory_peak, m.trace), checks=checks)
    result.notes.append(f"{workload} seed {seed}: {m.attempted} frames in the window, {m.failed} overflowed, "
                        f"{len(m.frames)} compared at t = {[round(f['t'], 6) for f in m.frames]} "
                        f"in {time.perf_counter() - t_cmp:.3f} s")
    result.notes.append("set-up, seconds since process start: "
                        + ", ".join(f"{k} {v:.3f}" for k, v in meas.stamps.items()))
    if dev.type == "cuda":
        result.notes.append(f"card: {_card()}")
    if not trace:
        for metric in wanted:
            if metric["name"] not in m.e2e:
                raise spec.SpecError(f"the {meas.traffic['loop']} loop measures no {metric['name']}")
            result.metrics[metric["name"]] = {"value": m.e2e[metric["name"]], "unit": metric["unit"]}
        return result

    samples = w * h * cfg["msaa"]

    def raster_work(times):
        total_b = total_ops = 0.0
        for t in times:
            clip, _, _ = ref_render.clip_space(cfg["reference"], attrs, scene.uniforms(t, w / h, args),
                                               instances=instances)
            offsets = ref_render.raster.MSAA4_OFFSETS if cfg["msaa"] == 4 else ref_render.raster.CENTER
            s = ref_render.raster.setup(clip, w, h, offsets, cfg["reference"]["cull_mode"],
                                        cfg["reference"]["front_face"])
            n = int(s.index.numel())
            bbox = int(((s.x1 - s.x0) * (s.y1 - s.y0)).sum()) * len(offsets) if n else 0
            b, ops = stage_work(samples, n, bbox)
            total_b += b
            total_ops += ops
        return total_b, total_ops

    readings = Readings(m, raster_work)
    for metric in wanted:
        value = readers[metric["name"]].read(readings)
        if value is not None:
            result.metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    if m.trace is not None:
        b, ops = readings.raster_work()
        result.notes.append(f"traced {m.traced_frames} frames in {m.trace.window_s:.6f} s; raster work "
                            f"{b:.0f} bytes, {ops:.0f} int ops, bound by {least_seconds(b, ops)[1]}")
        result.breakdown = {"device_ops": m.trace.top_ops(), "idle_gaps": m.trace.idle_gaps()}
    return result


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else f"nvidia-smi: {out.stderr.strip()}"
