"""The big_mesh demo's pair budget over one whole turn of its model.

    python3 sweep_pair_budget.py [--width 3840 --height 2160 --msaa 4] [--triangles 1000000]
                                 [--meshes benchmark demo] [--check] [--out build/sweep.jsonl]

For each mesh (the benchmark's ``procedural_mesh`` scene, mesh_seed 0, and
the demo's generated mesh) it renders one-frame ``render_sequence`` calls
over the model's period (4 pi s of animation at 0.5 rad/s) at dt 1/60, then
at dt 1/600 within 0.5 s of the worst frames, and reads each call's
``last_sequence_pair_budget_use``, the renderer's own count:

- measuring (the default): the demo's pipeline with a generous budget,
  ``raster_pairs_factor`` 4.0, reads extras / 3T with no slot cut, and with
  a slot cut of 1024 it reads true pairs / 1024; so each view's extra tiles
  and true (tile, triangle) pairs, per triangle, and the worst of each;
- ``--check``: the demo's own budget (``demos.big_mesh_budget``), the
  largest share of it any view needs and the views that overflow it.

One JSON line per mesh and pass, and a summary line last.  Needs a CUDA
device unless ``--device cpu`` (small sizes only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from based_renderer_tpu_torch.models import demos  # noqa: E402
from based_renderer_tpu_torch.renderer import Renderer, RendererConfig  # noqa: E402
from based_renderer_tpu_torch.scene import Mesh  # noqa: E402
from benchmark.reference.scenes import procedural_mesh  # noqa: E402

PERIOD_S = procedural_mesh.PERIOD_S
MEASURE_PAIRS = 4.0  # the budget the readings are taken under
PAIR_SLOTS = 1024  # a slot cut this small makes the count read true pairs / 1024


def meshes(r: Renderer, triangles: int, names):
    """{name: (mesh, uniforms_fn)} on the renderer's device."""
    out = {}
    aspect = r.config.width / r.config.height
    args = {"triangles": triangles, "mesh_seed": 0}
    for name in names:
        if name == "benchmark":
            attrs = procedural_mesh.mesh(0, args, r.device)
            out[name] = (Mesh(attributes=attrs, indices=None),
                         lambda t: procedural_mesh.uniforms(float(t), aspect, args))
        else:
            _, mesh, uniforms, _ = demos.big_mesh_demo(r, triangles=triangles, generated=True)
            out[name] = (mesh, uniforms)
    return out


def reads(r: Renderer, pipe, mesh, uniforms, times) -> np.ndarray:
    """Each time's pair budget use, one one-frame sequence a time."""
    got = []
    for t in times:
        r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=1, t0=float(t))
        got.append(float(r.last_sequence_pair_budget_use))
    return np.asarray(got, dtype=np.float64)


def orbit() -> np.ndarray:
    """The period at dt 1/60."""
    return np.arange(int(round(PERIOD_S * 60))) / 60.0


def near(*t_worst: float) -> np.ndarray:
    """dt 1/600 within 0.5 s of each worst time."""
    return np.unique(np.concatenate([t + (np.arange(601) - 300) / 600.0 for t in t_worst]))


def measure(r, base, mesh, uniforms, times) -> dict:
    """Per time: extras and true pairs per triangle."""
    triangles = mesh.num_triangles
    eb = int(triangles * MEASURE_PAIRS) - triangles
    extras = dataclasses.replace(base, raster_pairs_factor=MEASURE_PAIRS, raster_slots_factor=None)
    pairs = dataclasses.replace(extras, raster_slots_factor=PAIR_SLOTS / triangles / 2)
    e = np.rint(reads(r, extras, mesh, uniforms, times) * eb)
    p = np.rint(reads(r, pairs, mesh, uniforms, times) * PAIR_SLOTS)
    if not (e <= eb).all():
        raise AssertionError(f"a view needs more than {MEASURE_PAIRS} pairs a triangle: raise MEASURE_PAIRS")
    return {"extras": e / triangles, "pairs": p / triangles}


def worst(times, values) -> dict:
    i = int(np.argmax(values))
    return {"value": float(values[i]), "t": float(times[i])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=3840)
    p.add_argument("--height", type=int, default=2160)
    p.add_argument("--msaa", type=int, default=4)
    p.add_argument("--triangles", type=int, default=1_000_000)
    p.add_argument("--meshes", nargs="+", default=["benchmark", "demo"], choices=["benchmark", "demo"])
    p.add_argument("--check", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    t_start = time.perf_counter()
    r = Renderer(RendererConfig(a.width, a.height, msaa=a.msaa), device=a.device)
    base = demos.big_mesh_demo(r, triangles=a.triangles, generated=True)[0]
    lines, summary = [], {"width": a.width, "height": a.height, "msaa": a.msaa, "triangles": a.triangles,
                          "budget": demos.big_mesh_budget(a.width, a.msaa, a.triangles)}
    for name, (mesh, uniforms) in meshes(r, a.triangles, a.meshes).items():
        coarse = orbit()
        if a.check:
            use = reads(r, base, mesh, uniforms, coarse)
            fine = near(worst(coarse, use)["t"])
            use_fine = reads(r, base, mesh, uniforms, fine)
            got = {"mesh": name, "check": True, "worst_use": worst(coarse, use), "worst_use_fine": worst(fine, use_fine),
                   "overflowed_t": [float(t) for t, u in zip(np.concatenate([coarse, fine]),
                                                             np.concatenate([use, use_fine])) if u > 1]}
        else:
            c = measure(r, base, mesh, uniforms, coarse)
            fine = near(worst(coarse, c["extras"])["t"], worst(coarse, c["pairs"])["t"])
            f = measure(r, base, mesh, uniforms, fine)
            got = {"mesh": name, "check": False,
                   **{f"worst_{k}": worst(coarse, c[k]) for k in c}, **{f"worst_{k}_fine": worst(fine, f[k]) for k in f},
                   "frames": [len(coarse), len(fine)]}
        got["triangles"] = mesh.num_triangles
        got["seconds"] = time.perf_counter() - t_start
        print(json.dumps(got), flush=True)
        lines.append(got)
    summary["device"] = torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu"
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as fh:
            for x in lines + [summary]:
                fh.write(json.dumps(x) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
