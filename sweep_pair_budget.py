"""A demo's pair budget over one whole period of its animation.

    python3 sweep_pair_budget.py [--scene big_mesh] [--width 3840 --height 2160 --msaa 4]
                                 [--triangles 1000000] [--meshes benchmark demo] [--check]
                                 [--out build/sweep.jsonl]
    python3 sweep_pair_budget.py --scene instanced [--width 1920 --height 1080 --msaa 1]
                                 [--count 10000] [--seeds 1 2 3] [--meshes benchmark demo] [--check]

``--scene big_mesh`` (the default) sweeps the big_mesh demo's pipeline over
one turn of its model (4 pi s of animation at 0.5 rad/s), for the
benchmark's ``procedural_mesh`` scene (mesh_seed 0) and the demo's
generated mesh.  ``--scene instanced`` sweeps the instanced demo's pipeline
over one orbit of its camera (2 pi / 0.3 s), for the benchmark's
``instanced_field`` scene, whose instance table each of ``--seeds`` draws,
and the demo's own grid.  For each mesh or table it renders one-frame
``render_sequence`` calls over the period at dt 1/60, then at dt 1/600
within 0.5 s of the worst frames, and reads each call's
``last_sequence_pair_budget_use``, the renderer's own count:

- measuring (the default): the demo's pipeline with a generous budget,
  ``raster_pairs_factor`` 4.0, reads extras / 3T with no slot cut, and with
  a slot cut of 1024 it reads true pairs / 1024; so each view's extra tiles
  and true (tile, triangle) pairs, per triangle of the stream T (every
  instance's), and the worst of each;
- ``--check``: the demo's own budget, the largest share of it any view
  needs and the views that overflow it.

One JSON line per mesh or table and pass, and a summary line last, which
holds the worst of every table.  Needs a CUDA device unless ``--device
cpu`` (small sizes only).
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
from benchmark.reference.scenes import instanced_field, procedural_mesh  # noqa: E402

PERIOD_S = {"big_mesh": procedural_mesh.PERIOD_S, "instanced": instanced_field.PERIOD_S}
#: (width, height, msaa) of each scene's benchmark cell
SIZE = {"big_mesh": (3840, 2160, 4), "instanced": (1920, 1080, 1)}
MEASURE_PAIRS = 4.0  # the budget the readings are taken under
PAIR_SLOTS = 1024  # a slot cut this small makes the count read true pairs / 1024


def meshes(r: Renderer, triangles: int, names):
    """{name: (mesh, uniforms_fn, None)} of the big_mesh scene on the
    renderer's device."""
    out = {}
    aspect = r.config.width / r.config.height
    args = {"triangles": triangles, "mesh_seed": 0}
    for name in names:
        if name == "benchmark":
            attrs = procedural_mesh.mesh(0, args, r.device)
            out[name] = (Mesh(attributes=attrs, indices=None),
                         lambda t: procedural_mesh.uniforms(float(t), aspect, args), None)
        else:
            _, mesh, uniforms, _ = demos.big_mesh_demo(r, triangles=triangles, generated=True)
            out[name] = (mesh, uniforms, None)
    return out


def tables(r: Renderer, count: int, names, seeds):
    """{name: (mesh, uniforms_fn, instances)} of the instanced scene on the
    renderer's device: the benchmark's table of each seed
    (``benchmark_<seed>``) and the demo's grid (``demo``)."""
    out = {}
    aspect = r.config.width / r.config.height
    args = {"count": count, "spacing": 2.5}
    for name in names:
        if name == "benchmark":
            mesh = Mesh(attributes=instanced_field.mesh(0, args, r.device), indices=None)
            for seed in seeds:
                out[f"benchmark_{seed}"] = (mesh, lambda t: instanced_field.uniforms(float(t), aspect, args),
                                            instanced_field.instances(seed, args, r.device))
        else:
            _, mesh, uniforms, inst = demos.instanced_demo(r, count=count)
            out[name] = (mesh, uniforms, inst)
    return out


def reads(r: Renderer, pipe, mesh, uniforms, times, instances=None) -> np.ndarray:
    """Each time's pair budget use, one one-frame sequence a time."""
    got = []
    for t in times:
        r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=1, t0=float(t), instances=instances)
        got.append(float(r.last_sequence_pair_budget_use))
    return np.asarray(got, dtype=np.float64)


def orbit(period: float = PERIOD_S["big_mesh"]) -> np.ndarray:
    """The period at dt 1/60."""
    return np.arange(int(round(period * 60))) / 60.0


def near(*t_worst: float) -> np.ndarray:
    """dt 1/600 within 0.5 s of each worst time."""
    return np.unique(np.concatenate([t + (np.arange(601) - 300) / 600.0 for t in t_worst]))


def stream_triangles(mesh, instances) -> int:
    """The triangles a draw hands the binner: every instance's."""
    return mesh.num_triangles * (1 if instances is None else next(iter(instances.values())).shape[0])


def measure(r, base, mesh, uniforms, times, instances=None) -> dict:
    """Per time: extras and true pairs per triangle."""
    triangles = stream_triangles(mesh, instances)
    eb = max(int(triangles * MEASURE_PAIRS), 1024) - triangles  # the renderer's extras budget
    extras = dataclasses.replace(base, raster_pairs_factor=MEASURE_PAIRS, raster_slots_factor=None)
    pairs = dataclasses.replace(extras, raster_slots_factor=PAIR_SLOTS / triangles / 2)
    e = np.rint(reads(r, extras, mesh, uniforms, times, instances) * eb)
    p = np.rint(reads(r, pairs, mesh, uniforms, times, instances) * PAIR_SLOTS)
    if not (e <= eb).all():
        raise AssertionError(f"a view needs more than {MEASURE_PAIRS} pairs a triangle: raise MEASURE_PAIRS")
    return {"extras": e / triangles, "pairs": p / triangles}


def worst(times, values) -> dict:
    i = int(np.argmax(values))
    return {"value": float(values[i]), "t": float(times[i])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="big_mesh", choices=sorted(PERIOD_S))
    p.add_argument("--width", type=int, default=None, help="default: the scene's benchmark cell's")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--msaa", type=int, default=None)
    p.add_argument("--triangles", type=int, default=1_000_000, help="big_mesh")
    p.add_argument("--count", type=int, default=10_000, help="instanced: the instances")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3], help="instanced: the benchmark's tables")
    p.add_argument("--meshes", nargs="+", default=["benchmark", "demo"], choices=["benchmark", "demo"])
    p.add_argument("--check", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    width, height, msaa = (x if x is not None else d for x, d in zip((a.width, a.height, a.msaa), SIZE[a.scene]))

    t_start = time.perf_counter()
    r = Renderer(RendererConfig(width, height, msaa=msaa), device=a.device)
    if a.scene == "big_mesh":
        base = demos.big_mesh_demo(r, triangles=a.triangles, generated=True)[0]
        draws = meshes(r, a.triangles, a.meshes)
        summary = {"triangles": a.triangles}
    else:
        base = demos.instanced_demo(r, count=a.count)[0]
        draws = tables(r, a.count, a.meshes, a.seeds)
        summary = {"count": a.count}
    summary = {"scene": a.scene, "width": width, "height": height, "msaa": msaa, **summary,
               "budget": (base.raster_pairs_factor, base.raster_slots_factor)}
    lines = []
    for name, (mesh, uniforms, inst) in draws.items():
        coarse = orbit(PERIOD_S[a.scene])
        if a.check:
            use = reads(r, base, mesh, uniforms, coarse, inst)
            fine = near(worst(coarse, use)["t"])
            use_fine = reads(r, base, mesh, uniforms, fine, inst)
            got = {"mesh": name, "check": True, "worst_use": worst(coarse, use), "worst_use_fine": worst(fine, use_fine),
                   "overflowed_t": [float(t) for t, u in zip(np.concatenate([coarse, fine]),
                                                             np.concatenate([use, use_fine])) if u > 1]}
        else:
            c = measure(r, base, mesh, uniforms, coarse, inst)
            fine = near(worst(coarse, c["extras"])["t"], worst(coarse, c["pairs"])["t"])
            f = measure(r, base, mesh, uniforms, fine, inst)
            got = {"mesh": name, "check": False,
                   **{f"worst_{k}": worst(coarse, c[k]) for k in c}, **{f"worst_{k}_fine": worst(fine, f[k]) for k in f},
                   "frames": [len(coarse), len(fine)]}
        got["triangles"] = stream_triangles(mesh, inst)
        got["seconds"] = time.perf_counter() - t_start
        print(json.dumps(got), flush=True)
        lines.append(got)
        r._sequences.clear()  # this mesh's or table's programs
    for k in ("use",) if a.check else ("extras", "pairs"):
        w = max(({**x[f"worst_{k}{s}"], "mesh": x["mesh"]} for x in lines for s in ("", "_fine")),
                key=lambda v: v["value"])
        summary[f"worst_{k}"] = w
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
