"""The comparison fails its control: the reference in TF32 (each operand
of the vertex stage's products rounded to a 10-bit mantissa), put in the
program's place, is out of at least one of the cell's limits.

On the CPU the cube runs at the cell's own 1920x1080 and the mesh at
1920x1080 with 100,000 triangles; ``-m chip`` runs every cell at its own
size on the card (``test_bench_chip.py``)."""

import numpy as np
import pytest

from benchmark.calibrate import control_frames
from benchmark.harness import compare, core, spec
from benchmark.reference import render

SIZES = {
    "cube_1080p.present": {},
    "cube_1080p.sequence": {},
    "big_mesh_4k_msaa4.sequence": {"width": 1920, "height": 1080, "demo_args": {"triangles": 100_000},
                                   "scene_args": {"triangles": 100_000}},
}


def control_readings(bench, workload, seed, overrides, device="cpu"):
    """(sound reference numbers, control numbers) over the frames a run of
    the cell compares: three at animation times drawn from the seed, with
    the visibility planes where the cell compares them."""
    cell = spec.cell(bench, workload)
    cfg = core.merge(spec.config(bench, cell["config"]), overrides)
    traffic = spec.traffic(cell["traffic"])
    sc = render.scene(cfg["scene"])
    attrs = sc.mesh(seed, cfg["scene_args"], device)
    inst = render.scene_instances(sc, seed, cfg["scene_args"], device)
    w, h = cfg["width"], cfg["height"]
    ref = compare.reference_for(cfg, sc, attrs, w / h, instances=inst)
    rng = np.random.default_rng([seed, 3])
    times = sorted(sc.start_time(seed) + rng.uniform(0, 30, 3))
    frames = []
    for t in times:
        r = ref(t)
        f = {"t": t, "color": r.color}
        if traffic["loop"] == "present":
            f.update(tri_id=r.tri_id, depth_q=r.depth_q)
        frames.append(f)
    ctl = compare.reference_for(cfg, sc, attrs, w / h, precision="tf32", instances=inst)
    return compare.numbers(frames, ref), compare.numbers(control_frames(frames, ctl), ref)


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_and_the_reference_passes(bench, workload):
    limits = spec.limits(workload)
    sound, control = control_readings(bench, workload, 2**31 + 101, SIZES[workload])
    assert compare.judge(sound, limits)[0], sound
    assert not compare.judge(control, limits)[0], control
