"""BASELINE config 4, the instanced cube field, through the port on the CPU:
its frames against the benchmark's plain reference, the binner's pair
counter (``profiling.bin_pairs_records``) against an independent count
from the reference's bounding boxes, and the ``brt.draw.instances`` span.

At 160x90 with 100 cubes of a seeded instance table (the benchmark's
``instanced_field`` scene), against the configuration and limits of the
benchmark's ``instanced_10k_1080p.sequence`` cell; no JAX.
"""

import json

import pytest
import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.scene import Mesh
from based_renderer_tpu_torch.utils import profiling
from benchmark.harness import compare, loops, spec
from benchmark.reference import raster as ref_raster
from benchmark.reference import render as ref_render
from benchmark.reference.scenes import instanced_field

W, H, COUNT = 160, 90, 100
SEED = 2**31 + 24
CONFIG = "instanced_10k_1080p"
CELL = CONFIG + ".sequence"


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    """The cell's configuration (its reference draws as the demo's
    pipeline does), at the small size."""
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(width=W, height=H, demo_args={"count": COUNT}, scene_args={**cfg["scene_args"], "count": COUNT})
    return cfg


def _field(seed=SEED):
    """(renderer, the demo's pipeline, the cube, the scene's table, uniforms_fn, attrs)."""
    cfg = _cfg()
    args = cfg["scene_args"]
    r = tbrt.Renderer(tbrt.RendererConfig(W, H), device="cpu")
    pipe = demos.instanced_demo(r, **cfg["demo_args"])[0]
    attrs = instanced_field.mesh(seed, args, torch.device("cpu"))
    inst = instanced_field.instances(seed, args, torch.device("cpu"))

    def uniforms(t):
        return instanced_field.uniforms(float(t), W / H, args)

    return r, pipe, Mesh(attributes=dict(attrs), indices=None), inst, uniforms, attrs


def _reference_pairs(pipe, inst, attrs, u) -> int:
    """True (tile, triangle) pairs from the reference's setup: the tiles of
    the bounding box of each triangle it would rasterize."""
    ref = _cfg()["reference"]
    clip, _, _ = ref_render.clip_space(ref, attrs, u, instances=inst)
    s = ref_raster.setup(clip, W, H, ref_raster.CENTER, ref["cull_mode"], ref["front_face"])
    tw, th = pipe.raster_tile
    tiles = ((s.x1 - 1) // tw - s.x0 // tw + 1) * ((s.y1 - 1) // th - s.y0 // th + 1)
    assert s.index.numel() > 100 and int((tiles > 1).sum()) > 0  # engaged: many triangles, some over two tiles
    return int(tiles.sum())


def test_sequence_equals_the_reference_within_the_cells_limit():
    r, pipe, mesh, inst, uniforms, attrs = _field()
    cfg = _cfg()
    t0, dt, n = instanced_field.start_time(SEED), 1 / 60, 6
    _, colors = r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=n, t0=t0, dt=dt,
                                  instances=inst, return_frames=True)
    assert not bool(r.last_sequence_overflowed) and 0 < float(r.last_sequence_pair_budget_use) <= 1
    times = loops.sequence_times(t0, dt, n)
    frames = [{"t": times[i], "color": colors[i]} for i in (0, 2, 5)]
    reference = compare.reference_for(cfg, instanced_field, attrs, W / H, instances=inst)
    got = compare.numbers(frames, reference)
    limits = json.loads((spec.BENCH_DIR / "limits" / f"{CELL}.json").read_text())["limits"]
    ok, checks = compare.judge(got, limits)
    assert ok, checks
    assert got["color_gap"] > 0  # the frames were compared, not skipped
    # coverage and depth are the integer spec's: exact, in a frame through render_frame
    f = r.render_frame(pipe, mesh, uniforms(times[2]), instances=inst)
    assert torch.equal(f.color_planar, colors[2])
    vis = compare.numbers([{"t": times[2], "tri_id": f.tri_id, "depth_q": f.depth_q, "color": f.color_planar}],
                          reference)
    assert vis["tri_id_off"] == 0 and vis["depth_q_gap"] == 0
    assert torch.unique(f.tri_id[f.tri_id >= 0] // 12).numel() > 20  # many cubes on the screen


def test_counter_equals_the_references_bbox_count_in_frames_and_sequences(monkeypatch):
    monkeypatch.setattr(profiling, "_BIN_PAIRS", profiling.collections.deque(maxlen=8))
    r, pipe, mesh, inst, uniforms, attrs = _field()
    t0, dt = 3.2, 0.4
    times = loops.sequence_times(t0, dt, 2)
    want = [_reference_pairs(pipe, inst, attrs, uniforms(t)) for t in times]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_frame(pipe, mesh, uniforms(times[0]), instances=inst)
        r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=t0, dt=dt, instances=inst)
    frame, seq = profiling.bin_pairs_records()
    assert frame.pairs.dtype == seq.pairs.dtype == torch.int64 and frame.pairs.shape == ()
    assert (int(frame.pairs), frame.triangles) == (want[0], 12 * COUNT)
    assert (int(seq.pairs), seq.triangles) == (sum(want), 2 * 12 * COUNT)
    assert frame.called_ns < seq.called_ns


def test_a_frame_sums_its_draws(monkeypatch):
    """Two draws of half the table each count the pairs of one draw of the
    whole; a frame without draws keeps nothing."""
    monkeypatch.setattr(profiling, "_BIN_PAIRS", profiling.collections.deque(maxlen=8))
    r, pipe, mesh, inst, uniforms, attrs = _field()
    u = uniforms(1.0)
    half = {k: v[: COUNT // 2] for k, v in inst.items()}
    rest = {k: v[COUNT // 2 :] for k, v in inst.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_frame(pipe, mesh, u, instances=inst)
        r.begin_frame()
        r.draw(pipe, mesh, u, half)
        r.draw(pipe, mesh, u, rest)
        r.end_frame()
        r.begin_frame()
        r.end_frame()
    one, two = profiling.bin_pairs_records()
    assert int(one.pairs) == int(two.pairs) == _reference_pairs(pipe, inst, attrs, u)
    assert one.triangles == two.triangles == 12 * COUNT


def test_counter_is_kept_only_while_a_profiler_records(monkeypatch):
    monkeypatch.setattr(profiling, "_BIN_PAIRS", profiling.collections.deque(maxlen=8))
    r, pipe, mesh, inst, uniforms, _ = _field()
    r.render_frame(pipe, mesh, uniforms(0.5), instances=inst)
    r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=0.5, instances=inst)
    assert profiling.bin_pairs_records() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=0.5, instances=inst)
    r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=0.5, instances=inst)
    assert len(profiling.bin_pairs_records()) == 1


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def test_the_instances_span_wraps_the_instance_path_of_a_profiled_eager_frame():
    r, pipe, mesh, inst, uniforms, _ = _field()
    u = uniforms(0.5)

    def eager(pipe, mesh, u, instances):
        r.begin_frame()
        r.draw(pipe, mesh, u, instances)
        return r._run_frame(*r.close_frame())

    events = _profiled(lambda: eager(pipe, mesh, u, inst))
    spans = [e for e in events if e.name == "brt.draw.instances"]
    assert len(spans) == 1
    start, end = spans[0].time_range.start, spans[0].time_range.end
    inside = [e for e in events if start <= e.time_range.start and e.time_range.end <= end and e is not spans[0]]
    assert inside  # the table's upload and expansion run in it
    cube, cube_mesh, cube_u, _ = demos.cube_demo(r)  # a draw without instances
    assert not [e for e in _profiled(lambda: eager(cube, cube_mesh, cube_u(0.5), None))
                if e.name == "brt.draw.instances"]
