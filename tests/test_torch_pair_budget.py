"""The pair budget's count (``pair_budget_use``) and the big_mesh demo's
budget tiers.

The binner reports, beside its overflow flag, the largest share of its
(tile, triangle) pair budget that a draw's true stream needs; frames fold
it over draws and sequences over frames.  These tests hold it against an
independent count from the benchmark's plain reference, against the
overflow flag on both kinds of overflow, and the demo's 4K MSAA-4x tier
against the orbit sweep it was sized from.  CPU only, frames at 128x96.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import based_renderer_tpu_torch as tbrt
from based_renderer_tpu_torch.models import demos
from based_renderer_tpu_torch.ops import binning
from based_renderer_tpu_torch.scene import Mesh
from based_renderer_tpu_torch.utils import profiling
from based_renderer_tpu_torch.utils.errors import AllocationError
from benchmark.harness import compare, loops, spec
from benchmark.reference import raster as ref_raster
from benchmark.reference import render as ref_render
from benchmark.reference.scenes import procedural_mesh

W, H, TRIS = 128, 96, 2000
NT = 1936  # the tube's 44 rings x 22 segments x 2 at 2000 asked for
SEED = 2**31 + 18
CELL = "big_mesh_4k_msaa4.sequence"


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _renderer(**cfg):
    return tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4, **cfg), device="cpu")


def _scene(r):
    """The benchmark's mesh and uniforms at the small size, and the demo's
    pipeline for it."""
    args = {"triangles": TRIS, "mesh_seed": 0}
    attrs = procedural_mesh.mesh(SEED, args, torch.device("cpu"))
    assert attrs["position"].shape[0] == 3 * NT
    pipe = demos.big_mesh_demo(r, triangles=TRIS)[0]

    def uniforms(t):
        return procedural_mesh.uniforms(float(t), W / H, args)

    return pipe, Mesh(attributes=attrs, indices=None), uniforms, attrs


def _spec():
    return json.loads((spec.BENCH_DIR / "configs" / "big_mesh_4k_msaa4.json").read_text())["reference"]


# ---- (a) the port against the plain reference ---------------------------------


def test_sequence_equals_the_reference_within_the_cells_limit():
    r = _renderer()
    pipe, mesh, uniforms, attrs = _scene(r)
    t0, dt, n = procedural_mesh.start_time(SEED), 1 / 60, 6
    _, colors = r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=n, t0=t0, dt=dt, return_frames=True)
    assert not bool(r.last_sequence_overflowed) and 0 < float(r.last_sequence_pair_budget_use) <= 1
    times = loops.sequence_times(t0, dt, n)
    frames = [{"t": times[i], "color": colors[i]} for i in (0, 2, 5)]
    cfg = {"reference": _spec(), "width": W, "height": H, "msaa": 4, "scene_args": {"triangles": TRIS}}
    got = compare.numbers(frames, compare.reference_for(cfg, procedural_mesh, attrs, W / H))
    ok, checks = compare.judge(got, spec.limits(CELL))
    assert ok, checks
    assert got["color_gap"] > 0  # the frames were compared, not skipped


# ---- (b) the count against an independent one --------------------------------


def _reference_use(clip, pipe) -> torch.Tensor:
    """max(extras / extras budget, true pairs / slots) from the reference's
    setup: the bounding boxes of the triangles it rasterizes, in tiles."""
    ref = _spec()
    s = ref_raster.setup(clip, W, H, ref_raster.MSAA4_OFFSETS, ref["cull_mode"], ref["front_face"])
    tw, th = pipe.raster_tile
    tiles = ((s.x1 - 1) // tw - s.x0 // tw + 1) * ((s.y1 - 1) // th - s.y0 // th + 1)
    extras = (tiles - 1).sum()
    t = clip.shape[0]
    max_pairs = max(int(t * pipe.raster_pairs_factor), 1024)
    use = extras.to(torch.float64) / (max_pairs - t)
    if pipe.raster_slots_factor is not None:
        slots = max(int(t * pipe.raster_slots_factor), 1024)
        slots = -(-slots // 128) * 128
        if slots < max_pairs:
            use = torch.maximum(use, (s.index.numel() + extras).to(torch.float64) / slots)
    assert 0 < extras and use.dtype == torch.float64
    return use


@pytest.mark.parametrize("slots_factor", [None, 0.85], ids=["extras", "slots"])
def test_count_equals_the_references_bbox_count(slots_factor):
    """One frame from the reference's own clip space (the flat_ndc shader
    takes it as it is), so that both count the same snapped vertices."""
    r = _renderer()
    pipe, _, uniforms, attrs = _scene(r)
    clip, _, _ = ref_render.clip_space(_spec(), attrs, uniforms(procedural_mesh.start_time(SEED)))
    raw = dataclasses.replace(pipe, shader="flat_ndc", raster_slots_factor=slots_factor)
    f = r.render_frame(raw, r.upload_mesh(clip.reshape(-1, 4)))
    want = _reference_use(clip, raw)
    assert f.pair_budget_use.dtype == torch.float64 and f.pair_budget_use.shape == ()
    assert torch.equal(f.pair_budget_use, want), (float(f.pair_budget_use), float(want))
    assert not bool(f.overflowed)


# ---- (c) overflow: the count, the flag, sequences, debug mode ------------------


@pytest.mark.parametrize("bound", ["extras", "slots"])
def test_count_reads_above_one_exactly_when_overflowed(bound):
    """Frames under a budget cut to what they need: the extras budget at
    the median view's extra tiles (some views overflow it, some do not), or
    a slot cut under the fewest true pairs of any view, with the generous
    extras budget."""
    r = _renderer()
    pipe, mesh, uniforms, _ = _scene(r)
    t0, dt, n = 0.0, 0.7, 9
    times = loops.sequence_times(t0, dt, n)
    budget = 3 * NT  # the generous tier's extras budget
    floor = dataclasses.replace(pipe, raster_slots_factor=0.01)  # cut at 1024: reads true pairs / 1024
    generous = [r.render_frame(pipe, mesh, uniforms(t)).pair_budget_use for t in times]
    extras = [round(float(u) * budget) for u in generous]
    pairs = [round(float(r.render_frame(floor, mesh, uniforms(t)).pair_budget_use) * 1024) for t in times]
    if bound == "extras":
        tight = dataclasses.replace(pipe, raster_pairs_factor=(NT + int(np.median(extras)) + 0.5) / NT)
    else:
        tight = dataclasses.replace(pipe, raster_slots_factor=min(pairs) // 128 * 128 / NT)
    flags, uses = [], []
    for t in times:
        f = r.render_frame(tight, mesh, uniforms(t))
        flags.append(bool(f.overflowed))
        uses.append(f.pair_budget_use)
    assert [float(u) > 1 for u in uses] == flags
    assert any(flags), (extras, pairs)
    if bound == "extras":
        assert not all(flags)
        assert flags == [e > int(np.median(extras)) for e in extras]
    r.render_sequence(tight, mesh, uniforms_fn=uniforms, num_frames=n, t0=t0, dt=dt)
    assert torch.equal(r.last_sequence_pair_budget_use, torch.stack(uses).max())
    assert bool(r.last_sequence_overflowed)
    r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=n, t0=t0, dt=dt)
    assert not bool(r.last_sequence_overflowed)
    assert torch.equal(r.last_sequence_pair_budget_use, torch.stack(generous).max())

    rd = _renderer(debug=True)
    over = times[flags.index(True)]
    with pytest.raises(AllocationError):
        rd.render_frame(tight, mesh, uniforms(over))
    with pytest.raises(AllocationError):
        rd.render_sequence(tight, mesh, uniforms_fn=uniforms, num_frames=1, t0=over)


def test_a_frame_folds_its_draws_with_a_max():
    r = _renderer()
    pipe, mesh, uniforms, _ = _scene(r)
    u = uniforms(1.0)
    single = [float(r.render_frame(p, mesh, u).pair_budget_use)
              for p in (pipe, dataclasses.replace(pipe, raster_pairs_factor=2.0))]
    r.begin_frame()
    r.draw(pipe, mesh, u)
    r.draw(dataclasses.replace(pipe, raster_pairs_factor=2.0), mesh, u)
    both = r.end_frame()
    assert float(both.pair_budget_use) == max(single) and single[1] > single[0]
    r.begin_frame()
    empty = r.end_frame()
    assert float(empty.pair_budget_use) == 0.0 and not bool(empty.overflowed)


@pytest.mark.parametrize("slots", [None, 1280], ids=["extras", "slots"])
def test_the_flag_read_off_the_count_equals_the_integer_tests(slots):
    """The binner reads its flag off the count; it equals the integer tests
    (extras needed > extras budget, true pairs > slots) on every budget
    from far under to far over the draw's needs."""
    r = _renderer()
    pipe, mesh, uniforms, _ = _scene(r)
    ps_args = dict(tile_w=128, tile_h=8)
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import gather_triangles
    from based_renderer_tpu_torch.ops import fixedpoint as fp

    shd = tbrt.shader.get(pipe.shader)
    clip, var = shd.vertex(mesh.attributes, r._uniforms(uniforms(2.0)))
    clip_tri, _ = gather_triangles(clip, var, None)
    ts = setup_triangles(clip_tri, W, H, cull_mode="back", front_face="ccw", bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP)
    need = binning.pair_stream(ts, W, H, max_pairs=4 * NT, **ps_args)
    extras_needed = round(float(need.pair_budget_use) * 3 * NT)
    for extra_budget in (0, extras_needed - 1, extras_needed, extras_needed + 1, 3 * NT):
        kw = dict(max_pairs=NT + extra_budget, slots=slots, **ps_args)
        read = binning.pair_stream(ts, W, H, **kw)
        assert bool(read.overflowed) == (float(read.pair_budget_use) > 1)
        want = extra_budget < extras_needed or (slots is not None and int(read.num_pairs) > slots)
        assert bool(read.overflowed) == want, extra_budget


def test_count_over_one_is_exact_for_any_budget_a_frame_holds():
    """A count of budget + d reads above 1 exactly when d > 0: for every
    budget up to 2^20 and a million drawn up to 2^50, computed as a float64
    division (the CPU) and as a product with the float64 reciprocal of the
    budget (CUDA's division by a host scalar), and through the binner's own
    quotient."""
    b = np.concatenate([np.arange(1, (1 << 20) + 1), np.random.default_rng(5).integers(1, 1 << 50, 1 << 20)])
    bf = b.astype(np.float64)
    inv = 1.0 / bf
    for d in (-1, 0, 1):
        c = (b + d).astype(np.float64)
        for q in (c / bf, c * inv):
            assert ((q > 1) == (d > 0)).all(), d
        for budget in (1, 4_096_000, (1 << 24) + 1, (1 << 40) - 3):
            use = binning._budget_use(torch.tensor(budget + d), budget)
            assert use.dtype == torch.float64 and (float(use) > 1) == (d > 0), (budget, d)
    assert float(binning._budget_use(torch.tensor(0), 0)) == 0.0
    assert float(binning._budget_use(torch.tensor(3), 0)) == float("inf")


# ---- recording while a profiler records ---------------------------------------


def test_budget_use_is_kept_only_while_a_profiler_records(monkeypatch):
    monkeypatch.setattr(profiling, "_BUDGET_USE", profiling.collections.deque(maxlen=8))
    r = _renderer()
    pipe, mesh, uniforms, _ = _scene(r)
    r.render_frame(pipe, mesh, uniforms(0.5))
    r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=0.5)
    assert profiling.budget_use_records() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        f = r.render_frame(pipe, mesh, uniforms(0.5))
        r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=2, t0=0.5)
    kept = profiling.budget_use_records()
    assert [x.use for x in kept] == [f.pair_budget_use, r.last_sequence_pair_budget_use]
    assert kept[0].called_ns < kept[1].called_ns


# ---- (d) the demo's tiers -----------------------------------------------------


@pytest.mark.parametrize("msaa, worst", [(4, demos.WORST_4K_MSAA4), (1, demos.WORST_4K)], ids=["msaa4", "no_msaa"])
def test_4k_tiers_hold_the_sweeps_worst_view_with_the_headroom(msaa, worst):
    pairs, slots = demos.big_mesh_budget(3840, msaa, 1_000_000)
    extras_worst, pairs_worst = worst
    assert pairs - 1 >= extras_worst * demos.HEADROOM
    assert slots >= pairs_worst * demos.HEADROOM
    if msaa == 4:  # the smallest to 0.01, and at every size
        assert pairs - 1 - 0.01 < extras_worst * demos.HEADROOM and slots - 0.01 < pairs_worst * demos.HEADROOM
        assert demos.big_mesh_budget(1920, 4, 1_000_000) == (pairs, slots)


def test_narrow_and_small_tiers_are_the_jax_packages():
    assert demos.big_mesh_budget(1920, 1, 1_000_000) == (1.15, 0.6)
    assert demos.big_mesh_budget(2560, 1, 100_000) == (1.15, 0.6)
    for size in ((128, 4), (128, 1), (3840, 4)):
        assert demos.big_mesh_budget(*size, 99_999) == (4.0, None)
    r = _renderer()
    pipe = demos.big_mesh_demo(r, triangles=TRIS)[0]
    assert (pipe.raster_pairs_factor, pipe.raster_slots_factor) == (4.0, None)


def test_the_sweep_script_reads_the_counts_it_reports(monkeypatch, capsys):
    """sweep_pair_budget.py at the small size over three views: its check
    of the demo's own budget (4.0, no cut, at 2000 triangles) reads the
    worst view's extra tiles over the 3T extras budget."""
    import sweep_pair_budget as sweep

    monkeypatch.setattr(sweep, "orbit", lambda *period: np.array([0.0, 1.0, 2.1]))
    monkeypatch.setattr(sweep, "near", lambda *t: np.unique(np.concatenate([[x - 1 / 600, x] for x in t])))
    args = ["--width", str(W), "--height", str(H), "--triangles", str(TRIS), "--device", "cpu", "--meshes", "benchmark"]
    sweep.main(args)
    sweep.main(args + ["--check"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    measured, checked = lines[0], lines[2]
    assert measured["triangles"] == NT and lines[1]["budget"] == [4.0, None]
    extras, pairs = measured["worst_extras"], measured["worst_pairs"]
    assert round(extras["value"] * NT) == pytest.approx(extras["value"] * NT, abs=1e-6)
    assert 0 < extras["value"] < pairs["value"] < 1
    assert checked["worst_use"]["t"] == extras["t"] and checked["overflowed_t"] == []
    assert checked["worst_use"]["value"] == pytest.approx(extras["value"] / 3, rel=1e-6)


# ---- (e) the instanced demo's budget --------------------------------------------


def test_instanced_budget_holds_the_sweeps_worst_view_with_the_headroom():
    pairs, slots = demos.INSTANCED_BUDGET
    extras_worst, pairs_worst = demos.WORST_INSTANCED_1080P
    assert pairs - 1 >= extras_worst * demos.HEADROOM
    assert slots >= pairs_worst * demos.HEADROOM
    r = tbrt.Renderer(tbrt.RendererConfig(160, 90), device="cpu")
    pipe = demos.instanced_demo(r, count=100)[0]
    assert (pipe.raster_pairs_factor, pipe.raster_slots_factor) == (pairs, slots)


#: The instanced cell's configuration: its reference draws as the demo's
#: pipeline does.
INSTANCED_CONFIG = spec.BENCH_DIR / "configs" / "instanced_10k_1080p.json"


def _instanced_reference_counts(t, w, h, count, seed, tile):
    """(extra tiles, true pairs) of the instanced scene's view at ``t`` from
    the reference's setup."""
    from benchmark.reference.scenes import instanced_field

    args = {"count": count, "spacing": 2.5}
    cpu = torch.device("cpu")
    ref = json.loads(INSTANCED_CONFIG.read_text())["reference"]
    clip, _, _ = ref_render.clip_space(ref, instanced_field.mesh(seed, args, cpu),
                                       instanced_field.uniforms(float(t), w / h, args),
                                       instances=instanced_field.instances(seed, args, cpu))
    s = ref_raster.setup(clip, w, h, ref_raster.CENTER, ref["cull_mode"], ref["front_face"])
    tw, th = tile
    tiles = ((s.x1 - 1) // tw - s.x0 // tw + 1) * ((s.y1 - 1) // th - s.y0 // th + 1)
    return int((tiles - 1).sum()), int(tiles.sum())


def test_the_sweep_script_reads_the_instanced_fields_counts(monkeypatch, capsys):
    """sweep_pair_budget.py --scene instanced at 160x90 with 100 cubes over
    three views: the worst view's extra tiles and true pairs are the
    reference's bbox counts, and the check reads the demo's own budget."""
    import sweep_pair_budget as sweep

    w, h, count, seed = 160, 90, 100, 2**31 + 77
    monkeypatch.setattr(sweep, "orbit", lambda *period: np.array([0.0, 5.0, 11.1]))
    monkeypatch.setattr(sweep, "near", lambda *t: np.unique(np.concatenate([[x - 1 / 600, x] for x in t])))
    args = ["--scene", "instanced", "--width", str(w), "--height", str(h), "--count", str(count),
            "--seeds", str(seed), "--device", "cpu", "--meshes", "benchmark"]
    sweep.main(args)
    sweep.main(args + ["--check"])
    measured, summary, checked, _ = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    t = 12 * count
    assert measured["mesh"] == f"benchmark_{seed}" and measured["triangles"] == t
    assert summary["budget"] == list(demos.INSTANCED_BUDGET) and summary["worst_extras"]["mesh"] == measured["mesh"]
    tile = (128, 8)
    for i, key in enumerate(("extras", "pairs")):
        worst = measured[f"worst_{key}"]
        assert round(worst["value"] * t) == _instanced_reference_counts(worst["t"], w, h, count, seed, tile)[i]
    extras, pairs = _instanced_reference_counts(checked["worst_use"]["t"], w, h, count, seed, tile)
    budget = max(int(t * demos.INSTANCED_BUDGET[0]), 1024) - t
    slots = max(int(t * demos.INSTANCED_BUDGET[1]), 1024)
    assert checked["worst_use"]["value"] == pytest.approx(max(extras / budget, pairs / slots), rel=1e-12)
    assert checked["overflowed_t"] == []
