"""An instanced configuration is data only: its configuration, scene,
reference shader, limits and entries (``instanced_cell/``) are laid into
a temporary checkout as new files, and both mixes run through
``core.run`` on the CPU without an edit of any file that is there.

The scene gives an instance table, the loops pass it with every draw, the
stated ``depth_clip`` is checked against the demo's pipeline, and the
reference draws every instance.  The cube cells, whose scene gives none,
pass ``instances=None`` in every call.  Where the benchmark already holds
a reference module of the cell's (``instanced_color.py``, whose name the
pipeline fixes), its own serves the cell and nothing is laid over it.
"""

import json
import shutil
from pathlib import Path

import pytest

from benchmark.conftest import INSTANCED_CELL, SMALL
from benchmark.harness import core, guard, spec
from benchmark.tests.test_bench_imports import _imports

SEED = 2**31 + 53
TRAFFIC = {"instanced_small.present": {}, "instanced_small.sequence": {"seconds_per_call": 0.1}}


def _lay_cell(root, owns):
    """Lay the cell's files under ``root/benchmark``.  Its configuration
    and limits are new names that no benchmark directory of ``owns`` may
    hold; its reference scene and shader are laid only where none of
    ``owns`` has a module of that name, which then serves the cell."""
    cell = sorted(p.relative_to(INSTANCED_CELL) for p in INSTANCED_CELL.rglob("*") if p.is_file()
                  and p.name != "entries.json" and "__pycache__" not in p.parts)
    for rel in cell:
        if any((own / rel).exists() for own in owns):
            assert rel.parts[0] == "reference", f"{rel} is a file of the benchmark: the cell would edit it"
            continue
        dst = root / "benchmark" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(INSTANCED_CELL / rel, dst)


SHADER = Path("reference") / "shaders" / "instanced_color.py"


@pytest.fixture
def owned(request, tmp_path):
    """Benchmark directories, besides the benchmark's own, whose reference
    modules the checkout holds already: none, or under the parameter
    ``"shader"`` one that holds ``instanced_color.py``, as the benchmark
    will once a configuration that runs the instanced demo is in."""
    if getattr(request, "param", None) != "shader":
        return []
    own = tmp_path / "own"
    (own / SHADER).parent.mkdir(parents=True)
    shutil.copy(INSTANCED_CELL / SHADER, own / SHADER)
    return [own]


@pytest.fixture
def checkout(bench, tmp_path, monkeypatch, lay_reference, owned):
    """A checkout holding the benchmark's data files and the instanced
    cell's new ones; the BENCHMARK.json that lists them."""
    root = tmp_path / "checkout"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.BENCH_DIR / d, root / "benchmark" / d, ignore=shutil.ignore_patterns("__pycache__"))
    _lay_cell(root, [spec.BENCH_DIR, *owned])
    lay_reference(root / "benchmark", *owned)
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "BENCH_DIR", root / "benchmark")
    new = json.loads(json.dumps(bench))
    for key, entries in json.loads((INSTANCED_CELL / "entries.json").read_text()).items():
        new[key] += entries
    return new


def _run(bench, workload, overrides=None, trace=False, seconds=1.5):
    over = core.merge({"traffic": TRAFFIC.get(workload, {})}, overrides)
    if workload.startswith("cube"):
        over = core.merge(SMALL["cube_1080p"], over)
    return core.run(bench, workload, SEED, seconds, trace, "cpu", core.time.perf_counter(), overrides=over)


@pytest.mark.parametrize("workload", sorted(TRAFFIC))
def test_the_instanced_cell_runs_correct_as_data(checkout, workload):
    r = _run(checkout, workload)
    assert r.correct and r.failed == 0 and r.attempted > 0, r.checks
    assert set(r.metrics) == {m["name"] for m in spec.metrics(checkout, workload, False)}
    assert list(r.line())[-1] == "checks"


@pytest.mark.parametrize("owned", ["shader"], indirect=True)
def test_a_benchmark_that_holds_the_shader_serves_the_cell_with_its_own(owned, checkout, tmp_path):
    """The reference shader's name is the pipeline's, so a later benchmark
    holds ``instanced_color.py`` itself: the cell then uses that one, and
    still runs correct as data."""
    from benchmark.reference import render as ref_render

    assert not (tmp_path / "checkout" / "benchmark" / SHADER).exists()
    assert Path(ref_render.shader("instanced_color").__file__) == owned[0] / SHADER
    r = _run(checkout, "instanced_small.present")
    assert r.correct and r.failed == 0 and r.attempted > 0, r.checks


def _first_instance_only(monkeypatch):
    """The timed path draws only the first instance of the table it is handed."""
    from based_renderer_tpu_torch import renderer as R

    render_frame, render_sequence = R.Renderer.render_frame, R.Renderer.render_sequence

    def first(instances):
        return {k: v[:1] for k, v in instances.items()}

    def frame(self, pipeline, mesh, uniforms=None, instances=None, **kw):
        return render_frame(self, pipeline, mesh, uniforms, first(instances), **kw)

    def sequence(self, *a, instances=None, **kw):
        return render_sequence(self, *a, instances=first(instances), **kw)

    monkeypatch.setattr(R.Renderer, "render_frame", frame)
    monkeypatch.setattr(R.Renderer, "render_sequence", sequence)


@pytest.mark.parametrize("workload", sorted(TRAFFIC))
def test_drawing_only_the_first_instance_makes_the_run_incorrect(checkout, monkeypatch, workload):
    _first_instance_only(monkeypatch)
    r = _run(checkout, workload)
    assert not r.correct, r.checks


@pytest.mark.parametrize("workload, depth_clip", [("instanced_small.present", True), ("cube_1080p.present", False)])
def test_a_wrongly_stated_depth_clip_is_refused(checkout, workload, depth_clip):
    """The instanced demo's pipeline clips no depth and the cube's does."""
    with pytest.raises(spec.SpecError, match="depth"):
        _run(checkout, workload, {"reference": {"depth_clip": depth_clip}})


@pytest.mark.parametrize("workload", ["cube_1080p.present", "cube_1080p.sequence"])
def test_the_cube_cells_pass_no_instances(checkout, monkeypatch, workload):
    """A scene without an instance table: every call into the program
    carries ``instances=None``, the call the cells made before."""
    from based_renderer_tpu_torch import renderer as R

    seen = []

    def recorder(call):
        def record(self, *a, **kw):
            seen.append(kw.get("instances", "not passed"))
            return call(self, *a, **kw)

        return record

    for name in ("render_frame", "render_sequence"):
        monkeypatch.setattr(R.Renderer, name, recorder(getattr(R.Renderer, name)))
    r = _run(checkout, workload)
    assert r.correct and len(seen) > 2
    assert all(x is None for x in seen), set(map(str, seen))


def test_the_raster_work_counts_every_instance(checkout, monkeypatch):
    """``raster_roofline_pct``'s work is reckoned over every instance's
    triangles, not over one cube's twelve."""
    counted = []
    stage_work = core.stage_work

    def record(samples, triangles, bbox):
        counted.append(triangles)
        return stage_work(samples, triangles, bbox)

    monkeypatch.setattr(core, "stage_work", record)
    r = _run(checkout, "instanced_small.present", trace=True)
    assert r.correct and counted
    assert min(counted) > 12 * 3  # back faces culled, most of the 27 cubes in view


def test_the_laid_reference_names_nothing_of_the_program():
    files = sorted((INSTANCED_CELL / "reference").rglob("*.py"))
    assert len(files) == 2
    for path in files:
        tops = {guard.top_level(m) for m in _imports(path)}
        assert "based_renderer_tpu_torch" not in tops and not (tops & guard.FORBIDDEN), path
