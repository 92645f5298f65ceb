"""BENCHMARK.json meets the contract's form, and everything a cell needs is
found by name from files, so a new cell is data only."""

import json
import shutil

import pytest

from benchmark.conftest import SMALL
from benchmark.harness import core, spec

CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS, c["name"]
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD_KEYS, w["name"]
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS, m["name"]


def test_names_and_units_use_allowed_characters(bench):
    assert spec.check_names(bench) == []
    for bad in ("frame ms", "a/b", ".x", "é", "x" * 65):
        assert not spec.NAME.fullmatch(bad)
    for bad in ("tokens per second", "µs", ""):
        assert not spec.UNIT.fullmatch(bad)


def test_names_are_unique(bench):
    for group in (bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics(bench, w["name"], False)]
        layer = spec.metrics(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in layer:  # a per-layer metric moves an end-to-end metric the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_per_layer_metric_without_cells_is_reported_where_its_metric_is():
    bench = {"end_to_end": [{"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "busy", "moves": "rate"}, {"name": "load", "moves": "setup_s"},
                           {"name": "tail", "moves": "setup_s", "workloads": ["b"]}]}
    names = {w: [m["name"] for m in spec.metrics(bench, w, True)] for w in "ab"}
    assert names == {"a": ["busy", "load"], "b": ["load", "tail"]}
    assert [m["name"] for m in spec.metrics(bench, "b", False)] == ["setup_s"]


def test_per_layer_metrics_move_one_e2e_metric_and_layers_match_perf_md(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["layer"] in perf, m["layer"]


def test_everything_a_cell_needs_is_found_by_name(bench):
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        traffic = spec.traffic(w["traffic"])
        assert traffic["loop"] in core.loops.LOOPS
        assert spec.limits(w["name"])
        from benchmark.reference import render

        render.scene(cfg["scene"])
        render.shader(cfg["reference"]["shader"])
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and (spec.ROOT / c["file"]).is_file()


def test_files_and_command_stay_under_paths(bench):
    for word in bench["command"][1:]:
        assert word.startswith("benchmark/") and ".." not in word
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_is_data_only(bench, tmp_path, monkeypatch):
    """A new traffic mix and a new cell, as a data file each and an entry,
    run through the harness without an edit of any file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR / "configs", root / "benchmark" / "configs")
    shutil.copytree(spec.BENCH_DIR / "traffic", root / "benchmark" / "traffic")
    shutil.copytree(spec.BENCH_DIR / "limits", root / "benchmark" / "limits")
    (root / "benchmark" / "metrics").mkdir()
    for f in (spec.BENCH_DIR / "metrics").glob("*.py"):
        shutil.copy(f, root / "benchmark" / "metrics" / f.name)
    mix = json.loads((root / "benchmark" / "traffic" / "present.json").read_text())
    mix.update(swapchain_depth=3, ring_depth=3)
    (root / "benchmark" / "traffic" / "present_deep.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "cube_1080p.present_deep.json").write_text(
        (root / "benchmark" / "limits" / "cube_1080p.present.json").read_text())
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "cube_1080p.present_deep", "config": "cube_1080p", "traffic": "present_deep",
                             "chips": 1, "why": "a deeper swapchain and ring"})
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "BENCH_DIR", root / "benchmark")
    r = core.run(new, "cube_1080p.present_deep", 2**31 + 17, 1.0, False, "cpu", core.time.perf_counter(),
                 overrides=SMALL["cube_1080p"])
    assert r.correct and r.attempted > 0
    assert set(r.metrics) == {m["name"] for m in spec.metrics(new, "cube_1080p.present_deep", False)}
    assert list(r.line())[-1] == "checks"


def test_a_missing_file_is_an_error_not_a_result(bench):
    with pytest.raises(spec.SpecError):
        spec.traffic("no_such_mix")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.cell(bench, "no_such.cell")
