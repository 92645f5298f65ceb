"""The reader of ``pair_budget_use_pct``: exact values from made-up records,
None where the program keeps none (one older than the count), and a real
traced run of the 4K mesh's cell on the CPU at a small size."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.conftest import SMALL
from benchmark.harness import core, spec
from benchmark.harness.trace import Trace

W0 = 1_000_000_000
MS = 1_000_000
CELL = "big_mesh_4k_msaa4.sequence"


def _readings(trace=True):
    return SimpleNamespace(trace=Trace((W0, W0 + 100 * MS), [], []) if trace else None, traced_frames=4)


@pytest.fixture
def store(monkeypatch):
    from based_renderer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_BUDGET_USE", profiling.collections.deque(maxlen=16))
    return profiling


def test_no_records_read_none(store, monkeypatch):
    read = spec.reader("pair_budget_use_pct").read
    assert read(_readings()) is None
    assert read(_readings(trace=False)) is None
    store.keep_budget_use(W0 - MS, torch.tensor(0.5))  # before the window only
    assert read(_readings()) is None
    monkeypatch.delattr(store, "budget_use_records")  # the parent of the count
    assert read(_readings()) is None


def test_reads_the_largest_record_inside_the_window(store):
    for at_ms, use in [(-1, 1.7), (2, 0.25), (40, 0.625), (99, 0.5), (101, 2.0)]:
        store.keep_budget_use(W0 + at_ms * MS, torch.tensor(use, dtype=torch.float32))
    assert spec.reader("pair_budget_use_pct").read(_readings()) == pytest.approx(62.5)


def test_the_metric_is_the_cells_and_reads_on_a_traced_cpu_run(bench, store):
    wanted = {m["name"] for m in spec.metrics(bench, CELL, True)}
    assert "pair_budget_use_pct" in wanted
    assert "pair_budget_use_pct" not in {m["name"] for w in ("cube_1080p.present", "cube_1080p.sequence")
                                         for m in spec.metrics(bench, w, True)}
    r = core.run(bench, CELL, 2**31 + 47, 3.0, True, "cpu", core.time.perf_counter(),
                 overrides=SMALL["big_mesh_4k_msaa4"])
    assert r.correct and r.failed == 0
    assert 0 < r.metrics["pair_budget_use_pct"]["value"] < 100
    # every other per-layer metric of the cell reads too, but those of device work, which the CPU has none of
    cpu_silent = {"device_idle_pct", "launches_per_frame", "raster_roofline_pct"}
    assert wanted - cpu_silent <= set(r.metrics), sorted(wanted - set(r.metrics))
