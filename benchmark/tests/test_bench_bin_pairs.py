"""The reader of ``bin_pairs_per_tri``: exact values from made-up records,
None where the program keeps none (one older than the counter), and a real
traced run of the instanced field on the CPU, in the small instanced cell
that ``test_bench_instances.py`` lays as data."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import core, spec
from benchmark.harness.trace import Trace
from benchmark.tests.test_bench_instances import checkout, owned  # noqa: F401 (fixtures)

W0 = 1_000_000_000
MS = 1_000_000
CELL = "instanced_small.sequence"


def _readings(trace=True):
    return SimpleNamespace(trace=Trace((W0, W0 + 100 * MS), [], []) if trace else None, traced_frames=4)


@pytest.fixture
def store(monkeypatch):
    from based_renderer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_BIN_PAIRS", profiling.collections.deque(maxlen=16))
    return profiling


def test_no_records_read_none(store, monkeypatch):
    read = spec.reader("bin_pairs_per_tri").read
    assert read(_readings()) is None
    assert read(_readings(trace=False)) is None
    store.keep_bin_pairs(W0 - MS, [torch.tensor(5)], 4)  # before the window only
    assert read(_readings()) is None
    store.keep_bin_pairs(W0 + MS, [torch.tensor(5)], 4)
    monkeypatch.delattr(store, "bin_pairs_records")  # the parent of the counter
    assert read(_readings()) is None


def test_reads_the_pairs_over_the_triangles_inside_the_window(store):
    for at_ms, pairs, tris in [(-1, [9], 1), (2, [3, 4], 10), (40, [13], 10), (99, [20], 20), (101, [50], 1)]:
        store.keep_bin_pairs(W0 + at_ms * MS, [torch.tensor(p, dtype=torch.int32) for p in pairs], tris)
    assert spec.reader("bin_pairs_per_tri").read(_readings()) == pytest.approx(40 / 40)


def test_reads_on_a_traced_cpu_run_of_the_instanced_field(checkout, store):
    """The benchmark's tests' small instanced cell, laid as data, with the
    metric's entry naming it: a traced run reads it."""
    per_layer = [{**m, "workloads": [*m["workloads"], CELL]} if m["name"] == "bin_pairs_per_tri" else m
                 for m in checkout["per_layer"]]
    assert any(m["name"] == "bin_pairs_per_tri" for m in per_layer)
    bench = {**checkout, "per_layer": per_layer}
    r = core.run(bench, CELL, 2**31 + 61, 3.0, True, "cpu", core.time.perf_counter(),
                 overrides={"traffic": {"seconds_per_call": 0.05}})
    assert r.correct and r.failed == 0, r.checks
    # half the triangles are back faces, binned to no tile; most of the rest lie in one
    assert 0.3 < r.metrics["bin_pairs_per_tri"]["value"] < 1
