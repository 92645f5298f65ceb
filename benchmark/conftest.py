"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests that need the card carry the ``chip`` marker and take the
``cuda_device`` fixture, which skips them where there is none: the
decision is made when the test runs, never while a module is imported.
Run them on the card with ``python3 -m pytest benchmark/tests -m chip``.
"""

import pytest

#: Small sizes at which a whole run fits in a CPU test: 128x96, 2000
#: triangles, short sequence calls.  Keys are configuration names.
SMALL = {
    "cube_1080p": {"width": 128, "height": 96, "traffic": {"seconds_per_call": 0.1}},
    "big_mesh_4k_msaa4": {"width": 128, "height": 96, "demo_args": {"triangles": 2000},
                          "scene_args": {"triangles": 2000},
                          "traffic": {"seconds_per_call": 0.02}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (an H100); skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip with `python3 -m pytest benchmark/tests -m chip`")
    return torch.device("cuda")


#: The 4K MSAA-4x mesh's configuration and cell, held out of BENCHMARK.json
#: while the demo's pair budget overflows in one view (PERF.md, Open
#: questions).  The CPU tests keep its yardstick working.
HELD_OUT = {
    "configs": [{"name": "big_mesh_4k_msaa4", "source": "BASELINE.json config 5",
                 "file": "benchmark/configs/big_mesh_4k_msaa4.json", "reduced": [],
                 "why": "1M-triangle Blinn-Phong mesh at 4K MSAA-4x"}],
    "workloads": [{"name": "big_mesh_4k_msaa4.sequence", "config": "big_mesh_4k_msaa4", "traffic": "sequence",
                   "chips": 1, "why": "1M triangles at 4K MSAA-4x through render_sequence"}],
}


@pytest.fixture(scope="module")
def bench():
    from benchmark.harness import spec

    return spec.load()


@pytest.fixture(scope="module")
def bench_all(bench):
    """BENCHMARK.json with the held-out configuration and cell added."""
    out = {k: (list(v) if isinstance(v, list) else v) for k, v in bench.items()}
    for key, entries in HELD_OUT.items():
        names = {e["name"] for e in out[key]}
        out[key] += [e for e in entries if e["name"] not in names]
    return out
