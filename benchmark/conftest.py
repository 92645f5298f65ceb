"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests that need the card carry the ``chip`` marker and take the
``cuda_device`` fixture, which skips them where there is none: the
decision is made when the test runs, never while a module is imported.
Run them on the card with ``python3 -m pytest benchmark/tests -m chip``.
"""

from pathlib import Path

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


@pytest.fixture(scope="module")
def bench():
    from benchmark.harness import spec

    return spec.load()


#: A small instanced configuration as the new files a checkout would gain
#: (``configs/``, ``limits/``, ``reference/scenes/``, ``reference/shaders/``
#: under ``benchmark/``) and its ``BENCHMARK.json`` entries (``entries.json``).
INSTANCED_CELL = Path(__file__).parent / "tests" / "instanced_cell"


@pytest.fixture
def lay_reference(monkeypatch):
    """``lay(*bench_dirs)``: the scene and shader modules under each
    ``bench_dir/reference/`` are found by name, in that order and ahead of
    the benchmark's own, as files of the checkout would be; for this test
    only."""
    import importlib
    import sys

    laid = []

    def lay(*bench_dirs: Path):
        for kind in ("scenes", "shaders"):
            pkg = importlib.import_module(f"benchmark.reference.{kind}")
            wheres = [d / "reference" / kind for d in bench_dirs]
            monkeypatch.setattr(pkg, "__path__", [*map(str, wheres), *pkg.__path__])
            for f in (f for where in wheres for f in where.glob("*.py")):
                name = f"{pkg.__name__}.{f.stem}"
                monkeypatch.delitem(sys.modules, name, raising=False)
                laid.append(name)
        importlib.invalidate_caches()

    yield lay
    for name in laid:
        sys.modules.pop(name, None)
