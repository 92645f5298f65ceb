"""The one table of kernel routes (ops/_build.py ROUTES), its launch path
and its counter, on the CPU.

Every route names a C entry that csrc/*.cu defines and ``_build._declare``
declares with the stream last, and a device kernel that csrc/ defines;
``_build.launch`` against a stub library counts a launch under its route
and raises on a failed one, counting nothing; a rank reports every kernel
route of the table.
"""

import ctypes
import re
import types

import pytest

from based_renderer_tpu_torch.ops import _build
from based_renderer_tpu_torch.parallel import launch, workers
from based_renderer_tpu_torch.utils import profiling

SOURCES = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))


class _Declared:
    """A stand-in library that keeps what ``_declare`` sets on each entry."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, types.SimpleNamespace())


@pytest.mark.parametrize("route", list(_build.ROUTES))
def test_route_names_an_entry_and_a_kernel_of_csrc(route):
    entry, symbol = _build.ROUTES[route]
    assert re.search(rf'extern "C" cudaError_t {entry}\(', SOURCES), entry
    assert re.search(rf"__global__ void (__launch_bounds__\([^)]*\) )?{symbol}\(", SOURCES), symbol
    lib = _Declared()
    _build._declare(lib)
    assert lib.entries[entry].restype is ctypes.c_int
    assert lib.entries[entry].argtypes[-1] is ctypes.c_void_p  # the stream, which launch appends


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_of_a_route_counts_or_raises(rc, monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return rc

    monkeypatch.setattr(_build, "_lib", types.SimpleNamespace(brt_raster_tile=entry))
    monkeypatch.setattr(_build, "stream", lambda dev: ("stream", dev))
    before = profiling.ROUTES_TAKEN.copy()
    if rc:
        with pytest.raises(RuntimeError, match="raster_two_pass kernel launch failed: cudaError 700"):
            _build.launch("raster_two_pass", 1, 2, dev="cpu")
    else:
        _build.launch("raster_two_pass", 1, 2, dev="cpu")
    assert calls == [(1, 2, ("stream", "cpu"))]
    counted = {k: profiling.ROUTES_TAKEN[k] - before[k] for k in set(profiling.ROUTES_TAKEN) | set(before)}
    assert {k: v for k, v in counted.items() if v} == ({} if rc else {"raster_two_pass": 1})


def test_rank_reports_every_kernel_route():
    """A rank's report has every kernel route of the table, by name; on
    the CPU none launched."""
    spec = {"mesh": (1, 1), "config": {"width": 128, "height": 64}, "draws": [{"demo": "cube", "t": 0.5}]}
    (res,), = launch.run(workers.run_specs, (1, 1), ([spec],), backend="gloo", devices="cpu", timeout=300)
    for key in ("launches", "frame_launches"):
        assert res[key] == dict.fromkeys(_build.ROUTES, 0)
