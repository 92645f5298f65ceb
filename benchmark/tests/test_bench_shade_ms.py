"""The reader of ``shade_ms`` on a made-up traced window: the fused shading
kernel's device time over the traced frames, by the kernel's name, and None
where it did not run."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import DeviceEvent, Trace

W0 = 1_000_000_000
KERNEL = "void (anonymous namespace)::shade_blinn_phong_kernel<4, false, true>(float const*, int, float*)"


def _readings(device, frames=4):
    return SimpleNamespace(trace=Trace((W0, W0 + 100_000_000), device, []), traced_frames=frames)


def _ev(name, start_ms, dur_ms, kind="kernel"):
    return DeviceEvent(name, kind, W0 + int(start_ms * 1e6), W0 + int((start_ms + dur_ms) * 1e6))


def test_shade_ms_sums_the_kernel_over_the_frames():
    device = [_ev(KERNEL, 1, 0.5), _ev(KERNEL, 11, 0.25), _ev("raster_msaa4_sublane_kernel", 2, 0.9),
              _ev("elementwise_kernel", 3, 2.0), _ev("shade_blinn_phong copy", 4, 1.0, kind="memcpy")]
    assert spec.reader("shade_ms").read(_readings(device)) == pytest.approx(0.75 / 4)


@pytest.mark.parametrize("readings", [
    _readings([_ev("elementwise_kernel", 1, 2.0), _ev("raster_msaa4_sublane_kernel", 2, 0.9)]),
    _readings([_ev(KERNEL, 1, 0.5)], frames=0),
    SimpleNamespace(trace=None, traced_frames=4),
], ids=["kernel_absent", "no_frames", "untraced"])
def test_shade_ms_reads_none_without_the_kernel(readings):
    """The parent's frames shade without the fused kernel: nothing to read."""
    assert spec.reader("shade_ms").read(readings) is None
