"""The present ring's intake at 1080p: 24 frames through a linear ring of
depth 2, each converted to u8 inside ``submit``.  Host only, imports
nothing of the JAX package, so it runs unchanged on the card's host:

    python3 -m pytest tests/test_torch_ring_intake.py -s

prints the mean room -> copied time (the fused f32 -> u8 pass) beside a
``np.copyto`` of the same f32 frame; it asserts no time.
"""

import shutil
import time

import numpy as np
import pytest

from based_renderer_tpu_torch import runtime
from based_renderer_tpu_torch.utils import profiling


def test_ring_intake_at_1080p():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native runtime cannot build here")
    h, w = 1080, 1920
    frame = np.random.default_rng(11).uniform(-0.1, 1.1, (h, w, 4)).astype(np.float32)
    ring = runtime.PresentRing(w, h, depth=2)
    for _ in range(24):
        ring.submit(frame)
    ring.flush()
    ring._drain()
    assert ring.presented == 24
    ring.close()
    rec = sorted((r for r in profiling.ring_records() if r.ring == ring.serial), key=lambda r: r.index)
    assert [r.index for r in rec] == list(range(24))
    for r in rec:
        assert 0 < r.enter_ns <= r.room_ns <= r.copied_ns <= r.popped_ns <= r.converted_ns <= r.freed_ns
        assert r.written_ns == 0
    fused = np.mean([r.copied_ns - r.room_ns for r in rec]) / 1e6
    dst = np.zeros_like(frame)
    copies = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, frame)
        copies.append(time.perf_counter() - t0)
    copy = np.mean(copies) * 1e3
    print(f"\n1080p intake: fused f32 -> u8 pass {fused:.3f} ms a frame; np.copyto of the f32 frame {copy:.3f} ms; "
          f"ratio {fused / copy:.2f}")
