"""The port's native C++ runtime (its own copy of brt_runtime.cpp): arena
allocator, pacer, image IO and present ring, mirroring
tests/test_runtime.py, and its build.

Tolerances: none; every comparison is exact.  f32_to_u8 (linear and sRGB)
equals the JAX package's numpy encoders (utils/image.py to_u8) byte for
byte, and PNGs decode to the bytes written.  The library builds at first
use into build/torch_runtime/ under a hashed name, moved into place
atomically, so concurrent builds (xdist workers, the two processes below)
never load half a file.  Skips only where g++ is missing.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from based_renderer_tpu.utils import image as jimage
from based_renderer_tpu_torch import runtime
from based_renderer_tpu_torch.utils import image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native runtime cannot build here")


def test_arena_batched_layout():
    a = runtime.Arena()
    i0 = a.request(100, alignment=64)
    i1 = a.request(1000, alignment=64)
    i2 = a.request(17, alignment=4096)
    a.finalize()
    # Two alignment classes -> two backing groups (the memory-type
    # grouping of vulkan_allocate).
    assert a.num_groups == 2
    v0 = a.view(i0, (100,))
    v1 = a.view(i1, (1000,))
    v2 = a.view(i2, (17,))
    v0[:] = 1
    v1[:] = 2
    v2[:] = 3
    # Distinct, non-overlapping buffers with requested alignment.
    assert v0.ctypes.data % 64 == 0
    assert v2.ctypes.data % 4096 == 0
    assert (v0 == 1).all() and (v1 == 2).all() and (v2 == 3).all()
    assert a.total_bytes >= 1117


def test_arena_dedicated_allocations():
    """Explicit or size-promoted requests get their own backing block
    instead of a slot in an alignment group."""
    a = runtime.Arena()
    a.set_dedicated_threshold(1 << 20)  # 1 MiB for the test
    i_small = a.request(100, alignment=64)
    i_flag = a.request(200, alignment=64, dedicated=True)
    i_big = a.request((1 << 20) + 5, alignment=64)  # auto-promoted
    a.finalize()
    assert a.num_groups == 1  # only the small request shares a group
    assert a.num_dedicated == 2
    vs = a.view(i_small, (100,))
    vf = a.view(i_flag, (200,))
    vb = a.view(i_big, ((1 << 20) + 5,))
    vs[:] = 1
    vf[:] = 2
    vb[:] = 3
    assert (vs == 1).all() and (vf == 2).all() and (vb == 3).all()
    assert vf.ctypes.data % 64 == 0 and vb.ctypes.data % 64 == 0
    assert a.total_bytes >= (1 << 20) + 305

    # Threshold 0 disables auto-promotion; explicit still honored.
    b = runtime.Arena()
    b.set_dedicated_threshold(0)
    b.request(64 << 20, alignment=64)
    b.request(10, alignment=64, dedicated=True)
    b.finalize()
    assert b.num_groups == 1 and b.num_dedicated == 1


def test_arena_rejects_bad_requests():
    a = runtime.Arena()
    with pytest.raises(ValueError):
        a.request(10, alignment=48)  # not a power of two
    a.request(10)
    a.finalize()
    with pytest.raises(ValueError):
        a.request(10)  # after finalize


def test_arena_views_keep_it_alive():
    a = runtime.Arena()
    i = a.request(4096, alignment=64)
    a.finalize()
    v = a.view(i, (1024,), np.float32)
    del a
    v[:] = 7.0  # the arena is not destroyed while a view of it lives
    assert (v == 7.0).all()


def test_pacer_ticks():
    p = runtime.NativePacer(fixed_dt=0.001, vsync=True)
    t = 0.0
    for _ in range(5):
        t = p.tick()
    assert abs(t - 0.005) < 1e-9


def test_f32_to_u8_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (16, 16, 4)).astype(np.float32)
    got = runtime.f32_to_u8(img)
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimage.to_u8(img))
    np.testing.assert_array_equal(got, image.to_u8(img))


def test_write_png_roundtrip():
    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (20, 30, 4), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.png")
        runtime.write_png(path, img)
        back = np.asarray(Image.open(path))
        ours = image.read_png(path)  # the stdlib-zlib decoder chip_smoke.py reads PNGs with
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(ours, img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_round_trip(tmp_path, channels):
    """read_png decodes the unfiltered PNGs both writers make, and rejects
    a filtered one (PIL filters its scanlines) rather than misread it."""
    from PIL import Image

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (20, 30, channels), dtype=np.uint8)
    image.write_png(tmp_path / "py.png", img)
    runtime.write_png(tmp_path / "native.png", img)
    np.testing.assert_array_equal(image.read_png(tmp_path / "py.png"), img)
    np.testing.assert_array_equal(image.read_png(tmp_path / "native.png"), img)
    ramp = np.broadcast_to(np.arange(30, dtype=np.uint8)[None, :, None] * 8, (20, 30, channels))
    Image.fromarray(ramp.squeeze(-1) if channels == 1 else np.ascontiguousarray(ramp)).save(tmp_path / "pil.png")
    with pytest.raises(ValueError, match="filtered"):
        image.read_png(tmp_path / "pil.png")


def test_present_ring_writes_frames():
    with tempfile.TemporaryDirectory() as d:
        ring = runtime.PresentRing(32, 16, depth=2, out_dir=d)
        frames = [np.full((16, 32, 4), i / 4, np.float32) for i in range(4)]
        for f in frames:
            ring.submit(f)
        ring.flush()
        assert ring.presented == 4
        files = sorted(os.listdir(d))
        assert files == [f"frame_{i:06d}.png" for i in range(4)]
        np.testing.assert_array_equal(image.read_png(os.path.join(d, files[-1])), jimage.to_u8(frames[-1]))
        ring.close()


def test_f32_to_u8_srgb_matches_python():
    """Native sRGB encode equals the JAX package's utils.image.to_u8(srgb=True)
    and the port's (all compute the transfer function in double on this
    host's libm)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, (16, 16, 4)).astype(np.float32)
    got = runtime.f32_to_u8(img, srgb=True)
    np.testing.assert_array_equal(got, jimage.to_u8(img, srgb=True))
    np.testing.assert_array_equal(got, image.to_u8(img, srgb=True))


def test_srgb_encode_anchors():
    # Known sRGB anchor points: 0 -> 0, 1 -> 255, linear 0.5 -> 188
    # (sRGB(0.5) = 0.735357 -> 187.5 + 0.5 rounds to 188); the linear
    # segment boundary 0.0031308 -> 12.92 * 0.0031308 * 255 ~ 10.3 -> 10.
    px = np.asarray([[[0.0, 1.0, 0.5, 0.5]], [[0.0031308, 0.25, 0.75, 1.0]]], np.float32)
    u8 = image.to_u8(px, srgb=True)
    assert u8[0, 0, 0] == 0 and u8[0, 0, 1] == 255
    assert u8[0, 0, 2] == 188
    assert u8[0, 0, 3] == 128  # alpha stays linear
    assert u8[1, 0, 0] == 10
    np.testing.assert_array_equal(runtime.f32_to_u8(px, srgb=True), u8)
    # Monotone and >= linear encode everywhere on [0, 1] RGB.
    ramp = np.linspace(0, 1, 257, dtype=np.float32).reshape(1, -1, 1)
    enc = image.srgb_encode(ramp)
    assert np.all(np.diff(enc[0, :, 0]) >= 0)
    assert np.all(enc >= ramp.astype(np.float64) - 1e-12)
    np.testing.assert_array_equal(enc, jimage.srgb_encode(ramp))


def test_present_ring_srgb_flag():
    from PIL import Image

    img = np.full((16, 32, 4), 0.5, np.float32)
    with tempfile.TemporaryDirectory() as d:
        ring = runtime.PresentRing(32, 16, depth=2, out_dir=d, srgb=True)
        ring.submit(img)
        ring.flush()
        ring.close()
        back = np.asarray(Image.open(os.path.join(d, "frame_000000.png")))
    np.testing.assert_array_equal(back, jimage.to_u8(img, srgb=True))


def test_present_ring_rejects_wrong_extent():
    from based_renderer_tpu_torch.utils.errors import PresentError

    ring = runtime.PresentRing(32, 16, depth=1)
    with pytest.raises(PresentError):
        ring.submit(np.zeros((16, 16, 4), np.float32))
    ring.close()


def test_library_is_named_by_source_and_flags(monkeypatch):
    path = runtime.library_path()
    assert path.parent == runtime.BUILD_DIR and path.name.startswith("libbrt_runtime_")
    assert runtime.available() and runtime.build() == path and path.exists()
    monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ("-g",))
    assert runtime.library_path() != path  # other flags, another build


def test_build_error_is_raised_not_hidden(tmp_path, monkeypatch):
    """A runtime that fails to build leaves available() false, and every
    class raises with g++'s diagnostic: no silent fallback."""
    bad = tmp_path / "brt_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SRC", bad)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    assert not runtime.available()
    for make in (runtime.Arena, lambda: runtime.PresentRing(8, 8), runtime.NativePacer):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            make()
    assert not any((tmp_path / "build").glob("*.so"))  # nothing half-built left in place


_BUILD_AND_LOAD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from based_renderer_tpu_torch import runtime
from based_renderer_tpu_torch.utils import cache
cache.enable_persistent_cache(sys.argv[2])
path = runtime.build()
img = np.linspace(0, 1, 64, dtype=np.float32).reshape(4, 4, 4)
assert (runtime.f32_to_u8(img) == np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)).all()
print(path)
"""


def test_concurrent_builds_load_in_both(tmp_path):
    """Two processes build the library into one empty cache at the same
    time; both load a whole library and agree on its path."""
    cache_dir = str(tmp_path / "cache")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, ROOT, cache_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert path.startswith(os.path.join(cache_dir, "torch_runtime", "libbrt_runtime_"))
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]  # no temporary left behind
