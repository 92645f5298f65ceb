"""The port's native C++ runtime (its own copy of brt_runtime.cpp's present
path): the f32 -> u8 converters, image IO and the present ring, mirroring
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
import threading

import numpy as np
import pytest

from based_renderer_tpu.utils import image as jimage
from based_renderer_tpu_torch import runtime
from based_renderer_tpu_torch.utils import image, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native runtime cannot build here")


def test_f32_to_u8_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (16, 16, 4)).astype(np.float32)
    got = runtime.f32_to_u8(img)
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimage.to_u8(img))
    np.testing.assert_array_equal(got, image.to_u8(img))


def _adversarial() -> np.ndarray:
    """Every rounding edge (k - 0.5) / 255 and its neighbours one ulp
    away, signed zeros, subnormals, out-of-range and non-finite values,
    and a uniform spread."""
    edges = ((np.arange(257) - 0.5) / 255).astype(np.float32)
    f32 = np.finfo(np.float32)
    sub = np.nextafter(np.float32(0), np.float32(1))
    special = np.asarray([0.0, -0.0, sub, -sub, f32.tiny - sub, -(f32.tiny - sub), f32.tiny, -1.0, -0.25, -1e30,
                          1.0, np.nextafter(np.float32(1), np.float32(2)), 2.0, 1e30, f32.max, -f32.max,
                          np.inf, -np.inf, np.nan, -np.nan], np.float32)
    spread = np.random.default_rng(7).uniform(-0.5, 1.5, 301).astype(np.float32)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    return np.concatenate([edges, np.nextafter(edges, down), np.nextafter(edges, up), special, spread])


def _want_u8(x: np.ndarray) -> np.ndarray:
    """The JAX package's to_u8, with NaN pinned to 0 (numpy's NaN -> uint8
    cast is undefined)."""
    with np.errstate(over="ignore", invalid="ignore"):
        want = jimage.to_u8(x)
    want[np.isnan(x)] = 0
    return want


def _at_offset(a: np.ndarray, offset: int) -> np.ndarray:
    """A contiguous copy of ``a`` whose data starts ``offset`` bytes past a
    64-byte boundary."""
    buf = np.zeros(a.nbytes + 64 + offset, np.uint8)
    start = -buf.ctypes.data % 64 + offset
    out = buf[start:start + a.nbytes].view(a.dtype)
    out[:] = a
    return out


@pytest.mark.parametrize("n", [*range(1, 48), 37 * 5 * 4])
def test_f32_to_u8_exact_on_adversarial_values(n):
    """The SSE2 blocks and the scalar tail equal numpy on every edge, in
    chunks of n (so each length's tail), from aligned and from unaligned
    source and destination addresses."""
    x = _adversarial()
    fn = runtime.require().brt_f32_to_u8
    for src_off, dst_off in ((0, 0), (4, 1)):
        for start in range(0, len(x), n):
            chunk = x[start:start + n]
            src, dst = _at_offset(chunk, src_off), _at_offset(np.zeros(len(chunk), np.uint8), dst_off)
            fn(src.ctypes.data, dst.ctypes.data, len(chunk))
            np.testing.assert_array_equal(dst, _want_u8(chunk), err_msg=f"at {start}, offsets {src_off}/{dst_off}")


def test_f32_to_u8_public_path_is_the_same_body():
    x = _adversarial()
    src = _at_offset(x, 4)
    assert src.ctypes.data % 16 == 4  # unaligned loads
    got = runtime.f32_to_u8(src)
    np.testing.assert_array_equal(got, _want_u8(x))
    assert got[np.isnan(x)].tolist() == [0, 0]


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


def _edge_frames(count: int, h: int = 23, w: int = 37) -> list:
    """Frames of out-of-range, non-finite and rounding-edge values (h * w
    * 4 not a multiple of 16, so each ends in the scalar tail)."""
    x = np.resize(_adversarial(), h * w * 4)
    return [np.roll(x, 97 * i).reshape(h, w, 4) for i in range(count)]


def _ring_records(ring) -> list:
    ring._drain()
    return sorted((r for r in profiling.ring_records() if r.ring == ring.serial), key=lambda r: r.index)


@pytest.mark.parametrize("srgb", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_ring_pngs_equal_write_png_of_f32_to_u8(tmp_path, depth, srgb):
    """The ring converts in submit; the PNGs it writes are those of
    write_png(f32_to_u8(frame, srgb)), byte for byte."""
    frames = _edge_frames(6)
    (tmp_path / "ring").mkdir()
    (tmp_path / "direct").mkdir()
    ring = runtime.PresentRing(37, 23, depth=depth, out_dir=str(tmp_path / "ring"), srgb=srgb)
    for f in frames:
        ring.submit(f)
    ring.flush()
    assert ring.presented == len(frames)
    ring.close()
    for i, f in enumerate(frames):
        name = f"frame_{i:06d}.png"
        runtime.write_png(tmp_path / "direct" / name, runtime.f32_to_u8(f, srgb=srgb))
        assert (tmp_path / "ring" / name).read_bytes() == (tmp_path / "direct" / name).read_bytes()
        if not srgb:
            np.testing.assert_array_equal(image.read_png(tmp_path / "ring" / name), _want_u8(f))


@pytest.mark.parametrize("srgb", [False, True])
def test_submit_frees_the_callers_array(tmp_path, srgb):
    """One array, refilled after each submit while the worker is still
    writing earlier PNGs: every PNG holds the frame as it was submitted."""
    ring = runtime.PresentRing(64, 48, depth=3, out_dir=str(tmp_path), srgb=srgb)
    buf = np.empty((48, 64, 4), np.float32)
    for i in range(8):
        buf[:] = (i * 29 + 3) / 255
        ring.submit(buf)
    ring.flush()
    assert ring.presented == 8
    ring.close()
    for i in range(8):
        want = runtime.f32_to_u8(np.full((48, 64, 4), (i * 29 + 3) / 255, np.float32), srgb=srgb)
        np.testing.assert_array_equal(image.read_png(tmp_path / f"frame_{i:06d}.png"), want)


@pytest.mark.parametrize("depth", [1, 2])
def test_submit_blocks_while_depth_frames_wait(tmp_path, depth):
    """Frame i finds room only once frame i - depth has left the ring, and
    with a worker slowed by PNG writes some submit has to wait for it."""
    rng = np.random.default_rng(5)
    frames = [rng.random((192, 256, 4), dtype=np.float32) for _ in range(2)]
    ring = runtime.PresentRing(256, 192, depth=depth, out_dir=str(tmp_path))
    for i in range(10):
        ring.submit(frames[i % 2])
    ring.flush()
    rec = _ring_records(ring)
    ring.close()
    assert [r.index for r in rec] == list(range(10))
    for r in rec:
        assert 0 < r.enter_ns <= r.room_ns <= r.copied_ns <= r.popped_ns <= r.converted_ns <= r.written_ns <= r.freed_ns
    for r, older in zip(rec[depth:], rec):
        assert r.room_ns >= older.popped_ns
    assert any(r.enter_ns < older.popped_ns for r, older in zip(rec[depth:], rec))


def _submit_from_threads(out_dir, threads: int, each: int) -> list:
    """Submit threads * each uniform frames from ``threads`` threads at once
    to one ring of depth 8; the ring's records, after its counters are
    checked."""
    ring = runtime.PresentRing(256, 128, depth=8, out_dir=str(out_dir))
    frames = [[np.full((128, 256, 4), (t * each + j + 1) / 255, np.float32) for j in range(each)]
              for t in range(threads)]

    def submit_all(own):
        for f in own:
            ring.submit(f)

    workers = [threading.Thread(target=submit_all, args=(own,)) for own in frames]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    ring.flush()
    assert ring.presented == threads * each
    rec = _ring_records(ring)
    ring.close()
    return rec


def test_concurrent_submitters_keep_every_frame(tmp_path):
    """More submitting threads than cores on one ring, four times over:
    every frame gets its own index and slot (each PNG is its own uniform
    frame, none lost or overwritten), and frames reach the worker in index
    order."""
    threads, each = 3 * (os.cpu_count() or 4), 6
    n = threads * each
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for round_ in range(4):
            out = tmp_path / str(round_)
            out.mkdir()
            rec = _submit_from_threads(out, threads, each)
            assert [r.index for r in rec] == list(range(n))
            assert all(a.popped_ns <= b.popped_ns for a, b in zip(rec, rec[1:])), "queued out of index order"
            images = [image.read_png(out / f"frame_{i:06d}.png") for i in range(n)]
            assert all((im == im.flat[0]).all() for im in images)
            assert sorted(int(im.flat[0]) for im in images) == list(range(1, n + 1))
    finally:
        sys.setswitchinterval(interval)


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
    """A runtime that fails to build leaves available() false, and the
    present ring raises with g++'s diagnostic: no silent fallback."""
    bad = tmp_path / "brt_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SRC", bad)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    assert not runtime.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.PresentRing(8, 8)
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
