"""Adversarial clip-space streams of the rasterization spec (a test aid).

The port's own copies of the JAX package's hardest test inputs
(``tests/test_spec_adversarial.py`` and ``tests/test_raster_bitexact.py``),
as numpy generators made from a seed and parametrised by the framebuffer
(``width``, ``height``), plus two new ones: a ground plane cut by the near
plane, and a seeded mix of all of them.  At 96x64 every stream taken from
a JAX test is that test's input bit for bit; at other sizes the screen
coordinates are re-based to the extent, so a regime must be asserted
again at each size (``assert_engaged``).  Nothing here is part of the
renderer: ``tests/test_torch_adversarial.py`` and ``chip_smoke.py`` (phase
7b) both read these streams.

The raster states the streams also run under (``tests/
test_torch_adversarial_state.py`` and ``chip_smoke.py`` phase 7c), each with
its expected planes and an engagement check of its own:
  scissors        rects (tile-aligned, off-grid with odd edges, one pixel,
                  to the far edge, the full frame); scissor_expect masks
                  the unscissored oracle (assert_scissor_engaged)
  bias_triples    depth-bias (constant, slope, clamp) triples: constants of
                  both signs, slopes at the +/-2^29 clip, binding clamps,
                  constants past [0, 1], and one whose int32 sum wraps
                  (assert_bias_engaged)
  BAND_ROWS       band heights of band binning per tile
                  (assert_bands_engaged)
  windows         shard windows (origin, extent); window_expect crops the
                  full-frame oracle (assert_window_engaged)
  supersampling   the stream at 2W x 2H (assert_supersample_engaged)

Streams (name: what it engages):
  slivers         sub-pixel slivers spanning the depth range (the JAX
                  test's), then copies of clamp_boundary moved around the
                  screen: some |dzdx_q| or |dzdy_q| == DEPTH_GRAD_CLAMP,
                  some coverage
  clamp_boundary  a half-pixel-tall sliver whose quantized y gradient
                  lands on the clamp's rint boundary: max |dzdy_q| ==
                  DEPTH_GRAD_CLAMP, more than 40 covered pixels
  guard_band      vertices at and beyond +/-8192 px, and a seeded fuzz of
                  vertices from {+/-2g, +/-g, +/-(g - 1), 0, W, H}: a snapped
                  coordinate at GUARD_LO/GUARD_HI, an edge anchor at
                  +/-ANCHOR_CLAMP in some record
  zshift_flat     constant-depth triangles: some zshift == 0
  zshift_steep    2-subpixel micro-triangles over the whole depth window
                  (the JAX test's, which cover no pixel), then thin ones as
                  steep that do: max zshift >= 18, pixels won at zshift >= 18
  near_plane      a ground-plane grid through the camera, straddling w = 0,
                  cut by ops.clip.clip_near: cut vertices clamped to the
                  guard band, some coverage
  degenerate      zero-area, off-screen and w < 0 triangles, then one valid
                  one: triangles 0-2 cover nothing, 3 covers
  shared_edge     a quad split on its diagonal: the halves' coverage is
                  disjoint and their union is the quad's
  random          random clip-space triangles (for every depth compare and
                  cull mode)
  empty           no triangles (T = 0)
  fuzz            a seeded mix of the streams above
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.clip import clip_near
from ..ops.fixedpoint import ANCHOR_CLAMP, DEPTH_GRAD_CLAMP, DEPTH_ONE_Q, GUARD_BAND_PIX, GUARD_HI, GUARD_LO

STREAMS = (
    "slivers",
    "clamp_boundary",
    "guard_band",
    "zshift_flat",
    "zshift_steep",
    "near_plane",
    "degenerate",
    "shared_edge",
    "random",
    "empty",
)


def screen_to_clip(sx, sy, z, width: int, height: int) -> np.ndarray:
    """Screen-space pixels and depth -> clip positions with w = 1
    (ndc = 2 * s / extent - 1; test_spec_adversarial.py:24-36)."""
    sx = np.asarray(sx, np.float32)
    sy = np.asarray(sy, np.float32)
    z = np.asarray(z, np.float32)
    nx = sx / np.float32(width) * 2 - 1
    ny = sy / np.float32(height) * 2 - 1
    return np.stack([nx, ny, z, np.ones_like(nx)], axis=-1).astype(np.float32)


def _rebase(width: int, height: int) -> tuple[int, int]:
    """A whole number of 128-px depth tiles to move a construction made for
    96x64 towards the middle of a larger screen: (0, 0) at 96x64, so the
    JAX inputs stay bit for bit, and the tile-relative geometry (the
    depth anchors) unchanged elsewhere."""
    return (width // 256) * 128, (height // 256) * 128


def slivers(width: int, height: int, seed: int = 0, n: int = 220, clamped: int = 16) -> np.ndarray:
    """Nearly degenerate triangles spanning the depth range over a
    subpixel-scale screen extent: the first ``n`` are
    test_spec_adversarial.py:55-78's (its seeds 100-104 for ``seed`` 0-4),
    then ``clamped`` slivers of clamp_slivers.  The JAX stream alone never
    reaches DEPTH_GRAD_CLAMP: the adaptive exponent scales the larger
    gradient into [2^20, 2^21), so only a gradient within half a unit of
    2^21 rounds onto the clamp (about one triangle in 2^21)."""
    rng = np.random.default_rng(100 + seed)
    bx = rng.uniform(2.0, width - 2.0, size=n).astype(np.float32)
    by = rng.uniform(2.0, height - 2.0, size=n).astype(np.float32)
    length = rng.uniform(0.05, 2.0, size=n).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    off = rng.uniform(1.0 / 32, 4.0 / 16, size=n).astype(np.float32)
    dx, dy = np.cos(theta) * length, np.sin(theta) * length
    sx = np.stack([bx, bx + dx, bx + dx * 0.5 - dy / length * off], -1)
    sy = np.stack([by, by + dy, by + dy * 0.5 + dx / length * off], -1)
    z0 = rng.uniform(0.0, 0.2, size=n).astype(np.float32)
    z1 = rng.uniform(0.8, 1.0, size=n).astype(np.float32)
    zm = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    jax_slivers = screen_to_clip(sx, sy, np.stack([z0, z1, zm], -1), width, height)
    return np.concatenate([jax_slivers, clamp_slivers(width, height, seed, clamped)])


def clamp_slivers(width: int, height: int, seed: int = 0, n: int = 16) -> np.ndarray:
    """``n`` copies of clamp_boundary's construction, each moved to a
    seeded place on the snap grid, lying along x or along y, its depth
    rising or falling across its half-pixel thickness, and placed so a row
    (or column) of pixel centres lies inside it at a depth in (0, 1).
    Moves keep A, B, area2 = 2^13 and zq2 - zq0 = +/-(2^27 - 8), so every
    one has a quantized gradient of +/-DEPTH_GRAD_CLAMP."""
    rng = np.random.default_rng(200 + seed)
    out = []
    for _ in range(n):
        along_y = bool(rng.integers(0, 2)) and height * 16 >= 1024
        span, across = (height, width) if along_y else (width, height)
        c = int(rng.integers(1, 8))  # subpixel units from the edge to the centre row
        lo = int(rng.integers(0, span * 16 - 1024 + 1))
        row = int(rng.integers(0, across))
        up = bool(rng.integers(0, 2))  # the sliver lies above its edge row (or left of it)
        edge = row * 16 + 8 + (c if up else -c)
        thick = -8 if up else 8
        d = float(rng.uniform(0.05, 0.95))
        step = (2**27 - 8) * (1 if rng.integers(0, 2) else -1)  # zq2 - zq0
        k = int(round((d * 2**24 - step * c / 8) / 128))
        zq0 = np.clip(128 * k, -(1 << 29), (1 << 29) - (2**27 - 8) * (step > 0))
        z0 = np.float32(zq0) * np.float32(2.0**-24)
        z2 = np.float32(zq0 + step) * np.float32(2.0**-24)
        u = np.array([lo, lo + 1024, lo], np.float32) / 16.0
        v = np.array([edge, edge, edge + thick], np.float32) / 16.0
        sx, sy = (v, u) if along_y else (u, v)
        out.append(screen_to_clip(sx[None], sy[None], np.array([[z0, z0, z2]], np.float32), width, height))
    return np.concatenate(out) if out else np.zeros((0, 3, 4), np.float32)


def clamp_boundary(width: int, height: int) -> np.ndarray:
    """The round-1 divergence sliver (test_spec_adversarial.py:89-116):
    v0 = (4, 71), v1 = (1028, 71), v2 = (4, 79) in 1/16 px, area2 = 2^13,
    zq2 - zq0 = 2^27 - 8, so gy16 = 2^28 - 16, zshift 13, and the
    quantized y gradient rint(2^21) clamps to 2^21 - 1."""
    rx, ry = _rebase(width, height)
    k = -35000
    sx = np.array([[4, 1028, 4]], np.float32) / 16.0 + np.float32(rx)
    sy = np.array([[71, 71, 79]], np.float32) / 16.0 + np.float32(ry)
    z0 = np.float32(128 * k) * np.float32(2.0**-24)
    z2 = np.float32(128 * k + 2**27 - 8) * np.float32(2.0**-24)
    return screen_to_clip(sx, sy, np.array([[z0, z0, z2]], np.float32), width, height)


def guard_band(width: int, height: int) -> np.ndarray:
    """Vertices at and beyond the +/-8192 px guard band
    (test_spec_adversarial.py:125-150)."""
    g = float(GUARD_BAND_PIX)
    sx = np.array([[-g, width + 40.0, 30.0], [-g * 2, g * 2, 40.0], [width / 2, g, -g]], np.float32)
    sy = np.array([[-g, -10.0, height + 30.0], [height / 3, height / 2, g * 2], [-g, height / 2, height / 2]],
                  np.float32)
    z = np.array([[0.1, 0.9, 0.5], [0.0, 1.0, 0.5], [0.3, 0.7, 0.2]], np.float32)
    return screen_to_clip(sx, sy, z, width, height)


def guard_band_fuzz(width: int, height: int, seed: int = 0, n: int = 24) -> np.ndarray:
    """``n`` triangles whose vertices are drawn from {+/-2g, +/-g,
    +/-(g - 1), 0, W} in x and the same with H in y (g = 8192 px), half of
    them jittered by up to a pixel; depths uniform in [0, 1]."""
    rng = np.random.default_rng(300 + seed)
    g = float(GUARD_BAND_PIX)
    base = np.array([-2 * g, -g, -(g - 1), 0.0, g - 1, g, 2 * g], np.float32)
    xs = np.append(base, np.float32(width))
    ys = np.append(base, np.float32(height))
    sx = rng.choice(xs, size=(n, 3)).astype(np.float32)
    sy = rng.choice(ys, size=(n, 3)).astype(np.float32)
    jitter = rng.random(size=(n, 3, 2)) < 0.5
    sx = sx + np.where(jitter[..., 0], rng.uniform(-1, 1, size=(n, 3)), 0).astype(np.float32)
    sy = sy + np.where(jitter[..., 1], rng.uniform(-1, 1, size=(n, 3)), 0).astype(np.float32)
    z = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return screen_to_clip(sx, sy, z, width, height)


def zshift_flat(width: int, height: int, n: int = 64) -> np.ndarray:
    """Constant-depth triangles of ordinary size: zshift 0
    (test_spec_adversarial.py:153-188, mode "flat")."""
    rng = np.random.default_rng(7)
    bx = rng.uniform(2, width - 20, size=n).astype(np.float32)
    by = rng.uniform(2, height - 20, size=n).astype(np.float32)
    sx = np.stack([bx, bx + 15, bx + 4], -1)
    sy = np.stack([by, by + 3, by + 12], -1)
    zc = rng.uniform(0, 1, size=n).astype(np.float32)
    return screen_to_clip(sx, sy, np.stack([zc, zc, zc], -1), width, height)


def zshift_steep(width: int, height: int, n: int = 64, covering: int = 32) -> np.ndarray:
    """Micro-triangles (2 subpixel units) spanning the whole +/-2^29
    quantized-depth window: the steepest planes, zshift >= 18.  The first
    ``n`` are test_spec_adversarial.py:153-188's (mode "steep"), which
    cover no pixel centre; then ``covering`` steep_covering triangles."""
    rng = np.random.default_rng(8)
    bx = rng.uniform(2, width - 20, size=n).astype(np.float32)
    by = rng.uniform(2, height - 20, size=n).astype(np.float32)
    bx = np.rint(bx * 16) / np.float32(16)
    by = np.rint(by * 16) / np.float32(16)
    sx = np.stack([bx, bx + 2.0 / 16, bx], -1)
    sy = np.stack([by, by, by + 2.0 / 16], -1)
    z = np.tile(np.float32([-32.0, 32.0, 32.0]), (n, 1))
    jax_steep = screen_to_clip(sx, sy, z, width, height)
    return np.concatenate([jax_steep, steep_covering(width, height, covering)])


def steep_covering(width: int, height: int, n: int = 32, seed: int = 0) -> np.ndarray:
    """``n`` thin triangles as steep as the depth window allows that cover
    a pixel centre: across the gradient 2 or 4 subpixel units wide at the
    base (vertex depths -32 and +32, zshift 19 or 18), 80 long, the centre
    halfway up at a depth in (0, 0.5), where the plane's unit value is
    negative (the rescale of a negative value by a large zshift)."""
    rng = np.random.default_rng(400 + seed)
    px = rng.integers(1, width - 1, size=n)
    py = rng.integers(3, height - 3, size=n)
    out = []
    for i in range(n):
        half = int(rng.choice([1, 2]))  # half the base: 2 or 4 units wide
        d = np.float32(rng.uniform(0.05, 0.45))
        u = np.array([-half, half, 0], np.float32)  # across the gradient
        v = np.array([-40, -40, 40], np.float32)  # along it
        z = np.array([-32.0, 32.0, 2 * d], np.float32)
        if rng.integers(0, 2):
            z[:2] = z[1::-1]
        cx, cy = px[i] * 16 + 8, py[i] * 16 + 8
        ox, oy = (v, u) if rng.integers(0, 2) else (u, v)
        out.append(screen_to_clip(((cx + ox) / 16)[None], ((cy + oy) / 16)[None], z[None], width, height))
    return np.concatenate(out)


def near_plane_raw(width: int, height: int, grid: int = 8) -> np.ndarray:
    """A ground plane through the camera, before the near clip: a grid of
    ``grid`` x ``grid`` quads on y = 0 spanning x in [-20, 20] and z in
    [-60, 12], seen by a camera 1.5 above it at the origin, looking down
    -z with a 20 degree pitch (Vulkan clip space: y down, depth in [0, 1],
    near 0.1, far 100, 60 degree field of view).  The quads behind the
    camera have w < 0, those beside it straddle w = 0."""
    xs = np.linspace(-20.0, 20.0, grid + 1, dtype=np.float32)
    zs = np.linspace(-60.0, 12.0, grid + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    i = np.arange(grid)
    i0 = (i[:, None] * (grid + 1) + i[None, :]).reshape(-1)
    quads = np.stack([i0, i0 + 1, i0 + grid + 2, i0 + grid + 1], -1)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    pitch = np.float32(np.radians(20.0))
    c, s = np.cos(pitch), np.sin(pitch)
    wx = gx.reshape(-1)
    wy = np.full_like(wx, -1.5)  # the plane, relative to the eye
    wz = gz.reshape(-1)
    vy = c * wy - s * wz
    vz = s * wy + c * wz
    f = np.float32(1.0 / np.tan(np.radians(30.0)))
    near, far = np.float32(0.1), np.float32(100.0)
    clip = np.stack(
        [
            wx * (f / np.float32(width / height)),
            -vy * f,
            vz * (far / (near - far)) + (near * far / (near - far)),
            -vz,
        ],
        -1,
    ).astype(np.float32)
    return clip[tris]


def near_plane(width: int, height: int, grid: int = 8) -> np.ndarray:
    """near_plane_raw through the port's near clip (ops.clip.clip_near,
    on the CPU): (2T, 3, 4), two slots per input triangle."""
    pos, _ = clip_near(torch.from_numpy(near_plane_raw(width, height, grid)), {})
    return pos.numpy()


def degenerate() -> np.ndarray:
    """Zero-area, fully off-screen and behind-camera (w < 0) triangles,
    then a valid one (test_raster_bitexact.py:55-75)."""
    return np.array(
        [
            [[0, 0, 0.5, 1], [0.5, 0.5, 0.5, 1], [1, 1, 0.5, 1]],
            [[5, 5, 0.5, 1], [6, 5, 0.5, 1], [5, 6, 0.5, 1]],
            [[0, 0, 0.5, -1], [0.5, 0, 0.5, -1], [0, 0.5, 0.5, -1]],
            [[-0.8, -0.8, 0.25, 1], [0.8, -0.6, 0.25, 1], [0.0, 0.9, 0.25, 1]],
        ],
        dtype=np.float32,
    )


def shared_edge() -> np.ndarray:
    """A quad split along its diagonal into two triangles
    (test_raster_bitexact.py:77-104)."""
    bl, br = [-0.7, -0.6, 0.5, 1.0], [0.8, -0.7, 0.5, 1.0]
    tr, tl = [0.75, 0.66, 0.5, 1.0], [-0.66, 0.71, 0.5, 1.0]
    return np.array([[bl, br, tr], [bl, tr, tl]], dtype=np.float32)


def random_tris(seed: int, n: int = 24, spread: float = 1.2) -> np.ndarray:
    """Clip-space triangles, mostly on screen, random w per vertex
    (test_raster_bitexact.py:17-23, default_rng(seed))."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-spread, spread, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0.0, 1.0, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], axis=-1).astype(np.float32)


def empty() -> np.ndarray:
    """The empty draw (test_raster_bitexact.py:129-134)."""
    return np.zeros((0, 3, 4), np.float32)


def fuzz(width: int, height: int, seed: int, large: int = 48) -> np.ndarray:
    """A seeded mix of the streams: some slivers, steep and flat
    micro-triangles, guard-band, near-plane and random triangles, in a
    shuffled draw order, with at most ``large`` triangles that can cover
    much of the screen (the guard-band, near-plane and random ones)."""
    rng = np.random.default_rng(1000 + seed)
    small = [
        slivers(width, height, seed=int(rng.integers(0, 1 << 16)), n=int(rng.integers(20, 120))),
        zshift_steep(width, height)[: int(rng.integers(1, 64))],
        zshift_flat(width, height)[: int(rng.integers(1, 64))],
        clamp_boundary(width, height),
    ]
    big = np.concatenate([
        guard_band(width, height),
        guard_band_fuzz(width, height, seed=int(rng.integers(0, 1 << 16)), n=16),
        near_plane(width, height, grid=4),
        random_tris(int(rng.integers(0, 1 << 16)), n=16),
    ])
    big = big[rng.permutation(big.shape[0])[:large]]
    clip = np.concatenate([*small, big])
    return clip[rng.permutation(clip.shape[0])]


def cases(width: int, height: int, fuzz_seeds=()) -> list[tuple[str, str, np.ndarray]]:
    """Every stream's cases at this size: (stream, label, clip)."""
    out = [("slivers", f"slivers seed {s}", slivers(width, height, seed=s)) for s in range(5)]
    out += [
        ("clamp_boundary", "clamp_boundary", clamp_boundary(width, height)),
        ("guard_band", "guard_band", guard_band(width, height)),
    ]
    out += [("guard_band", f"guard_band fuzz {s}", guard_band_fuzz(width, height, seed=s)) for s in range(2)]
    out += [
        ("zshift_flat", "zshift_flat", zshift_flat(width, height)),
        ("zshift_steep", "zshift_steep", zshift_steep(width, height)),
        ("near_plane", "near_plane", near_plane(width, height)),
        ("degenerate", "degenerate", degenerate()),
        ("shared_edge", "shared_edge", shared_edge()),
    ]
    out += [("random", f"random seed {s}", random_tris(s)) for s in range(4)]
    out += [("empty", "empty", empty())]
    out += [("fuzz", f"fuzz seed {s}", fuzz(width, height, s)) for s in fuzz_seeds]
    return out


def assert_engaged(stream: str, ts, tri_id=None, records=None, total=None) -> str:
    """Raise AssertionError unless the stream's regime is engaged; return
    what was seen.

    ``ts`` is the port's TriSetup of the stream (any device); ``tri_id``
    the oracle's or a route's (H, W) winners, needed for the coverage
    claims; ``records`` and ``total`` an int record stream of the draw
    and its live slot count, needed for guard_band's anchor claim.
    """
    valid = ts.valid.cpu().numpy()
    if stream == "empty":
        if valid.shape[0] != 0:
            raise AssertionError(f"empty stream has {valid.shape[0]} triangles")
        return "T = 0"
    cov = None if tri_id is None else np.asarray(tri_id.cpu() if hasattr(tri_id, "cpu") else tri_id)
    covered = None if cov is None else int((cov >= 0).sum())

    def need(ok, what):
        if not ok:
            raise AssertionError(f"{stream}: regime not engaged: {what}")

    if stream in ("slivers", "clamp_boundary"):
        gx = np.abs(ts.dzdx_q.cpu().numpy())[valid]
        gy = np.abs(ts.dzdy_q.cpu().numpy())[valid]
        if stream == "slivers":
            need(((gx == DEPTH_GRAD_CLAMP) | (gy == DEPTH_GRAD_CLAMP)).any(), "no gradient at DEPTH_GRAD_CLAMP")
            need(covered is None or covered > 0, "no coverage")
        else:
            need(gy.size and gy.max() == DEPTH_GRAD_CLAMP, "max |dzdy_q| is not DEPTH_GRAD_CLAMP")
            need(covered is None or covered > 40, f"{covered} covered pixels, not > 40")
        return f"{int(((gx == DEPTH_GRAD_CLAMP) | (gy == DEPTH_GRAD_CLAMP)).sum())} clamped gradients"
    if stream in ("guard_band", "near_plane"):
        xf, yf = ts.xf.cpu().numpy()[valid], ts.yf.cpu().numpy()[valid]
        at_guard = int(np.isin(xf, (GUARD_LO, GUARD_HI)).sum() + np.isin(yf, (GUARD_LO, GUARD_HI)).sum())
        need(at_guard > 0, "no snapped coordinate at the guard band")
        seen = f"{at_guard} coordinates at the guard band"
        if stream == "near_plane":
            need(covered is None or covered > 0, "no coverage")
        elif records is not None:
            live = int(total) if total is not None else records.shape[1]
            eb = records[:3, :live].cpu().numpy()
            anchors = int((np.abs(eb) == ANCHOR_CLAMP).sum())
            need(anchors > 0, "no edge anchor at ANCHOR_CLAMP")
            seen += f", {anchors} anchors clamped"
        return seen
    if stream in ("zshift_flat", "zshift_steep"):
        zs_all = ts.zshift.cpu().numpy()
        zs = zs_all[valid]
        if stream == "zshift_flat":
            need((zs == 0).any(), "no zshift 0")
            need(covered is None or covered > 0, "no coverage")
            return f"zshift {int(zs.min())}..{int(zs.max())}"
        need(zs.size and zs.max() >= 18, f"max zshift {zs.max() if zs.size else None} < 18")
        seen = f"zshift {int(zs.min())}..{int(zs.max())}"
        if cov is not None:
            steep = int((zs_all[cov[cov >= 0]] >= 18).sum())
            need(steep > 0, "no pixel won by a triangle of zshift >= 18")
            seen += f", {steep} pixels won at zshift >= 18"
        return seen
    if stream == "degenerate":
        if cov is not None:
            need(not np.isin(cov, (0, 1, 2)).any(), "a degenerate triangle covers pixels")
            need((cov == 3).any(), "the valid triangle covers nothing")
        return "triangles 0-2 cover nothing"
    return f"{covered} covered" if covered is not None else "no claim"


def assert_shared_edge(alone_a, alone_b, both) -> int:
    """The fill rule on shared_edge: (H, W) winners of each half drawn
    alone and of both (depth test off); the halves' coverage is disjoint
    and its union is the quad's.  Returns the quad's covered pixels."""
    a, b, ab = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) >= 0 for x in (alone_a, alone_b, both))
    if (a & b).any():
        raise AssertionError(f"shared_edge: {int((a & b).sum())} pixels covered by both halves")
    if not np.array_equal(a | b, ab):
        raise AssertionError("shared_edge: the halves' union is not the quad's coverage")
    return int(ab.sum())


# ---- raster states (phase 7c) ------------------------------------------

# Band rows of band binning (rasterize_vis bin_rows) per sublane tile.
BAND_ROWS = (((128, 8), (1, 2, 4, 8)), ((128, 32), (8, 16)))


def _down(v: int, m: int) -> int:
    return v // m * m


def scissors(width: int, height: int) -> list[tuple[str, tuple]]:
    """(label, (x0, y0, x1, y1)) scissor rects, x1 and y1 exclusive: one on
    the 32x16 tile and 8-row band grid; one off it with odd edges that cut
    tiles, bands and MSAA samples ((13, 7, 61, 45) at 96x64, scaled
    elsewhere); one pixel; one that runs to the frame's far edges; and
    the full frame."""
    sx, sy = width / 96, height / 64
    odd = lambda v: int(v) | 1  # noqa: E731
    return [
        ("aligned", (_down(width // 3, 32), _down(height // 4, 16), _down(2 * width // 3, 32),
                     _down(3 * height // 4, 16))),
        ("off-grid", (odd(13 * sx), odd(7 * sy), odd(61 * sx), odd(45 * sy))),
        ("one pixel", (odd(width // 2), odd(height // 2), odd(width // 2) + 1, odd(height // 2) + 1)),
        ("far edge", (odd(width // 3), odd(height // 2 - 8), width, height)),
        ("full", (0, 0, width, height)),
    ]


def scissor_expect(want: dict, rect, clear_q: int, clear_stencil: int = 0) -> dict:
    """The oracle's planes (``want``: (H, W) or per-sample (4, H, W);
    ``bary`` with a trailing 3) under a scissor: pixels outside ``rect``
    keep their clear values (tri_id -1, depth_q ``clear_q``, stencil
    ``clear_stencil``, barycentrics 0).  Every update outside the rect is
    suppressed, so inside it the unscissored draw is unchanged."""
    h, w = np.asarray(want["tri_id"]).shape[-2:]
    x0, y0, x1, y1 = rect
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    inside = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    fill = {"tri_id": -1, "depth_q": clear_q, "stencil": clear_stencil & 0xFF, "bary": 0.0,
            "depth": clear_q / float(DEPTH_ONE_Q)}
    out = dict(want)
    for k, v in fill.items():
        if k in want:
            plane = np.asarray(want[k])
            out[k] = np.where(inside[..., None] if k == "bary" else inside, plane, np.asarray(v, plane.dtype))
    return out


def assert_scissor_engaged(rect, tri_id) -> str:
    """Raise unless the scissor changes the draw: the unscissored oracle
    (``tri_id``, (H, W) or (4, H, W)) covers a pixel outside ``rect`` and
    one inside it.  For a rect of the whole frame (nothing to cut) the
    draw must cover the last column or row instead, where the rect's
    exclusive bounds lie."""
    cov = np.asarray(tri_id) >= 0
    cov = cov.any(0) if cov.ndim == 3 else cov
    h, w = cov.shape
    x0, y0, x1, y1 = rect
    inside = np.zeros_like(cov)
    inside[y0:y1, x0:x1] = True
    n_in, n_out = int((cov & inside).sum()), int((cov & ~inside).sum())
    if (x0, y0, x1, y1) == (0, 0, w, h):
        edge = int(cov[:, -1].sum() + cov[-1, :].sum())
        if edge == 0:
            raise AssertionError("scissor: regime not engaged: nothing covered on the full rect's far edges")
        return f"{edge} covered on the far edges"
    if n_out == 0 or n_in == 0:
        raise AssertionError(f"scissor {rect}: regime not engaged: {n_in} covered inside, {n_out} outside")
    return f"{n_out} covered pixels cut, {n_in} kept"


def bias_triples():
    """The depth-bias configurations the oracle is held to: (label, kind,
    (constant, slope, clamp), depth_clip modes), constants in quantized-LSB
    (2^-24 depth) units, clamps in depth units."""
    return [
        ("constant +", "constant", (3000.0, 0.0, 0.0), (True,)),
        ("constant -", "constant", (-3000.0, 0.0, 0.0), (True,)),
        ("slope clip +", "slope_clip", (0.0, 4.0, 0.0), (True, "clamp")),
        ("slope clip -", "slope_clip", (0.0, -4.0, 0.0), (True, "clamp")),
        ("clamp +", "clamp", (2000.0, 1.0, 0.0005), (True,)),
        ("clamp -", "clamp", (-2000.0, -1.0, -0.0005), (True,)),
        ("past 1.0", "range", (float(1 << 23), 0.0, 0.0), (True, "clamp")),
        ("below 0.0", "range", (-float(1 << 23), 0.0, 0.0), (True, "clamp")),
    ]


# A constant of 2^30 on top of a clipped slope (2^29): a vertex at the
# +2^29 depth clamp then sums to 2^31, which wraps in the JAX package's
# and the port's int32 setup (ops/setup.py) and not in the oracle's int64
# sum; see bias_offsets.
BIAS_WRAP = ("int32 wrap", "wrap", (float(1 << 30), 4.0, 0.0), ("clamp",))


def bias_offsets(ts, triple) -> dict:
    """The offset of each valid triangle of the unbiased setup ``ts`` under
    ``triple``, in int64 (the oracle's sum): the slope term before
    and after its +/-2^29 clip, the offset before and after the bias
    clamp, and vertex 0's biased depth before the vertex clamp."""
    c, s, cl = triple
    valid = ts.valid.cpu().numpy()
    g16 = np.float32(16)
    m = np.maximum(np.abs(ts.gx.cpu().numpy() * g16), np.abs(ts.gy.cpu().numpy() * g16))[valid]
    raw = (m * np.float32(s)).astype(np.float32)
    lim = np.float32(1 << 29)
    slope = np.rint(np.clip(raw, -lim, lim)).astype(np.int64)
    o = slope + int(round(float(c)))
    o_cl = o
    if cl > 0:
        o_cl = np.minimum(o, int(round(float(cl) * (1 << 24))))
    elif cl < 0:
        o_cl = np.maximum(o, int(round(float(cl) * (1 << 24))))
    zq0 = ts.zq.cpu().numpy()[valid][:, 0].astype(np.int64)
    return {"raw": raw, "clipped": np.abs(raw) >= lim, "o": o, "o_clamped": o_cl, "z0": zq0 + o_cl}


def assert_bias_engaged(kind: str, ts, triple, biased=None, unbiased=None) -> str:
    """Raise unless the triple does what its kind says on this stream
    (``ts``: the unbiased setup): "slope_clip", some slope term reaches
    the +/-2^29 clip; "clamp", the bias clamp binds on some triangle;
    "constant", every offset is the constant; "range", the biased oracle
    (``biased``, against ``unbiased``) has a covered pixel at depth 0 or
    1.0 that the unbiased one does not, or covers fewer pixels; "wrap",
    some vertex 0 sums past the int32 range."""
    off = bias_offsets(ts, triple)
    n = off["o"].size

    def need(ok, what):
        if not ok:
            raise AssertionError(f"bias {kind} {triple}: regime not engaged: {what}")

    need(n > 0, "no valid triangle")
    if kind == "slope_clip":
        k = int(off["clipped"].sum())
        need(k > 0, "no slope term at the +/-2^29 clip")
        return f"{k} slope terms clipped"
    if kind == "clamp":
        k = int((off["o"] != off["o_clamped"]).sum())
        need(k > 0, "the bias clamp never binds")
        return f"{k} offsets clamped"
    if kind == "constant":
        need(bool((off["o"] == int(round(triple[0]))).all()), "an offset is not the constant")
        return f"{n} offsets of {int(round(triple[0]))}"
    if kind == "wrap":
        k = int((off["z0"] > np.iinfo(np.int32).max).sum() + (off["z0"] < np.iinfo(np.int32).min).sum())
        need(k > 0, "no vertex-0 sum past the int32 range")
        return f"{k} vertex-0 sums past int32"
    b, u = np.asarray(biased["tri_id"]) >= 0, np.asarray(unbiased["tri_id"]) >= 0
    zq = np.asarray(biased["depth_q"])
    at_bound = b & ((zq == 0) | (zq == DEPTH_ONE_Q)) & ~(u & np.isin(np.asarray(unbiased["depth_q"]), (0, DEPTH_ONE_Q)))
    need(int(at_bound.sum()) > 0 or int(b.sum()) < int(u.sum()), "no depth pushed past [0, 1]")
    return f"{int(at_bound.sum())} pixels clamped to [0, 1], coverage {int(u.sum())} -> {int(b.sum())}"


def assert_bands_engaged(binned, width: int, height: int, tile, bin_rows: int) -> str:
    """Raise unless band binning splits a triangle: with more than one
    band a tile, some triangle is binned into more than one band of one
    tile; with one band a tile, into more than one bin.  ``binned`` is the
    band-binned stream (column-major (tile, band) ids) of a frame of
    ``height`` rows padded to the tile grid."""
    tile_w, tile_h = tile
    bands = tile_h // bin_rows
    num_by = -(-height // tile_h) * bands
    start = binned.tile_start.cpu().numpy().astype(np.int64)
    count = binned.tile_count.cpu().numpy().astype(np.int64)
    tri = binned.records[13].cpu().numpy()
    b = np.repeat(np.arange(start.size), count)
    slot = np.concatenate([np.arange(s, s + c) for s, c in zip(start, count)]) if count.sum() else np.zeros(0, int)
    tid = tri[slot]
    tile_of = (b // num_by) * (num_by // bands) + (b % num_by) // bands
    key = tile_of * (1 << 32) + tid if bands > 1 else tid
    _, per = np.unique(key, return_counts=True)
    k = int((per > 1).sum())
    if k == 0:
        where = "bands of one tile" if bands > 1 else "bins"
        raise AssertionError(f"bands {bin_rows} at {tile_w}x{tile_h}: regime not engaged: no triangle in two {where}")
    return f"{k} triangles split over {'bands' if bands > 1 else 'bins'}"


def windows(width: int, height: int) -> list[tuple[str, tuple, tuple]]:
    """(label, origin, extent) shard windows, in pixels: the top-left
    quadrant; an off-origin window whose extent cuts each tile dimension
    to 8 (renderer.shard_tile); one touching the far edges; and one whose
    tile columns stay on the 128-px grid, so the sublane raster (B2, B5)
    still takes it (at 96x64 the full width from x = 0)."""
    quad = (_down(width // 2, 8), _down(height // 2, 8))
    cut = (_down(width // 2, 16) + 8, _down(height // 3, 16) + 8)
    cut_o = (_down(width // 4, 16) + 8, _down(height // 4, 16) + 8)
    far = (_down(width // 3, 32), _down(height // 2, 8))
    wide = ((128, 64), (256, 128)) if width >= 384 and height >= 192 else ((0, 16), (width, _down(height // 2, 8) + 8))
    return [
        ("quadrant", (0, 0), quad),
        ("cut to 8", cut_o, cut),
        ("far edges", (width - far[0], height - far[1]), far),
        ("128 wide", *wide),
    ]


def window_sublane_ok(origin, extent, width: int) -> bool:
    """Whether a 128-wide tile grid serves the window: its tile columns
    start on the frame's 128-px grid and end at a multiple of 128 or at
    the frame's right edge."""
    return origin[0] % 128 == 0 and (extent[0] % 128 == 0 or origin[0] + extent[0] == width)


def window_expect(want: dict, origin, extent) -> dict:
    """The full-frame oracle's planes cropped to the window."""
    (x0, y0), (w, h) = origin, extent
    out = {}
    for k, v in want.items():
        v = np.asarray(v)
        if k == "bary":
            out[k] = v[..., y0 : y0 + h, x0 : x0 + w, :]
        elif v.ndim >= 2:
            out[k] = v[..., y0 : y0 + h, x0 : x0 + w]
    return out


def assert_window_engaged(origin, extent, tri_id) -> str:
    """Raise unless some triangle crosses a window edge: the full-frame
    oracle (``tri_id``) has a triangle winning pixels inside the window
    and outside it."""
    t = np.asarray(tri_id)
    t = t.reshape(-1, *t.shape[-2:])
    (x0, y0), (w, h) = origin, extent
    inside = np.zeros(t.shape[-2:], bool)
    inside[y0 : y0 + h, x0 : x0 + w] = True
    ids_in = set(np.unique(t[:, inside]).tolist()) - {-1}
    ids_out = set(np.unique(t[:, ~inside]).tolist()) - {-1}
    both = ids_in & ids_out
    if not both:
        raise AssertionError(f"window {origin} {extent}: regime not engaged: no triangle crosses its edge")
    return f"{len(both)} triangles cross the window's edge"


def assert_supersample_engaged(ts2, tri_id2) -> str:
    """Raise unless supersampling keeps an adversarial regime: at 2W x 2H
    (``ts2`` the setup there, ``tri_id2`` the oracle's winners), some
    triangle with a snapped coordinate at the guard band or a quantized
    gradient at DEPTH_GRAD_CLAMP wins a pixel."""
    valid = ts2.valid.cpu().numpy()
    xf, yf = ts2.xf.cpu().numpy(), ts2.yf.cpu().numpy()
    guard = (np.isin(xf, (GUARD_LO, GUARD_HI)) | np.isin(yf, (GUARD_LO, GUARD_HI))).any(-1)
    clamp = (np.abs(ts2.dzdx_q.cpu().numpy()) == DEPTH_GRAD_CLAMP) | (np.abs(ts2.dzdy_q.cpu().numpy()) == DEPTH_GRAD_CLAMP)
    special = np.flatnonzero(valid & (guard | clamp))
    won = np.isin(np.asarray(tri_id2), special)
    if not won.any():
        raise AssertionError("supersample: regime not engaged: no guard-band or clamped triangle covers a pixel at 2x")
    return f"{int(won.sum())} pixels won by guard-band or clamped triangles at 2x"
