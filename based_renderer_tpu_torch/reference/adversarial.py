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
from ..ops.fixedpoint import ANCHOR_CLAMP, DEPTH_GRAD_CLAMP, GUARD_BAND_PIX, GUARD_HI, GUARD_LO

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
