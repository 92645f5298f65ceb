"""The spec's adversarial streams under raster state, through every plain route.

The streams of ``based_renderer_tpu_torch/reference/adversarial.py`` at
96x64 under the five states that change what a raster computes or is fed:
a scissor (five rects), depth bias (constants, slopes at the +/-2^29 clip,
binding clamps, depths pushed past [0, 1]), band binning (1, 2, 4 and 8
rows at 128x8; 8 and 16 at 128x32), a shard window (four windows, the
tile cut to its gcd with the extent) and 2x2 supersampling.  Each plain
route that takes a state (sequential at two tiles, two-pass, sublane from
each assembly, batched, MSAA-4x and its sublane form) gives the port's
oracle's tri_id, depth_q (and stencil) exactly, masked by the scissor or
cropped to the window, per sample under MSAA; the port's oracle equals the
JAX package's on every call.  A subset (one scissor, bin_rows 4, one window
origin, two bias triples; sequential, sublane and MSAA) is held against the
JAX package's rasterize_vis_pallas(..., interpret=True): ints exact,
barycentrics within atol 2e-4 (tests/test_pallas.py:40).  Supersampling
and shard windows also go through Renderer(device="cpu") with the flat_ndc
shader: against the oracle at 2W x 2H, against the JAX Renderer (its XLA
backend, as tests/test_torch_msaa_renderer.py takes for supersampling),
and a shard against the full frame cropped, colour included.  Every case
asserts that its state is engaged.

One bias triple is not held to the oracle: a constant of 2^30 on a slope
term at its clip sums vertex depths past the int32 range, which wraps in
the JAX package's setup (ops/setup.py:241-243) and in the port's, and not
in the oracle's int64 sum.  The port follows the JAX package there
(test_bias_int32_wrap_follows_the_jax_package).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
import based_renderer_tpu_torch as tbrt
from based_renderer_tpu.ops import fixedpoint as jfp
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu.ops.raster_pallas import rasterize_vis_pallas
from based_renderer_tpu.reference import oracle as jax_oracle
from based_renderer_tpu_torch.ops import fixedpoint as tfp
from based_renderer_tpu_torch.ops import raster as traster
from based_renderer_tpu_torch.ops.binning import bin_triangles
from based_renderer_tpu_torch.ops.setup import setup_triangles
from based_renderer_tpu_torch.reference import adversarial as adv
from based_renderer_tpu_torch.reference import oracle
from based_renderer_tpu_torch.renderer import Shard, shard_tile

W, H = 96, 64
ATOL = 2e-4
T_PAD = 256
PAIRS = 96 * T_PAD + 4096  # every triangle in every 8x8 tile of the frame
ONE_Q = tfp.DEPTH_ONE_Q
ORDERED = ("less", "less_equal", "greater", "greater_equal")
BY_LABEL = {label: (stream, clip) for stream, label, clip in adv.cases(W, H, fuzz_seeds=(0, 1))}
SCISSORS = dict(adv.scissors(W, H))
BIAS = {label: (kind, triple, clips) for label, kind, triple, clips in adv.bias_triples()}
WINDOWS = {label: (origin, extent) for label, origin, extent in adv.windows(W, H)}
BANDS = [(tile, rows) for tile, all_rows in adv.BAND_ROWS for rows in all_rows]
INCREMENT = tbrt.StencilState(enable=True, compare="always", pass_op="increment_clamp",
                              depth_fail_op="increment_wrap")
OFF_GRID = SCISSORS["off-grid"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The 96x64 routes are thousands of small tensor ops, which intra-op
    threads only slow (and oversubscribe the cores under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clear_q(compare):
    return 0 if compare.startswith("greater") else ONE_Q


@functools.lru_cache(maxsize=None)
def oracles(label, compare="less", depth_clip=True, bias=None, stencil=None, size=(W, H)):
    """(port oracle, port MSAA-4x oracle) of a stream; the first is held
    equal to the JAX package's on the same call (the MSAA copy is held to
    JAX's in tests/test_torch_oracle.py)."""
    clip = BY_LABEL[label][1]
    kw = dict(depth_compare=compare, depth_clear=_clear_q(compare) / ONE_Q, depth_clip=depth_clip,
              depth_bias=bias, stencil=stencil)
    ora, want = oracle.rasterize(clip, *size, **kw), jax_oracle.rasterize(clip, *size, **kw)
    for k in ("tri_id", "depth_q", *(("stencil",) if stencil is not None else ())):
        np.testing.assert_array_equal(ora[k], want[k], err_msg=f"{label} oracle {k}")
    return ora, oracle.rasterize_msaa4(clip, *size, **kw)


def plain_routes(clip, *, scissor=None, bias=None, compare="less", depth_clip=True, stencil=None, origin=(0, 0),
                 extent=(W, H), bands=()):
    """{route: VisBuffer} of every plain route that takes this state.
    ``scissor`` is in frame pixels (setup's clamp; the raster's mask in the
    window's pixels); a window (``origin``, ``extent``) draws at the tiles
    the window cuts the routes' own to, the sublane routes only where a
    128-px grid serves it; ``bands`` adds the sublane route binned at
    those band heights (128x8), from each assembly."""
    c = torch.from_numpy(clip)
    ts = setup_triangles(c, W, H, scissor=scissor, depth_bias=bias)
    ts4 = setup_triangles(c, W, H, scissor=scissor, depth_bias=bias, bbox_pad_fp=tfp.MSAA4_BBOX_PAD_FP)
    ew, eh = extent
    local = None if scissor is None else (scissor[0] - origin[0], scissor[1] - origin[1],
                                          scissor[2] - origin[0], scissor[3] - origin[1])
    kw = dict(depth_compare=compare, depth_clear=_clear_q(compare) / ONE_Q, depth_clip=depth_clip, scissor=local,
              origin=origin, max_pairs=PAIRS, return_overflow=True)
    tile, small = shard_tile((128, 32), extent), shard_tile((32, 16), extent)
    runs = {
        "sequential": (ts, tile, dict(stencil=stencil)),
        "sequential small": (ts, small, dict(stencil=stencil)),
        "two_pass": (ts, tile, dict(two_pass=True, stencil=stencil)),
        "msaa4": (ts4, tile, dict(msaa4=True, stencil=stencil)),
    }
    if compare in ORDERED and stencil is None:
        runs["batched"] = (ts, shard_tile((64, 64), extent), dict(batch=16))
        if adv.window_sublane_ok(origin, extent, W):
            sub = (128, math.gcd(8, eh))
            runs.update({
                "sublane": (ts, sub, dict(sublane=True)),
                "sublane assemble=pallas": (ts, sub, dict(sublane=True, assemble="pallas")),
                "sublane tmpl=pallas": (ts, sub, dict(sublane=True, assemble="pallas", tmpl="pallas")),
                "msaa4 sublane": (ts4, sub, dict(sublane=True, msaa4=True, assemble="pallas")),
            })
            for rows in bands:
                for asm in ("xla", "pallas", "tmpl"):
                    extra = dict(assemble="pallas", tmpl="pallas") if asm == "tmpl" else dict(assemble=asm)
                    runs[f"sublane bands {rows} {asm}"] = (ts, sub, dict(sublane=True, bin_rows=rows, **extra))
    out = {}
    for name, (setup, (tw, th), extra) in runs.items():
        vis, overflowed, _ = traster.rasterize_vis(setup, ew, eh, tile_w=tw, tile_h=th, **kw, **extra)
        assert not bool(overflowed), name
        out[name] = vis
    return out


def assert_routes(routes, want, want4, stencil=False):
    for name, vis in routes.items():
        w = want4 if name.startswith("msaa4") else want
        for k in ("tri_id", "depth_q") + (("stencil",) if stencil else ()):
            np.testing.assert_array_equal(getattr(vis, k).numpy(), w[k], err_msg=f"{name} {k}")


# ---- scissor ---------------------------------------------------------------

SCISSOR_STREAMS = {
    "aligned": ("slivers seed 0", "zshift_steep", "fuzz seed 0"),
    "off-grid": ("slivers seed 1", "guard_band fuzz 1", "fuzz seed 1"),
    "one pixel": ("guard_band fuzz 0", "near_plane", "fuzz seed 0"),
    "far edge": ("zshift_flat", "near_plane", "fuzz seed 1"),
    "full": ("slivers seed 4", "guard_band fuzz 1", "fuzz seed 0"),
}


@pytest.mark.parametrize("rect", list(SCISSORS))
def test_scissor(rect):
    """Every route under the scissor (with band binning at 4 rows: band
    rows and scissor rows mix in the sublane raster) equals the
    unscissored oracle with the pixels outside the rect cleared."""
    sc = SCISSORS[rect]
    for label in SCISSOR_STREAMS[rect]:
        ora, ora4 = oracles(label)
        adv.assert_scissor_engaged(sc, ora["tri_id"])
        routes = plain_routes(BY_LABEL[label][1], scissor=sc, bands=(4,))
        assert_routes(routes, adv.scissor_expect(ora, sc, ONE_Q), adv.scissor_expect(ora4, sc, ONE_Q))


@pytest.mark.parametrize("rect", ["off-grid", "one pixel"])
def test_scissor_stencil(rect):
    """The stencil plane under a scissor: no update outside the rect."""
    sc = SCISSORS[rect]
    ora, ora4 = oracles("fuzz seed 0", stencil=INCREMENT)
    adv.assert_scissor_engaged(sc, ora["tri_id"])
    routes = plain_routes(BY_LABEL["fuzz seed 0"][1], scissor=sc, stencil=INCREMENT)
    assert_routes(routes, adv.scissor_expect(ora, sc, ONE_Q), adv.scissor_expect(ora4, sc, ONE_Q), stencil=True)
    assert int(routes["sequential"].stencil.max()) >= 1


@pytest.mark.parametrize("compare", ["greater_equal", "less_equal"])
def test_scissor_under_msaa_samples(compare):
    """The off-grid rect cuts pixels whose samples straddle a triangle's
    edge: every sample of a pixel outside the rect is cleared, every
    sample inside is the oracle's, on both MSAA routes."""
    ora, ora4 = oracles("fuzz seed 1", compare=compare)
    adv.assert_scissor_engaged(OFF_GRID, ora4["tri_id"])
    routes = plain_routes(BY_LABEL["fuzz seed 1"][1], scissor=OFF_GRID, compare=compare)
    want4 = adv.scissor_expect(ora4, OFF_GRID, _clear_q(compare))
    assert_routes({k: v for k, v in routes.items() if k.startswith("msaa4")}, None, want4)
    t = want4["tri_id"]
    assert ((t != t[:1]).any(0) & (t >= 0).any(0)).any()  # a pixel whose samples differ stays in


# ---- depth bias ------------------------------------------------------------

BIAS_STREAMS = {
    "slope_clip": ("slivers seed 0", "zshift_steep"),
    "clamp": ("slivers seed 1", "zshift_steep", "guard_band fuzz 0"),
    "constant": ("slivers seed 2", "random seed 1"),
    "range": ("zshift_steep", "random seed 2"),
}


@pytest.mark.parametrize("label", list(BIAS))
def test_depth_bias(label):
    """Every route equals the oracle's biased draw under each depth-clip
    mode of the triple (the JAX package's setup under bias is held in
    test_against_jax_pallas and test_bias_int32_wrap_follows_the_jax_package)."""
    kind, triple, clips = BIAS[label]
    for stream_label in BIAS_STREAMS[kind]:
        clip = BY_LABEL[stream_label][1]
        for depth_clip in clips:
            ora, ora4 = oracles(stream_label, depth_clip=depth_clip, bias=triple)
            unbiased = oracles(stream_label, depth_clip=depth_clip)[0]
            adv.assert_bias_engaged(kind, setup_triangles(torch.from_numpy(clip), W, H), triple, ora, unbiased)
            assert_routes(plain_routes(clip, bias=triple, depth_clip=depth_clip), ora, ora4)


@pytest.mark.parametrize("label", ["slope clip -", "clamp +"])
def test_depth_bias_on_clamp_slivers_greater_equal_clamped(label):
    """Bias on the slivers at DEPTH_GRAD_CLAMP under greater_equal with the
    depth clamp (depthClampEnable): the combination of the clip, the bias
    clamp and the [0, 1] clamp."""
    kind, triple, _ = BIAS[label]
    ora, ora4 = oracles("slivers seed 4", compare="greater_equal", depth_clip="clamp", bias=triple)
    ts = setup_triangles(torch.from_numpy(BY_LABEL["slivers seed 4"][1]), W, H)
    adv.assert_engaged("slivers", ts, ora["tri_id"])
    adv.assert_bias_engaged(kind, ts, triple)
    routes = plain_routes(BY_LABEL["slivers seed 4"][1], bias=triple, compare="greater_equal", depth_clip="clamp")
    assert "sublane" in routes and "msaa4 sublane" in routes
    assert_routes(routes, ora, ora4)


def test_bias_int32_wrap_follows_the_jax_package():
    """A divergence of the reference: zshift_steep under BIAS_WRAP.  Vertex
    depths at +2^29 plus an offset of 2^29 + 2^30 sum to 2^31, which wraps
    to -2^31 in the JAX package's int32 setup (ops/setup.py:241-243) and in
    the port's, and clamps to +2^29 in the oracle's int64 sum
    (reference/oracle.py:318-328).  The port equals the JAX package: setup
    bitwise, and every route the JAX sequential Pallas raster; the oracle
    differs, so it is left out of the comparison.  Under the off-grid
    scissor and over the "128 wide" window, so JAX's interpret compile is
    the one test_against_jax_pallas makes."""
    _, kind, triple, clips = adv.BIAS_WRAP
    clip = BY_LABEL["zshift_steep"][1]
    unbiased = setup_triangles(torch.from_numpy(clip), W, H)
    adv.assert_bias_engaged(kind, unbiased, triple)
    ts = setup_triangles(torch.from_numpy(clip), W, H, depth_bias=triple)
    jts = jsetup.setup_triangles(jnp.asarray(padded(clip)), W, H, scissor=OFF_GRID, depth_bias=triple)
    np.testing.assert_array_equal(ts.zq.numpy(), np.asarray(jts.zq)[: clip.shape[0]])
    assert (ts.zq.numpy()[ts.valid.numpy(), 0] == -tfp.DEPTH_VERTEX_CLAMP).any()  # wrapped, then clamped
    origin, extent = WINDOWS["128 wide"]
    routes = plain_routes(clip, bias=triple, depth_clip=clips[0], scissor=OFF_GRID, origin=origin, extent=extent)
    jv = jax_pallas(clip, ts=jts, depth_clip=clips[0], scissor=OFF_GRID, origin=origin, extent=extent)
    for name, vis in routes.items():
        if not name.startswith("msaa4"):
            assert_port_equals_jax(vis, jv, name, floats=name == "sequential")
    ora = oracle.rasterize(clip, W, H, depth_clip=clips[0], depth_bias=triple)
    ora = adv.window_expect(adv.scissor_expect(ora, OFF_GRID, ONE_Q), origin, extent)
    assert (routes["sequential"].depth_q.numpy() != ora["depth_q"]).any()


# ---- band binning ----------------------------------------------------------

BAND_STREAMS = ("slivers seed 0", "guard_band fuzz 0", "zshift_steep", "near_plane", "fuzz seed 1")


def _banded(ts, tile, rows):
    """The stream binned at ``rows``-row bands of ``tile`` (column-major
    (tile, band) ids, records anchored at the tile's rows)."""
    bin_h = -(-H // tile[1]) * tile[1]
    return bin_triangles(ts, W, bin_h, tile[0], rows, max_pairs=PAIRS, col_major_ids=True, anchor_rows=tile[1])


@pytest.mark.parametrize("tile,rows", BANDS, ids=[f"{t[0]}x{t[1]}-{r}" for t, r in BANDS])
def test_band_binning(tile, rows):
    """The sublane route binned at ``rows``-row bands, from the XLA
    assembly, the kernel assembly's layout and the transposed templates:
    every plane equal to the unbanded frame's, ints equal to the oracle's."""
    for label in BAND_STREAMS:
        clip = BY_LABEL[label][1]
        ts = setup_triangles(torch.from_numpy(clip), W, H)
        adv.assert_bands_engaged(_banded(ts, tile, rows), W, H, tile, rows)
        ora, _ = oracles(label)
        kw = dict(tile_w=tile[0], tile_h=tile[1], sublane=True, max_pairs=PAIRS)
        whole = traster.rasterize_vis(ts, W, H, **kw)
        for extra in (dict(), dict(assemble="pallas"), dict(assemble="pallas", tmpl="pallas")):
            vis = traster.rasterize_vis(ts, W, H, bin_rows=rows, **kw, **extra)
            for k in vis._fields[:5]:
                assert torch.equal(getattr(vis, k), getattr(whole, k)), f"{label} {extra} {k}"
            assert_routes({"sublane": vis}, ora, None)


@pytest.mark.parametrize("compare", ["greater", "less_equal"])
def test_band_binning_with_scissor(compare):
    """Band rows and scissor rows together at 128x32 in 8- and 16-row
    bands, the off-grid rect cutting bands mid-way, under two more
    compares."""
    label = "fuzz seed 0"
    ora, _ = oracles(label, compare=compare)
    adv.assert_scissor_engaged(OFF_GRID, ora["tri_id"])
    ts = setup_triangles(torch.from_numpy(BY_LABEL[label][1]), W, H, scissor=OFF_GRID)
    want = adv.scissor_expect(ora, OFF_GRID, _clear_q(compare))
    for rows in (8, 16):
        adv.assert_bands_engaged(_banded(ts, (128, 32), rows), W, H, (128, 32), rows)
        for extra in (dict(), dict(assemble="pallas"), dict(assemble="pallas", tmpl="pallas")):
            vis = traster.rasterize_vis(ts, W, H, tile_w=128, tile_h=32, sublane=True, bin_rows=rows,
                                        depth_compare=compare, depth_clear=_clear_q(compare) / ONE_Q,
                                        scissor=OFF_GRID, max_pairs=PAIRS, **extra)
            assert_routes({"sublane": vis}, want, None)


# ---- shard windows ---------------------------------------------------------

WINDOW_STREAMS = {
    "quadrant": ("slivers seed 0", "near_plane", "fuzz seed 0"),
    "cut to 8": ("zshift_steep", "guard_band fuzz 1", "fuzz seed 1"),
    "far edges": ("zshift_flat", "random seed 0", "fuzz seed 0"),
    "128 wide": ("slivers seed 3", "guard_band fuzz 0", "fuzz seed 1"),
}


def test_windows_are_shards():
    """Each window lies in the frame, its tiles are cut as a shard's (the
    "cut to 8" one to 8x8) and its origin is on that tile grid; only the
    "128 wide" one keeps the sublane routes."""
    for label, (origin, extent) in WINDOWS.items():
        assert origin[0] + extent[0] <= W and origin[1] + extent[1] <= H
        tile = shard_tile((128, 32), extent)
        assert origin[0] % tile[0] == 0 and origin[1] % tile[1] == 0
        assert (tile == (8, 8)) == (label == "cut to 8")
        assert adv.window_sublane_ok(origin, extent, W) == (label == "128 wide")


@pytest.mark.parametrize("window", list(WINDOWS))
def test_window(window):
    """Every route over the window (setup in frame coordinates, records
    anchored at the frame's tile grid) equals the full-frame oracle
    cropped to it."""
    origin, extent = WINDOWS[window]
    for label in WINDOW_STREAMS[window]:
        ora, ora4 = oracles(label)
        adv.assert_window_engaged(origin, extent, ora["tri_id"])
        routes = plain_routes(BY_LABEL[label][1], origin=origin, extent=extent, bands=(4,))
        assert ("sublane" in routes) == (window == "128 wide")
        assert_routes(routes, adv.window_expect(ora, origin, extent), adv.window_expect(ora4, origin, extent))


@pytest.mark.parametrize("window", ["cut to 8", "128 wide"])
def test_window_with_scissor_and_bias(window):
    """A window, the off-grid scissor (in frame pixels for setup, in the
    window's for the raster) and a clipped bias slope at once."""
    origin, extent = WINDOWS[window]
    kind, triple, _ = BIAS["slope clip +"]
    ora, ora4 = oracles("fuzz seed 1", bias=triple)
    adv.assert_window_engaged(origin, extent, ora["tri_id"])
    adv.assert_scissor_engaged(OFF_GRID, ora["tri_id"])
    adv.assert_bias_engaged(kind, setup_triangles(torch.from_numpy(BY_LABEL["fuzz seed 1"][1]), W, H), triple)
    routes = plain_routes(BY_LABEL["fuzz seed 1"][1], scissor=OFF_GRID, bias=triple, origin=origin, extent=extent)
    crop = functools.partial(adv.window_expect, origin=origin, extent=extent)
    assert_routes(routes, crop(adv.scissor_expect(ora, OFF_GRID, ONE_Q)),
                  crop(adv.scissor_expect(ora4, OFF_GRID, ONE_Q)))


# ---- the JAX package's Pallas kernels, interpreted ---------------------------


def padded(clip):
    """The stream followed by zero-area triangles up to T_PAD."""
    out = np.zeros((T_PAD, 3, 4), np.float32)
    out[..., 3] = 1.0
    out[: clip.shape[0]] = clip
    return out


def jax_pallas(clip, msaa4=False, sublane=False, scissor=None, bias=None, depth_clip=True, origin=(0, 0),
               extent=(W, H), bin_rows=None, ts=None):
    """The JAX package's rasterize_vis_pallas, interpreted, of the stream
    padded to T_PAD (or of its setup ``ts``)."""
    if ts is None:
        ts = jsetup.setup_triangles(jnp.asarray(padded(clip)), W, H, scissor=scissor, depth_bias=bias,
                                    bbox_pad_fp=jfp.MSAA4_BBOX_PAD_FP if msaa4 else 0)
    tile = (128, math.gcd(8, extent[1])) if sublane else shard_tile((128, 32), extent)
    local = None if scissor is None else (scissor[0] - origin[0], scissor[1] - origin[1],
                                          scissor[2] - origin[0], scissor[3] - origin[1])
    return rasterize_vis_pallas(ts, *extent, tile_w=tile[0], tile_h=tile[1], interpret=True, msaa4=msaa4,
                                max_pairs=PAIRS, sublane=sublane, scissor=local, depth_clip=depth_clip,
                                origin=origin, bin_rows=bin_rows)


def assert_port_equals_jax(vis, jv, label, floats=True):
    np.testing.assert_array_equal(vis.tri_id.numpy(), np.asarray(jv.tri_id), err_msg=f"{label} tri_id")
    np.testing.assert_array_equal(vis.depth_q.numpy(), np.asarray(jv.depth_q), err_msg=f"{label} depth_q")
    if floats:
        for k in ("b0", "b1", "b2"):
            np.testing.assert_allclose(getattr(vis, k).numpy(), np.asarray(getattr(jv, k)), rtol=0, atol=ATOL,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("route", ["sequential", "sublane", "msaa4"])
def test_against_jax_pallas(route):
    """The port's plain route against the JAX package's Pallas kernel under
    one value of each static state at once, one interpret compile a route:
    the "128 wide" window's origin, the off-grid scissor (in the window's
    pixels for the raster) and, on the sublane route, bin_rows 4 at 128x8;
    with no bias and with the "slope clip +" and "clamp -" triples
    (through each package's setup)."""
    clip = BY_LABEL["fuzz seed 0"][1]
    ora = oracles("fuzz seed 0")[0]
    ts = setup_triangles(torch.from_numpy(clip), W, H)
    origin, extent = WINDOWS["128 wide"]
    adv.assert_window_engaged(origin, extent, ora["tri_id"])
    adv.assert_scissor_engaged(OFF_GRID, ora["tri_id"])
    sublane = route == "sublane"
    if sublane:
        adv.assert_bands_engaged(_banded(ts, (128, 8), 4), W, H, (128, 8), 4)
    kw = {"sublane": dict(sublane=True, bin_rows=4), "msaa4": dict(msaa4=True)}.get(route, {})
    name = "sublane bands 4 xla" if sublane else route
    for label in (None, "slope clip +", "clamp -"):
        triple = None if label is None else BIAS[label][1]
        if label is not None:
            adv.assert_bias_engaged(BIAS[label][0], ts, triple)
        vis = plain_routes(clip, scissor=OFF_GRID, bias=triple, origin=origin, extent=extent,
                           bands=(4,) if sublane else ())[name]
        jv = jax_pallas(clip, scissor=OFF_GRID, bias=triple, origin=origin, extent=extent, **kw)
        assert_port_equals_jax(vis, jv, f"{name} {label}")


# ---- supersampling and shards through the renderer ------------------------------


def _frame(r, clip, scissor=None, shard=None, compare="less", **pipe):
    """One flat_ndc draw of the stream (no near clip: the clip positions
    are drawn as given): (color, depth_q, tri_id, stencil, overflowed),
    by render_frame, or with a ``shard`` by the eager _run_frame over its
    window."""
    mesh = r.upload_mesh(clip.reshape(-1, 4))
    pipe = tbrt.Pipeline(shader="flat_ndc", scissor=scissor, depth=tbrt.DepthState(compare=compare),
                         near_clip=False, **pipe)
    u = {"color": (0.2, 0.6, 0.9, 1.0)}
    r.begin_frame(clear_depth=_clear_q(compare) / ONE_Q)
    r.draw(pipe, mesh, u)
    if shard is not None:
        return r._run_frame(*r.close_frame(), shard=shard)[:5]
    f = r.end_frame()
    return f.color_planar, f.depth_q, f.tri_id, f.stencil, f.overflowed


SS_STREAMS = ("guard_band fuzz 0", "near_plane", "fuzz seed 1")


@pytest.mark.parametrize("rect", [None, "off-grid", "far edge"])
def test_supersample_against_the_oracle(rect):
    """msaa_supersample: the raster at 2W x 2H equals the oracle there, masked
    with the rect scaled by 2."""
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4, msaa_supersample=True), device="cpu")
    sc = None if rect is None else SCISSORS[rect]
    sc2 = None if sc is None else tuple(2 * v for v in sc)
    for label in SS_STREAMS:
        clip = BY_LABEL[label][1]
        ora, _ = oracles(label, size=(2 * W, 2 * H))
        adv.assert_supersample_engaged(setup_triangles(torch.from_numpy(clip), 2 * W, 2 * H), ora["tri_id"])
        want = ora if sc2 is None else adv.scissor_expect(ora, sc2, ONE_Q)
        if sc2 is not None:
            adv.assert_scissor_engaged(sc2, ora["tri_id"])
        color, depth_q, tri_id, _, overflowed = _frame(r, clip, scissor=sc)
        assert not bool(overflowed) and tuple(color.shape) == (4, H, W)
        np.testing.assert_array_equal(tri_id.numpy(), want["tri_id"], err_msg=f"{label} tri_id")
        np.testing.assert_array_equal(depth_q.numpy(), want["depth_q"], err_msg=f"{label} depth_q")


@pytest.mark.parametrize("rect", [None, "off-grid"])
def test_supersample_against_the_jax_renderer(rect):
    """The same frame from the JAX Renderer on its XLA backend: tri_id and
    depth_q exact, the resolved colour within 1e-4."""
    label = "fuzz seed 1"
    clip = BY_LABEL[label][1]
    sc = None if rect is None else SCISSORS[rect]
    ora, _ = oracles(label, size=(2 * W, 2 * H))
    adv.assert_supersample_engaged(setup_triangles(torch.from_numpy(clip), 2 * W, 2 * H), ora["tri_id"])
    if sc is not None:
        adv.assert_scissor_engaged(tuple(2 * v for v in sc), ora["tri_id"])
    jr = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, msaa=4, msaa_supersample=True, raster_backend="xla"))
    jf = jr.render_frame(jbrt.Pipeline(shader="flat_ndc", scissor=sc, near_clip=False), jr.upload_mesh(clip.reshape(-1, 4)),
                         {"color": (0.2, 0.6, 0.9, 1.0)})
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4, msaa_supersample=True), device="cpu")
    color, depth_q, tri_id, _, _ = _frame(r, clip, scissor=sc)
    np.testing.assert_array_equal(tri_id.numpy(), np.asarray(jf.tri_id))
    np.testing.assert_array_equal(depth_q.numpy(), np.asarray(jf.depth_q))
    np.testing.assert_allclose(color.permute(1, 2, 0).numpy(), jf.color_np(), rtol=0, atol=1e-4)


def _assert_shard_is_crop(full, part, origin, extent, scale):
    """A shard's (color, depth_q, tri_id, ...) equals the full frame's
    cropped: colour at framebuffer pixels, the raster planes at ``scale``
    times them."""
    (x0, y0), (w, h) = origin, extent
    assert torch.equal(part[0], full[0][..., y0 : y0 + h, x0 : x0 + w])
    s = scale
    for i in (1, 2):
        assert torch.equal(part[i], full[i][..., s * y0 : s * (y0 + h), s * x0 : s * (x0 + w)]), i


@pytest.mark.parametrize("window", list(WINDOWS))
def test_supersampled_shard_is_the_frame_cropped(window):
    """A supersampled frame over a shard window (scaled by 2 for the
    raster), with and without the off-grid scissor, equals the full
    frame cropped, colour included."""
    origin, extent = WINDOWS[window]
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, msaa=4, msaa_supersample=True), device="cpu")
    clip = BY_LABEL["fuzz seed 0"][1]
    ora, _ = oracles("fuzz seed 0", size=(2 * W, 2 * H))
    adv.assert_window_engaged(tuple(2 * v for v in origin), tuple(2 * v for v in extent), ora["tri_id"])
    for sc in (None, OFF_GRID):
        full = _frame(r, clip, scissor=sc)
        part = _frame(r, clip, scissor=sc, shard=Shard(origin, extent))
        assert not bool(full[4]) and not bool(part[4])
        _assert_shard_is_crop(full, part, origin, extent, 2)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_shard_frame_is_the_frame_cropped(window):
    """A shard frame of each stream on the Pallas backend rule through the
    batched route (at the tile the window cuts to), scissored after the
    raster as the renderer does, equals the full frame cropped, colour
    included, and the oracle cropped."""
    origin, extent = WINDOWS[window]
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, raster_backend="pallas"), device="cpu")
    for label in WINDOW_STREAMS[window][-2:]:
        clip = BY_LABEL[label][1]
        ora, _ = oracles(label, compare="greater_equal")
        adv.assert_window_engaged(origin, extent, ora["tri_id"])
        for sc in (None, OFF_GRID):
            full = _frame(r, clip, scissor=sc, compare="greater_equal", raster_batch=16)
            part = _frame(r, clip, scissor=sc, shard=Shard(origin, extent), compare="greater_equal", raster_batch=16)
            assert not bool(full[4]) and not bool(part[4])
            _assert_shard_is_crop(full, part, origin, extent, 1)
            want = ora if sc is None else adv.scissor_expect(ora, sc, 0)
            want = adv.window_expect(want, origin, extent)
            np.testing.assert_array_equal(part[2].numpy(), want["tri_id"], err_msg=f"{label} {sc}")
            np.testing.assert_array_equal(part[1].numpy(), want["depth_q"], err_msg=f"{label} {sc}")


def test_shard_frame_against_the_jax_renderer():
    """The port's shard frame over the "cut to 8" window under the off-grid
    scissor equals the JAX Renderer's full frame (its XLA backend) cropped:
    tri_id and depth_q exact, colour within 1e-4."""
    origin, extent = WINDOWS["cut to 8"]
    (x0, y0), (w, h) = origin, extent
    clip = BY_LABEL["fuzz seed 1"][1]
    adv.assert_window_engaged(origin, extent, oracles("fuzz seed 1")[0]["tri_id"])
    jr = jbrt.Renderer(jbrt.RendererConfig(width=W, height=H, raster_backend="xla"))
    jf = jr.render_frame(jbrt.Pipeline(shader="flat_ndc", scissor=OFF_GRID, near_clip=False),
                         jr.upload_mesh(clip.reshape(-1, 4)), {"color": (0.2, 0.6, 0.9, 1.0)})
    r = tbrt.Renderer(tbrt.RendererConfig(W, H, raster_backend="pallas"), device="cpu")
    color, depth_q, tri_id, _, overflowed = _frame(r, clip, scissor=OFF_GRID, shard=Shard(origin, extent))
    assert not bool(overflowed)
    np.testing.assert_array_equal(tri_id.numpy(), np.asarray(jf.tri_id)[y0 : y0 + h, x0 : x0 + w])
    np.testing.assert_array_equal(depth_q.numpy(), np.asarray(jf.depth_q)[y0 : y0 + h, x0 : x0 + w])
    np.testing.assert_allclose(color.permute(1, 2, 0).numpy(), jf.color_np()[y0 : y0 + h, x0 : x0 + w], rtol=0,
                               atol=1e-4)
