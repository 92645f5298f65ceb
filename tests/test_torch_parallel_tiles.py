"""The port's TiledRenderer over tile meshes, on gloo CPU ranks.

One world of 4 ranks (parallel/launch.py) renders every case below over a
(2, 2) or a (4, 1) mesh at 96x64 and gathers the whole frame; rank 0
renders the same frame on one device and compares.  Each tiled frame:
  * equals the port's single-device frame with every draw at the tile the
    shards cut it to, bit for bit, colour included;
  * equals the port's single-device frame at the pipeline's own tile:
    tri_id, depth_q and stencil exact, colour within 1e-5 (the float
    planes are anchored at other tile origins; the JAX package's tiled
    tests use the same tolerance);
  * equals the JAX package's single-device "pallas" frame at the
    tolerance of tests/test_torch_package.py (each package runs its own
    vertex matmul): tri_id (and stencil) on >= 99.9% of pixels, colour
    within 1e-4 where tri_id agrees.
The binner's window origin is held against the JAX binner's exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import based_renderer_tpu as jbrt
from based_renderer_tpu.models import demos as jdemos
from based_renderer_tpu.models import geometry as jgeometry
from based_renderer_tpu.ops import binning as jbin
from based_renderer_tpu.ops import setup as jsetup
from based_renderer_tpu_torch.ops import binning as tbin
from based_renderer_tpu_torch.ops import setup as tsetup
from based_renderer_tpu_torch.parallel import launch, workers

W, H = 96, 64
XLA = {"width": W, "height": H, "raster_backend": "xla"}
PALLAS = {"width": W, "height": H, "raster_backend": "pallas"}
FLAT = {"shader": "flat_ndc", "depth": {"test": False, "write": False}}


def cube(t, **pipe):
    return {"demo": "cube", "t": t, "pipe": pipe}


FRAMES = {
    "xla-2x2": {"mesh": (2, 2), "config": XLA, "draws": [cube(0.5)]},
    "pallas-2x2": {"mesh": (2, 2), "config": PALLAS, "draws": [cube(0.5)]},
    "xla-4x1": {"mesh": (4, 1), "config": XLA, "draws": [cube(0.5)]},
    "pallas-4x1": {"mesh": (4, 1), "config": PALLAS, "draws": [cube(0.5)]},
    "multidraw-blend": {
        "mesh": (2, 2),
        "config": PALLAS,
        "draws": [
            cube(0.4),
            {"attrs": {"color": [[1.0, 0.0, 0.0]] * 3},
             "pipe": {"shader": "ndc_color", "depth": {"test": False, "write": False},
                      "blend": {"enable": True, "src_factor": "src_alpha", "dst_factor": "one_minus_src_alpha"}}},
        ],
    },
    "msaa-coverage": {"mesh": (2, 2), "config": {**PALLAS, "msaa": 4}, "draws": [cube(0.6)]},
    "stencil": {
        "mesh": (1, 4),
        "config": PALLAS,
        "draws": [
            {"scale": 0.6, "uniforms": {"color": (1.0, 0.0, 0.0, 1.0)},
             "pipe": {**FLAT, "stencil": {"enable": True, "compare": "always", "ref": 1, "pass_op": "replace"}}},
            {"uniforms": {"color": (0.0, 1.0, 0.0, 1.0)},
             "pipe": {**FLAT, "stencil": {"enable": True, "compare": "equal", "ref": 1}}},
        ],
    },
    "scissor-xla": {"mesh": (2, 2), "config": XLA, "draws": [cube(0.5, scissor=(20, 10, 60, 40))]},
    "scissor-pallas": {"mesh": (2, 2), "config": PALLAS, "draws": [cube(0.5, scissor=(20, 10, 60, 40))]},
    "dryrun-msaa-stencil-blend": workers.dryrun_msaa_spec(W, H, (2, 2)),
    # Two frames of one key: a cube of its own at another time, then the
    # compared frame through the same program.
    "program-reuse": {"mesh": (2, 2), "config": PALLAS, "draws": [cube(0.5)], "before": [[cube(0.2)]]},
}
SEQUENCES = {
    "uniforms-seq": {"mesh": (2, 2), "config": PALLAS, "draws": [cube(0.0)],
                     "sequence": {"times": [0.0, 0.5, 1.1]}, "return_frames": True},
    "uniforms-fn": {"mesh": (2, 2), "config": PALLAS, "draws": [cube(0.0)],
                    "sequence": {"n": 4, "t0": 0.25, "dt": 0.037}},
}
REJECTED = {
    # Binner overflow in debug mode raises on every rank (JAX's tiled
    # debug test: sublane off, since the shard cuts tile_w below 128).
    "debug-overflow": {
        "mesh": (2, 2), "config": {**PALLAS, "debug": True}, "expect": "AllocationError",
        "draws": [{"demo": "instanced", "kw": {"count": 500}, "t": 0.2,
                   "pipe": {"raster_pairs_factor": 0.0001, "raster_sublane": False}}],
    },
    "not-divisible": {"mesh": (2, 2), "config": {**PALLAS, "width": 95}, "draws": [cube(0.5)],
                      "expect": "ValueError"},
    "not-multiple-of-8": {"mesh": (4, 1), "config": {**PALLAS, "height": 72}, "draws": [cube(0.5)],
                          "expect": "ValueError"},
}
CASES = {**FRAMES, **SEQUENCES, **REJECTED}


@pytest.fixture(scope="module")
def results():
    specs = [dict(spec, arrays=True) for spec in CASES.values()]
    ranks = launch.run(workers.run_specs, (2, 2), (specs,), backend="gloo", devices="cpu", timeout=900)
    return {name: [rank[i] for rank in ranks] for i, name in enumerate(CASES)}


def jax_frame(spec):
    """The spec's frame from the JAX package on one device, Pallas backend."""
    jr = jbrt.Renderer(jbrt.RendererConfig(**{**spec["config"], "raster_backend": "pallas"}))
    jr.begin_frame(**spec.get("clear", {}))
    for d in spec["draws"]:
        if "demo" in d:
            pipe, mesh, uniforms, inst = getattr(jdemos, f"{d['demo']}_demo")(jr, **d.get("kw", {}))
            u = uniforms(d["t"])
        else:
            pos = jgeometry.triangle_mesh_data()["positions"] * np.float32(d.get("scale", 1.0))
            mesh = jr.upload_mesh(pos, **{k: np.asarray(v, np.float32) for k, v in d.get("attrs", {}).items()})
            pipe, u, inst = jbrt.Pipeline(), dict(d.get("uniforms", {})), None
        jr.draw(workers.override(pipe, d.get("pipe", {})), mesh, u, inst)
    return jr.end_frame()


def assert_matches_jax(arrays, jf):
    """tri_id (and stencil) on >= 99.9% of pixels, colour within 1e-4 where
    every sample's tri_id agrees."""
    tid = arrays["tri_id"]
    same = tid == np.asarray(jf.tri_id)
    assert same.mean() >= 0.999 and (tid >= 0).any()
    pix = same.all(axis=0) if same.ndim == 3 else same
    np.testing.assert_allclose(arrays["color"][pix], jf.color_np()[pix], rtol=0, atol=1e-4)
    assert (arrays["stencil"] is None) == (jf.stencil is None)
    if arrays["stencil"] is not None:
        assert (arrays["stencil"] == np.asarray(jf.stencil)).mean() >= 0.999


@pytest.mark.parametrize("name", FRAMES)
def test_tiled_frame_matches_single_device(results, name):
    ranks = results[name]
    r0 = ranks[0]
    for key in ("tri_id", "depth_q", "stencil", "color_bitwise"):
        assert r0["vs_single_tile"][key], key
    for key in ("tri_id", "depth_q", "stencil"):
        assert r0["vs_single"][key], key
    assert r0["vs_single"]["color"] <= 1e-5 and r0["vs_single"]["covered"] > 0
    ny, nx = FRAMES[name]["mesh"]
    lw, lh = W // nx, H // ny
    assert {r["shard"] for r in ranks} == {((x * lw, y * lh), (lw, lh)) for y in range(ny) for x in range(nx)}
    assert_matches_jax(r0["arrays"], jax_frame(FRAMES[name]))


def test_tiled_frames_of_one_key_share_a_program(results):
    """Each rank renders both frames through one frame program (the shard
    in its key), and the second frame is the single device's."""
    assert [r["programs"] for r in results["program-reuse"]] == [1] * 4
    assert [r["programs"] for r in results["pallas-2x2"]] == [1] * 4


def test_tiled_scissor_clips(results):
    tid = results["scissor-pallas"][0]["arrays"]["tri_id"]
    cov = tid >= 0
    assert cov.any() and not cov[:10].any() and not cov[40:].any()
    assert not cov[:, :20].any() and not cov[:, 60:].any()


def test_tiled_msaa_and_stencil_layers(results):
    arrays = results["msaa-coverage"][0]["arrays"]
    assert arrays["tri_id"].shape == (4, H, W) and arrays["color"].shape == (H, W, 4)
    dry = results["dryrun-msaa-stencil-blend"][0]["arrays"]
    assert dry["stencil"].shape == (4, H, W) and (dry["stencil"] == 7).any()
    stamp = results["stencil"][0]["arrays"]
    assert (stamp["stencil"] == 1).any() and (stamp["tri_id"] >= 0).any()


@pytest.mark.parametrize("name", SEQUENCES)
def test_tiled_sequence_matches_single_device(results, name):
    ranks = results[name]
    sums = ranks[0]["sums"]
    for r in ranks:  # every rank holds the global checksums
        np.testing.assert_array_equal(r["sums"], sums)
    np.testing.assert_allclose(sums, ranks[0]["want_sums"], rtol=1e-5)
    assert len(set(np.round(sums, 3))) == len(sums)
    if SEQUENCES[name].get("return_frames"):
        assert ranks[0]["frames_max_diff"] <= 1e-5


@pytest.mark.parametrize("name", REJECTED)
def test_tiled_rejections_raise_on_every_rank(results, name):
    expect = REJECTED[name]["expect"]
    assert [r.get("raised") for r in results[name]] == [expect] * 4
    words = {"not-divisible": "not divisible", "not-multiple-of-8": "multiple of 8", "debug-overflow": "overflow"}
    assert words[name] in results[name][0]["message"]


_jax_setup = jax.jit(jsetup.setup_triangles, static_argnums=(1, 2))


@pytest.mark.parametrize("origin,extent,tile,bands", [
    ((32, 32), (64, 32), (32, 16), None),
    ((48, 0), (48, 64), (16, 32), None),
    ((64, 32), (64, 64), (64, 32), 8),
])
def test_window_records_match_jax(origin, extent, tile, bands):
    """bin_triangles with a window origin: every record, the tile table and
    the overflow equal the JAX binner's (fusion off, as in
    test_torch_binning.py), band binning included."""
    rng = np.random.default_rng(7)
    n = 40
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0, 1, size=(n, 3, 1)).astype(np.float32) * w
    clip = np.concatenate([xy, z, w], -1).astype(np.float32)
    ch = rng.normal(size=(n, 3, 2)).astype(np.float32)
    fw, fh = 128, 96
    kw = dict(tile_w=tile[0], tile_h=tile[1], origin=origin)
    height = extent[1]
    if bands is not None:
        kw.update(tile_h=bands, col_major_ids=True, anchor_rows=tile[1])
    ts = tsetup.setup_triangles(torch.from_numpy(clip), fw, fh)
    tb = tbin.bin_triangles(ts, extent[0], height, channels=torch.from_numpy(ch), **kw)
    js = _jax_setup(jnp.asarray(clip), fw, fh)
    fn = jax.jit(functools.partial(jbin.bin_triangles, width=extent[0], height=height, **kw))
    jb = fn.lower(js, channels=jnp.asarray(ch)).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})(js, channels=jnp.asarray(ch))
    for name in ("records", "tile_start", "tile_count", "num_pairs", "overflowed"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.frecords.numpy().view(np.int32), np.asarray(jb.frecords).view(np.int32))
    assert int(tb.num_pairs) > 0
