"""The port's TiledRenderer with a geometry axis, on gloo CPU ranks.

One world of 4 ranks renders every case over a mesh with a "g" dim: each
draw's triangle stream is cut into slices by the "g" coordinate and the
slices' winners are depth-composited after each draw.  Each frame is held
against the port's single-device frame (tri_id and depth_q exact; colour
bitwise at the tile the shards use, within 1e-5 at the pipeline's own)
and the JAX package's single-device "pallas" frame (as in
test_torch_parallel_tiles.py), under the compare modes of
tests/test_parallel.py, with instancing on the batched and sublane routes,
and in a sequence, whose frames run eagerly.
"""

import numpy as np
import pytest

from based_renderer_tpu_torch.parallel import launch, workers

from test_torch_parallel_tiles import assert_matches_jax, jax_frame

W, H = 96, 64
PALLAS = {"width": W, "height": H, "raster_backend": "pallas"}


def cube(t, **pipe):
    return {"demo": "cube", "t": t, "pipe": pipe}


def compare_mode(compare, write, clear, mesh):
    return {"mesh": mesh, "geometry_axis": "g", "config": {**PALLAS, "clear_depth": clear},
            "clear": {"clear_depth": clear}, "draws": [cube(0.8, depth={"compare": compare, "write": write})]}


FRAMES = {
    "cube-1x2x2": {"mesh": (1, 2, 2), "geometry_axis": "g", "config": PALLAS, "draws": [cube(0.8)]},
    "cube-1x1x4": {"mesh": (1, 1, 4), "geometry_axis": "g", "config": PALLAS, "draws": [cube(0.8)]},
    # The compare modes of tests/test_parallel.py:161-188.
    "greater-write-clear0": compare_mode("greater", True, 0.0, (2, 1, 2)),
    "less_equal-write": compare_mode("less_equal", True, 1.0, (2, 1, 2)),
    "always-write": compare_mode("always", True, 1.0, (1, 1, 4)),
    "less-nowrite": compare_mode("less", False, 1.0, (1, 2, 2)),
    "multidraw": {"mesh": (1, 2, 2), "geometry_axis": "g", "config": PALLAS,
                  "draws": [cube(0.3), cube(0.9, depth={"compare": "less_equal"})]},
    "instanced-batched": {"mesh": (2, 1, 2), "geometry_axis": "g", "config": PALLAS,
                          "draws": [{"demo": "instanced", "kw": {"count": 64}, "t": 0.3,
                                     "pipe": {"raster_batch": 8}}]},
    # Shards 128 px wide keep the sublane route's tile_w of 128.
    "instanced-sublane": {"mesh": (1, 2, 2), "geometry_axis": "g",
                          "config": {"width": 256, "height": 32, "raster_backend": "pallas"},
                          "draws": [{"demo": "instanced", "kw": {"count": 48}, "t": 0.3,
                                     "pipe": {"raster_sublane": True, "raster_tile": (128, 8)}}]},
}
SEQUENCE = {"mesh": (1, 2, 2), "geometry_axis": "g", "config": PALLAS, "draws": [cube(0.0)],
            "sequence": {"times": [0.1, 0.6, 1.2]}, "return_frames": True}
REJECTED = {
    "not_equal": {"mesh": (1, 2, 2), "geometry_axis": "g", "config": PALLAS, "expect": "ValueError",
                  "draws": [cube(0.8, depth={"compare": "not_equal"})]},
    "stencil": {"mesh": (1, 2, 2), "geometry_axis": "g", "config": PALLAS, "expect": "ValueError",
                "draws": [cube(0.8, stencil={"enable": True, "pass_op": "replace", "ref": 3})]},
    "xla-backend": {"mesh": (1, 2, 2), "geometry_axis": "g", "config": {**PALLAS, "raster_backend": "xla"},
                    "expect": "FeatureNotPresentError", "draws": [cube(0.8)]},
}
TIMED = {**FRAMES["multidraw"], "timing": 3}
CASES = {**FRAMES, "sequence": SEQUENCE, "timed": TIMED, **REJECTED}


@pytest.fixture(scope="module")
def results():
    specs = [dict(spec, arrays=True) for spec in CASES.values()]
    ranks = launch.run(workers.run_specs, (1, 2, 2), (specs,), backend="gloo", devices="cpu", timeout=900)
    return {name: [rank[i] for rank in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", FRAMES)
def test_geometry_frame_matches_single_device(results, name):
    spec = FRAMES[name]
    ranks = results[name]
    r0 = ranks[0]
    for key in ("tri_id", "depth_q", "stencil", "color_bitwise"):
        assert r0["vs_single_tile"][key], key
    for key in ("tri_id", "depth_q"):
        assert r0["vs_single"][key], key
    assert r0["vs_single"]["color"] <= 1e-5 and r0["vs_single"]["covered"] > 0
    # Every rank's window and slice: g ranks share a window.
    ny, nx, ng = spec["mesh"]
    assert sorted(r["shard"] for r in ranks) == sorted(
        ((x * (spec["config"]["width"] // nx), y * (spec["config"]["height"] // ny)),
         (spec["config"]["width"] // nx, spec["config"]["height"] // ny))
        for y in range(ny) for x in range(nx) for _ in range(ng))
    assert_matches_jax(r0["arrays"], jax_frame(spec))


def test_geometry_sequence_matches_single_device(results):
    ranks = results["sequence"]
    for r in ranks:
        np.testing.assert_array_equal(r["sums"], ranks[0]["sums"])
    np.testing.assert_allclose(ranks[0]["sums"], ranks[0]["want_sums"], rtol=1e-5)
    assert ranks[0]["frames_max_diff"] <= 1e-5


def test_geometry_composite_clock_holds_the_timed_frames_only(results):
    """The composite's clock starts after the warm-up: it counts one merge
    a draw of each timed frame, and their time lies within the frames'."""
    n_frames, n_draws = TIMED["timing"], len(TIMED["draws"])
    for r in results["timed"]:
        assert r["merge_calls"] == n_frames * n_draws
        assert 0 < r["merge_ms_per_draw"] * r["merge_calls"] <= r["ms"] * n_frames


@pytest.mark.parametrize("name", REJECTED)
def test_geometry_rejections(results, name):
    expect = REJECTED[name]["expect"]
    assert [r.get("raised") for r in results[name]] == [expect] * 4
    words = {"not_equal": "not_equal", "stencil": "stencil", "xla-backend": "Pallas backend"}
    assert words[name] in results[name][0]["message"]
