"""parallel.tiled.merge_vis_over_axis against the JAX package's composite.

Synthetic visibility buffers for 4 geometry slices, made from a numpy
seed: disjoint triangle ids per slice (as the renderer's global ids are),
uncovered pixels at the clear depth, and depths drawn from four values so
that slices tie at most pixels.  The port's composite runs over the "g"
group of a world of 4 gloo CPU ranks; the JAX package's
``_merge_vis_over_axis`` runs under ``jax.shard_map`` over 4 of the
virtual CPU devices tests/conftest.py provides.  Every merged plane equals
JAX's bit for bit on every slice, for every depth compare with write on
and off and with the test off, on a plain and a per-sample (MSAA) shape.
"""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import based_renderer_tpu as jbrt
from based_renderer_tpu.ops.raster_xla import VisBuffer as JVisBuffer
from based_renderer_tpu.parallel.tiled import _merge_vis_over_axis
from based_renderer_tpu_torch.parallel import launch, workers

NG = 4
SHAPES = [(16, 24), (4, 8, 16)]
COMPARES = ["never", "less", "equal", "less_equal", "greater", "not_equal", "greater_equal", "always"]
STATES = [{"test": True, "write": w, "compare": c} for c in COMPARES for w in (True, False)]
STATES.append({"test": False, "write": True, "compare": "less"})
PLANES = ("tri_id", "depth_q", "b0", "b1", "b2", "interp", "invw")


def make_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    full = (NG, *shape)
    base = (np.arange(NG) * 1000).reshape(-1, *[1] * len(shape))
    covered = rng.random(full) < 0.7
    tri_id = np.where(covered, rng.integers(0, 1000, full) + base, -1).astype(np.int32)
    depth_q = np.where(covered, rng.integers(0, 4, full) * (1 << 28), 1 << 30).astype(np.int32)
    out = {"tri_id": tri_id, "depth_q": depth_q}
    for k in ("b0", "b1", "b2", "invw"):
        out[k] = np.where(covered, rng.random(full), 0.0).astype(np.float32)
    out["invw"] = np.where(covered, out["invw"] + 0.5, 1.0).astype(np.float32)
    out["interp"] = rng.normal(size=(NG, 3, *shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def results():
    inputs = [make_inputs(shape, seed) for seed, shape in enumerate(SHAPES)]
    ranks = launch.run(workers.merge_check, (1, 1, NG), (inputs, STATES), backend="gloo", devices="cpu",
                       timeout=600)
    return inputs, ranks


def jax_merge(x, state):
    mesh = Mesh(np.array(jax.devices()[:NG]), ("g",))

    def body(*planes):
        vis = JVisBuffer(*(p[0] for p in planes[:5]))
        merged, (interp, invw) = _merge_vis_over_axis(vis, [planes[5][0], planes[6][0]], "g", state)
        return tuple(p[None] for p in (*merged[:5], interp, invw))

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("g"),) * 7, out_specs=(P("g"),) * 7, check_vma=False))
    return [np.asarray(p) for p in fn(*(x[k] for k in PLANES))]


@pytest.mark.parametrize("state", STATES, ids=lambda s: f"{s['compare']}-w{int(s['write'])}-t{int(s['test'])}")
def test_merge_equals_jax(results, state):
    inputs, ranks = results
    i = STATES.index(state)
    for s, x in enumerate(inputs):
        want = jax_merge(x, jbrt.DepthState(**state))
        for g in range(NG):
            got = ranks[g][s][i]
            for k, w in zip(PLANES, want):
                np.testing.assert_array_equal(got[k].view(np.int32), w[g].view(np.int32), err_msg=f"{k} slice {g}")
        assert (want[0] >= 0).any()
