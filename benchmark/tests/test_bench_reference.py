"""The plain reference: its vectorised raster equals the frozen loop
oracle bit for bit, with depth clipping on and off, and its frames agree
with the program's CPU path at 128x96 for both configurations (big_mesh at
2000 triangles) and for the instanced test cell (``instanced_cell/``)."""

import json

import numpy as np
import pytest
import torch

from benchmark.conftest import INSTANCED_CELL, SMALL
from benchmark.harness import compare, core, spec
from benchmark.reference import oracle, raster, render

SEEDS = (5, 2**31 + 9)


def _cfg(bench, name):
    return core.merge(spec.config(bench, name), {k: v for k, v in SMALL[name].items() if k != "traffic"})


@pytest.mark.parametrize("name", ["cube_1080p", "big_mesh_4k_msaa4"])
@pytest.mark.parametrize("seed", SEEDS)
def test_raster_equals_the_oracle(bench, name, seed):
    cfg = _cfg(bench, name)
    sc = render.scene(cfg["scene"])
    attrs = sc.mesh(seed, cfg["scene_args"], "cpu")
    w, h = cfg["width"], cfg["height"]
    clip, _, _ = render.clip_space(cfg["reference"], attrs, sc.uniforms(sc.start_time(seed), w / h, cfg["scene_args"]))
    spec_ = cfg["reference"]
    msaa = cfg["msaa"] == 4
    fn = oracle.rasterize_msaa4 if msaa else oracle.rasterize
    o = fn(clip.numpy(), w, h, cull_mode=spec_["cull_mode"], front_face=spec_["front_face"])
    vis = raster.rasterize(clip, w, h, raster.MSAA4_OFFSETS if msaa else raster.CENTER, spec_["cull_mode"],
                           spec_["front_face"], max_pairs=4096)  # many chunks
    lead = (lambda x: x) if msaa else (lambda x: x[None])
    assert (vis.tri.numpy() == lead(o["tri_id"])).all()
    assert (vis.depth_q.numpy() == lead(o["depth_q"])).all()
    assert (vis.bary.numpy() == lead(o["bary"])).all()
    assert (vis.tri >= 0).sum() > 100


def test_raster_at_1080p_equals_the_oracle():
    """The cube at the cell's own size, where its triangles span hundreds of
    pixels and cross depth tiles."""
    sc = render.scene("spinning_cube")
    attrs = sc.mesh(1, {}, "cpu")
    spec_ = {"shader": "vertex_color", "near_clip": True}
    clip, _, _ = render.clip_space(spec_, attrs, sc.uniforms(0.7, 1920 / 1080, {}))
    o = oracle.rasterize(clip.numpy(), 1920, 1080)
    vis = raster.rasterize(clip, 1920, 1080)
    assert (vis.tri[0].numpy() == o["tri_id"]).all() and (vis.depth_q[0].numpy() == o["depth_q"]).all()


@pytest.mark.parametrize("name", ["cube_1080p", "big_mesh_4k_msaa4"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_agrees_with_the_program_on_the_cpu(bench, name, seed):
    from based_renderer_tpu_torch.models import demos
    from based_renderer_tpu_torch.renderer import Renderer, RendererConfig
    from based_renderer_tpu_torch.scene import Mesh

    cfg = _cfg(bench, name)
    w, h = cfg["width"], cfg["height"]
    r = Renderer(RendererConfig(w, h, msaa=cfg["msaa"]), device="cpu")
    pipe = demos.DEMOS[cfg["demo"]](r, **cfg["demo_args"])[0]
    core.check_pipeline(pipe, cfg["reference"])
    sc = render.scene(cfg["scene"])
    attrs = sc.mesh(seed, cfg["scene_args"], "cpu")
    t = sc.start_time(seed)
    f = r.render_frame(pipe, Mesh(attributes=dict(attrs), indices=None), sc.uniforms(t, w / h, cfg["scene_args"]))
    values = compare.numbers([{"t": t, "tri_id": f.tri_id, "depth_q": f.depth_q, "color": f.color_planar}],
                             compare.reference_for(cfg, sc, attrs, w / h))
    assert values["tri_id_off"] == 0 and values["depth_q_gap"] == 0
    # the program's barycentric planes carry the fill rule's bias; the
    # spec's do not: a gap of some 1e-3 on 2-pixel triangles, 1e-5 on the cube
    assert values["color_gap"] < 5e-3


def test_tf32_operands_round_to_ten_mantissa_bits():
    from benchmark.reference import precision

    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, 3.14159265])
    y = precision.operand(x, "tf32")
    bits = y.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-9 and y[2] == 1.0 + 2**-10  # ties to even
    assert torch.equal(precision.operand(x, "float32"), x)
    with pytest.raises(ValueError):
        precision.operand(x, "bf16")


def _deep_stream(seed, width, height, n=48):
    """Clip triangles of both windings whose depth runs from -0.6 to 1.6
    in NDC, so that many samples lie outside [0, 1], crossing each other."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    centre = rng.uniform(-0.8, 0.8, (n, 1, 2))
    xy = (centre + rng.uniform(-0.5, 0.5, (n, 3, 2))).astype(np.float32) * w[..., None]
    z = (rng.uniform(-0.6, 1.6, (n, 1)) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32) * w
    return np.concatenate([xy, z[..., None], w[..., None]], axis=-1)


@pytest.mark.parametrize("msaa", [1, 4])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth_clip", [False, True])
def test_raster_equals_the_oracle_with_depth_clip_on_and_off(seed, msaa, depth_clip):
    w, h = 64, 48
    clip = _deep_stream(seed, w, h)
    fn = oracle.rasterize_msaa4 if msaa == 4 else oracle.rasterize
    o = fn(clip, w, h, cull_mode="back", depth_clip=depth_clip)
    vis = raster.rasterize(torch.from_numpy(clip), w, h, raster.MSAA4_OFFSETS if msaa == 4 else raster.CENTER,
                           "back", depth_clip=depth_clip, max_pairs=2048)
    lead = (lambda x: x) if msaa == 4 else (lambda x: x[None])
    assert (vis.tri.numpy() == lead(o["tri_id"])).all()
    assert (vis.depth_q.numpy() == lead(o["depth_q"])).all()
    assert (vis.bary.numpy() == lead(o["bary"])).all()
    won = vis.depth_q[vis.tri >= 0]
    outside = int(((won < 0) | (won > raster.DEPTH_ONE_Q)).sum())
    # engaged: without the clip, samples outside [0, 1] win; with it, none do
    assert (outside > 50) if not depth_clip else (outside == 0 and int((vis.tri >= 0).sum()) > 200)


@pytest.mark.parametrize("seed", SEEDS)
def test_instanced_reference_agrees_with_the_program_on_the_cpu(lay_reference, seed):
    """The instanced cell's reference frame against the port's CPU frame at
    128x96: the port's vertex stage gives the reference's clip space bit for
    bit, so the two rasterize the same stream."""
    from based_renderer_tpu_torch import shader as program_shader
    from based_renderer_tpu_torch.models import demos
    from based_renderer_tpu_torch.ops import vertex
    from based_renderer_tpu_torch.renderer import Renderer, RendererConfig
    from based_renderer_tpu_torch.scene import Mesh

    lay_reference(INSTANCED_CELL)
    cfg = json.loads((INSTANCED_CELL / "configs" / "instanced_small.json").read_text())
    w, h, args = cfg["width"], cfg["height"], cfg["scene_args"]
    r = Renderer(RendererConfig(w, h, msaa=cfg["msaa"]), device="cpu")
    pipe = demos.DEMOS[cfg["demo"]](r, **cfg["demo_args"])[0]
    core.check_pipeline(pipe, cfg["reference"])
    sc = render.scene(cfg["scene"])
    attrs = sc.mesh(seed, args, "cpu")
    inst = render.scene_instances(sc, seed, args, "cpu")
    t = sc.start_time(seed)
    u = sc.uniforms(t, w / h, args)
    mesh = Mesh(attributes=dict(attrs), indices=None)
    merged, _ = vertex.expand_instances(mesh, inst)
    ours = render.expand_instances(attrs, inst)
    assert sorted(merged) == sorted(ours) and all(torch.equal(merged[k], ours[k]) for k in merged)
    prog_clip, _ = program_shader.get(cfg["reference"]["shader"]).vertex(merged, u)
    clip, _, ids = render.clip_space(cfg["reference"], attrs, u, instances=inst)
    assert torch.equal(prog_clip.reshape(clip.shape), clip)
    assert torch.equal(ids, torch.arange(12 * args["count"]))
    f = r.render_frame(pipe, mesh, u, instances=inst)
    values = compare.numbers([{"t": t, "tri_id": f.tri_id, "depth_q": f.depth_q, "color": f.color_planar}],
                             compare.reference_for(cfg, sc, attrs, w / h, instances=inst))
    assert values["tri_id_off"] == 0 and values["depth_q_gap"] == 0
    assert values["color_gap"] <= 1e-4
    drawn = torch.unique(f.tri_id[f.tri_id >= 0] // 12)
    assert drawn.numel() > 10  # many instances on the screen
