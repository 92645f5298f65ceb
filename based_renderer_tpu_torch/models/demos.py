"""The demo set of ``based_renderer_tpu/models/demos.py`` that the port runs.

Each demo returns (pipeline, mesh, uniforms_fn, instances) where
``uniforms_fn(t)`` produces the per-frame uniforms at animation time ``t``.
Pipelines are copied field for field from the JAX package; see its
demos.py for the measurements behind each budget and raster knob.  One
departs: big_mesh's MSAA-4x pair budget (``big_mesh_budget``), sized
from the port's own sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math3d
from ..pipeline import DepthState, Pipeline
from ..renderer import Renderer
from . import geometry


def triangle_demo(r: Renderer):
    """BASELINE config 1 / triangle.slang: flat NDC triangle, no depth."""
    data = geometry.triangle_mesh_data()
    mesh = r.upload_mesh(data["positions"])
    pipe = Pipeline(shader="flat_ndc", depth=DepthState(test=False, write=False))
    return pipe, mesh, lambda t: {}, None


def cube_demo(r: Renderer, vertex_colors: bool = True):
    """BASELINE config 2 / cube.slang: spinning cube, depth-tested.

    Uniforms mirror the reference: model spins about -Y, view = translate
    z -3, proj = perspective 45 deg.
    """
    data = geometry.cube_mesh_data()
    kwargs = {"color": data["color"]} if vertex_colors else {}
    mesh = r.upload_mesh(data["positions"], **kwargs)
    shader = "vertex_color" if vertex_colors else "flat_mvp"
    pipe = Pipeline(shader=shader, depth=DepthState(test=True, write=True, compare="less"))
    aspect = r.config.width / r.config.height

    def uniforms(t):
        model = math3d.rotate(np.float32(t), (0.0, -1.0, 0.0))
        model = math3d.rotate(np.float32(np.radians(-55.0)), (1.0, 0.0, 0.0), model)
        view = math3d.translate((0.0, 0.0, 3.0))  # camera at z=-3 looking +z
        proj = math3d.perspective(np.radians(45.0), aspect, 0.1, 10.0)
        return {"model": model, "view": view, "proj": proj}

    return pipe, mesh, uniforms, None


def textured_cube_demo(r: Renderer):
    """BASELINE config 3: textured + Lambert-lit cube, back-face culled,
    shaded per covered tile through a ladder of budgets (the cube covers
    ~20-30% of the tiles as it turns)."""
    data = geometry.cube_mesh_data()
    mesh = r.upload_mesh(data["positions"], uv=data["uv"], normal=data["normal"])
    tex = r.upload_texture(geometry.checkerboard_texture(), mipmaps=True)
    pipe = Pipeline(
        shader="textured_lit",
        depth=DepthState(test=True, write=True, compare="less"),
        cull_mode="back",
        front_face="ccw",
        shade_compact=(0.125, 0.25, 0.375, 0.5),
    )
    aspect = r.config.width / r.config.height

    def uniforms(t):
        model = math3d.rotate(np.float32(t), (0.0, -1.0, 0.0))
        model = math3d.rotate(np.float32(np.radians(-55.0)), (1.0, 0.0, 0.0), model)
        view = math3d.translate((0.0, 0.0, 3.0))
        proj = math3d.perspective(np.radians(45.0), aspect, 0.1, 10.0)
        return {
            "model": model,
            "view": view,
            "proj": proj,
            "texture": tex,
            "light_dir": torch.tensor([0.3, 0.4, 1.0]),
            "ambient": 0.15,
        }

    return pipe, mesh, uniforms, None


def textured_fullscreen_demo(r: Renderer):
    """Full-screen textured quad (the sky/background tier of BASELINE
    config 3): every pixel takes a texture tap, so there is nothing for
    compaction to skip.  Frames scroll the UVs."""
    data = geometry.fullscreen_quad_data()
    mesh = r.upload_mesh(data["positions"], uv=data["uv"])
    tex = r.upload_texture(geometry.checkerboard_texture(), mipmaps=True)
    pipe = Pipeline(shader="textured_fullscreen", depth=DepthState(test=False, write=False))

    def uniforms(t):
        t = torch.tensor(t, dtype=torch.float32)
        return {
            "texture": tex,
            "uv_offset": torch.stack([t * 0.11, t * 0.07]),
            # Keeps per-frame checksums distinct (a scrolled periodic
            # texture sums shift-invariant).
            "tint": torch.tensor(0.9) + torch.tensor(0.1) * torch.sin(t),
        }

    return pipe, mesh, uniforms, None


def instanced_demo(r: Renderer, count: int = 10_000):
    """BASELINE config 4: a field of instanced cubes.  The pair and slot
    budgets are INSTANCED_BUDGET."""
    data = geometry.cube_mesh_data()
    mesh = r.upload_mesh(data["positions"])
    transforms, colors = geometry.instanced_grid_transforms(count)
    instances = {
        "transform": torch.tensor(transforms.reshape(count, 16), device=r.device),
        "instance_color": torch.tensor(colors, device=r.device),
    }
    pipe = Pipeline(
        shader="instanced_color",
        depth=DepthState(test=True, write=True, compare="less", clip=False),
        cull_mode="back",
        front_face="ccw",
        near_clip=False,
        raster_pairs_factor=INSTANCED_BUDGET[0],
        raster_sublane=True,
        raster_group=32,
        raster_assemble="pallas",
        raster_slots_factor=INSTANCED_BUDGET[1],
        raster_tile=(128, 8),
    )
    aspect = r.config.width / r.config.height
    extent = float(np.abs(transforms[:, :3, 3]).max()) + 2.0

    def uniforms(t):
        a = torch.tensor(t, dtype=torch.float32) * torch.tensor(0.3, dtype=torch.float32)
        eye = torch.stack(
            [torch.cos(a) * extent, torch.tensor(-extent * 0.6, dtype=torch.float32), torch.sin(a) * extent]
        )
        view = math3d.look_at(eye, (0.0, 0.0, 0.0), (0.0, -1.0, 0.0))
        proj = math3d.perspective(np.radians(60.0), aspect, 0.1, extent * 4.0)
        return {"view": view, "proj": proj}

    return pipe, mesh, uniforms, instances


#: The worst view of the 1M-triangle mesh over one turn of the model, as
#: (extra tiles, true (tile, triangle) pairs) per triangle, at 3840x2160
#: with coverage MSAA-4x and without it: the largest of the benchmark's
#: mesh and the demo's generated mesh (the same procedural torus-knot tube,
#: mesh_seed 0), over the period at dt 1/60 and dt 1/600 within 0.5 s of
#: each worst view (sweep_pair_budget.py on an H100; PERF.md section 6).
WORST_4K_MSAA4 = (0.400538, 0.877929)  # t = 9.435 s and 4.843 s
WORST_4K = (0.347944, 0.816077)  # t = 9.443 s and 4.882 s
#: Room each 4K tier keeps above its worst view, on the extras budget
#: (raster_pairs_factor - 1) and on the slots: 10%, for views between the
#: sampled times.  A view that needs more overflows visibly (overflowed,
#: FrameResult.pair_budget_use > 1), never silently.
HEADROOM = 1.10

#: The worst view of the instanced cube field over one orbit of the camera,
#: as (extra tiles, true (tile, triangle) pairs) per triangle of the stream
#: (every instance's 12), at 1920x1080 without MSAA: the largest of the
#: benchmark's instanced_field tables (six seeds) and the demo's own grid,
#: 10,000 cubes, over the orbit at dt 1/60 and dt 1/600 within 0.5 s of
#: each worst view (sweep_pair_budget.py --scene instanced on an H100;
#: PERF.md section 6).  Both are the demo's grid's.
WORST_INSTANCED_1080P = (0.146342, 0.534150)  # t = 3.067 s and 3.067 s
#: (raster_pairs_factor, raster_slots_factor) of the instanced demo: the
#: JAX package's (1.2, 0.6), which holds WORST_INSTANCED_1080P with
#: HEADROOM (it needs 1.17 and 0.59).
INSTANCED_BUDGET = (1.2, 0.6)


def big_mesh_budget(width: int, msaa: int, triangles: int) -> tuple:
    """(raster_pairs_factor, raster_slots_factor) of the big_mesh demo.

    - Below 100k triangles each triangle spans more tiles: the generous
      defaults (4.0, no slot cut), as in the JAX package.
    - MSAA-4x: the smallest factors, to 0.01, that hold WORST_4K_MSAA4 with
      HEADROOM.  Coverage MSAA pads every bbox, so it crosses more tiles;
      the JAX package's (1.4, 0.9) does not hold: the worst view needs
      0.4005 extra tiles a triangle.
    - Up to 2560 px wide without MSAA: the JAX package's tight tier
      (1.15, 0.6), measured there for ~1M tiny triangles.
    - Wider without MSAA: the JAX package's (1.4, 0.9), which holds
      WORST_4K with HEADROOM (it needs 1.39 and 0.90).

    The sweep behind the MSAA-4x tier covers one mesh, the procedural
    stand-in for BASELINE config 5's scan, at 1M triangles and 3840x2160
    with coverage MSAA.  Other sizes, triangle counts from 100k up (larger
    triangles, more tiles each), a scanned mesh's spread of triangle
    sizes, and 2x2 supersampling (``msaa_supersample``, which rasterizes
    at twice the width and height) take the tier unswept: they overflow
    visibly if it does not hold.  Sweep it again once the scan is in the
    repository.
    """
    if triangles < 100_000:
        return 4.0, None
    if msaa == 4:
        return 1.45, 0.97
    if width <= 2560:
        return 1.15, 0.6
    return 1.4, 0.9


def big_mesh_demo(r: Renderer, triangles: int = 1_000_000, generated: bool = False):
    """BASELINE config 5: ~1M-triangle mesh with Blinn-Phong shading.

    The pair and slot budgets are ``big_mesh_budget``'s tiers.
    ``generated=True`` makes the mesh on the device with
    geometry.procedural_mesh_device (Renderer.generated_mesh): a sequence
    then regenerates it once per call into buffers of its own instead of
    capturing the uploaded tensors.
    """
    if generated:
        mesh = r.generated_mesh(geometry.procedural_mesh_device(triangles, device=r.device))
    else:
        data = geometry.procedural_mesh_data(triangles)
        mesh = r.upload_mesh(data["positions"], indices=data["indices"], normal=data["normal"])
    pairs_factor, slots_factor = big_mesh_budget(r.config.width, r.config.msaa, triangles)
    pipe = Pipeline(
        shader="blinn_phong",
        depth=DepthState(test=True, write=True, compare="less"),
        cull_mode="back",
        front_face="ccw",
        near_clip=False,
        raster_pairs_factor=pairs_factor,
        raster_slots_factor=slots_factor,
        raster_sublane=True,
        raster_group=64,
        raster_tile=(128, 8),
        raster_assemble="pallas",
    )
    aspect = r.config.width / r.config.height

    def uniforms(t):
        model = math3d.rotate(np.float32(t * 0.5), (0.0, -1.0, 0.0))
        view = math3d.translate((0.0, 0.0, 2.2))
        proj = math3d.perspective(np.radians(50.0), aspect, 0.1, 10.0)
        return {
            "model": model,
            "view": view,
            "proj": proj,
            "light_pos": torch.tensor([3.0, -3.0, -3.0]),
            "eye_pos": torch.tensor([0.0, 0.0, -2.2]),
            "base_color": torch.tensor([0.55, 0.65, 0.8]),
        }

    return pipe, mesh, uniforms, None


DEMOS = {
    "triangle": triangle_demo,
    "cube": cube_demo,
    "textured_cube": textured_cube_demo,
    "textured_fullscreen": textured_fullscreen_demo,
    "instanced": instanced_demo,
    "big_mesh": big_mesh_demo,
}
