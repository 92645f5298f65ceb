"""The demo set of ``based_renderer_tpu/models/demos.py`` that the port runs.

Each demo returns (pipeline, mesh, uniforms_fn, instances) where
``uniforms_fn(t)`` produces the per-frame uniforms at animation time ``t``.
Pipelines are copied field for field from the JAX package; see its
demos.py for the measurements behind each budget and raster knob.
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
    """BASELINE config 4: a field of instanced cubes."""
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
        raster_pairs_factor=1.2,
        raster_sublane=True,
        raster_group=32,
        raster_assemble="pallas",
        raster_slots_factor=0.6,
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


def big_mesh_demo(r: Renderer, triangles: int = 1_000_000, generated: bool = False):
    """BASELINE config 5: ~1M-triangle mesh with Blinn-Phong shading.

    The budget tiers follow the JAX package: tight pair/slot factors for
    ~1M tiny triangles at up to 2560 px wide without MSAA, a wide tier at
    4K (or under MSAA), and the generous defaults at toy triangle counts.
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
    narrow = r.config.width <= 2560 and r.config.msaa == 1
    pipe = Pipeline(
        shader="blinn_phong",
        depth=DepthState(test=True, write=True, compare="less"),
        cull_mode="back",
        front_face="ccw",
        near_clip=False,
        raster_pairs_factor=(1.15 if narrow else 1.4) if triangles >= 100_000 else 4.0,
        raster_slots_factor=(0.6 if narrow else 0.9) if triangles >= 100_000 else None,
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
