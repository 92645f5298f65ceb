"""The reference's two demos, as in ``based_renderer_tpu/models/demos.py``.

Each demo returns (pipeline, mesh, uniforms_fn, instances) where
``uniforms_fn(t)`` produces the per-frame uniforms at animation time ``t``.
"""

from __future__ import annotations

import numpy as np

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
