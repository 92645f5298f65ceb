"""based_renderer_tpu_torch: the PyTorch + CUDA port of based_renderer_tpu.

The port runs the renderer's main path (one opaque draw, no MSAA) with a
hand-written Hopper raster kernel (``csrc/raster_tile.cu``) on CUDA
tensors and its plain PyTorch version on CPU tensors.  It imports torch
and never jax; the JAX package stays the reference it is tested against.

Quick start::

    import based_renderer_tpu_torch as brt

    r = brt.Renderer(brt.RendererConfig(width=1920, height=1080))
    pipe, mesh, uniforms, _ = brt.models.demos.cube_demo(r)
    frame = r.render_frame(pipe, mesh, uniforms(0.0))
"""

from . import convert, math3d, models, shader
from .models import demos
from .pipeline import BlendState, DepthState, Pipeline, StencilState
from .renderer import FrameResult, Renderer, RendererConfig
from .scene import Mesh, upload_mesh
from .shader import Shader, register
from .utils import errors, image

__version__ = "0.1.0"

__all__ = [
    "BlendState",
    "DepthState",
    "FrameResult",
    "Mesh",
    "Pipeline",
    "Renderer",
    "RendererConfig",
    "Shader",
    "StencilState",
    "convert",
    "demos",
    "errors",
    "image",
    "math3d",
    "models",
    "register",
    "shader",
    "upload_mesh",
    "__version__",
]
