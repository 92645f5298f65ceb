"""based_renderer_tpu_torch: the PyTorch + CUDA port of based_renderer_tpu.

The port runs the renderer's main path (one opaque draw), the dense-mesh
path (the 1M-triangle ``big_mesh`` and 10k-instance ``instanced`` demos),
coverage MSAA-4x (``RendererConfig(msaa=4)``, and 2x2 supersampling
with ``msaa_supersample``) and the render state of multi-draw frames
(stencil, blending, depth bias, ``raster_two_pass``, ``raster_batch``,
``raster_tmpl="pallas"``), textured draws (textures, samplers and
``shade_compact`` covered-tile compaction), per-instance frustum culling
(``instance_cull``), generated meshes, and frame sequences
(``render_sequence``, captured as CUDA graphs and replayed per frame)
with hand-written Hopper kernels on CUDA tensors (``csrc/raster_tile.cu``,
``csrc/raster_sublane.cu``, ``csrc/assemble_records.cu``,
``csrc/raster_msaa4.cu``, ``csrc/raster_msaa4_sublane.cu``,
``csrc/transpose_templates.cu``, ``csrc/shade_blinn_phong.cu``,
``csrc/triangle_templates.cu``, ``csrc/transform_points.cu``) and their
plain PyTorch versions on CPU tensors.  It imports torch and never jax;
the JAX package stays the reference it is tested against.  As in the JAX
package, the present path (``present``: Swapchain, FramePacer,
render_loop), the native host runtime (``runtime``) and
``utils.profiling``/``utils.cache`` are imported by path;
``examples/render_demo_torch.py`` drives them.

Quick start::

    import based_renderer_tpu_torch as brt

    r = brt.Renderer(brt.RendererConfig(width=1920, height=1080))
    pipe, mesh, uniforms, instances = brt.demos.big_mesh_demo(r)
    frame = r.render_frame(pipe, mesh, uniforms(0.0), instances=instances)
    sums = r.render_sequence(pipe, mesh, uniforms_fn=uniforms, num_frames=20)
"""

from . import convert, math3d, models, shader
from .models import demos
from .pipeline import BlendState, DepthState, Pipeline, StencilState
from .renderer import FrameResult, Renderer, RendererConfig
from .scene import Mesh, Texture, generated_mesh, upload_mesh, upload_texture
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
    "Texture",
    "convert",
    "demos",
    "errors",
    "image",
    "math3d",
    "models",
    "register",
    "shader",
    "generated_mesh",
    "upload_mesh",
    "upload_texture",
    "__version__",
]
