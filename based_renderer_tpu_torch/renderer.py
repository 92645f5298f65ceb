"""Renderer: record draws, then run the frame eagerly on one device.

The PyTorch counterpart of ``based_renderer_tpu/renderer.py`` for the
main path: ``begin_frame``/``draw``/``end_frame`` record a draw list,
and ``end_frame`` runs, per draw, the vertex stage -> gather_triangles ->
clip_near -> setup_triangles -> rasterize_vis with the varyings as
channels (the Hopper kernel on CUDA), then per draw the gather-free
shading from the interpolated planes and the opaque composite.  PyTorch
runs eagerly, so there is no program cache.

Render state outside this slice raises FeatureNotPresentError naming the
ROADMAP step that will port it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from . import shader as shader_lib
from .ops import fixedpoint as fp
from .ops.clip import clip_near
from .ops.raster import rasterize_vis
from .ops.setup import setup_triangles
from .ops.vertex import expand_instances, gather_triangles
from .pipeline import Pipeline
from .scene import Mesh, upload_mesh
from .utils.errors import AllocationError, DeviceError, DrawError, FeatureNotPresentError, FrameError


@dataclass(frozen=True)
class RendererConfig:
    """Static renderer configuration; the same fields and validation as the
    JAX package's RendererConfig."""

    width: int = 800
    height: int = 600
    msaa: int = 1  # 1 or 4 (4 is not ported yet)
    msaa_supersample: bool = False
    clear_color: tuple = (0.0, 0.0, 0.0, 1.0)
    clear_depth: float = 1.0
    debug: bool = False  # overflow raises AllocationError; NaN check
    raster_backend: str = "auto"  # one tile rasterizer serves every value
    clear_stencil: int = 0
    framebuffer_srgb: bool = False  # color_u8 encodes with the sRGB curve

    def __post_init__(self):
        if self.msaa not in (1, 4):
            raise ValueError("msaa must be 1 or 4")
        if self.width <= 0 or self.height <= 0 or self.width > 8192 or self.height > 8192:
            raise ValueError("extent must be within 1..8192")


@dataclass
class _DrawCmd:
    pipeline: Pipeline
    mesh: Mesh
    uniforms: Any
    instances: Optional[dict]


@dataclass
class FrameResult:
    """Rendered frame (device tensors; fetch lazily)."""

    color_planar: torch.Tensor  # (4, H, W) f32
    depth_q: torch.Tensor  # (H, W) int32 quantized depth
    tri_id: torch.Tensor  # (H, W) int32
    stencil: Any = None
    # True when a draw's binned (tile, triangle) pair count exceeded its
    # raster_pairs_factor / raster_slots_factor budget (a () bool tensor).
    overflowed: Any = False
    srgb: bool = False

    @property
    def color(self) -> torch.Tensor:
        """(H, W, 4) view."""
        return self.color_planar.permute(1, 2, 0)

    def color_np(self) -> np.ndarray:
        return np.moveaxis(self.color_planar.cpu().numpy(), 0, -1)

    def color_u8(self) -> np.ndarray:
        from .utils import image

        return image.to_u8(self.color_np(), srgb=self.srgb)

    def depth_np(self) -> np.ndarray:
        return self.depth_q.cpu().numpy().astype(np.int64).astype(np.float64) / fp.DEPTH_ONE_Q


def _blend(src, dst, state):
    """Opaque composite in planar (4, H, W) layout: blending disabled, so
    the source replaces the destination in the channels of the write mask."""
    if state.enable:
        raise FeatureNotPresentError("blending is not ported yet (ROADMAP A.10)")
    if set(state.write_mask) == set("rgba"):
        return src
    mask = torch.tensor([ch in state.write_mask for ch in "rgba"], device=src.device)
    return torch.where(mask.reshape(4, 1, 1), src, dst)


def _check_draw_state(pipe: Pipeline, instances):
    """Raise FeatureNotPresentError for render state outside this slice."""
    checks = (
        (pipe.stencil.enable, "stencil", "A.10"),
        (pipe.blend.enable, "blending", "A.10"),
        (pipe.depth.bias_enable, "depth bias", "A.10"),
        (pipe.shade_compact is not None, "shade_compact", "A.11"),
        (bool(instances), "instanced draws", "A.12"),
        (pipe.instance_cull is not None, "instance_cull", "A.12"),
        (pipe.raster_sublane, "raster_sublane", "A.8 and queue B2"),
        (pipe.raster_batch, "raster_batch", "queue B7"),
        (pipe.raster_two_pass, "raster_two_pass", "queue B6"),
        (pipe.raster_assemble == "pallas", "raster_assemble='pallas'", "A.8 and queue B3"),
        (pipe.raster_tmpl == "pallas", "raster_tmpl='pallas'", "queue B8"),
    )
    for on, what, step in checks:
        if on:
            raise FeatureNotPresentError(f"{what} is not ported yet (ROADMAP {step})")


class Renderer:
    """Single-device renderer.

    ``device=None`` means ``torch.device("cuda")`` and raises DeviceError
    when CUDA is absent; the CPU is used only when named.
    """

    def __init__(self, config: RendererConfig = RendererConfig(), device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise DeviceError("no CUDA device; pass device='cpu' to render on the CPU")
            device = torch.device("cuda")
        self.device = torch.device(device)
        if config.msaa == 4 or config.msaa_supersample:
            raise FeatureNotPresentError("MSAA is not ported yet (ROADMAP A.9)")
        self.config = config
        self._draws: list[_DrawCmd] = []
        self._in_frame = False
        self._frame_clear = (config.clear_color, config.clear_depth)
        self.frame_count = 0

    # -- resources ---------------------------------------------------------

    def upload_mesh(self, positions, indices=None, **attrs) -> Mesh:
        return upload_mesh(positions, indices=indices, device=self.device, **attrs)

    def upload_texture(self, image, **sampler):
        raise FeatureNotPresentError("textures are not ported yet (ROADMAP A.11)")

    def resize(self, width: int, height: int):
        if self._in_frame:
            raise FrameError("resize during an open frame")
        self.config = dataclasses.replace(self.config, width=width, height=height)

    # -- frame recording ---------------------------------------------------

    def begin_frame(self, clear_color=None, clear_depth=None):
        if self._in_frame:
            raise FrameError("begin_frame called twice without end_frame")
        self._in_frame = True
        self._draws = []
        self._frame_clear = (
            tuple(clear_color) if clear_color is not None else self.config.clear_color,
            float(clear_depth) if clear_depth is not None else self.config.clear_depth,
        )
        return self

    def draw(self, pipeline: Pipeline, mesh: Mesh, uniforms=None, instances=None):
        if not self._in_frame:
            raise FrameError("draw outside begin_frame/end_frame")
        shd = shader_lib.get(pipeline.shader)  # validates the shader name
        _check_draw_state(pipeline, instances)
        for need in shd.attributes:
            if need not in mesh.attributes:
                raise DrawError(
                    f"shader {pipeline.shader!r} needs attribute {need!r}; "
                    f"mesh has {sorted(mesh.attributes)}"
                )
        self._draws.append(_DrawCmd(pipeline, mesh, uniforms or {}, instances))

    def end_frame(self) -> FrameResult:
        if not self._in_frame:
            raise FrameError("end_frame without begin_frame")
        self._in_frame = False
        draws, self._draws = self._draws, []
        color, depth_q, tri_id, overflowed = self._run_frame(draws, *self._frame_clear)
        if self.config.debug:
            if bool(overflowed):
                raise AllocationError(
                    "raster pair buffer overflow: a draw's (tile, triangle) pair "
                    "count exceeded its raster_pairs_factor budget, so trailing "
                    "triangles were dropped; raise Pipeline.raster_pairs_factor"
                )
            if not bool(torch.isfinite(color).all()):
                raise FrameError("non-finite values in rendered color buffer")
        self.frame_count += 1
        return FrameResult(
            color_planar=color,
            depth_q=depth_q,
            tri_id=tri_id,
            overflowed=overflowed,
            srgb=self.config.framebuffer_srgb,
        )

    def render_frame(self, pipeline, mesh, uniforms=None, instances=None, **clear) -> FrameResult:
        """Convenience: one-draw frame."""
        self.begin_frame(**clear)
        self.draw(pipeline, mesh, uniforms, instances)
        return self.end_frame()

    # -- the frame -----------------------------------------------------------

    def _uniform_leaf(self, x):
        if isinstance(x, torch.Tensor):
            t = x.to(self.device)
        else:
            t = torch.tensor(np.asarray(x), device=self.device)
        return t.to(torch.float32) if t.is_floating_point() else t

    def _uniforms(self, tree):
        if isinstance(tree, dict):
            return {k: self._uniforms(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._uniforms(v) for v in tree)
        return self._uniform_leaf(tree)

    def _run_frame(self, draws, clear_color, clear_depth: float):
        cfg = self.config
        w, h = cfg.width, cfg.height
        dev = self.device
        vis = None
        per_draw = []
        offset = 0
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        # Pass 1: visibility, every draw into the shared buffer.
        for d in draws:
            pipe = d.pipeline
            shd = shader_lib.get(pipe.shader)
            uniforms = self._uniforms(d.uniforms)
            attrs, tri_idx = expand_instances(d.mesh, d.instances)
            clip, varyings = shd.vertex(attrs, uniforms)
            clip_tri, var_tri = gather_triangles(clip, varyings, tri_idx)
            if pipe.near_clip:
                clip_tri, var_tri = clip_near(clip_tri, var_tri)
            num_t = clip_tri.shape[0]
            ts = setup_triangles(
                clip_tri,
                w,
                h,
                cull_mode=pipe.cull_mode,
                front_face=pipe.front_face,
                scissor=pipe.scissor,
            )
            var_keys = sorted(var_tri)
            channels = torch.cat([var_tri[k] for k in var_keys], dim=-1) if var_keys else None
            tile_w, tile_h = pipe.raster_tile
            out = rasterize_vis(
                ts,
                w,
                h,
                tile_w=tile_w,
                tile_h=tile_h,
                depth_test=pipe.depth.test,
                depth_compare=pipe.depth.compare,
                depth_write=pipe.depth.write,
                depth_clip="clamp" if pipe.depth.clamp else pipe.depth.clip,
                depth_clear=clear_depth,
                max_pairs=max(int(num_t * pipe.raster_pairs_factor), 1024),
                slots=(
                    None
                    if pipe.raster_slots_factor is None
                    else max(int(num_t * pipe.raster_slots_factor), 1024)
                ),
                init=vis,
                id_offset=offset,
                channels=channels,
                perspective=pipe.perspective_correct,
                scissor=pipe.scissor,
                skip_losers=pipe.raster_skip_losers,
                unroll=pipe.raster_unroll,
                assemble=pipe.raster_assemble,
                tmpl=pipe.raster_tmpl,
                return_overflow=True,
            )
            if channels is None:
                vis, of = out
                interp = invw = None
            else:
                vis, interp, invw, of = out
            overflowed = overflowed | of
            per_draw.append((var_tri, offset, num_t, interp, invw, vis, uniforms))
            offset += num_t

        # Pass 2: gather-free shading and the opaque composite, per draw,
        # against each draw's own visibility snapshot (Vulkan's sequential
        # semantics for multi-draw frames).
        clear = torch.as_tensor(clear_color, dtype=torch.float32, device=dev).reshape(4, 1, 1)
        color = clear.expand(4, h, w)
        for d, (var_tri, off, ntri, interp, invw, vis_i, uniforms) in zip(draws, per_draw):
            pipe = d.pipeline
            mask = (vis_i.tri_id >= off) & (vis_i.tri_id < off + ntri)
            frag = {}
            if interp is not None:
                if pipe.perspective_correct:
                    one = torch.ones((), dtype=torch.float32, device=dev)
                    interp = interp / torch.where(invw == 0, one, invw)[None]
                c0 = 0
                for k in sorted(var_tri):
                    c = var_tri[k].shape[-1]
                    frag[k] = interp[c0 : c0 + c].permute(1, 2, 0)
                    c0 += c
            frag["tri_id"] = torch.where(mask, vis_i.tri_id - off, -1)
            frag["depth"] = vis_i.depth
            frag["bary"] = torch.stack([vis_i.b0, vis_i.b1, vis_i.b2], dim=-1)
            rgba = shader_lib.get(pipe.shader).fragment(frag, uniforms).permute(2, 0, 1)
            color = torch.where(mask[None], _blend(rgba, color, pipe.blend), color)
        if vis is None:  # a frame without draws is the cleared frame
            clear_q = int(round(clear_depth * fp.DEPTH_ONE_Q))
            depth_q = torch.full((h, w), clear_q, dtype=torch.int32, device=dev)
            return color.contiguous(), depth_q, torch.full_like(depth_q, -1), overflowed
        return color.contiguous(), vis.depth_q, vis.tri_id, overflowed
