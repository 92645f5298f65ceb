"""Renderer: record draws, then run the frame eagerly on one device.

The PyTorch counterpart of ``based_renderer_tpu/renderer.py`` for
single- and multi-draw frames: ``begin_frame``/``draw``/``end_frame``
record a draw list, and ``end_frame`` runs, per draw, expand_instances ->
the vertex stage -> gather_triangles -> clip_near -> setup_triangles (with
the draw's depth bias) -> rasterize_vis with the varyings as channels, the
draw's stencil state and the previous draw's visibility as init (the
Hopper kernels on CUDA: the sequential raster, also for
``raster_two_pass``; the record assembly for ``raster_assemble="pallas"``;
the sublane raster for eligible ``raster_sublane`` and ``raster_batch``
draws; the MSAA-4x forms under coverage MSAA; the template transpose and
the row-reading assembly under ``raster_tmpl="pallas"``), then per draw
the gather-free shading from the interpolated planes (per covered tile
under ``shade_compact``) and the blend composite against that draw's own
visibility snapshot, and the MSAA resolve.  PyTorch runs eagerly, so
there is no program cache.

``RendererConfig.msaa=4`` is coverage-sample MSAA-4x: per-sample
visibility at the four standard sample positions, attributes and shading
once per sample layer (each layer one image, a batch axis of the
fragment shader) at the pixel center of each sample's winner, then a
box resolve.  With ``msaa_supersample`` it is 2x2 supersampling instead:
the frame rasterizes without MSAA at twice the extent and a 2x2 box
resolve follows.  With ``msaa=1`` ``msaa_supersample`` changes nothing.

``Pipeline.shade_compact`` shades a draw per covered (8, 128) tile
(ops/compact.py) when the raster extent tiles by (8, 128) and the
backend is "pallas", or "auto" on a device other than the CPU: the JAX
package's rule, so CPU frames under "auto" equal its "auto" frames.  A
ladder of budgets picks the smallest that holds the draw's covered-tile
count, read on the host (one synchronisation per compacted draw); past
the largest the draw shades full-screen.  Render state the port does not
have yet (``instance_cull``) raises FeatureNotPresentError naming the
ROADMAP step that will port it.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from . import shader as shader_lib
from .ops import compact
from .ops import fixedpoint as fp
from .ops.clip import clip_near
from .ops.raster import rasterize_vis
from .ops.setup import setup_triangles
from .ops.vertex import expand_instances, gather_triangles
from .pipeline import Pipeline
from .scene import Mesh, Texture, upload_mesh, upload_texture
from .utils.errors import AllocationError, DeviceError, DrawError, FeatureNotPresentError, FrameError


@dataclass(frozen=True)
class RendererConfig:
    """Static renderer configuration; the same fields and validation as the
    JAX package's RendererConfig."""

    width: int = 800
    height: int = 600
    msaa: int = 1  # 1 or 4
    msaa_supersample: bool = False
    clear_color: tuple = (0.0, 0.0, 0.0, 1.0)
    clear_depth: float = 1.0
    debug: bool = False  # overflow raises AllocationError; NaN check
    raster_backend: str = "auto"  # "pallas": the kernel variants and compaction; "xla": neither
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
    """Rendered frame (device tensors; fetch lazily).

    ``color_planar`` is always the resolved (4, H, W) colour.  ``tri_id``
    and ``depth_q`` (and ``stencil``) are (4, H, W) per-sample planes under
    coverage MSAA and (2H, 2W) under ``msaa_supersample``.
    """

    color_planar: torch.Tensor  # (4, H, W) f32
    depth_q: torch.Tensor  # (H, W) int32 quantized depth
    tri_id: torch.Tensor  # (H, W) int32
    stencil: Any = None  # int32 8-bit values when a draw turned stencil on, else None
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
    """Blend in planar layout, the channel axis third from last: (4, H, W),
    or (4 samples, 4, H, W) under coverage MSAA, where every sample blends
    on its own (the JAX package vmaps _blend over samples).

    The full VkPipelineColorBlendAttachmentState of the JAX package's
    renderer._blend: separate colour and alpha factors and ops (the alpha
    ones default to the colour ones), the constant-colour family,
    src_alpha_saturate, min/max ignoring the factors, and a write mask
    that applies even with blending off.
    """
    const = torch.tensor(state.constants, dtype=torch.float32, device=src.device).reshape(4, 1, 1)

    def rgb(x):
        return x[..., 0:3, :, :]

    def alpha(x):
        return x[..., 3:4, :, :]

    def factor(name, is_alpha):
        comp = alpha if is_alpha else rgb  # colour-valued factors by component
        if name == "zero":
            return 0.0
        if name == "one":
            return 1.0
        if name == "src_color":
            return comp(src)
        if name == "one_minus_src_color":
            return 1.0 - comp(src)
        if name == "dst_color":
            return comp(dst)
        if name == "one_minus_dst_color":
            return 1.0 - comp(dst)
        if name == "src_alpha":
            return alpha(src)
        if name == "one_minus_src_alpha":
            return 1.0 - alpha(src)
        if name == "dst_alpha":
            return alpha(dst)
        if name == "one_minus_dst_alpha":
            return 1.0 - alpha(dst)
        if name == "constant_color":
            return comp(const)
        if name == "one_minus_constant_color":
            return 1.0 - comp(const)
        if name == "constant_alpha":
            return alpha(const)
        if name == "one_minus_constant_alpha":
            return 1.0 - alpha(const)
        if name == "src_alpha_saturate":  # min(src.a, 1 - dst.a) for colour, 1 for alpha
            return 1.0 if is_alpha else torch.minimum(alpha(src), 1.0 - alpha(dst))
        raise ValueError(name)

    def combine(op, sf, df, is_alpha):
        comp = alpha if is_alpha else rgb
        s, d = comp(src), comp(dst)
        if op == "min":
            return torch.minimum(s, d)
        if op == "max":
            return torch.maximum(s, d)
        a, b = s * factor(sf, is_alpha), d * factor(df, is_alpha)
        if op == "add":
            return a + b
        if op == "subtract":
            return a - b
        if op == "reverse_subtract":
            return b - a
        raise ValueError(op)

    out = src
    if state.enable:
        out = torch.cat(
            [
                combine(state.color_op, state.src_factor, state.dst_factor, False),
                combine(
                    state.alpha_op if state.alpha_op is not None else state.color_op,
                    state.src_alpha_factor if state.src_alpha_factor is not None else state.src_factor,
                    state.dst_alpha_factor if state.dst_alpha_factor is not None else state.dst_factor,
                    True,
                ),
            ],
            dim=-3,
        )
    if set(state.write_mask) == set("rgba"):
        return out
    mask = torch.tensor([ch in state.write_mask for ch in "rgba"], device=src.device)
    return torch.where(mask.reshape(4, 1, 1), out, dst)


def _check_draw_state(pipe: Pipeline):
    """Raise FeatureNotPresentError for render state outside the port."""
    if pipe.instance_cull is not None:
        raise FeatureNotPresentError("instance_cull is not ported yet (ROADMAP A.12)")


def _fragment_inputs(var_tri, interp, invw, depth, bary, tri_id) -> dict:
    """The fragment shader's inputs from ([B,] H, W) planes: the raw
    interpolated varyings ``interp`` (K, ...), divided by the 1/w plane
    ``invw`` when it is given (elementwise, so dividing gathered tiles
    equals gathering divided planes bit for bit), depth, ``bary`` (3, ...)
    and the draw-local ``tri_id``."""
    frag = {}
    if interp is not None:
        if invw is not None:
            interp = interp / torch.where(invw == 0, torch.ones((), dtype=invw.dtype, device=invw.device), invw)[None]
        c0 = 0
        for k in sorted(var_tri):
            c = var_tri[k].shape[-1]
            frag[k] = interp[c0 : c0 + c].movedim(0, -1)
            c0 += c
    frag["tri_id"] = tri_id
    frag["depth"] = depth
    frag["bary"] = bary.movedim(0, -1)
    return frag


#: Draws shaded per covered tile in this process (proof that compaction ran).
COMPACTED_DRAWS = 0


def _compact_tiles(fractions, mask, h: int, w: int):
    """(tile order, budget) for a draw's covered (8, 128) tiles, or None
    when they outnumber every budget of the ladder.  ``mask`` is (S, H, W):
    a tile covered in any sample layer is shaded.  Reading the count is the
    one host synchronisation of a compacted draw.  Every budget that holds
    the count gives the same pixels; the JAX package picks the smallest."""
    nt = compact.num_tiles(h, w)
    fracs = fractions if isinstance(fractions, tuple) else (fractions,)
    budgets = sorted({min(nt, max(8, -(-int(nt * f) // 8) * 8)) for f in fracs})
    order, count = compact.covered_tile_order(mask.any(dim=0), h, w)
    count = int(count)
    fits = [b for b in budgets if count <= b]
    return (order, fits[0]) if fits else None


def _shade_tiles(var_tri, interp, invw, vis, tri_id, fragment, uniforms, blend_state, color, tiles):
    """Shade the draw on its covered tiles only (ops/compact.py).

    ``interp`` (K, [S,] H, W) raw varyings or None, ``invw`` the 1/w plane
    when perspective-correct, ``vis`` the draw's VisBuffer, ``tri_id``
    ([S,] H, W) draw-local (-1 where the draw lost), ``color`` ([S,] 4, H,
    W).  Sample
    layers fold into the tile-row channel axis, so compaction is one row
    gather and one scatter per plane set; the fragment shader sees
    (budget * S, 8, 128) images, each one tile of one sample layer."""
    global COMPACTED_DRAWS
    order, budget = tiles
    parts = [] if interp is None else [interp]
    if invw is not None:
        parts.append(invw[None])
    planes = torch.cat(parts + [vis.depth[None], vis.b0[None], vis.b1[None], vis.b2[None]])
    th, tw = compact.TILE_H, compact.TILE_W
    h, w = tri_id.shape[-2:]
    s = tri_id.numel() // (h * w)
    cin = planes.shape[0]
    sel = order[:budget]
    g = compact.gather_tiles(compact.tile_rows(planes.reshape(cin * s, h, w), h, w), sel, cin * s)
    g = g.reshape(budget, cin, s, th, tw).movedim(1, 0).reshape(cin, budget * s, th, tw)
    g_id = compact.gather_tiles(compact.tile_rows(tri_id.reshape(s, h, w), h, w), sel, s).reshape(budget * s, th, tw)
    nvar = 0 if interp is None else interp.shape[0]
    frag = _fragment_inputs(var_tri, g[:nvar] if nvar else None, g[nvar] if invw is not None else None,
                            g[cin - 4], g[cin - 3 :], g_id)
    rgba = fragment(frag, uniforms).movedim(-1, -3)  # (budget * S, 4, 8, 128)
    rows = compact.tile_rows(color.reshape(s * 4, h, w), h, w)
    cur = compact.gather_tiles(rows, sel, s * 4).reshape(budget * s, 4, th, tw)
    out = torch.where((g_id >= 0)[:, None], _blend(rgba, cur, blend_state), cur)
    rows = compact.scatter_tiles(rows, sel, out.reshape(budget, s * 4, th, tw))
    COMPACTED_DRAWS += 1
    return compact.untile_rows(rows, s * 4, h, w).reshape(color.shape)


def _reduction_ineligible_reason(pipe: Pipeline, coverage_msaa: bool, need_tile128: bool):
    """Why an order-independent raster cannot serve this draw, or None: the
    JAX package's _reduction_ineligible_reason (renderer.py:496-516).  The
    sublane raster (``need_tile128``) has an MSAA form; the batched one
    does not."""
    if not (pipe.depth.test and pipe.depth.write):
        return "depth test+write disabled"
    if pipe.depth.compare not in ("less", "less_equal", "greater", "greater_equal"):
        return f"unordered depth compare {pipe.depth.compare!r}"
    if pipe.stencil.enable:
        return "stencil enabled"
    if coverage_msaa and not need_tile128:
        return "coverage-sample MSAA"
    if pipe.raster_two_pass:
        return "two-pass rasterization requested"
    if need_tile128 and pipe.raster_tile[0] != 128:
        return f"tile_w {pipe.raster_tile[0]} != 128"
    return None


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
        self.config = config
        self._draws: list[_DrawCmd] = []
        self._in_frame = False
        self._frame_clear = (config.clear_color, config.clear_depth)
        self.frame_count = 0

    # -- resources ---------------------------------------------------------

    def upload_mesh(self, positions, indices=None, **attrs) -> Mesh:
        return upload_mesh(positions, indices=indices, device=self.device, **attrs)

    def upload_texture(self, image, wrap: str = "repeat", mipmaps: bool = False,
                       mip_filter: str = "linear") -> Texture:
        return upload_texture(image, device=self.device, wrap=wrap, mipmaps=mipmaps, mip_filter=mip_filter)

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
        _check_draw_state(pipeline)
        for need in shd.attributes:
            if need not in mesh.attributes and not (instances and need in instances) and not (
                instances and f"instance_{need}" in instances
            ):
                raise DrawError(
                    f"shader {pipeline.shader!r} needs attribute {need!r}; "
                    f"mesh has {sorted(mesh.attributes)}"
                )
        if self.config.debug:
            self._validate_draw(mesh, instances)
        self._draws.append(_DrawCmd(pipeline, mesh, uniforms or {}, instances))

    @staticmethod
    def _validate_draw(mesh: Mesh, instances):
        """Debug-mode draw validation: attribute shapes, index bounds and
        instance-table counts (index checking syncs the device)."""
        n = mesh.num_vertices
        for k, v in mesh.attributes.items():
            if v.ndim != 2:
                raise DrawError(f"attribute {k!r} must be (N, C), got {tuple(v.shape)}")
            if v.shape[0] != n:
                raise DrawError(f"attribute {k!r} has {v.shape[0]} rows; position has {n}")
        p = mesh.attributes["position"]
        if p.shape[1] not in (2, 3, 4):
            raise DrawError(f"position must be (N, 2|3|4), got {tuple(p.shape)}")
        if mesh.indices is not None:
            idx = mesh.indices
            if idx.ndim != 2 or idx.shape[1] != 3:
                raise DrawError(f"indices must be (T, 3), got {tuple(idx.shape)}")
            if idx.numel():
                lo, hi = int(idx.min()), int(idx.max())
                if lo < 0 or hi >= n:
                    raise DrawError(f"index out of bounds: [{lo}, {hi}] vs {n} vertices")
        if instances:
            counts = {k: v.shape[0] for k, v in instances.items()}
            if len(set(counts.values())) > 1:
                raise DrawError(f"instance attribute counts differ: {counts}")

    def _use_pallas(self) -> bool:
        """The JAX package's backend rule (its Renderer._use_pallas): the
        kernel variants (raster_sublane, raster_batch) and compaction are
        on for "pallas", off for "xla", and on off the CPU for "auto"."""
        backend = self.config.raster_backend
        if backend == "pallas":
            return True
        if backend == "xla":
            return False
        return self.device.type != "cpu"

    def _signal_fallback(self, pipe: Pipeline, knob: str, why: str):
        """A requested fast kernel variant is ineligible for this draw:
        warn (raise DrawError in debug mode) and run the sequential raster
        (its MSAA form under coverage MSAA)."""
        msg = (
            f"{knob} requested (shader {pipe.shader!r}) but the draw is "
            f"ineligible: {why}; falling back to the sequential raster kernel"
        )
        if self.config.debug:
            raise DrawError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)

    def end_frame(self) -> FrameResult:
        if not self._in_frame:
            raise FrameError("end_frame without begin_frame")
        self._in_frame = False
        draws, self._draws = self._draws, []
        color, depth_q, tri_id, stencil, overflowed = self._run_frame(draws, *self._frame_clear)
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
            stencil=stencil,
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
        if isinstance(tree, Texture):
            return tree.to(self.device)
        if isinstance(tree, dict):
            return {k: self._uniforms(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._uniforms(v) for v in tree)
        return self._uniform_leaf(tree)

    @staticmethod
    def _scaled_scissor(pipe: Pipeline, scale: int):
        if pipe.scissor is None:
            return None
        return tuple(int(v) * scale for v in pipe.scissor)

    def _run_frame(self, draws, clear_color, clear_depth: float):
        cfg = self.config
        w, h = cfg.width, cfg.height
        # Coverage MSAA-4x: per-sample visibility in (4, H, W) planes; or
        # 2x2 supersampling: the frame at twice the extent, then a box resolve.
        coverage_msaa = cfg.msaa == 4 and not cfg.msaa_supersample
        scale = 2 if (cfg.msaa == 4 and cfg.msaa_supersample) else 1
        nsamp = 4 if coverage_msaa else 1
        rw, rh = w * scale, h * scale
        dev = self.device
        vis = None
        per_draw = []
        offset = 0
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        use_pallas = self._use_pallas()
        # Pass 1: visibility, every draw into the shared buffer.  Off the
        # Pallas backend a draw asking for a kernel variant takes the
        # sequential raster without a signal, as in the JAX package; the
        # variants equal it bit for bit.
        for d in draws:
            pipe = d.pipeline
            shd = shader_lib.get(pipe.shader)
            uniforms = self._uniforms(d.uniforms)
            sublane = batch = False
            if use_pallas and pipe.raster_sublane:
                why = _reduction_ineligible_reason(pipe, coverage_msaa, True)
                sublane = why is None
                if not sublane:
                    self._signal_fallback(pipe, "raster_sublane", why)
            if use_pallas and pipe.raster_batch and not pipe.raster_sublane:
                why = _reduction_ineligible_reason(pipe, coverage_msaa, False)
                batch = why is None
                if not batch:
                    self._signal_fallback(pipe, "raster_batch", why)
            instances = self._uniforms(d.instances) if d.instances else None
            attrs, tri_idx = expand_instances(d.mesh, instances)
            clip, varyings = shd.vertex(attrs, uniforms)
            clip_tri, var_tri = gather_triangles(clip, varyings, tri_idx)
            if pipe.near_clip:
                clip_tri, var_tri = clip_near(clip_tri, var_tri)
            num_t = clip_tri.shape[0]
            scissor = self._scaled_scissor(pipe, scale)
            prev_stencil = None if vis is None else vis.stencil
            ts = setup_triangles(
                clip_tri,
                rw,
                rh,
                cull_mode=pipe.cull_mode,
                front_face=pipe.front_face,
                scissor=scissor,
                bbox_pad_fp=fp.MSAA4_BBOX_PAD_FP if coverage_msaa else 0,
                depth_bias=(
                    (pipe.depth.bias_constant, pipe.depth.bias_slope, pipe.depth.bias_clamp)
                    if pipe.depth.bias_enable
                    else None
                ),
            )
            var_keys = sorted(var_tri)
            channels = torch.cat([var_tri[k] for k in var_keys], dim=-1) if var_keys else None
            tile_w, tile_h = pipe.raster_tile
            out = rasterize_vis(
                ts,
                rw,
                rh,
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
                scissor=scissor,
                skip_losers=pipe.raster_skip_losers,
                unroll=pipe.raster_unroll,
                msaa4=coverage_msaa,
                two_pass=pipe.raster_two_pass,
                stencil=pipe.stencil if pipe.stencil.enable else None,
                stencil_clear=cfg.clear_stencil,
                batch=pipe.raster_batch if batch else 0,
                sublane=sublane,
                sublane_group=pipe.raster_group,
                # No band binning under MSAA, as in the JAX package.
                bin_rows=pipe.raster_bin_rows if sublane and not coverage_msaa else None,
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
            if vis.stencil is None and prev_stencil is not None:
                vis = vis._replace(stencil=prev_stencil)  # a stencil-off draw leaves the attachment
            per_draw.append((var_tri, offset, num_t, interp, invw, vis, uniforms))
            offset += num_t

        # Pass 2: gather-free shading and the blend composite, per draw,
        # against each draw's own visibility snapshot (Vulkan's sequential
        # semantics for multi-draw frames).  Under coverage MSAA every
        # plane has a leading sample axis, which the fragment shader takes
        # as a batch axis (one image per sample layer, as the JAX package's
        # vmap over samples), and the colour is (4, 4, H, W) until the resolve.
        clear = torch.as_tensor(clear_color, dtype=torch.float32, device=dev).reshape(4, 1, 1)
        fbs = (nsamp, rh, rw) if coverage_msaa else (rh, rw)
        color = clear.expand(*fbs[:-2], 4, rh, rw)
        compact_on = use_pallas and compact.eligible(rh, rw)
        for d, (var_tri, off, ntri, interp, invw, vis_i, uniforms) in zip(draws, per_draw):
            pipe = d.pipeline
            fragment = shader_lib.get(pipe.shader).fragment
            mask = (vis_i.tri_id >= off) & (vis_i.tri_id < off + ntri)
            local = torch.where(mask, vis_i.tri_id - off, -1)
            invw = invw if interp is not None and pipe.perspective_correct else None
            tiles = None
            if compact_on and pipe.shade_compact is not None:
                tiles = _compact_tiles(pipe.shade_compact, mask if coverage_msaa else mask[None], rh, rw)
            if tiles is not None:
                color = _shade_tiles(var_tri, interp, invw, vis_i, local, fragment, uniforms, pipe.blend, color,
                                     tiles)
                continue
            bary = torch.stack([vis_i.b0, vis_i.b1, vis_i.b2])
            frag = _fragment_inputs(var_tri, interp, invw, vis_i.depth, bary, local)
            rgba = fragment(frag, uniforms).movedim(-1, -3)  # ([4,] 4, rh, rw)
            color = torch.where(mask[:, None] if coverage_msaa else mask, _blend(rgba, color, pipe.blend), color)
        if coverage_msaa:
            color = color.mean(dim=0)  # coverage resolve: box-average the samples
        if scale == 2:  # supersample resolve: 2x2 box
            color = color.reshape(4, h, 2, w, 2).sum(dim=(2, 4)) * 0.25
        if vis is None:  # a frame without draws is the cleared frame
            clear_q = int(round(clear_depth * fp.DEPTH_ONE_Q))
            depth_q = torch.full(fbs, clear_q, dtype=torch.int32, device=dev)
            return color.contiguous(), depth_q, torch.full_like(depth_q, -1), None, overflowed
        return color.contiguous(), vis.depth_q, vis.tri_id, vis.stencil, overflowed

