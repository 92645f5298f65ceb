"""Renderer: record draws, run frames on one device, and frame sequences.

The PyTorch counterpart of ``based_renderer_tpu/renderer.py``:
``begin_frame``/``draw``/``end_frame`` record a draw list, and
``end_frame`` runs, per draw, the instance cull (``Pipeline.instance_cull``,
ops/cull.py) -> expand_instances -> the vertex stage -> gather_triangles ->
clip_near -> setup_triangles (with the draw's depth bias) -> rasterize_vis
with the varyings as channels, the draw's stencil state and the previous
draw's visibility as init (the Hopper kernels on CUDA: the sequential
raster, also for ``raster_two_pass``; the record assembly for
``raster_assemble="pallas"``; the sublane raster for eligible
``raster_sublane`` and ``raster_batch`` draws; the MSAA-4x forms under
coverage MSAA; the template transpose and the row-reading assembly under
``raster_tmpl="pallas"``), then per draw the gather-free shading from the
interpolated planes (per covered tile under ``shade_compact``) and the
blend composite against that draw's own visibility snapshot, and the MSAA
resolve.  On CUDA an opaque draw whose shader has a fused body
(``Shader.fused``: ``blinn_phong``'s, ops/shade.py) shades, composites
and, as the frame's last draw, resolves in one kernel
(``profiling.ROUTES_TAKEN["fused_shading"]`` counts such draws).
``_run_frame`` is that frame, eagerly.

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
the largest the draw shades full-screen.

``Pipeline.instance_cull`` (the same backend rule; not with ``near_clip``)
compacts an instanced draw's visible instances into a budget before
expansion and carries each surviving triangle's original id through the
records, so the frame equals the unculled one.

A frame is one cached program per key, as the JAX package jits one
per key: ``end_frame`` (and ``render_frame``) looks the program up by the
JAX package's key (the configuration; per draw the pipeline, the shapes
and dtypes of the attributes, indices, instance tables and uniform
leaves, the uniform tree, a texture's sampler state; the clear depth; the
shard), copies the caller's inputs and clear colour into the program's
own buffers and runs it.  On CUDA the program's frame is captured as
CUDA graphs on the key's first call (one eager warm-up frame on a side
stream, then the capture) and replayed after that; its results are
cloned, since the next replay overwrites them.  On the CPU, and on a
geometry axis, whose depth composite talks to other ranks inside the
frame, the program runs the eager frame over its buffers.  A capture
that fails raises.  The eager frame stays reachable:
``r._run_frame(*r.close_frame())``.

``render_sequence`` and ``render_sequence_multi`` render N frames of a
draw list whose uniforms change per frame.  Where the JAX package scans
one compiled program, the port runs the same program machinery once per
frame, one cached program per key (the draws' state and shapes, the ids
of the tensors it captures, ``return_frames``, the clear values), and
copies each frame's uniforms into its buffers on the device.  A frame is
captured in segments split at the compaction's host read: the first
runs pass 1 and pass 2 up to the first compacted draw's covered-tile
count; the host reads the count and replays the segment captured for the
chosen budget (capturing it on first use), which runs to the next count
or the end.  All segments of a program share one memory pool.

Each frame counts, on the device, how full its fullest draw's pair budget
was (``FrameResult.pair_budget_use``, the binner's ``pair_budget_use``
folded over draws with a max); a sequence folds it over its frames
(``last_sequence_pair_budget_use``).  It reads above 1 exactly when a
draw's pair budget overflowed; an instance cull's overflow sets
``overflowed`` alone.  Nothing reads it on the host unless
the caller does; while a profiler records, each frame and each sequence
hands it to ``profiling.keep_budget_use``.  So too the binner's work
(``BinCount``: each draw's true (tile, triangle) pair count and the
triangles binned), which pass 1 leaves in ``Renderer._last_bins`` and a
sequence sums over its frames only while a profiler records:
``profiling.keep_bin_pairs``.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import time
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from . import shader as shader_lib
from .ops import compact
from .ops import fixedpoint as fp
from .ops.clip import clip_near
from .ops.cull import compact_instances, instance_visibility
from .ops.raster import VisBuffer, rasterize_vis
from .ops.setup import setup_triangles
from .ops.vertex import expand_instances, gather_triangles
from .pipeline import Pipeline
from .scene import Mesh, Texture, generated_mesh, upload_mesh, upload_texture
from .utils import profiling
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
    # The largest share of its pair budget a draw's true pair stream
    # needed (a () float64 tensor, > 1 exactly where a pair budget overflowed).
    pair_budget_use: Any = None
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
    factors = (state.src_factor, state.dst_factor, state.src_alpha_factor, state.dst_alpha_factor)
    const = None
    if any(f is not None and "constant" in f for f in factors):
        const = fp.consts(state.constants, src.device).reshape(4, 1, 1)

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
    mask = fp.consts([ch in state.write_mask for ch in "rgba"], src.device, torch.bool)
    return torch.where(mask.reshape(4, 1, 1), out, dst)


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


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where fused bodies run: on a CUDA device."""
    return t.is_cuda


def _fused_body(shd: shader_lib.Shader, pipe: Pipeline, interp, compacted: bool):
    """The draw's fused shading body (``Shader.fused``), or None for the
    plain path: the shader has one, the draw has varyings on CUDA divided
    by 1/w (``perspective_correct``), blending is off, every channel is
    written and the draw is not shaded per covered tile."""
    if shd.fused is None or interp is None or compacted or not _on_card(interp) or not pipe.perspective_correct:
        return None
    if pipe.blend.enable or set(pipe.blend.write_mask) != set("rgba"):
        return None
    return shd.fused


def _tile_budgets(fractions, h: int, w: int) -> list[int]:
    """The ladder of covered-tile budgets of ``Pipeline.shade_compact``."""
    nt = compact.num_tiles(h, w)
    fracs = fractions if isinstance(fractions, tuple) else (fractions,)
    return sorted({min(nt, max(8, -(-int(nt * f) // 8) * 8)) for f in fracs})


def _shade_tiles(var_tri, interp, invw, vis, tri_id, fragment, uniforms, blend_state, color, order, budget):
    """Shade the draw on its first ``budget`` tiles of ``order`` only
    (ops/compact.py).

    ``interp`` (K, [S,] H, W) raw varyings or None, ``invw`` the 1/w plane
    when perspective-correct, ``vis`` the draw's VisBuffer, ``tri_id``
    ([S,] H, W) draw-local (-1 where the draw lost), ``color`` ([S,] 4, H,
    W).  Sample layers fold into the tile-row channel axis, so compaction
    is one row gather and one scatter per plane set; the fragment shader
    sees (budget * S, 8, 128) images, each one tile of one sample layer.
    Counts one ``compacted_draws`` in ``profiling.ROUTES_TAKEN``."""
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
    profiling.ROUTES_TAKEN["compacted_draws"] += 1
    return compact.untile_rows(rows, s * 4, h, w).reshape(color.shape)


def _reduction_ineligible_reason(pipe: Pipeline, coverage_msaa: bool, need_tile128: bool, tile_w: int):
    """Why an order-independent raster cannot serve this draw, or None: the
    JAX package's _reduction_ineligible_reason (renderer.py:496-516).  The
    sublane raster (``need_tile128``) has an MSAA form; the batched one
    does not.  ``tile_w`` is the tile width the draw rasterizes at (a
    shard may cut it)."""
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
    if need_tile128 and tile_w != 128:
        return f"tile_w {tile_w} != 128"
    return None


def shard_tile(tile, extent) -> tuple:
    """The raster tile a shard of ``extent`` (raster pixels) draws with:
    each tile dim cut to its gcd with the extent, so the shard's tile
    origins stay on the frame's tile grid, which the canonical depth
    anchor needs (JAX renderer.py:519-531; every tile dim divides 128)."""
    tw, th = math.gcd(tile[0], extent[0]), math.gcd(tile[1], extent[1])
    if tw < 8 or th < 8:
        raise ValueError(f"shard extent {extent[0]}x{extent[1]} incompatible with raster tiling (needs multiples of 8)")
    return tw, th


def _scissor_window(vis: VisBuffer, prev: Optional[VisBuffer], rect, x0: int, y0: int, clear_q: int,
                    clear_stencil: int) -> VisBuffer:
    """A shard's scissor, applied after the raster (JAX renderer.py:697-712):
    ``vis`` inside ``rect`` (global raster pixels), ``prev`` (the state
    before the draw; None: the cleared buffer) outside it.  The window's
    top-left pixel is (x0, y0).  Equal to the kernels' own scissor, which
    suppresses every update outside the rect."""
    h, w = vis.tri_id.shape[-2:]
    dev = vis.tri_id.device
    sx0, sy0, sx1, sy1 = rect
    gx = torch.arange(x0, x0 + w, device=dev)
    gy = torch.arange(y0, y0 + h, device=dev)
    m = ((gy >= sy0) & (gy < sy1))[:, None] & ((gx >= sx0) & (gx < sx1))[None, :]
    if prev is None:
        prev = VisBuffer(tri_id=-1, depth_q=clear_q, b0=0.0, b1=0.0, b2=0.0)
    stencil = vis.stencil
    if stencil is not None:
        stencil = torch.where(m, stencil, clear_stencil & 0xFF if prev.stencil is None else prev.stencil)
    return VisBuffer(*(torch.where(m, getattr(vis, k), getattr(prev, k)) for k in VisBuffer._fields[:5]),
                     stencil=stencil)


def _flatten(tree):
    """(leaves, treedef) of a uniforms tree: dicts (keys sorted, as JAX
    flattens them), lists and tuples are nodes; everything else, a Texture
    included, is a leaf.  The treedef is hashable (a cache-key part)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k]) for k in keys]
        return [x for leaves, _ in subs for x in leaves], ("dict", tuple(keys), tuple(d for _, d in subs))
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v) for v in tree]
        return [x for leaves, _ in subs for x in leaves], (type(tree).__name__, len(tree), tuple(d for _, d in subs))
    return [tree], None


def _unflatten(treedef, leaves):
    """The inverse of _flatten."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, names, subs = d
        vals = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(names, vals))
        return tuple(vals) if kind == "tuple" else list(vals)

    return build(treedef)


class Shard(NamedTuple):
    """The window of the frame one rank of parallel.TiledRenderer renders:
    the JAX package's shard dict (renderer.py:460-466).

    ``origin`` is the window's top-left pixel in the frame and ``extent``
    its (width, height), both in framebuffer pixels (a supersampled frame
    scales them).  ``geometry`` is None, or (ng, g_index, merge): each
    draw's triangle stream is cut into ng slices, this rank rasterizes
    slice ``g_index``, and ``merge(vis, interp, invw, depth_state)``
    depth-composites the slices' winners after each draw."""

    origin: tuple
    extent: tuple
    geometry: Optional[tuple] = None


class BinCount(NamedTuple):
    """A frame's binning work: per draw the binner's () int32 true (tile,
    triangle) pair count on the device, and the triangles handed to the
    binner over its draws."""

    pairs: tuple
    triangles: int


class _Visibility(NamedTuple):
    """Pass 1's result: every draw's visibility snapshot and planes."""

    draws: list
    per_draw: list  # (var_tri, first id, logical triangle count, interp, invw, vis, uniforms) per draw
    vis: Any  # the last draw's VisBuffer, None without draws
    overflowed: torch.Tensor  # () bool
    pair_budget_use: torch.Tensor  # () float64, the max over draws
    clear_depth: float
    shard: Optional[Shard] = None


class _Pending(NamedTuple):
    """Pass 2 stopped before the compacted draw ``draw``: the host reads
    ``count`` and picks the draw's tile budget (Renderer._tile_budget)."""

    vis: _Visibility
    draw: int
    color: torch.Tensor
    order: torch.Tensor
    count: torch.Tensor


class _Capture(NamedTuple):
    """Where a program captures: one memory pool for all of its segments,
    and the side stream its warm-up and captures run on."""

    pool: Any
    stream: torch.cuda.Stream


class _Segment:
    """A run of the frame between two host decisions: pass 1 and pass 2 up
    to the first compacted draw's covered-tile count, or one compacted draw
    at one budget up to the next count or the end.  ``children`` holds the
    segments that follow, by budget.  With a _Capture it is captured once
    as a CUDA graph and replayed (a failed capture raises); without one it
    runs eagerly."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.out = None
        self.children: dict = {}

    def run(self, state, capture: Optional[_Capture]):
        """The segment once: its eager run without a capture, else its
        graph's replay (span ``brt.frame.replay`` either way), captured
        first on the first call (``brt.frame.capture``)."""
        if capture is None:
            with profiling.span("brt.frame.replay"):
                return self.fn(state)
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            # Cyclic garbage that holds CUDA resources (a profiler's results,
            # a dropped program) must not be freed mid-capture: a destructor's
            # CUDA call there invalidates the capture.  Collect it first and
            # keep the collector off until the capture ends.
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with profiling.span("brt.frame.capture"):
                    with torch.cuda.graph(graph, pool=capture.pool, stream=capture.stream):
                        out = self.fn(state)
            finally:
                if collecting:
                    gc.enable()
            self.graph, self.out = graph, out
        with profiling.span("brt.frame.replay"):
            self.graph.replay()
        return self.out


class _Program:
    """A cached program: a draw list over input buffers of its own, run
    one frame per ``frame()`` call.  On CUDA the frame's segments are
    captured as CUDA graphs, after one eager warm-up frame on the capture
    stream, and replayed; without a capture (the CPU, and a geometry axis,
    which merges over a process group inside the frame, which no CUDA
    graph can capture) the same segments run eagerly."""

    def __init__(self, r: "Renderer", draws, clear_color, clear_depth: float, shard: Optional[Shard]):
        self.r = r
        self.draws = draws
        self.clear = (clear_color, clear_depth)
        self.shard = shard
        self.capture = None
        self.warm = False
        self.bins: Optional[BinCount] = None  # the frame's binning work (pass 1's; a capture's is the graph's)
        if r.device.type == "cuda" and (shard is None or shard.geometry is None):
            self.capture = _Capture(torch.cuda.graph_pool_handle(), torch.cuda.Stream(r.device))
        self.root = _Segment(lambda _: r._frame_begin(self.draws, *self.clear, shard))

    def frame(self):
        """One frame from the current input buffers: its result tuple."""
        if self.capture is not None and not self.warm:
            # Eager warm-up on the capture stream before the first capture:
            # the kernel library, cuBLAS and the allocator are set up.
            cur = torch.cuda.current_stream(self.r.device)
            self.capture.stream.wait_stream(cur)
            with profiling.span("brt.frame.capture"), torch.cuda.stream(self.capture.stream):
                self.r._run_frame(self.draws, *self.clear, self.shard)
            cur.wait_stream(self.capture.stream)
            self.warm = True
        node = self.root
        state = node.run(None, self.capture)
        while isinstance(state, _Pending):
            budget = self.r._tile_budget(state)
            child = node.children.get(budget)
            if child is None:
                child = node.children[budget] = _Segment(functools.partial(self.r._frame_resume, budget=budget))
            state = child.run(state, self.capture)
            node = child
        if self.capture is None or self.bins is None:
            self.bins = self.r._last_bins  # a replay refills the captured frame's tensors
        self.r._last_bins = self.bins
        return state


class _Slot:
    """One input buffer of a frame program, and the tensor last copied
    into it with that tensor's version counter."""

    __slots__ = ("buf", "src", "version")

    def __init__(self, buf: torch.Tensor):
        self.buf, self.src, self.version = buf, None, None

    def load(self, x):
        """Copy ``x`` into the buffer on the current stream, unless it is
        the tensor of the last call and unchanged since (an inference
        tensor keeps no version counter: always copied).  Anything but a
        tensor is copied every time: a numpy array can change in place
        with no counter to show it."""
        if isinstance(x, torch.Tensor):
            version = None if x.is_inference() else x._version
            if x is self.src and version is not None and version == self.version:
                return
            with _upload_span(self.buf.device, x):
                self.buf.copy_(x)
            self.src, self.version = x, version
            return
        if isinstance(x, (bool, int, float)):
            self.buf.fill_(x)
        else:
            x = torch.tensor(np.asarray(x))
            with _upload_span(self.buf.device, x):
                self.buf.copy_(x)
        self.src = self.version = None


def _upload_span(device: torch.device, src: torch.Tensor):
    """``brt.sync.upload`` around a copy of ``src`` onto ``device`` that
    blocks the host until the stream reaches it: from pageable host memory
    onto a CUDA device.  ``profiling.OFF`` around any other copy."""
    if not profiling.recording() or device.type != "cuda" or src.is_cuda or src.is_pinned():
        return profiling.OFF
    return profiling.span("brt.sync.upload")


def _map_inputs(draws, fn) -> list:
    """The draws with every input replaced by ``fn(x, uniform)``, in one
    fixed order per key: per draw the mesh attributes (sorted), the
    indices, the instance tables (sorted), then the uniform leaves in
    flattening order, a texture's data and packed rows in its place.
    ``uniform`` is True where the frame converts the value as a uniform
    (Renderer._uniform_leaf) and False where it reads it as it is."""
    out = []
    for d in draws:
        mesh = d.mesh
        attrs = {k: fn(mesh.attributes[k], False) for k in sorted(mesh.attributes)}
        indices = None if mesh.indices is None else fn(mesh.indices, False)
        inst = {k: fn(d.instances[k], True) for k in sorted(d.instances)} if d.instances else None
        leaves, treedef = _flatten(d.uniforms)
        leaves = [Texture(fn(x.data, False), fn(x.packed, False), x.meta) if isinstance(x, Texture) else fn(x, True)
                  for x in leaves]
        out.append(_DrawCmd(d.pipeline, Mesh(attributes=attrs, indices=indices), _unflatten(treedef, leaves), inst))
    return out


class _FrameProgram(_Program):
    """``end_frame``'s program for one key, the JAX package's jitted frame.

    Every input of the frame lies in a buffer the program owns: the mesh
    attributes and indices, the instance tables, the uniform leaves, each
    texture's data and packed rows, and the clear colour.  A call copies
    the caller's values into them (``_Slot.load``), runs the frame and
    returns its result tuple.  A captured frame's results are clones: the
    graph's own outputs are overwritten by the next replay."""

    def __init__(self, r: "Renderer", draws, clear_depth: float, shard: Optional[Shard]):
        self.slots = []

        def make(x, uniform):
            t = r._uniform_leaf(x) if uniform else x
            self.slots.append(_Slot(torch.empty(t.shape, dtype=t.dtype, device=r.device)))
            return self.slots[-1].buf

        bound = _map_inputs(draws, make)
        self.last_clear = None
        super().__init__(r, bound, torch.empty((4,), dtype=torch.float32, device=r.device), clear_depth, shard)

    def __call__(self, draws, clear_color):
        with profiling.span("brt.frame.load"):
            slots = iter(self.slots)
            _map_inputs(draws, lambda x, _: next(slots).load(x))
            if clear_color != self.last_clear:
                clear = torch.tensor(clear_color, dtype=torch.float32)
                with _upload_span(self.clear[0].device, clear):
                    self.clear[0].copy_(clear)
                self.last_clear = clear_color
        out = self.frame()
        if self.capture is not None:
            with profiling.span("brt.frame.clone"):
                out = tuple(None if x is None else x.clone() for x in out)
        return out


class _SequenceProgram(_Program):
    """One cached sequence: the draw list over input buffers of its own,
    and on CUDA the captured segments of its frame.

    Per call, a generated mesh's generator() fills its attribute buffers
    once; per frame, each per-frame uniform leaf is copied into its buffer
    from the stacked (N, ...) tensor, the segments run (replayed on CUDA),
    and the checksum, the overflow and, if asked, the colour are written
    out.  Mesh attributes, instance tables, static uniforms and textures
    are taken as they are: the key carries their ids, and the program
    keeps the caller's objects alive so the ids stay unique."""

    def __init__(self, r: "Renderer", draws, specs, keep, shard: Optional[Shard] = None):
        self.keep = keep  # the caller's objects whose ids are in the key
        self.inputs = []  # one buffer per per-frame uniform leaf, in flattening order
        self.generated = []  # (attribute buffers, generator) per generated mesh
        bound = []
        for d, (leaves, treedef, static) in zip(draws, specs):
            mesh = d.mesh
            if mesh.generator is not None:
                bufs = {k: torch.empty_like(v) for k, v in mesh.attributes.items()}
                self.generated.append((bufs, mesh.generator))
                mesh = Mesh(attributes=bufs, indices=None, generator=mesh.generator)
            frame_leaves = []
            for x in leaves:
                if isinstance(x, Texture):
                    frame_leaves.append(x.to(r.device))
                else:
                    self.inputs.append(torch.empty(x.shape[1:], dtype=x.dtype, device=r.device))
                    frame_leaves.append(self.inputs[-1])
            u = _unflatten(treedef, frame_leaves)
            if isinstance(u, dict):
                u = {**r._uniforms(static), **u}
            inst = r._uniforms(d.instances) if d.instances else None
            bound.append(_DrawCmd(d.pipeline, mesh, u, inst))
        super().__init__(r, bound, *r._frame_clear, shard)

    def run(self, stacks, n: int, return_frames: bool):
        """N frames: (checksums (N,), colours (N, 4, H, W) or None, overflowed
        (), pair_budget_use ()), H and W the shard's extent when there is
        one.  While a profiler records, ``Renderer._last_bins`` ends as the
        frames' binning work summed on the device."""
        dev = self.r.device
        for bufs, gen in self.generated:
            for k, v in gen().items():
                bufs[k].copy_(v)
        cfg = self.r.config
        w, h = (cfg.width, cfg.height) if self.shard is None else self.shard.extent
        sums = torch.empty((n,), dtype=torch.float32, device=dev)
        frames = torch.empty((n, 4, h, w), dtype=torch.float32, device=dev) if return_frames else None
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        use = torch.zeros((), dtype=torch.float64, device=dev)
        pairs = torch.zeros((), dtype=torch.int64, device=dev) if profiling.recording() else None
        triangles = 0
        for i in range(n):
            with profiling.span("brt.sequence.frame"):
                for buf, stack in zip(self.inputs, stacks):
                    buf.copy_(stack[i])
                color, _depth_q, _tri_id, _stencil, of, frame_use = self.frame()
                sums[i] = color.sum()
                overflowed |= of
                torch.maximum(use, frame_use, out=use)
                if pairs is not None:
                    for p in self.bins.pairs:
                        pairs += p
                    triangles += self.bins.triangles
                if frames is not None:
                    frames[i].copy_(color)
        if pairs is not None:
            self.r._last_bins = BinCount((pairs,), triangles)
        return sums, frames, overflowed, use


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
        self._programs: dict = {}  # frame programs by key
        self._sequences: dict = {}  # sequence programs by key
        self.last_sequence_overflowed = None
        self.last_sequence_pair_budget_use = None
        self._last_bins: Optional[BinCount] = None  # the last frame's BinCount; a sequence's sum while profiled
        self.frame_count = 0

    # -- resources ---------------------------------------------------------

    def upload_mesh(self, positions, indices=None, **attrs) -> Mesh:
        return upload_mesh(positions, indices=indices, device=self.device, **attrs)

    def generated_mesh(self, generator) -> Mesh:
        """Mesh defined by a generator of torch ops (scene.generated_mesh):
        a sequence regenerates it once per call into buffers of its own,
        so its captured program holds no attribute tensors."""
        return generated_mesh(generator, device=self.device)

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
        kernel variants (raster_sublane, raster_batch), compaction and the
        instance cull are on for "pallas", off for "xla", and on off the
        CPU for "auto"."""
        backend = self.config.raster_backend
        if backend == "pallas":
            return True
        if backend == "xla":
            return False
        return self.device.type != "cpu"

    def _signal_fallback(self, pipe: Pipeline, knob: str, why: str):
        """A requested fast path is ineligible for this draw: warn (raise
        DrawError in debug mode) and run the draw without it (the
        sequential raster, its MSAA form under coverage MSAA; no cull)."""
        msg = (
            f"{knob} requested (shader {pipe.shader!r}) but the draw is "
            f"ineligible: {why}; falling back to the sequential raster kernel"
        )
        if self.config.debug:
            raise DrawError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)

    def close_frame(self):
        """Close the open frame without rendering it: (its recorded draws,
        clear colour, clear depth), the frame function's arguments."""
        if not self._in_frame:
            raise FrameError("end_frame without begin_frame")
        self._in_frame = False
        draws, self._draws = self._draws, []
        return (draws, *self._frame_clear)

    def end_frame(self) -> FrameResult:
        called_ns = time.time_ns() if profiling.recording() else None
        color, depth_q, tri_id, stencil, overflowed, use = self._frame(*self.close_frame())
        if called_ns is not None:
            profiling.keep_budget_use(called_ns, use)
            profiling.keep_bin_pairs(called_ns, *self._last_bins)
        if self.config.debug:
            with profiling.span("brt.sync.debug"):
                bad_pairs = bool(overflowed)
                finite = bool(torch.isfinite(color).all())
            if bad_pairs:
                raise AllocationError(
                    "raster pair buffer overflow: a draw's (tile, triangle) pair "
                    "count exceeded its raster_pairs_factor budget, so trailing "
                    "triangles were dropped; raise Pipeline.raster_pairs_factor"
                )
            if not finite:
                raise FrameError("non-finite values in rendered color buffer")
        self.frame_count += 1
        return FrameResult(
            color_planar=color,
            depth_q=depth_q,
            tri_id=tri_id,
            stencil=stencil,
            overflowed=overflowed,
            pair_budget_use=use,
            srgb=self.config.framebuffer_srgb,
        )

    def render_frame(self, pipeline, mesh, uniforms=None, instances=None, **clear) -> FrameResult:
        """Convenience: one-draw frame."""
        with profiling.span("brt.render_frame"):
            self.begin_frame(**clear)
            self.draw(pipeline, mesh, uniforms, instances)
            return self.end_frame()

    # -- the frame -----------------------------------------------------------

    def _frame(self, draws, clear_color, clear_depth: float, shard: Optional[Shard] = None):
        """The frame through the program cached for its key (the JAX
        package's _program_cache): made on the key's first call, which on
        CUDA also captures it.  The result tuple is the caller's own."""
        with profiling.span("brt.frame.key"):
            key = (self._cache_key(draws), clear_depth, shard)
            program = self._programs.get(key)
        if program is None:
            program = _FrameProgram(self, draws, clear_depth, shard)
        out = program(draws, clear_color)
        self._programs[key] = program
        return out

    def _uniform_leaf(self, x):
        """A uniform on the device, floats as float32.  A Python scalar is
        made there by a fill kernel; an array is uploaded (the eager
        frame's host-to-device copy: a sequence makes it once per call, a
        frame program once, to size its buffer)."""
        if isinstance(x, (bool, int, float)):
            t = torch.full((), x, device=self.device)  # the dtype torch.tensor(x) would take
        else:
            x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
            with _upload_span(self.device, x):
                t = x.to(self.device)
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

    def _extent(self):
        """(coverage_msaa, scale, rw, rh): the raster extent of a frame."""
        cfg = self.config
        coverage_msaa = cfg.msaa == 4 and not cfg.msaa_supersample
        scale = 2 if (cfg.msaa == 4 and cfg.msaa_supersample) else 1
        return coverage_msaa, scale, cfg.width * scale, cfg.height * scale

    def _window(self, shard: Optional[Shard]):
        """(x0, y0, w, h): the part of the raster extent a frame renders, in
        raster pixels: all of it, or the shard's window."""
        _, scale, rw, rh = self._extent()
        if shard is None:
            return 0, 0, rw, rh
        return (shard.origin[0] * scale, shard.origin[1] * scale, shard.extent[0] * scale, shard.extent[1] * scale)

    def _run_frame(self, draws, clear_color, clear_depth: float, shard: Optional[Shard] = None):
        """The whole frame eagerly, on the caller's inputs: the result tuple
        (color, depth_q, tri_id, stencil, overflowed, pair_budget_use), over
        the shard's window if given.  ``clear_color`` is a 4-tuple, or a
        program's (4,) buffer."""
        state = self._frame_begin(draws, clear_color, clear_depth, shard)
        while isinstance(state, _Pending):
            state = self._frame_resume(state, self._tile_budget(state))
        return state

    def _frame_begin(self, draws, clear_color, clear_depth: float, shard: Optional[Shard] = None):
        """Pass 1, then pass 2 up to the first compacted draw's tile count
        (a _Pending) or to the end (the result tuple)."""
        fv = self._visibility(draws, clear_depth, shard)
        if not isinstance(clear_color, torch.Tensor):  # a program's clear colour is a buffer
            clear_color = fp.consts(clear_color, self.device)
        return self._shade_from(fv, 0, clear_color.reshape(4))

    def _frame_resume(self, pending: _Pending, budget: int):
        """Pass 2 from a pending compacted draw, shaded on ``budget`` tiles
        (0: full-screen), up to the next compacted draw's count or the end."""
        return self._shade_from(pending.vis, pending.draw, pending.color, pending.order, budget)

    def _tile_budget(self, pending: _Pending) -> int:
        """The smallest budget of the draw's ladder that holds its covered
        tiles, or 0 (full-screen) past the largest: every budget that holds
        the count gives the same pixels, and the JAX package picks the
        smallest.  Reading the count is a compacted draw's one host
        synchronisation."""
        _, _, w, h = self._window(pending.vis.shard)
        with profiling.span("brt.sync.tile_count"):
            count = int(pending.count)
        fits = [b for b in _tile_budgets(pending.vis.draws[pending.draw].pipeline.shade_compact, h, w) if count <= b]
        return fits[0] if fits else 0

    def _visibility(self, draws, clear_depth: float, shard: Optional[Shard] = None) -> _Visibility:
        """Pass 1: every draw rasterized into the shared visibility buffer.

        With a ``shard`` the draws rasterize over its window (JAX
        renderer.py:519-531, 634-666, 697-712, 806-812): setup stays in
        global viewport coordinates and the records are anchored at global
        tile origins; each tile dimension is cut to its gcd with the window,
        so the window's tiles lie on the frame's tile grid; a scissor is
        applied after the raster, in global pixels; on a geometry axis each
        draw rasterizes its slice of the triangle stream, with global ids,
        and the slices' winners are merged before the draw's snapshot."""
        cfg = self.config
        coverage_msaa, scale, rw, rh = self._extent()
        x0, y0, ew, eh = self._window(shard)
        geometry = None if shard is None else shard.geometry
        clear_q = int(round(clear_depth * fp.DEPTH_ONE_Q))
        dev = self.device
        vis = None
        per_draw = []
        offset = 0
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        use = None  # the pair budget's use, folded over draws
        pairs, binned = [], 0  # the binner's work, per draw
        use_pallas = self._use_pallas()
        if geometry is not None and not use_pallas:
            raise FeatureNotPresentError(
                "geometry-axis parallelism requires the Pallas backend (plane-interpolated varyings make "
                "the depth-composited winner shadeable on every shard)"
            )
        # Off the Pallas backend a draw asking for a kernel variant takes
        # the sequential raster without a signal, as in the JAX package;
        # the variants equal it bit for bit.
        for d in draws:
            pipe = d.pipeline
            shd = shader_lib.get(pipe.shader)
            uniforms = self._uniforms(d.uniforms)
            tile_w, tile_h = pipe.raster_tile if shard is None else shard_tile(pipe.raster_tile, (ew, eh))
            sublane = batch = False
            if use_pallas and pipe.raster_sublane:
                why = _reduction_ineligible_reason(pipe, coverage_msaa, True, tile_w)
                sublane = why is None
                if not sublane:
                    self._signal_fallback(pipe, "raster_sublane", why)
            if use_pallas and pipe.raster_batch and not pipe.raster_sublane:
                why = _reduction_ineligible_reason(pipe, coverage_msaa, False, tile_w)
                batch = why is None
                if not batch:
                    self._signal_fallback(pipe, "raster_batch", why)
            tri_ids = None
            num_logical = None
            with profiling.span("brt.draw.instances") if d.instances else profiling.OFF:
                instances = self._uniforms(d.instances) if d.instances else None
                # The instance cull (JAX renderer.py:586-625): the visible
                # instances, in order, in ceil(instance_cull * I) slots; each
                # surviving triangle keeps its original id, and the draw's id
                # range stays the logical I * tpi, so a later draw's ids never
                # collide with this one's.
                if pipe.instance_cull is not None and instances:
                    why = None
                    if not use_pallas:
                        why = "XLA raster backend (shading gathers by local id)"
                    elif pipe.near_clip:
                        why = "near_clip enabled (the clipper re-orders the stream)"
                    if why is not None:
                        self._signal_fallback(pipe, "instance_cull", why)
                    else:
                        num_inst = next(iter(instances.values())).shape[0]
                        budget = max(math.ceil(num_inst * pipe.instance_cull), 1)
                        visible = instance_visibility(shd, d.mesh, instances, uniforms, rw, rh)
                        instances, orig_idx, cull_of = compact_instances(instances, visible, budget)
                        overflowed = overflowed | cull_of
                        tpi = d.mesh.num_triangles
                        num_logical = num_inst * tpi
                        local = torch.arange(tpi, dtype=torch.int32, device=dev)
                        tri_ids = (orig_idx[:, None] * tpi + local[None, :]).reshape(-1)
                attrs, tri_idx = expand_instances(d.mesh, instances)
            clip, varyings = shd.vertex(attrs, uniforms)
            clip_tri, var_tri = gather_triangles(clip, varyings, tri_idx)
            if pipe.near_clip:
                clip_tri, var_tri = clip_near(clip_tri, var_tri)
            num_t = clip_tri.shape[0]
            num_ids = num_t if num_logical is None else num_logical
            id_offset = offset if tri_ids is None else tri_ids + offset
            if geometry is not None:
                # This rank's slice of the stream, zero-padded to ng equal
                # slices (zero rows are degenerate: setup drops them), with
                # the ids the whole stream gives it.
                ng, g_index, _ = geometry
                per = -(-num_t // ng)
                lo, pad = g_index * per, per * ng - num_t

                def cut(x):
                    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))[lo : lo + per]

                clip_tri = cut(clip_tri)
                var_tri = {k: cut(v) for k, v in var_tri.items()}
                id_offset = offset + lo if tri_ids is None else cut(tri_ids) + offset
                if num_logical is None:
                    num_ids = per * ng
                num_t = per
            scissor = self._scaled_scissor(pipe, scale)
            # A shard rasterizes unscissored and applies the scissor after.
            window_scissor = scissor if shard is not None else None
            prev = vis
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
            out = rasterize_vis(
                ts,
                ew,
                eh,
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
                id_offset=id_offset,
                channels=channels,
                perspective=pipe.perspective_correct,
                scissor=scissor if window_scissor is None else None,
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
                origin=(x0, y0),
                return_pairs=True,
            )
            if channels is None:
                vis, of, draw_use, draw_pairs = out
                interp = invw = None
            else:
                vis, interp, invw, of, draw_use, draw_pairs = out
            overflowed = overflowed | of
            use = draw_use if use is None else torch.maximum(use, draw_use)
            pairs.append(draw_pairs)
            binned += num_t
            if vis.stencil is None and prev_stencil is not None:
                vis = vis._replace(stencil=prev_stencil)  # a stencil-off draw leaves the attachment
            if window_scissor is not None:
                vis = _scissor_window(vis, prev, window_scissor, x0, y0, clear_q, cfg.clear_stencil)
            if geometry is not None:
                vis, interp, invw = geometry[2](vis, interp, invw, pipe.depth)
            per_draw.append((var_tri, offset, num_ids, interp, invw, vis, uniforms))
            offset += num_ids
        if use is None:
            use = torch.zeros((), dtype=torch.float64, device=dev)
        self._last_bins = BinCount(tuple(pairs), binned)
        return _Visibility(draws, per_draw, vis, overflowed, use, clear_depth, shard)

    def _shade_from(self, fv: _Visibility, start: int, color, order=None, budget: int = 0):
        """Pass 2 from draw ``start``: gather-free shading and the blend
        composite, per draw, against each draw's own visibility snapshot
        (Vulkan's sequential semantics for multi-draw frames), then the
        resolve.  Under coverage MSAA every plane has a leading sample
        axis, which the fragment shader takes as a batch axis (one image
        per sample layer, as the JAX package's vmap over samples), and the
        colour is (4, 4, H, W) until the resolve.  ``color`` is the (4,)
        clear colour until a draw writes it.  A draw whose shader has a
        fused body (``_fused_body``) shades, composites and, as the frame's
        last draw, resolves in that one call.  A compacted draw stops
        the pass with a _Pending until the host picks its budget; resumed
        with ``order`` and ``budget`` (0: full-screen), draw ``start``
        shades with them."""
        coverage_msaa, scale, _, _ = self._extent()
        _, _, ew, eh = self._window(fv.shard)
        planes = ((4,) if coverage_msaa else ()) + (4, eh, ew)
        compact_on = self._use_pallas() and compact.eligible(eh, ew)
        resolved = False
        for i in range(start, len(fv.draws)):
            pipe = fv.draws[i].pipeline
            var_tri, off, ntri, interp, invw, vis_i, uniforms = fv.per_draw[i]
            shd = shader_lib.get(pipe.shader)
            invw = invw if interp is not None and pipe.perspective_correct else None
            compacted = compact_on and pipe.shade_compact is not None
            fused = _fused_body(shd, pipe, interp, compacted)
            if fused is not None:
                resolved = coverage_msaa and i == len(fv.draws) - 1
                color = fused(interp, invw, vis_i.tri_id, off, off + ntri, color, uniforms, resolved)
                profiling.ROUTES_TAKEN["fused_shading"] += 1
                continue
            if color.dim() == 1:
                color = color.reshape(4, 1, 1).expand(planes)
            mask = (vis_i.tri_id >= off) & (vis_i.tri_id < off + ntri)
            local = torch.where(mask, vis_i.tri_id - off, -1)
            if compacted:
                if i != start or order is None:
                    # Under MSAA a tile covered in any sample layer is shaded.
                    tiles, count = compact.covered_tile_order(mask.any(dim=0) if coverage_msaa else mask, eh, ew)
                    return _Pending(fv, i, color, tiles, count)
                if budget:
                    color = _shade_tiles(var_tri, interp, invw, vis_i, local, shd.fragment, uniforms, pipe.blend,
                                         color, order, budget)
                    continue
            bary = torch.stack([vis_i.b0, vis_i.b1, vis_i.b2])
            frag = _fragment_inputs(var_tri, interp, invw, vis_i.depth, bary, local)
            rgba = shd.fragment(frag, uniforms).movedim(-1, -3)  # ([4,] 4, rh, rw)
            color = torch.where(mask[:, None] if coverage_msaa else mask, _blend(rgba, color, pipe.blend), color)
        if color.dim() == 1:  # no draw wrote it: a frame without draws
            color = color.reshape(4, 1, 1).expand(planes)
        if coverage_msaa and not resolved:
            color = color.mean(dim=0)  # coverage resolve: box-average the samples
        if scale == 2:  # supersample resolve: 2x2 box
            h, w = eh // 2, ew // 2
            color = color.reshape(4, h, 2, w, 2).sum(dim=(2, 4)) * 0.25
        if fv.vis is None:  # a frame without draws is the cleared frame
            clear_q = int(round(fv.clear_depth * fp.DEPTH_ONE_Q))
            fbs = (4, eh, ew) if coverage_msaa else (eh, ew)
            depth_q = torch.full(fbs, clear_q, dtype=torch.int32, device=self.device)
            return color.contiguous(), depth_q, torch.full_like(depth_q, -1), None, fv.overflowed, fv.pair_budget_use
        return (color.contiguous(), fv.vis.depth_q, fv.vis.tri_id, fv.vis.stencil, fv.overflowed,
                fv.pair_budget_use)

    # -- frame sequences -------------------------------------------------------

    def render_sequence(
        self,
        pipeline: Pipeline,
        mesh: Mesh,
        uniforms_seq=None,
        instances=None,
        return_frames: bool = False,
        num_frames: int | None = None,
        static_uniforms=None,
        uniforms_fn=None,
        t0: float = 0.0,
        dt: float = 1.0 / 60.0,
    ):
        """Render N frames of one draw (see render_sequence_multi).

        Args:
          uniforms_seq: a tree whose leaves are stacked per-frame arrays
            with leading dimension N (e.g. {"model": (N, 4, 4), ...}).
          uniforms_fn: instead of ``uniforms_seq``, ``fn(t) -> uniforms``
            evaluated on the host at ``t = f32(t0) + f32(dt) * f32(i)`` for
            frame i (the float32 arithmetic of the JAX package's in-scan
            evaluation); all N frames are stacked and uploaded once.  Needs
            ``num_frames``.  t0 and dt change no cache key.
          static_uniforms: uniforms shared by every frame (textures).
          return_frames: also return all colours (N, 4, H, W), planar.
        Returns:
          checksums (N,) f32, sum(color) per frame, or (checksums, colours).
        """
        return self.render_sequence_multi(
            [
                {
                    "pipeline": pipeline,
                    "mesh": mesh,
                    "uniforms_seq": uniforms_seq,
                    "uniforms_fn": uniforms_fn,
                    "instances": instances,
                    "static_uniforms": static_uniforms,
                }
            ],
            num_frames=num_frames,
            return_frames=return_frames,
            t0=t0,
            dt=dt,
        )

    def render_sequence_multi(
        self,
        seq_draws,
        *,
        num_frames: int | None = None,
        return_frames: bool = False,
        t0: float = 0.0,
        dt: float = 1.0 / 60.0,
    ):
        """N frames of a recorded draw list: on CUDA a captured program
        replayed once per frame, on the CPU the eager frame loop.

        Args:
          seq_draws: list of dicts with keys pipeline, mesh, uniforms_seq
            (a tree of (N, ...) stacked per-frame arrays) or uniforms_fn
            (see render_sequence), instances (optional), static_uniforms
            (optional; shared across frames, e.g. textures).
        Returns:
          checksums (N,) f32, or (checksums, colours (N, 4, H, W)) if
          return_frames.  ``last_sequence_overflowed`` holds the () bool
          overflow of all N frames, and ``last_sequence_pair_budget_use``
          the () float64 max of their ``pair_budget_use``; in debug mode
          an overflow raises AllocationError.
        """
        called_ns = time.time_ns() if profiling.recording() else None
        sums, frames, overflowed, use = self._sequence(seq_draws, num_frames, return_frames, t0, dt)
        self.last_sequence_overflowed = overflowed
        self.last_sequence_pair_budget_use = use
        if called_ns is not None:
            profiling.keep_budget_use(called_ns, use)
            profiling.keep_bin_pairs(called_ns, *self._last_bins)
        if self.config.debug:
            with profiling.span("brt.sync.debug"):
                bad_pairs = bool(overflowed)
            if bad_pairs:
                raise AllocationError(
                    "raster pair buffer overflow during render_sequence; raise Pipeline.raster_pairs_factor"
                )
        return (sums, frames) if return_frames else sums

    def _sequence(self, seq_draws, num_frames, return_frames: bool, t0: float, dt: float,
                  shard: Optional[Shard] = None):
        """render_sequence_multi's frames, over the shard's window if given:
        (checksums (N,), colours (N, 4, H, W) or None, overflowed (),
        pair_budget_use ())."""
        with profiling.span("brt.sequence"):
            self.begin_frame()
            specs = []  # (per-frame leaves, treedef, static uniforms) per draw
            n = None
            try:
                for sd in seq_draws:
                    fn = sd.get("uniforms_fn")
                    static = sd.get("static_uniforms") or {}
                    if fn is not None:
                        if sd.get("uniforms_seq"):
                            raise FrameError("pass either uniforms_seq or uniforms_fn, not both")
                        if num_frames is None:
                            raise FrameError("render_sequence needs num_frames when uniforms are empty")
                        times = [np.float32(t0) + np.float32(dt) * np.float32(i) for i in range(num_frames)]
                        with profiling.span("brt.caller.uniforms_fn"):
                            trees = [fn(t) for t in times]
                        leaves, treedef = self._stack_frames(trees)
                    else:
                        if sd.get("uniforms_seq") is None:
                            raise FrameError("each sequence draw needs uniforms_seq or uniforms_fn")
                        leaves, treedef = _flatten(sd["uniforms_seq"])
                        leaves = [x if isinstance(x, Texture) else self._uniform_leaf(x) for x in leaves]
                    for x in leaves:
                        if not isinstance(x, Texture):
                            if n is not None and x.shape[0] != n:
                                raise FrameError(f"per-frame uniforms of {x.shape[0]} and {n} frames")
                            n = x.shape[0]
                    u0 = _unflatten(treedef, [x if isinstance(x, Texture) else x[0] for x in leaves])
                    if isinstance(u0, dict):
                        u0 = {**static, **u0}
                    self.draw(sd["pipeline"], sd["mesh"], u0, sd.get("instances"))
                    specs.append((leaves, treedef, static))
            finally:
                draws, self._draws, self._in_frame = self._draws, [], False
            n = num_frames if n is None else n
            if n is None:
                raise FrameError("render_sequence needs num_frames when uniforms are empty")

            # The caller's objects the program captures as they are: ids in the key.
            keep = []
            for d, (leaves, _, static) in zip(draws, specs):
                if d.mesh.generator is None:
                    keep += [d.mesh.attributes[k] for k in sorted(d.mesh.attributes)]
                    keep += [] if d.mesh.indices is None else [d.mesh.indices]
                keep += [d.instances[k] for k in sorted(d.instances or {})]
                keep += _flatten(static)[0] + [x for x in leaves if isinstance(x, Texture)]
            key = (
                "seq",
                self._cache_key(draws),
                return_frames,
                self._frame_clear,
                tuple(id(x) for x in keep),
                tuple(None if d.mesh.generator is None else id(d.mesh.generator) for d in draws),
                shard,
            )
            program = self._sequences.get(key)
            if program is None:
                program = _SequenceProgram(self, draws, specs, keep + [d.mesh.generator for d in draws], shard)
            stacks = [x for leaves, _, _ in specs for x in leaves if not isinstance(x, Texture)]
            out = program.run(stacks, n, return_frames)
            self._sequences[key] = program
            return out

    def _stack_frames(self, trees):
        """uniforms_fn's N per-frame trees -> (leaves, treedef): each leaf
        stacked (N, ...) on the host and uploaded once; a Texture leaf must
        be one object in every frame, and stays as it is."""
        with profiling.span("brt.sequence.stack"):
            flat = [_flatten(t) for t in trees]
            treedef = flat[0][1]
            if any(d != treedef for _, d in flat):
                raise FrameError("uniforms_fn returned trees of different structure")
            leaves = []
            for col in zip(*(f[0] for f in flat)):
                if any(isinstance(x, Texture) for x in col):
                    if any(x is not col[0] for x in col):
                        raise FrameError("a texture from uniforms_fn must be the same object in every frame")
                    leaves.append(col[0])
                    continue
                host = [x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)) for x in col]
                leaves.append(self._uniform_leaf(torch.stack(host)))
            return leaves, treedef

    def _cache_key(self, draws):
        """The JAX package's program key (renderer.py:381-404): the
        configuration, and per draw its pipeline, the shapes and dtypes of
        its attributes, indices and instance tables, its uniform tree and
        the shapes of the uniform leaves (values for Python scalars); a
        texture leaf adds its packed rows' shape and its sampler state
        (``meta``), which the JAX package's key holds in the uniform tree."""

        def sig(x):
            if isinstance(x, Texture):  # the JAX Texture's treedef holds its meta
                return sig(x.data), sig(x.packed), x.meta
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                return (tuple(x.shape), str(x.dtype))
            return repr(x)

        parts = [self.config]
        for d in draws:
            u_leaves, u_tree = _flatten(d.uniforms)
            parts.append(
                (
                    d.pipeline,
                    tuple(sorted((k, sig(v)) for k, v in d.mesh.attributes.items())),
                    None if d.mesh.indices is None else sig(d.mesh.indices),
                    None if not d.instances else tuple(sorted((k, sig(v)) for k, v in d.instances.items())),
                    u_tree,
                    tuple(sig(x) for x in u_leaves),
                )
            )
        return tuple(parts)

    # -- introspection -----------------------------------------------------

    @property
    def num_cached_programs(self) -> int:
        """The frame and sequence programs this renderer holds, one per
        key, as the JAX package's _program_cache counts its compiled
        frame and sequence programs (on the CPU the programs run
        eagerly, but they are cached all the same)."""
        return len(self._programs) + len(self._sequences)
