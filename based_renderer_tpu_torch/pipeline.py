"""Pipeline state: the render-state bundle of a draw.

A field-for-field copy of ``based_renderer_tpu/pipeline.py``, defaults and
validation included, so one knob set drives both packages (a test holds
the two equal).  The reference bakes render state into an immutable
``vk::Pipeline`` (reference src/main.cpp:1626-1874); this frozen dataclass
is its analog.  The field comments below describe the JAX package's
kernels, and the timings in them were taken on a TPU v5e: they say
nothing about this port.  In the port, the knobs outside the main path
raise FeatureNotPresentError at draw time (renderer.py), and
``raster_skip_losers``/``raster_unroll`` only scheduled TPU work, so they
are accepted and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_COMPARE_OPS = (
    "never",
    "less",
    "equal",
    "less_equal",
    "greater",
    "not_equal",
    "greater_equal",
    "always",
)
_CULL_MODES = ("none", "back", "front")
_STENCIL_OPS = (
    "keep",
    "zero",
    "replace",
    "increment_clamp",
    "decrement_clamp",
    "invert",
    "increment_wrap",
    "decrement_wrap",
)
_FRONT_FACES = ("ccw", "cw")
# The full VkBlendFactor enum as the reference's attachment state declares
# it (reference src/main.cpp:1806-1827), minus the dual-source
# (src1) family — the reference requests no dual-source-blend feature.
_BLEND_FACTORS = (
    "zero",
    "one",
    "src_color",
    "one_minus_src_color",
    "dst_color",
    "one_minus_dst_color",
    "src_alpha",
    "one_minus_src_alpha",
    "dst_alpha",
    "one_minus_dst_alpha",
    "constant_color",
    "one_minus_constant_color",
    "constant_alpha",
    "one_minus_constant_alpha",
    "src_alpha_saturate",
)
# VkBlendOp (the non-extension ops).  min/max ignore the blend factors,
# exactly as the Vulkan spec defines them.
_BLEND_OPS = ("add", "subtract", "reverse_subtract", "min", "max")


@dataclass(frozen=True)
class DepthState:
    """Depth test/write state.

    The reference allocates a D24S8 depth buffer but ships with the depth
    test disabled (commented-out DepthStencilState with compare eLess,
    main.cpp:1792-1804); both configurations are expressible here.

    Depth bias and depth clamp mirror the reference's declared-but-disabled
    rasterization-state fields (main.cpp:1777-1789, depthBiasEnable /
    depthClampEnable).  The bias is applied in the integer quantized-depth
    spec as a per-triangle offset on the vertex depths (ops/fixedpoint.py
    "depth bias" note): o = rint(bias_constant) + rint(bias_slope * m)
    in 2^-24 depth units, where m = max(|dz/dx|, |dz/dy|) per pixel —
    Vulkan's r is exactly one quantized LSB here.  ``bias_clamp`` bounds o
    (in [0,1] depth units; 0 disables the bound, as in Vulkan).
    ``clamp`` is the depthClampEnable analog: fragment depth is clamped to
    [0, 1] instead of being discarded (``clip`` is ignored while set).

    Note: this renderer's depth ``clip`` is a per-fragment test that runs
    *after* the bias (Vulkan clips z in clip space before bias), so a
    bias large enough to push fragments outside [0, 1] discards them —
    pair large biases with ``clamp=True`` for GL-style post-bias clamping.
    """

    test: bool = True
    write: bool = True
    compare: str = "less"
    clip: bool = True  # discard fragments with interpolated z outside [0,1]
    clamp: bool = False  # clamp z to [0,1] instead of discarding (overrides clip)
    bias_enable: bool = False
    bias_constant: float = 0.0  # in units of the minimum resolvable depth (2^-24)
    bias_slope: float = 0.0  # scales the triangle's max depth slope per pixel
    bias_clamp: float = 0.0  # bound on the total bias, depth units; 0 = none

    def __post_init__(self):
        if self.compare not in _COMPARE_OPS:
            raise ValueError(f"bad depth compare {self.compare!r}; one of {_COMPARE_OPS}")
        for v in (self.bias_constant, self.bias_slope, self.bias_clamp):
            if not isinstance(v, (int, float)):
                raise ValueError("depth bias parameters must be numbers")


@dataclass(frozen=True)
class StencilState:
    """Stencil test/write state (both faces share one description).

    The reference allocates a D24_UNORM_S8_UINT depth-stencil image
    (reference src/main.cpp:1472-1484) and its (commented-out)
    depth-stencil state carries stencil fields (main.cpp:1792-1804); this
    is the working TPU counterpart.  The stencil buffer holds 8-bit
    values (stored int32 on device); the test is
        compare(ref & compare_mask, stencil & compare_mask)
    and the update op is selected per fragment: ``fail_op`` when the
    stencil test fails, ``depth_fail_op`` when stencil passes but depth
    fails, ``pass_op`` when both pass — each masked by ``write_mask``.
    """

    enable: bool = False
    compare: str = "always"
    ref: int = 0
    compare_mask: int = 0xFF
    write_mask: int = 0xFF
    fail_op: str = "keep"
    depth_fail_op: str = "keep"
    pass_op: str = "keep"

    def __post_init__(self):
        if self.compare not in _COMPARE_OPS:
            raise ValueError(f"bad stencil compare {self.compare!r}; one of {_COMPARE_OPS}")
        for op in (self.fail_op, self.depth_fail_op, self.pass_op):
            if op not in _STENCIL_OPS:
                raise ValueError(f"bad stencil op {op!r}; one of {_STENCIL_OPS}")
        for v in (self.ref, self.compare_mask, self.write_mask):
            if not 0 <= v <= 0xFF:
                raise ValueError("stencil ref/masks must be 8-bit (0..255)")


@dataclass(frozen=True)
class BlendState:
    """Color blend attachment state — the full VkPipelineColorBlendAttachmentState
    the reference declares (blendEnable, src/dst color factors, colorBlendOp,
    src/dst alpha factors, alphaBlendOp, colorWriteMask,
    reference src/main.cpp:1806-1827) plus the blend-constants
    "dynamic state" as a static field (the reference sets none).

    Blending composites per-draw over the accumulated color buffer:
      rgb = color_op(src.rgb * src_factor, dst.rgb * dst_factor)
      a   = alpha_op(src.a * src_alpha_factor, dst.a * dst_alpha_factor)
    with min/max ignoring the factors (Vulkan semantics), and
    ``write_mask`` gating which channels are stored (it applies even with
    blending disabled, as in Vulkan).

    ``src_alpha_factor``/``dst_alpha_factor``/``alpha_op`` default to None,
    meaning "same as the color factor/op".

    Semantics note (deferred-visibility renderer): within a single draw
    only the per-pixel *visibility winner* is blended — overlapping
    translucent fragments of the same draw do not blend against each
    other, unlike a Vulkan forward pass.  Multi-layer transparency needs
    one draw per layer (each draw blends over the accumulated buffer,
    typically with depth_write=False and back-to-front draw order).
    """

    enable: bool = False
    src_factor: str = "one"
    dst_factor: str = "zero"
    color_op: str = "add"
    src_alpha_factor: str | None = None  # None = src_factor
    dst_alpha_factor: str | None = None  # None = dst_factor
    alpha_op: str | None = None  # None = color_op
    constants: tuple = (0.0, 0.0, 0.0, 0.0)  # blend constant color RGBA
    write_mask: str = "rgba"  # any subset of "rgba", order-insensitive

    def __post_init__(self):
        for f in (
            self.src_factor,
            self.dst_factor,
            self.src_alpha_factor,
            self.dst_alpha_factor,
        ):
            if f is not None and f not in _BLEND_FACTORS:
                raise ValueError(f"bad blend factor {f!r}; one of {_BLEND_FACTORS}")
        for op in (self.color_op, self.alpha_op):
            if op is not None and op not in _BLEND_OPS:
                raise ValueError(f"bad blend op {op!r}; one of {_BLEND_OPS}")
        if len(self.constants) != 4:
            raise ValueError("blend constants must be RGBA (4 floats)")
        if not all(isinstance(c, (int, float)) for c in self.constants):
            raise ValueError("blend constants must be numbers")
        seen = set()
        for ch in self.write_mask:
            if ch not in "rgba" or ch in seen:
                raise ValueError(
                    f"write_mask must be a subset of 'rgba' without repeats, got {self.write_mask!r}"
                )
            seen.add(ch)


@dataclass(frozen=True)
class Pipeline:
    """Immutable render-state bundle; hashable, used as a jit cache key."""

    shader: str = "unlit"
    depth: DepthState = field(default_factory=DepthState)
    stencil: StencilState = field(default_factory=StencilState)
    cull_mode: str = "none"  # main.cpp:1782 uses eNone
    # Winding that counts as front-facing, in conventional y-UP screen
    # orientation (the default mirrors main.cpp:1783's eCounterClockwise).
    # Gotcha, exactly as in Vulkan: with the framework's y-down NDC and
    # math3d.perspective (+z forward), meshes with right-handed outward
    # winding project *clockwise* — pair them with front_face="cw".
    front_face: str = "ccw"
    blend: BlendState = field(default_factory=BlendState)
    perspective_correct: bool = True
    # Near-plane (w) clipping of partially-behind triangles (ops/clip.py).
    # Always on in Vulkan; optional here because it doubles the triangle
    # buffer through setup/binning — scenes that guarantee in-front
    # geometry (e.g. benchmarks) may disable it.
    near_clip: bool = True
    # Static budget of the binned (tile, triangle) pair buffer, as a
    # multiple of the triangle count (floor 1024 pairs).  4x is safe for
    # mixed scenes; dense small-triangle meshes fit in ~1.5x, and
    # oversizing costs HBM and gather bandwidth in the binner.  On
    # overflow trailing pairs are dropped from the frame and the flag is
    # surfaced: FrameResult.overflowed (and Renderer.last_sequence_
    # overflowed for sequences); RendererConfig.debug mode raises
    # AllocationError instead.
    raster_pairs_factor: float = 4.0
    # Post-sort assembled-slot budget as a fraction of the draw's triangle
    # count, or None to keep every expansion slot (= raster_pairs_factor).
    # The pair sort compacts culled/offscreen triangles' slots to the tail
    # of the stream, so slicing the sorted stream to a static budget lets
    # the binner's template gather + record assembly (its two biggest
    # costs) run over ~live pairs instead of the full expansion stream —
    # on back-face-culled dense meshes roughly HALF the slots are dead.
    # Exceeding the budget sets the same overflow surface as
    # raster_pairs_factor (warn / AllocationError in debug).
    raster_slots_factor: float | None = None
    # Optional scissor rect (x0, y0, x1, y1), x1/y1 exclusive; None = full
    # framebuffer (the reference bakes a full-extent static scissor,
    # main.cpp:1764-1775).
    scissor: tuple | None = None
    # Raster tile (tile_w, tile_h) in pixels.  Cost per binned record is
    # ~proportional to tile area (the kernel evaluates whole tiles on the
    # VPU), so dense tiny-triangle meshes want short tiles (128, 8) while
    # big-triangle scenes amortize better on (128, 32).  Both dims must
    # divide 128 (the anchored-exactness proofs in ops/fixedpoint.py).
    raster_tile: tuple = (128, 32)
    # Two-pass rasterization: an int-only visibility pass records the
    # winning record per pixel, then a replay pass interpolates float
    # planes only for records that won pixels.  Wins on dense meshes with
    # many varyings (losers skip all float work); the single-pass kernel
    # is better for low-record scenes.
    raster_two_pass: bool = False
    # Skip interpolation/writeback for raster records that win no pixels.
    # Wins on high-overdraw dense meshes (each skipped record saves the
    # f32 plane math); costs one vector reduce per record, so leave off
    # for low-overlap scenes.
    raster_skip_losers: bool = False
    # Batched-reduction rasterization: evaluate this many records
    # independently per kernel iteration and merge them with an
    # order-aware tree (ops/raster_pallas.py _raster_kernel_batched).
    # Breaks the sequential per-record dependency — the big lever on
    # record-bound dense meshes.  Requires depth test+write with an
    # ordered compare (less/greater families) and no stencil; must divide
    # 128.  0 = sequential kernel.  Ignored (sequential fallback) when the
    # draw is ineligible.
    raster_batch: int = 0
    # Unroll factor of the sequential kernel's inner record loop (the
    # scalar loop machinery is part of the dense-mesh floor); must
    # divide 128.
    raster_unroll: int = 1
    # Sublane-parallel rasterization (ops/raster_pallas.py
    # _raster_kernel_sublane): records are processed 8-at-a-time on the
    # VPU sublane axis with vector coefficient loads (no scalar reads —
    # the sequential kernels' per-record floor), and winner attributes
    # are recovered by an exact one-hot matmul on the MXU.  ~6x the
    # sequential kernel's record throughput; THE kernel for dense
    # tiny-triangle meshes.  Same eligibility as raster_batch (depth
    # test+write, ordered compare, no stencil) plus tile_w == 128 and no
    # MSAA; silently falls back to the sequential kernel when the draw
    # is ineligible.
    raster_sublane: bool = False
    # Sublane-kernel record-group size: records processed simultaneously
    # on the sublane axis per inner-loop step.  Groups > 8 span several
    # native (8, 128) registers per op, amortizing per-group coefficient
    # loads and loop control over more records (a pure throughput knob —
    # coverage/depth stay bit-identical).  Multiple of 8, dividing 128.
    raster_group: int = 8
    # Sub-tile band binning: bin records at (tile_w x raster_bin_rows)
    # granularity (None = whole raster tile).  The sublane kernel then
    # evaluates each record over only its band's rows instead of the full
    # tile_h — on tiny-triangle meshes most records cover 1-2 rows, so
    # pass-1 row work drops ~tile_h/raster_bin_rows-fold at the cost of
    # more (band, tri) pairs in the binner (a triangle spanning a band
    # boundary bins once per band).  Band-bin tile ids are COLUMN-major
    # so one output tile's bands stay contiguous in the sorted record
    # stream (one DMA stream per tile).  Coverage/depth/tri_id stay
    # bit-identical: bands partition pixel rows, so each pixel still sees
    # exactly its own records in draw order.  Requires raster_sublane,
    # tile_w == 128; must divide raster_tile's height.  Budget factors
    # (raster_pairs_factor / raster_slots_factor) should be raised to
    # cover the extra band-crossing pairs.
    raster_bin_rows: int | None = None
    # Binner record assembly: "xla" materializes the post-sort transpose
    # and column assembly as XLA ops; "pallas" fuses them into one
    # streaming kernel (ops/binassem.py) — measured the biggest binner
    # cost on dense meshes.  Records are bit-identical in coverage/depth
    # spec terms; the f32 plane bases may differ by 1 ulp (the two
    # compilations may contract the re-anchor multiply-adds differently),
    # within the barycentric tolerance contract.
    raster_assemble: str = "xla"
    # Binner template-matrix layout: "xla" builds the row-major gather
    # matrix with stack(axis=-1) (one near-footprint lane-interleave pass
    # per column — ~12.7 ms at 1M tris on v5e); "pallas" builds it
    # field-major (contiguous row writes) and relayouts with a tiled
    # Pallas transpose (two HBM passes).  Pure data movement — gathered
    # records are bit-identical either way.
    raster_tmpl: str = "xla"
    # Covered-tile-compacted deferred shading (ops/compact.py): budget the
    # fragment pass (and its texture-tap gathers) to a fraction — or a
    # LADDER of fractions — of the framebuffer's (8, 128) tiles.  Tiles
    # this draw covers are gathered into a dense stream, shaded, and
    # scattered back, so per-pixel shading cost scales with coverage
    # instead of resolution — the full-screen texture tap alone is
    # ~10 ms at 2M pixels.  The compacted stream is budget-sized (static
    # shapes), so with a tuple a lax.cond chain picks the tightest tier
    # the frame's covered-tile count fits; past the largest tier the
    # full-screen pass runs.  None = always full-screen.  Pallas-backend
    # draws only; ignored when the framebuffer doesn't tile by (8, 128).
    # Under coverage MSAA the sample layers fold into the tile-row
    # channel axis (still one gather/scatter per tier) and a tile is
    # selected when ANY sample layer covers it; compacted MSAA color can
    # differ from the full-screen pass by 1 ulp (XLA contracts the
    # fragment multiply-adds differently in the two branches — same
    # class as cross-backend color tolerance; coverage/depth are exact).
    shade_compact: float | tuple | None = None
    # Per-instance frustum culling (ops/cull.py): instanced draws run the
    # vertex stage on each instance's 8 bounding-box corners, cull
    # instances whose clip-space hull is conservatively outside the view
    # volume, and compact survivors into ceil(instance_cull * I) slots
    # BEFORE expansion — the vertex transform, setup, and binner sort all
    # shrink to the budget.  Original triangle ids ride the raster
    # records, so output coverage/depth/tri_id are bit-identical to the
    # unculled draw; if visible instances exceed the budget the overflow
    # is surfaced like a binner pair-budget breach.  Requires the vertex
    # stage to be affine in "position" (true for all built-in shaders)
    # and near_clip=False (the clipper re-orders the triangle stream).
    # None = no culling.
    instance_cull: float | None = None
    # Note: the sample count (MSAA) is a render-target property and lives in
    # RendererConfig, mirroring how dynamic rendering ties sample count to
    # the attachments rather than only the pipeline.

    def __post_init__(self):
        if self.cull_mode not in _CULL_MODES:
            raise ValueError(f"bad cull_mode {self.cull_mode!r}; one of {_CULL_MODES}")
        if self.front_face not in _FRONT_FACES:
            raise ValueError(f"bad front_face {self.front_face!r}; one of {_FRONT_FACES}")
        tw, th = self.raster_tile
        for d in (tw, th):
            if d <= 0 or 128 % d:
                raise ValueError(f"raster_tile dims must divide 128, got {self.raster_tile}")
        if self.raster_batch and (self.raster_batch < 0 or 128 % self.raster_batch):
            raise ValueError(f"raster_batch must divide 128, got {self.raster_batch}")
        if self.raster_unroll < 1 or 128 % self.raster_unroll:
            raise ValueError(f"raster_unroll must divide 128, got {self.raster_unroll}")
        if self.raster_slots_factor is not None and self.raster_slots_factor <= 0:
            raise ValueError(
                f"raster_slots_factor must be positive, got {self.raster_slots_factor}"
            )
        if self.raster_group % 8 or 128 % self.raster_group:
            raise ValueError(
                f"raster_group must be a multiple of 8 dividing 128, "
                f"got {self.raster_group}"
            )
        if self.raster_bin_rows is not None:
            if th % self.raster_bin_rows or self.raster_bin_rows <= 0:
                raise ValueError(
                    f"raster_bin_rows must divide raster_tile height {th}, "
                    f"got {self.raster_bin_rows}"
                )
            if not self.raster_sublane:
                raise ValueError("raster_bin_rows requires raster_sublane")
        if self.raster_assemble not in ("xla", "pallas"):
            raise ValueError(
                f"raster_assemble must be 'xla' or 'pallas', got {self.raster_assemble!r}"
            )
        if self.raster_tmpl not in ("xla", "pallas"):
            raise ValueError(
                f"raster_tmpl must be 'xla' or 'pallas', got {self.raster_tmpl!r}"
            )
        if self.instance_cull is not None and not (0.0 < self.instance_cull <= 1.0):
            raise ValueError(
                f"instance_cull must be in (0, 1], got {self.instance_cull}"
            )
        if self.shade_compact is not None:
            fracs = (
                self.shade_compact
                if isinstance(self.shade_compact, tuple)
                else (self.shade_compact,)
            )
            if not fracs or not all(
                isinstance(f, (int, float)) and 0.0 < f <= 1.0 for f in fracs
            ):
                raise ValueError(
                    f"shade_compact fractions must be in (0, 1], got {self.shade_compact}"
                )
