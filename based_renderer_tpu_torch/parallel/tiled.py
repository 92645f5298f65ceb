"""Tile-parallel rendering over a torch.distributed device mesh.

The PyTorch counterpart of ``based_renderer_tpu/parallel/tiled.py``.  The
framebuffer is split over a ``DeviceMesh`` with dims ("y", "x"[, "g"]),
one process (rank) per mesh position, the analog of a
``jax.sharding.Mesh``:

  * tile parallelism ("y", "x"): every rank runs the whole frame
    (multi-draw, blending, stencil, coverage MSAA, the kernel routes) over
    its own window of the framebuffer, binning the triangles against its
    local tile grid with records anchored at global tile origins
    (``Renderer._visibility`` with a ``renderer.Shard``).  No rank talks
    to another during the frame; only the overflow flag is OR-ed.
  * geometry parallelism ("g", optional): each draw's triangle stream is
    cut into slices by the "g" coordinate, every rank rasterizes its slice
    over its window, and the slices' per-pixel winners are
    depth-composited after each draw by ``merge_vis_over_axis`` (a few
    MIN/MAX all-reduces over the "g" group).  Like the JAX package it
    needs the Pallas backend rule, whose in-raster varyings ride along the
    composite.

Every spec quantity is computed in global pixel coordinates, so tri_id,
depth_q and stencil equal the single-device frame's bit for bit.  A
window's tiles are cut to divide its extent, so its float planes are
anchored at tile origins a whole frame drawn with those tiles would use:
colour then equals that frame's bit for bit, and a frame at the default
tile within float rounding.

``end_frame`` returns the rank's own window, the way each JAX device holds
its shard of the output; ``full_frame`` all-gathers the whole frame on
every rank.  Each rank renders on the mesh's device type: the CPU for a
"cpu" mesh, the current CUDA device for a "cuda" one.  The process group's
backend is the caller's choice (parallel/launch.py): several ranks that
share one card run over gloo, which stages CUDA tensors through the host.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..ops.raster import VisBuffer
from ..renderer import FrameResult, Renderer, RendererConfig, Shard
from ..utils.errors import AllocationError, FrameError

_BIG = 2**30
_INT32_MIN = -(2**31)
_ORDERED = ("less", "less_equal", "greater", "greater_equal")


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


def merge_vis_over_axis(vis: VisBuffer, extras: list, group, depth_state):
    """Depth-composite visibility buffers across the ranks of ``group``,
    with the sequential raster's winner for the pipeline's depth state
    (JAX tiled.py:42-120).  Global triangle ids are disjoint and
    draw-ordered across the group, so comparing ids compares draw order.

    * Depth test and write with an ordered compare: the winner holds the
      extremal depth; at equal depth the lowest id wins under the strict
      compares (a later fragment fails the strict test) and the highest
      under the ``*_equal`` ones (a later fragment overwrites).
    * Otherwise (test or write off, "equal", "always", "never") the set
      of passing fragments does not depend on the other ranks, so the last
      drawn, the highest id, wins, with the depth its rank holds.
    * "not_equal" with write is sequential per pixel and cannot be merged:
      TiledRenderer rejects it.

    ``extras`` are more float planes (interpolated channels (K, ...),
    1/w) carried from the winning rank; an entry may be None.  Where no
    rank covers a pixel every plane takes its background: 0, and 1.0 for
    ``extras[1]`` (1/w clears to 1.0, as the rasterizer's background).
    Returns (merged VisBuffer, merged extras).
    """
    MIN, MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX
    if depth_state.test and depth_state.write and depth_state.compare in _ORDERED:
        dbest = _all_reduce(vis.depth_q, MIN if depth_state.compare.startswith("less") else MAX, group)
        mine = (vis.depth_q == dbest) & (vis.tri_id >= 0)
        if depth_state.compare.endswith("_equal"):
            tid = torch.where(mine, vis.tri_id, -1)
            tid_win = _all_reduce(tid, MAX, group)
            won = mine & (tid == tid_win) & (tid_win >= 0)
        else:
            tid = torch.where(mine, vis.tri_id, _BIG)
            tid_min = _all_reduce(tid, MIN, group)
            tid_win = torch.where(tid_min < _BIG, tid_min, -1)
            won = mine & (tid == tid_min) & (tid_min < _BIG)
        depth_q = dbest
    else:
        tid_win = _all_reduce(vis.tri_id, MAX, group)
        won = (vis.tri_id == tid_win) & (tid_win >= 0)
        picked = _all_reduce(torch.where(won, vis.depth_q, _INT32_MIN), MAX, group)
        depth_q = torch.where(tid_win >= 0, picked, vis.depth_q)
    # Every float plane of the winner in one MAX: the other ranks give -inf.
    fbs = vis.tri_id.shape
    planes = [vis.b0, vis.b1, vis.b2] + [x for x in extras if x is not None]
    sizes = [x.numel() // vis.tri_id.numel() for x in planes]
    stacked = torch.cat([x.reshape(-1, *fbs) for x in planes])
    got = _all_reduce(torch.where(won, stacked, float("-inf")), MAX, group)
    covered = tid_win >= 0
    backgrounds = [0.0, 0.0, 0.0] + [1.0 if i == 1 else 0.0 for i, x in enumerate(extras) if x is not None]
    out = [
        torch.where(covered, part, bg).reshape(x.shape)
        for part, bg, x in zip(torch.split(got, sizes), backgrounds, planes)
    ]
    merged = VisBuffer(tri_id=tid_win, depth_q=depth_q, b0=out[0], b1=out[1], b2=out[2])
    rest = iter(out[3:])
    return merged, [None if x is None else next(rest) for x in extras]


class TiledRenderer:
    """Renderer over a ("y", "x"[, "g"]) ``DeviceMesh``: the JAX package's
    TiledRenderer, with the same begin_frame/draw/end_frame surface.

    Every rank of the mesh constructs it and makes the same calls in the
    same order (the collectives pair them up).  The mesh spans every rank
    of the process group, as ``init_device_mesh`` makes it.  The
    framebuffer is split into ny x nx windows of (width / nx, height / ny)
    pixels; a rank renders the window of its ("y", "x") coordinate.
    """

    def __init__(self, config: RendererConfig, device_mesh, geometry_axis: str | None = None):
        self.config = config
        self.mesh = device_mesh
        self.geometry_axis = geometry_axis
        names = tuple(device_mesh.mesh_dim_names or ())
        if "y" not in names or "x" not in names or (geometry_axis and geometry_axis not in names):
            raise ValueError(f"mesh dims {names} need 'y' and 'x' (and the geometry axis {geometry_axis!r})")
        if device_mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {device_mesh.size()} of the world's {dist.get_world_size()} ranks")
        shape = dict(zip(names, device_mesh.shape))
        ny, nx = shape["y"], shape["x"]
        if config.height % ny or config.width % nx:
            raise ValueError(f"framebuffer {config.width}x{config.height} not divisible by mesh {nx}x{ny}")
        self._lw, self._lh = config.width // nx, config.height // ny
        if self._lw % 8 or self._lh % 8:
            raise ValueError("shard extent must be a multiple of 8 pixels")
        coord = dict(zip(names, device_mesh.get_coordinate()))
        if device_mesh.device_type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(device_mesh.device_type)
        self._inner = Renderer(config, device=device)
        geometry = None
        if geometry_axis:
            geometry = (shape[geometry_axis], coord[geometry_axis], self._merge)
        self._shard = Shard(origin=(coord["x"] * self._lw, coord["y"] * self._lh),
                            extent=(self._lw, self._lh), geometry=geometry)
        self.last_sequence_overflowed = None
        self._clock_merges, self.merge_ms, self.merge_calls = False, 0.0, 0

    @property
    def device(self) -> torch.device:
        return self._inner.device

    @property
    def num_cached_programs(self) -> int:
        """The frame and sequence programs this rank holds (Renderer.num_cached_programs)."""
        return self._inner.num_cached_programs

    @property
    def shard(self) -> Shard:
        """This rank's window (and geometry slice)."""
        return self._shard

    def upload_mesh(self, positions, indices=None, **attrs):
        """Renderer.upload_mesh on this rank's device (the demos take a
        TiledRenderer as they take a Renderer)."""
        return self._inner.upload_mesh(positions, indices, **attrs)

    # -- frame recording -------------------------------------------------------

    def begin_frame(self, clear_color=None, clear_depth=None):
        self._inner.begin_frame(clear_color=clear_color, clear_depth=clear_depth)
        return self

    def draw(self, pipeline, mesh, uniforms=None, instances=None):
        self._check_pipeline(pipeline)
        self._inner.draw(pipeline, mesh, uniforms, instances)

    def _check_pipeline(self, pipeline):
        """The geometry axis's rejections (JAX tiled.py:163-178)."""
        if self.geometry_axis:
            if pipeline.depth.test and pipeline.depth.write and pipeline.depth.compare == "not_equal":
                raise ValueError(
                    "depth compare 'not_equal' with depth write is sequential per pixel and cannot be "
                    "composited across a geometry axis"
                )
            if pipeline.stencil.enable:
                raise ValueError(
                    "stencil updates are sequential per pixel and cannot be composited across a geometry axis"
                )

    def end_frame(self) -> FrameResult:
        """Render the recorded draws: this rank's window of the frame, with
        the overflow flag OR-ed over every rank.  The frame runs through
        the inner renderer's program for its key, the shard in the key (JAX
        tiled.py:189): on CUDA a tile-only rank replays its captured
        graphs, and a geometry axis, which merges inside the frame, runs
        its program eagerly.  The flags' all-reduce lies outside the
        program.  In debug mode an overflow or a non-finite colour on any
        rank raises on every rank."""
        inner = self._inner
        color, depth_q, tri_id, stencil, overflowed = inner._frame(*inner.close_frame(), self._shard)
        flags = [overflowed]
        if self.config.debug:
            flags.append(~torch.isfinite(color).all())
        flags = _all_reduce(torch.stack(flags).to(torch.int32), dist.ReduceOp.MAX, None)
        overflowed = flags[0] > 0
        if self.config.debug:
            if bool(overflowed):
                raise AllocationError(
                    "raster pair buffer overflow on a shard: a draw's (tile, triangle) pair count exceeded "
                    "its raster_pairs_factor budget; raise Pipeline.raster_pairs_factor"
                )
            if bool(flags[1]):
                raise FrameError("non-finite values in rendered color buffer")
        inner.frame_count += 1
        return FrameResult(
            color_planar=color,
            depth_q=depth_q,
            tri_id=tri_id,
            stencil=stencil,
            overflowed=overflowed,
            srgb=self.config.framebuffer_srgb,
        )

    def render(self, pipeline, scene_mesh, uniforms=None, instances=None):
        """Single-draw convenience: this rank's (color_planar, depth_q, tri_id)."""
        self.begin_frame()
        self.draw(pipeline, scene_mesh, uniforms, instances)
        f = self.end_frame()
        return f.color_planar, f.depth_q, f.tri_id

    def full_frame(self, frame: FrameResult) -> FrameResult:
        """The whole frame on every rank, from each rank's window: every plane
        all-gathered over "x", then over "y" (the analog of reading the JAX
        package's sharded output on the host)."""
        ints = [frame.tri_id, frame.depth_q] + ([] if frame.stencil is None else [frame.stencil])
        ints = self.gather_windows(torch.stack(ints))
        return FrameResult(
            color_planar=self.gather_windows(frame.color_planar),
            depth_q=ints[1],
            tri_id=ints[0],
            stencil=ints[2] if len(ints) > 2 else None,
            overflowed=frame.overflowed,
            srgb=frame.srgb,
        )

    # -- frame sequences ---------------------------------------------------------

    def render_sequence(self, pipeline, scene_mesh, uniforms_seq=None, instances=None, return_frames: bool = False,
                        num_frames: int | None = None, static_uniforms=None, uniforms_fn=None, t0: float = 0.0,
                        dt: float = 1.0 / 60.0):
        """N frames of one draw (Renderer.render_sequence): the (N,) global
        checksums, and this rank's (N, 4, h, w) windows with ``return_frames``."""
        return self.render_sequence_multi(
            [
                {
                    "pipeline": pipeline,
                    "mesh": scene_mesh,
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

    def render_sequence_multi(self, seq_draws, *, num_frames: int | None = None, return_frames: bool = False,
                              t0: float = 0.0, dt: float = 1.0 / 60.0):
        """Renderer.render_sequence_multi over this rank's window.  Each
        frame's checksum is summed over "y" and "x" (the "g" ranks hold the
        same merged window), so every rank returns the global checksums.
        On CUDA a tile-only mesh replays each rank's captured CUDA graphs
        and reduces the checksums once per call; a geometry axis merges
        inside every frame, which no graph can capture, so its frames run
        eagerly."""
        for sd in seq_draws:
            self._check_pipeline(sd["pipeline"])
        sums, frames, overflowed = self._inner._sequence(seq_draws, num_frames, return_frames, t0, dt, self._shard)
        sums = self._reduce(sums, dist.ReduceOp.SUM, ("y", "x"))
        overflowed = _all_reduce(overflowed.to(torch.int32), dist.ReduceOp.MAX, None) > 0
        self.last_sequence_overflowed = overflowed
        if self.config.debug and bool(overflowed):
            raise AllocationError(
                "raster pair buffer overflow during render_sequence; raise Pipeline.raster_pairs_factor"
            )
        return (sums, frames) if return_frames else sums

    # -- collectives ---------------------------------------------------------------

    def clock_merges(self):
        """Time every geometry composite from now on, from zero: ``merge_ms``
        (host clock, the device synchronised before and after each, so it
        holds the wait for the group's slowest rank) over ``merge_calls``."""
        self._clock_merges, self.merge_ms, self.merge_calls = True, 0.0, 0

    def _merge(self, vis, interp, invw, depth_state):
        """The Shard's merge: composite this draw's winners over the geometry axis."""
        if self._clock_merges:
            self._sync()
            t0 = time.perf_counter()
        vis, (interp, invw) = merge_vis_over_axis(
            vis, [interp, invw], self.mesh.get_group(self.geometry_axis), depth_state
        )
        if self._clock_merges:
            self._sync()
            self.merge_ms += (time.perf_counter() - t0) * 1e3
            self.merge_calls += 1
        return vis, interp, invw

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reduce(self, x: torch.Tensor, op, dims) -> torch.Tensor:
        """``x`` all-reduced over the mesh dims ``dims``, one dim after another."""
        for name in dims:
            if self.mesh.size(self.mesh.mesh_dim_names.index(name)) > 1:
                x = _all_reduce(x, op, self.mesh.get_group(name))
        return x

    def gather_windows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ([C,] h, w), planes of this rank's window, all-gathered into
        the whole frame ([C,] H, W) on every rank."""
        names = self.mesh.mesh_dim_names
        for name, axis in (("x", -1), ("y", -2)):
            dim = names.index(name)
            group = self.mesh.get_group(name)
            n = self.mesh.size(dim)
            if n == 1:
                continue
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            # Group ranks follow the global ranks; put the parts in the
            # order of their coordinate along this dim.
            layout = self.mesh.mesh.movedim(dim, -1).reshape(-1, n)
            ranks = dist.get_process_group_ranks(group)
            row = next(r for r in layout.tolist() if set(r) == set(ranks))
            x = torch.cat([parts[ranks.index(r)] for r in row], dim=axis)
        return x
