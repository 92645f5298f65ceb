"""Present engine: double-buffered asynchronous readback and frame pacing.

The reference's present path is the Vulkan swapchain: two images,
per-image fences, acquire -> submit -> present, with the fixed timestep
taken from the display's refresh rate.  Here "present" makes a rendered
frame available on the host.  ``Swapchain`` is a ring of in-flight
frames: ``submit`` hands it a frame and returns at once, and the ring's
depth bounds how far the device runs ahead.

On CUDA, ``submit`` interleaves the frame's planar colour to (H, W, 4) on
the device, starts a ``non_blocking`` device-to-host copy into a
page-locked staging slot and records a CUDA event after it; the drain
waits on the oldest frame's event only (the fence).  The slots are one
page-aligned block of anonymous memory (``mmap``), registered with CUDA
(``cudaHostRegister``) so that the copy is asynchronous.  On the CPU the
drain reads the frame's ``color_np()`` into the slot.  ``FramePacer``
supplies fixed-dt pacing and an FPS counter.
"""

from __future__ import annotations

import collections
import contextlib
import mmap
import time
from typing import Callable, Optional

import numpy as np
import torch

from .utils import profiling
from .utils.errors import PresentError

_BLOCK_ALIGN = 1 << 16  # the staging block's size multiple: whole pages


class _Staging:
    """``slots`` (H, W, 4) float32 slots in one anonymous ``mmap`` block,
    page-locked with ``cudaHostRegister`` when ``pin``; ``close``
    unregisters it.  The block is freed when its last view goes."""

    def __init__(self, extent, slots: int, pin: bool):
        w, h = extent
        slot_bytes = h * w * 4 * 4
        total = -(-slots * slot_bytes // _BLOCK_ALIGN) * _BLOCK_ALIGN
        # Private anonymous memory, as malloc maps a block this size (the
        # default MAP_SHARED would be shmem, another kind of page).
        block = np.frombuffer(mmap.mmap(-1, total, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS), np.uint8)
        self.views = [block[i * slot_bytes:(i + 1) * slot_bytes].view(np.float32).reshape(h, w, 4)
                      for i in range(slots)]
        self.tensors = None
        self._registered = None
        if pin:
            cudart = torch.cuda.cudart()
            ptr = block.ctypes.data
            rc = cudart.cudaHostRegister(ptr, total, 0)
            if int(rc) != 0:
                raise PresentError(f"cudaHostRegister of the {total}-byte staging block failed: error {int(rc)}")
            self._registered = ptr
            self._unregister = cudart.cudaHostUnregister  # held: torch may be torn down before __del__
            self.tensors = [torch.from_numpy(v) for v in self.views]

    @property
    def shape(self) -> tuple:
        return self.views[0].shape

    def close(self):
        if self._registered is not None:
            self._unregister(self._registered)
            self._registered = None
            self.tensors = None

    def __del__(self):
        self.close()


class Swapchain:
    """Ring of in-flight frames.

    depth=2 mirrors the reference's double buffering.  With ``extent``
    given, presented frames land in a fixed pool of ``2 * depth`` staging
    slots instead of fresh numpy arrays.  CUDA frames always do: their
    pool is page-locked, made from the frame's extent when none was
    given.  The pool is made at the first submit.  A presented image is
    valid for ``depth`` further presents, until its slot cycles: copy it
    to keep it.
    """

    def __init__(self, depth: int = 2, extent: tuple | None = None):
        if depth < 1:
            raise ValueError("swapchain depth must be >= 1")
        self.depth = depth
        self._ring: collections.deque = collections.deque()
        self.presented = 0
        self.submitted = 0
        self._staging: _Staging | None = None
        self.extent = None if extent is None else tuple(extent)

    def _make_staging(self, extent, pin: bool):
        """Build the staging pool (the swapchain-recreation analog)."""
        self.close()
        self.extent = tuple(extent)
        self._staging = _Staging(self.extent, 2 * self.depth, pin)

    def resize(self, extent):
        """Recreate staging for a new extent; in-flight frames are drained
        first (and returned)."""
        drained = self.flush()
        self.close()
        self.extent = tuple(extent)
        return drained

    def close(self):
        """Release the staging pool (unregistering its pages)."""
        if self._staging is not None:
            self._staging.close()
            self._staging = None

    def submit(self, frame) -> Optional[np.ndarray]:
        """Enqueue a rendered frame.  Returns the oldest frame's colour
        image (H, W, 4) float32 once the ring is full, else None (still
        warming up)."""
        planar = getattr(frame, "color_planar", None)
        cuda = isinstance(planar, torch.Tensor) and planar.is_cuda
        if not cuda and not (hasattr(frame, "color_np") or hasattr(frame, "color")):
            raise PresentError("submit expects a FrameResult-like frame")
        if self._staging is None and (cuda or self.extent is not None):
            self._make_staging(self.extent or (planar.shape[2], planar.shape[1]), pin=cuda)
        self._ring.append(self._start_copy(planar) if cuda else frame)
        self.submitted += 1
        if len(self._ring) < self.depth:
            return None
        return self._drain_one()

    def _slot(self, serial: int) -> int:
        return serial % len(self._staging.views)

    def _start_copy(self, planar: torch.Tensor):
        """Interleave on the device, copy asynchronously into this frame's
        page-locked slot, and record the event that fences the copy."""
        if self._staging.tensors is None:
            raise PresentError("a CUDA frame on a swapchain whose staging holds CPU frames")
        shape = tuple(planar.shape[1:]) + (4,)
        if shape != self._staging.shape:
            raise PresentError(f"frame extent {shape} does not match swapchain {self._staging.shape}"
                               " — call resize() (the OutOfDate analog)")
        slot = self._slot(self.submitted)
        with profiling.span("brt.swapchain.copy"):
            rgba = planar.permute(1, 2, 0).contiguous()
            self._staging.tensors[slot].copy_(rgba, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(planar.device))
        return _InFlight(slot, event, rgba)

    def _drain_one(self) -> np.ndarray:
        oldest = self._ring.popleft()
        if isinstance(oldest, _InFlight):
            with profiling.span("brt.sync.present_fence"):
                oldest.event.synchronize()  # the fence: this frame's copy, nothing newer
            img = self._staging.views[oldest.slot]
        else:
            img = oldest.color_np() if hasattr(oldest, "color_np") else np.asarray(oldest.color)
            if self._staging is not None:
                slot = self._staging.views[self._slot(self.presented)]
                if slot.shape != img.shape:
                    raise PresentError(f"frame extent {img.shape} does not match swapchain {slot.shape}"
                                       " — call resize() (the OutOfDate analog)")
                np.copyto(slot, img)
                img = slot
        self.presented += 1
        return img

    def flush(self) -> list:
        """Wait for everything in flight (the vkDeviceWaitIdle analog)."""
        out = []
        while self._ring:
            out.append(self._drain_one())
        return out


class _InFlight:
    """A CUDA frame on its way to the host: its slot, the event after its
    copy, and the interleaved device image the copy reads."""

    __slots__ = ("slot", "event", "source")

    def __init__(self, slot, event, source):
        self.slot, self.event, self.source = slot, event, source


class FramePacer:
    """Fixed-timestep pacing and FPS statistics.

    fixed_dt defaults to 1/60 (the reference takes it from the monitor's
    refresh rate; a headless run has no monitor).
    """

    def __init__(self, fixed_dt: float = 1.0 / 60.0, vsync: bool = False):
        self.fixed_dt = fixed_dt
        self.vsync = vsync  # sleep to pace at fixed_dt (FIFO analog)
        self.t = 0.0
        self._frames = 0
        self._window_start = time.perf_counter()
        self._last = self._window_start
        self.fps = 0.0

    def tick(self) -> float:
        """Advance simulation time by fixed_dt; update the FPS; optionally
        sleep to the next vsync slot.  Returns the new animation time."""
        now = time.perf_counter()
        if self.vsync:
            next_slot = self._last + self.fixed_dt
            if now < next_slot:
                time.sleep(next_slot - now)
                now = time.perf_counter()
        self._last = now
        self._frames += 1
        window = now - self._window_start
        if window >= 0.5:
            self.fps = self._frames / window
            self._frames = 0
            self._window_start = now
        self.t += self.fixed_dt
        return self.t


def render_loop(
    renderer,
    demo,
    frames: int = 120,
    on_frame: Optional[Callable] = None,
    vsync: bool = False,
    swapchain_depth: int = 2,
    timer=None,
):
    """The demo frame loop: record -> submit -> present, double buffered.

    demo: (pipeline, mesh, uniforms_fn, instances) as produced by
    models.demos.  Every frame reaches ``on_frame(img, pacer)``, the ones
    drained after the loop included.  Returns (last_image, pacer), the
    image a copy that outlives the swapchain.  ``timer``: optional
    utils.profiling.StageTimer, which times the render and present stages
    of each frame, the present stage fenced on the frame's colour.
    """
    pipeline, mesh, uniforms_fn, instances = demo
    cfg = getattr(renderer, "config", None)
    extent = (cfg.width, cfg.height) if cfg is not None else None
    chain = Swapchain(depth=swapchain_depth, extent=extent)
    pacer = FramePacer(vsync=vsync)
    last = None

    def stage(name, fence=None):
        if timer is None:
            return contextlib.nullcontext()
        return timer.stage(name, fence=fence)

    try:
        for _ in range(frames):
            t = pacer.tick()
            with stage("record+dispatch"):
                with profiling.span("brt.caller.uniforms_fn"):
                    uniforms = uniforms_fn(t)
                frame = renderer.render_frame(pipeline, mesh, uniforms, instances=instances)
            with stage("present", fence=frame.color_planar if timer else None):
                img = chain.submit(frame)
            if img is not None:
                if on_frame is not None:
                    on_frame(img, pacer)
                last = img
        for img in chain.flush():
            if on_frame is not None:
                on_frame(img, pacer)
            last = img
        # Staged slots cycle; hand back a stable copy.
        if last is not None and chain._staging is not None:
            last = last.copy()
    finally:
        chain.close()
    return last, pacer
