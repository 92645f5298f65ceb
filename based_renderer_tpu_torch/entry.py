"""Entry points: one frame on one card, and a multi-device dry run.

The port's counterparts of the JAX package's ``__graft_entry__.py``.
``entry()`` returns the frame function of the spinning-cube demo at
1920x1080 and its arguments.  ``dryrun_multichip(n)`` runs one
tile-parallel (with a geometry axis of 2 when n is even and at least 8)
frame and one MSAA-4x multi-draw frame with stencil and blending over a
world of n gloo processes on the CPU (parallel/launch.py), the analog of
the JAX package's n-device virtual CPU mesh.
"""

from __future__ import annotations

from . import demos
from .parallel import launch, workers
from .renderer import Renderer, RendererConfig


def entry(width: int = 1920, height: int = 1080, device=None):
    """(fn, args): ``fn(*args)`` renders the cube demo's frame at t = 0.5
    (cleared to zero colour) and returns the frame's result tuple (color
    (4, H, W), depth_q, tri_id, stencil, overflowed, pair_budget_use).
    ``device`` as for Renderer: the card unless the CPU is named."""
    r = Renderer(RendererConfig(width=width, height=height), device=device)
    pipe, mesh, uniforms, _ = demos.cube_demo(r)
    # Record one frame to get its draw list.
    r.begin_frame(clear_color=(0.0, 0.0, 0.0, 0.0))
    r.draw(pipe, mesh, uniforms(0.5))
    return r._run_frame, r.close_frame()


def dryrun_multichip(n_devices: int) -> None:
    """The JAX package's dry run over n ranks: gloo processes on the CPU,
    each rendering its window of two tiny frames (workers.dryrun).  Raises
    if a rank fails."""
    g = 2 if n_devices % 2 == 0 and n_devices >= 8 else 1
    ny, nx = workers.factor2(n_devices // g)
    launch.run(workers.dryrun, (ny, nx, g) if g > 1 else (ny, nx), (n_devices,), backend="gloo", devices="cpu")
