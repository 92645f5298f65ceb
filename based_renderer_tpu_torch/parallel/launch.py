"""Start a torch.distributed world of processes and run a function on every rank.

The analog of the JAX package's virtual device mesh: ``run`` spawns one
process per mesh position with ``torch.multiprocessing`` (the spawn
method), joins them into a process group over a ``file://`` rendezvous in
a temporary directory (no TCP port to collide), builds the
``DeviceMesh`` and calls ``fn(mesh, *args)`` on every rank.  The backend
and every rank's device are the caller's: several ranks on one card run
over "gloo" (NCCL refuses two ranks on one device), ranks on cards of
their own may run over "nccl".  Each child runs ``torch.set_num_threads(1)``.

``fn`` is pickled by its import path, so it must be a module-level
function of an importable module (``parallel/workers.py`` holds the
package's); it returns something picklable that holds no tensors (numpy
arrays, numbers).  A rank that raises fails the run: the other ranks are
stopped and ``run`` raises with the rank's traceback.
"""

from __future__ import annotations

import datetime
import math
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESH_DIMS = {2: ("y", "x"), 3: ("y", "x", "g")}


def make_mesh(shape, device_type: str):
    """A DeviceMesh of ``shape`` over the ranks of the world, with dims ("y",
    "x") or ("y", "x", "g").  Every rank of the world calls it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in shape)
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_DIMS[len(shape)])


def _child(rank, world, init_file, backend, device, shape, timeout, fn, args, results):
    torch.set_num_threads(1)
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(shape, device.type), *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def run(fn, mesh_shape, args=(), *, backend: str, devices, timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a world of prod(mesh_shape)
    processes; returns the ranks' results in rank order.

    ``backend`` is "gloo" or "nccl"; ``devices`` is one device for every
    rank or a list with one per rank ("cpu", "cuda:0", ...).  ``timeout``
    bounds the whole run and each collective, in seconds.
    """
    world = math.prod(mesh_shape)
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="brt_dist_")
    procs = []
    try:
        init_file = os.path.join(tmp, "rendezvous")
        for rank in range(world):
            p = ctx.Process(
                target=_child,
                args=(rank, world, init_file, backend, devices[rank], tuple(mesh_shape), timeout, fn, tuple(args),
                      results),
                daemon=True,
            )
            p.start()
            procs.append(p)
        out = [None] * world
        pending = set(range(world))
        deadline = time.monotonic() + timeout
        dead_before = []
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                # A rank that exited is failed once a further wait gave
                # nothing (its result could still have been in the pipe).
                dead = sorted(r for r in pending if not procs[r].is_alive())
                if dead and dead == dead_before:
                    raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result")
                dead_before = dead
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} gave no result within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
