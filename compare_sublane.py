"""Time the sublane raster kernel (B2, and the batched route B7 through it)
against other builds of the same C entry point, in turns, on one NVIDIA GPU.

Run from the root of a checkout:

    git show <commit>:based_renderer_tpu_torch/csrc/raster_sublane.cu > build/sublane_old.cu
    python3 compare_sublane.py --variant old=build/sublane_old.cu --exact old

Each ``--variant NAME=PATH`` is a ``.cu`` file that defines
``brt_raster_sublane`` with the signature of
``based_renderer_tpu_torch/csrc/raster_sublane.cu`` (an older version of
that file, or a stripped copy that skips part of the work).  Each is built
by its own nvcc, all started together, into its own shared library under
``build/compare/``, with the flags of the package's build.  The package's
own kernel (the checkout's) is the variant ``tree``.

Cases: big_mesh (1M triangles, t = 0.2) at 1920x1080 on the sublane route
(tiles 128x8), the 10k-instance demo at 1920x1080 on the sublane route,
and big_mesh at 1920x1080 on the batched route (batch 16).  The variants
run in turns, the list and then the list reversed (old, tree, tree, old
for one variant), each turn timed two ways: the median of 7 CUDA-event
windows of ITERS calls of the wrapper, and the kernel's device-only time
under torch.profiler (chip_smoke.kernel_ms).  Each ``--exact`` variant's
output, and the tree's, must equal the plain PyTorch version bitwise
(tri_id, depth_q and every float plane).  Prints one line per case, then
a JSON line of all turns, then the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import sys
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent
ITERS = 10
W, H = 1920, 1080
SYMBOL = "raster_sublane_kernel"


def build_variants(variants: dict[str, pathlib.Path],
                   symbols: tuple[str, ...] = ("brt_raster_sublane",)) -> tuple[dict[str, ctypes.CDLL], str]:
    """nvcc each variant into build/compare/NAME.so, all at once; load them,
    each of ``symbols`` it defines declared as the package's own."""
    from based_renderer_tpu_torch.ops import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"{name}.so" for name in variants}
    nvcc = _build._nvcc()
    log = _build._run([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(paths[n]), str(src)]
                       for n, src in variants.items()]) if variants else ""
    tree = _build.load()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for sym in symbols:
            if hasattr(lib, sym):
                getattr(lib, sym).restype = getattr(tree, sym).restype
                getattr(lib, sym).argtypes = getattr(tree, sym).argtypes
        libs[name] = lib
    return libs, log


def cases(dev):
    """(label, rasterize kwargs, binned) of the three cases."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops.binning import bin_triangles
    from based_renderer_tpu_torch.ops.setup import setup_triangles
    from based_renderer_tpu_torch.ops.vertex import expand_instances, gather_triangles

    def dense(demo, t):
        r = brt.Renderer(brt.RendererConfig(W, H), device=dev)
        pipe, mesh, uniforms, inst = getattr(brt.demos, demo)(r)
        attrs, tri_idx = expand_instances(mesh, inst)
        clip, var = brt.shader.get(pipe.shader).vertex(attrs, {k: v.to(dev) for k, v in uniforms(t).items()})
        clip_tri, var_tri = gather_triangles(clip, var, tri_idx)
        ts = setup_triangles(clip_tri, W, H, cull_mode=pipe.cull_mode, front_face=pipe.front_face)
        channels = torch.cat([var_tri[k] for k in sorted(var_tri)], dim=-1)
        n = clip_tri.shape[0]
        b = bin_triangles(ts, W, H, 128, 8, assemble="pallas", channels=channels,
                          max_pairs=max(int(n * pipe.raster_pairs_factor), 1024),
                          slots=max(int(n * pipe.raster_slots_factor), 1024))
        if bool(b.overflowed):
            raise AssertionError(f"{demo} overflowed")
        return b, channels.shape[-1]

    big, k_big = dense("big_mesh_demo", 0.2)
    inst, k_inst = dense("instanced_demo", 0.3)
    tile = dict(tile_w=128, tile_h=8)
    return [
        ("big_mesh 1080p sublane", dict(sublane=True, sublane_group=64, num_channels=k_big, **tile), big),
        ("instanced 1080p sublane", dict(sublane=True, sublane_group=32, num_channels=k_inst, depth_clip=False,
                                         **tile), inst),
        ("big_mesh 1080p batched", dict(batch=16, num_channels=k_big, **tile), big),
    ]


def bitwise_equal(got, want) -> bool:
    """(vis, interp, invw) pairs: tri_id, depth_q and every float plane bitwise."""
    def planes(out):
        return [out[0].tri_id, out[0].depth_q, out[0].b0, out[0].b1, out[0].b2, *out[1:]]

    return all(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
               for a, b in zip(planes(got), planes(want)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--exact", action="append", default=[], metavar="NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_sublane: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi, raster_bound, timed, winning_records
    from based_renderer_tpu_torch.ops import _build, raster

    card = nvidia_smi("name,power.limit")
    variants = {}
    for spec in args.variant:
        name, _, path = spec.partition("=")
        if not name or name == "tree" or not pathlib.Path(path).is_file():
            raise SystemExit(f"bad --variant {spec!r}")
        variants[name] = pathlib.Path(path)
    libs, log = build_variants(variants)
    regs = [line.split("ptxas info    :")[-1].strip() for line in log.splitlines() if "registers" in line]
    print(f"[build] {len(libs)} variants | {' | '.join(regs)} | {card}", flush=True)

    order = [*libs, "tree"]
    order += order[::-1]

    def run(name, binned, kw):
        if name == "tree":
            return raster.rasterize_binned(binned, W, H, **kw)
        saved = _build._lib
        _build._lib = types.SimpleNamespace(brt_raster_sublane=libs[name].brt_raster_sublane)
        try:
            return raster.rasterize_binned(binned, W, H, **kw)
        finally:
            _build._lib = saved

    dev = torch.device("cuda")
    rows = []
    for label, kw, binned in cases(dev):
        want = raster.rasterize_binned_reference(binned, W, H, **kw)
        for name in ["tree", *args.exact]:
            if not bitwise_equal(run(name, binned, kw), want):
                raise AssertionError(f"{label}: {name} differs from the plain version")
        vis = want[0]
        b = raster_bound(binned, vis, (128, 8), kw["num_channels"], 13, 40, False)
        turns = []
        for name in order:
            turns.append((name, timed(lambda: run(name, binned, kw), ITERS, SYMBOL)))
        by = {n: [t["kernel_ms"] for m, t in turns if m == n] for n in order}
        rows.append({"case": label, "bound_ms": b[0], "bound_by": b[1],
                     "winners": winning_records(vis.tri_id, None, (128, 8)),
                     "turns": [{"variant": n, "ms": t["ms"], "kernel_ms": t["kernel_ms"], "sm": t["sm"]}
                               for n, t in turns]})
        print(f"[{label}] bound {b[0]:.4f} ms ({b[1]}) | kernel-only ms per variant, turns in order: "
              + "; ".join(f"{n} {' '.join(f'{v:.4f}' for v in vs)} (median {statistics.median(vs):.4f})"
                          for n, vs in by.items())
              + " | event ms: " + ", ".join(f"{n} {t['ms']:.4f}" for n, t in turns) + f" | {card}", flush=True)
    print(json.dumps({"card": card, "exact": ["tree", *args.exact], "cases": rows}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
