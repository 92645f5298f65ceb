"""Time the rows entry of the record assembly (B3's
``brt_assemble_records_rows``) against other builds of the same C entry
point, in turns, on one NVIDIA GPU.

Run from the root of a checkout:

    git show HEAD~:based_renderer_tpu_torch/csrc/assemble_records.cu > build/assemble_old.cu
    python3 compare_assemble.py --variant old=build/assemble_old.cu --exact old

Each ``--variant NAME=PATH`` is a ``.cu`` file that defines
``brt_assemble_records_rows`` and ``brt_assemble_records`` with the
signatures of ``based_renderer_tpu_torch/csrc/assemble_records.cu`` (an
older version of that file, or a stripped copy that skips part of the
work), built by ``compare_sublane.build_variants``.  The checkout's own
build is the variant ``tree``.  A variant without
``brt_assemble_records_rows_smem`` takes the tree's, which only feeds the
wrapper's shared-memory check.

Streams, each as ``raster_tmpl="pallas"`` builds it (field-major
templates, transposed by B8): the instanced demo (10k cubes, K = 3) at
1920x1080 under instance_cull 0.9 (per-triangle ids); big_mesh (1M
triangles, t = 0.2, K = 6) at 1920x1080 (16-row records) and at 3840x2160
MSAA-4x (24-row records); big_mesh at 1920x1080 with 32 random channels
(128-wide rows).  The variants run in turns, the list and then the list
reversed (old, tree, tree, old for one variant).  Each turn times the rows
entry two ways, the median of 7 CUDA-event windows of ITERS calls of the
wrapper and its kernel's device-only time under torch.profiler
(chip_smoke.kernel_ms), and the per-field entry on the same slots
device-only.  The tree's records, and each ``--exact`` variant's, must
equal the plain version bitwise.  Prints one line per stream, then a JSON
line of all turns, then the card's name and power limit.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent
ITERS = 10
W, H = 1920, 1080
SYMBOLS = ("brt_assemble_records_rows", "brt_assemble_records", "brt_assemble_records_rows_smem")
ROWS, PER_FIELD = "assemble_records_rows_kernel", "assemble_records_kernel"


def streams(dev):
    """(label, pair stream, template rows, K, msaa4) of the four streams."""
    import based_renderer_tpu_torch as brt
    from based_renderer_tpu_torch.ops import binassem, binning
    from chip_smoke import culled_setup, dense_setup

    def stream(ts, width, height, kw, channels, ids=0):
        ps = binning.pair_stream(ts, width, height, 128, 8, kw["max_pairs"], ids, channels, True, kw["slots"])
        if bool(ps.overflowed):
            raise AssertionError("pair stream overflowed")
        fused = binassem.transpose_templates(*binning.templates_field_major(ps.tmpl))
        return ps, fused, channels.shape[-1]

    cull_ts, cull_kw, cull_ids, _ = culled_setup(brt.Renderer(brt.RendererConfig(W, H)), 0.3, 0.9, dev)
    out = [("instanced culled 1080p", *stream(cull_ts, W, H, cull_kw, cull_kw["channels"], cull_ids), False)]
    _, big_ts, big_kw = dense_setup(brt.Renderer(brt.RendererConfig(W, H)), "big_mesh_demo", 0.2, dev)
    out.append(("big_mesh 1080p", *stream(big_ts, W, H, big_kw, big_kw["channels"]), False))
    k32 = torch.randn((big_ts.valid.shape[0], 3, 32), generator=torch.Generator(device=dev).manual_seed(32),
                      device=dev)
    out.append(("big_mesh 1080p K=32", *stream(big_ts, W, H, big_kw, k32), False))
    del big_ts, big_kw, k32
    r4m = brt.Renderer(brt.RendererConfig(2 * W, 2 * H, msaa=4))
    _, ts4m, kw4m = dense_setup(r4m, "big_mesh_demo", 0.2, dev)
    out.append(("big_mesh 4K MSAA-4x", *stream(ts4m, 2 * W, 2 * H, kw4m, kw4m["channels"]), True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--exact", action="append", default=[], metavar="NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_assemble: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import kernel_ms, nvidia_smi, rows_bound, timed
    from compare_sublane import build_variants
    from based_renderer_tpu_torch.ops import _build, binassem, binning

    card = nvidia_smi("name,power.limit")
    variants = {}
    for spec in args.variant:
        name, _, path = spec.partition("=")
        if not name or name == "tree" or not pathlib.Path(path).is_file():
            raise SystemExit(f"bad --variant {spec!r}")
        variants[name] = pathlib.Path(path)
    libs, log = build_variants(variants, SYMBOLS)
    regs = [line.split("ptxas info    :")[-1].strip() for line in log.splitlines() if "registers" in line]
    print(f"[build] {len(libs)} variants | {' | '.join(regs)} | {card}", flush=True)

    order = [*libs, "tree"]
    order += order[::-1]
    tree = _build.load()

    def run(name, fn, *a):
        if name == "tree":
            return fn(*a)
        lib = libs[name]
        saved = _build._lib
        _build._lib = types.SimpleNamespace(**{s: getattr(lib if hasattr(lib, s) else tree, s) for s in SYMBOLS})
        try:
            return fn(*a)
        finally:
            _build._lib = saved

    dev = torch.device("cuda")
    rows = []
    for label, ps, fused, k, msaa4 in streams(dev):
        fw = binning.frecord_width(k)
        slots = binning.padded_slots(ps)
        rows_args = (fused, *slots, ps.total, fw, k, msaa4)
        field_args = (ps.tmpl, *slots, ps.total, fw, msaa4)
        want = binassem.assemble_records_rows_reference(*rows_args)
        for name in ["tree", *args.exact]:
            got = run(name, binassem.assemble_records_rows, *rows_args)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))):
                raise AssertionError(f"{label}: {name} differs from the plain version")
        b = rows_bound(slots[0], want[0].shape[0], fw, k)
        turns = []
        for name in order:
            t = timed(lambda: run(name, binassem.assemble_records_rows, *rows_args), ITERS, ROWS)
            t["field_kernel_ms"] = kernel_ms(lambda: run(name, binassem.assemble_records, *field_args), PER_FIELD)
            turns.append((name, t))
        by = {n: [t["kernel_ms"] for m, t in turns if m == n] for n in order}
        field = {n: [t["field_kernel_ms"] for m, t in turns if m == n] for n in order}
        rows.append({"case": label, "slots": int(slots[0].shape[0]), "live": int(ps.total), "bound_ms": b[0],
                     "bound_by": b[1],
                     "turns": [{"variant": n, "ms": t["ms"], "kernel_ms": t["kernel_ms"],
                                "field_kernel_ms": t["field_kernel_ms"], "sm": t["sm"]} for n, t in turns]})
        print(f"[{label}] {slots[0].shape[0]} slots, K={k}, bound {b[0]:.4f} ms ({b[1]}) | rows entry kernel-only "
              "ms per variant, turns in order: "
              + "; ".join(f"{n} {' '.join(f'{v:.4f}' for v in vs)} (median {statistics.median(vs):.4f}, "
                          f"{b[0] / statistics.median(vs):.0%} of bound)" for n, vs in by.items())
              + " | per-field entry: "
              + "; ".join(f"{n} median {statistics.median(vs):.4f}" for n, vs in field.items())
              + " | event ms: " + ", ".join(f"{n} {t['ms']:.4f}" for n, t in turns) + f" | {card}", flush=True)
    print(json.dumps({"card": card, "exact": ["tree", *args.exact], "cases": rows}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
