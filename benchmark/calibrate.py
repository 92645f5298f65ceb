"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3] [--seconds 3]

On the chip, in one process: for each seed, the cell's traffic is driven
for a short window and the frames the run would compare are compared with
the reference (the lower readings: sound runs of the program).  For each
control seed, the same frames are also made by the reference in TF32 in the
program's place, and compared the same way (the upper readings: a
comparison that passes them is too loose).  Prints one JSON line per seed
and per control, then the largest sound reading and the smallest control
reading of each number.  The benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_frames(frames: list, control) -> list:
    """The frames a run compares, made by ``control(t)`` instead."""
    out = []
    for f in frames:
        ref = control(f["t"])
        g = {"t": f["t"], "color": ref.color}
        if "tri_id" in f:
            g["tri_id"], g["depth_q"] = ref.tri_id, ref.depth_q
        out.append(g)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    import torch

    from benchmark.harness import compare, core, guard, spec

    bench = spec.load()
    lower: dict = {}
    upper: dict = {}
    for seed in a.seeds:
        meas = core.measure(bench, a.workload, seed, a.seconds, False, a.device, time.perf_counter())
        cfg, w, h = meas.cfg, meas.cfg["width"], meas.cfg["height"]
        ref = compare.reference_for(cfg, meas.scene, meas.attrs, w / h, instances=meas.instances)
        sound = compare.numbers(meas.m.frames, ref)
        for k, v in sound.items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps({"seed": seed, "kind": "program", "frames": len(meas.m.frames),
                          "failed": meas.m.failed, "numbers": sound}), flush=True)
        if seed in a.control_seeds:
            ctl = compare.reference_for(cfg, meas.scene, meas.attrs, w / h, precision="tf32",
                                        instances=meas.instances)
            control = compare.numbers(control_frames(meas.m.frames, ctl), ref)
            for k, v in control.items():
                upper[k] = min(upper.get(k, v), v)
            print(json.dumps({"seed": seed, "kind": "control_tf32", "numbers": control}), flush=True)
        del meas, ref
        if a.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - T_PROCESS,
                      "forbidden_loaded": guard.forbidden_loaded()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
