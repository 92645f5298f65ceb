"""The port's benchmark: one run of one cell on the chip.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  It measures ``based_renderer_tpu_torch``
(the PyTorch and CUDA port) on one CUDA device and prints, as the last
line of its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared with the
reference beside their limits, which are also its last lines on standard
error.  It exits non-zero and prints no result when there is no CUDA
device, when the checkout lacks the program, or when JAX or the JAX
package was loaded.  See ``benchmark/README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import guard  # noqa: E402

guard.keep_jax_out(os.environ)


def _seed(text: str) -> int:
    v = int(text)
    if v < 0:
        raise argparse.ArgumentTypeError("the seed is a whole number >= 0")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=_seed, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from benchmark.harness import core, spec

    bench = spec.load()
    cell = spec.cell(bench, a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = core.run(bench, a.workload, a.seed, a.seconds, bool(a.trace), "cuda", T_PROCESS)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}, which the benchmark may not import", file=sys.stderr)
        return 3
    for note in result.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
