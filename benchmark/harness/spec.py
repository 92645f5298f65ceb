"""Finding a cell and what belongs to it, by name, from files.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics.  Everything else is found by name:

- a configuration's file is the ``file`` its entry gives (under
  ``benchmark/configs/``);
- a traffic mix is ``benchmark/traffic/<traffic>.json``;
- the limits of a cell's comparison are ``benchmark/limits/<cell>.json``;
- a per-layer metric's reader is ``benchmark/metrics/<name>.py``, with
  ``.`` and ``-`` in the name read as ``_``;
- a scene is ``benchmark/reference/scenes/<scene>.py`` and a shader's
  reference ``benchmark/reference/shaders/<shader>.py``.

So a later cell, mix, configuration or metric is new files and new
entries, and no edit of a file that is there.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class SpecError(ValueError):
    """The benchmark's files do not say what a run needs."""


def load(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SpecError(f"no workload {workload!r} in BENCHMARK.json; there are {[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _read_json(ROOT / c["file"], f"configuration {name!r}")
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _read_json(BENCH_DIR / "traffic" / f"{name}.json", f"traffic mix {name!r}")


def limits(workload: str) -> dict:
    """{number name: limit} of the cell's comparison."""
    return _read_json(BENCH_DIR / "limits" / f"{workload}.json", f"limits of {workload!r}")["limits"]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones in an
    untraced run, the per-layer ones in a traced run.  A per-layer metric
    without a ``workloads`` key is reported where the end-to-end metric it
    moves is."""
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if applies(m, workload) and ("workloads" in m or m["moves"] in reported)]


def reader(name: str):
    """The module that reads per-layer metric ``name``."""
    module = re.sub(r"[.-]", "_", name)
    if not (BENCH_DIR / "metrics" / f"{module}.py").is_file():
        raise SpecError(f"per-layer metric {name!r} has no reader benchmark/metrics/{module}.py")
    return importlib.import_module(f"benchmark.metrics.{module}")


def check_names(bench: dict) -> list[str]:
    """Every breach of the naming rules in ``bench``: names, configs,
    traffic mixes and reduced keys of at most 64 letters, digits, ``_``,
    ``.`` and ``-`` (not starting with ``.`` or ``-``), and units of 1 to
    16 letters, digits, ``_``, ``/``, ``%``, ``.`` and ``-``."""
    bad = []

    def name(v, where):
        if not isinstance(v, str) or not NAME.fullmatch(v):
            bad.append(f"{where}: {v!r}")

    for c in bench["configs"]:
        name(c["name"], "config name")
        for k in c["reduced"]:
            name(k, f"reduced key of {c['name']}")
    for w in bench["workloads"]:
        name(w["name"], "workload name")
        name(w["config"], f"config of {w['name']}")
        name(w["traffic"], f"traffic of {w['name']}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name(m["name"], "metric name")
        if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
            bad.append(f"unit of {m['name']}: {m['unit']!r}")
    return bad
