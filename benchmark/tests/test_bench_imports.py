"""The import rule, by whole top-level module names: nothing the benchmark
runs loads JAX or the JAX package (``based_renderer_tpu``), and the plain
reference loads nothing of the program (``based_renderer_tpu_torch``)."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.harness import guard, spec

PY_FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("name, forbidden", [
    ("based_renderer_tpu", True), ("based_renderer_tpu.ops.raster_pallas", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("based_renderer_tpu_torch", False), ("based_renderer_tpu_torch.renderer", False), ("jaxtyping", False),
    ("torch", False), ("based_renderer_tpu2", False),
])
def test_forbidden_by_whole_top_level_name(name, forbidden):
    assert (guard.forbidden_loaded([name]) != []) == forbidden


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_names_a_forbidden_module():
    for path in PY_FILES:
        assert guard.forbidden_loaded(list(_imports(path))) == [], path


def test_the_reference_names_nothing_of_the_program():
    for path in sorted((spec.BENCH_DIR / "reference").rglob("*.py")):
        assert all(guard.top_level(m) != "based_renderer_tpu_torch" for m in _imports(path)), path


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_loading_the_harness_and_the_program_loads_no_jax():
    mods = _loaded_after("import benchmark.run, benchmark.calibrate\n"
                         "from benchmark.harness import core, loops, compare, trace, work\n"
                         "import based_renderer_tpu_torch.renderer, based_renderer_tpu_torch.present, "
                         "based_renderer_tpu_torch.models.demos")
    assert guard.forbidden_loaded(mods) == []
    assert "based_renderer_tpu_torch" in {guard.top_level(m) for m in mods}


def test_loading_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import benchmark.reference.render, benchmark.reference.oracle\n"
                         "from benchmark.reference.scenes import spinning_cube, procedural_mesh\n"
                         "from benchmark.reference.shaders import vertex_color, blinn_phong")
    tops = {guard.top_level(m) for m in mods}
    assert "based_renderer_tpu_torch" not in tops and not (tops & guard.FORBIDDEN)
