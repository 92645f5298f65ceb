"""The port's own copy of the numpy oracle, and chip_smoke.py's independence.

``based_renderer_tpu_torch/reference/oracle.py`` is a copy of the JAX
package's numpy oracle, so that neither the port nor ``chip_smoke.py``
loads a module of the JAX package.  Its ``rasterize`` and
``rasterize_msaa4`` must return what the original returns, bit for bit.
"""

import ast
import pathlib
import re

import numpy as np
import pytest

from based_renderer_tpu.reference import oracle as joracle
from based_renderer_tpu_torch.reference import oracle as toracle

ROOT = pathlib.Path(__file__).resolve().parents[1]


def random_clip(seed, n=20):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(-0.2, 1.2, size=(n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], -1).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(depth_compare="greater", depth_clear=0.0),
        dict(depth_clip="clamp", cull_mode="back"),
        dict(depth_clip=False, depth_compare="less_equal", front_face="cw", cull_mode="front"),
    ],
)
@pytest.mark.parametrize("fn", ["rasterize", "rasterize_msaa4"])
def test_copy_equals_the_jax_oracle(fn, kw):
    clip = random_clip(len(str(kw)) + len(fn))
    got = getattr(toracle, fn)(clip, 80, 48, **kw)
    want = getattr(joracle, fn)(clip, 80, 48, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["tri_id"] >= 0).any()


def test_copy_is_the_original_below_its_docstring():
    def body(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]  # drop the module docstring
        return ast.dump(tree)

    assert body(ROOT / "based_renderer_tpu_torch/reference/oracle.py") == body(
        ROOT / "based_renderer_tpu/reference/oracle.py"
    )


def _loads_nothing_of_the_jax_package(name: str) -> str:
    """Assert that the script ``name`` imports and opens nothing of
    based_renderer_tpu/ or JAX; return its source."""
    src = (ROOT / name).read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            top = name.split(".")[0]
            assert top not in ("based_renderer_tpu", "jax", "jaxlib", "importlib", "runpy"), name
        if isinstance(node, ast.Name):
            assert node.id not in ("exec", "eval", "__import__"), node.id
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in re.finditer(r"based_renderer_tpu(?!_torch)\S*", node.value):
                assert re.fullmatch(r"based_renderer_tpu/ops/\w+\.py:\d+", m.group(0)), m.group(0)
    assert "spec_from_file_location" not in src
    return src


def test_chip_smoke_loads_nothing_of_the_jax_package():
    """chip_smoke.py imports and opens nothing of based_renderer_tpu/: no
    import of it, no dynamic loading, no path into it.  The only mentions
    allowed are the file:line citations of the TPU kernels each CUDA kernel
    replaces (the ``replaces`` field of its kernels line)."""
    src = _loads_nothing_of_the_jax_package("chip_smoke.py")
    assert "reference.oracle" in src or "reference import oracle" in src


@pytest.mark.parametrize("name", ["compare_sublane.py", "compare_assemble.py"])
def test_compare_scripts_load_nothing_of_the_jax_package(name):
    """The on-card comparisons of kernel builds run without JAX, as
    chip_smoke.py does."""
    _loads_nothing_of_the_jax_package(name)
