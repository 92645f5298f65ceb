"""The import rule: nothing the benchmark runs loads JAX or the JAX package.

Modules are compared by their whole top-level name, the part before the
first dot: ``based_renderer_tpu_torch`` (the port, which is measured)
begins with ``based_renderer_tpu`` (the JAX package, which is not) and is
not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "based_renderer_tpu"})


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names among ``modules`` (default ``sys.modules``)
    that the rule forbids."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)


def keep_jax_out(environ) -> None:
    """Ask libraries that load JAX on their own not to (``transformers``
    reads USE_FLAX)."""
    environ.setdefault("USE_FLAX", "0")
    environ.setdefault("USE_JAX", "0")
