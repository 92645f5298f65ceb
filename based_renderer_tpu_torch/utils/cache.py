"""Persistent build cache (the on-disk pipeline-cache analog).

The JAX package enables JAX's persistent compilation cache here.  The
port compiles two things that outlive a process: the CUDA kernel library
(``ops/_build.py``) and the native host runtime (``runtime``).  Each is
kept on disk under a name hashed from its sources and flags, so a later
process reuses it.  ``enable_persistent_cache`` points both at one
directory.  Frames themselves are not cached: a captured CUDA graph does
not survive its process.
"""

from __future__ import annotations

import os
from pathlib import Path

from .. import runtime
from ..ops import _build

#: The checkout's ``build/`` directory, where both caches live by default.
DEFAULT_DIR = str(_build.BUILD_DIR.parent)


def enable_persistent_cache(directory: str | None = None) -> str:
    """Keep the kernel library in ``<directory>/torch_kernels`` and the
    native runtime in ``<directory>/torch_runtime`` for every later build
    of this process; returns the directory.  A library a process has
    already loaded stays loaded."""
    directory = os.path.abspath(directory or DEFAULT_DIR)
    os.makedirs(directory, exist_ok=True)
    _build.BUILD_DIR = Path(directory) / "torch_kernels"
    runtime.BUILD_DIR = Path(directory) / "torch_runtime"
    return directory
