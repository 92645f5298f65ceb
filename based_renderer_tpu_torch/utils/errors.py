"""Typed error taxonomy (the analog of the reference's exception ladder).

The reference maps every failure class to a typed exception surfaced via a
~165-line catch ladder in WinMain (reference src/main.cpp:613-779:
one catch per vk:: error plus the std exception families, each producing a
titled message box).  Here the same idea is a small exception hierarchy
plus ``format_error`` stamping function/line like the reference's
FORMAT_ERROR macro (main.cpp:28-29), and ``main_guard`` as the catch-all
entry-point wrapper for demo drivers.
"""

from __future__ import annotations

import inspect
import sys
import traceback


class RendererError(Exception):
    """Base class for all renderer failures."""


class DeviceError(RendererError):
    """Device discovery/initialization failed (the analog of the
    vk::createInstance / enumeratePhysicalDevices failure paths)."""


class FeatureNotPresentError(DeviceError):
    """A required backend capability is missing (main.cpp:1114-1117)."""


class AllocationError(RendererError):
    """Buffer pool / framebuffer allocation failed (vulkan_allocate analog)."""


class ShaderError(RendererError, KeyError):
    """Shader lookup or tracing failed (SLANG_CHECK analog, main.cpp:586-606).

    Also a KeyError: registry lookups are dictionary semantics."""


class FrameError(RendererError):
    """Frame-loop misuse or invalid frame output."""


class DrawError(RendererError):
    """Invalid draw call (missing attributes, bad shapes)."""


class PresentError(RendererError):
    """Present/readback failure (the vk::PresentKHR error family analog)."""


def format_error(msg: str) -> str:
    """Stamp the caller's function and line, like FORMAT_ERROR."""
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    if caller is None:
        return msg
    return f"{caller.f_code.co_name}:{caller.f_lineno}: {msg}"


def main_guard(fn, *args, **kwargs):
    """Run a demo entry point, mapping failures to titled stderr reports
    (the WinMain catch-ladder analog; message boxes become stderr)."""
    try:
        return fn(*args, **kwargs)
    except RendererError as e:
        print(f"[{type(e).__name__}] {e}", file=sys.stderr)
        raise SystemExit(1)
    except Exception as e:  # the std::exception catch-all (main.cpp:760-776)
        traceback.print_exc()
        print(f"[UnhandledError] {type(e).__name__}: {e}", file=sys.stderr)
        raise SystemExit(2)
