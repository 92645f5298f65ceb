"""Debug logging (the ``dprint`` / debug-utils-messenger analog).

The reference prints every Vulkan debug message to the Windows debug
console via dprint (reference src/main.cpp:33-47, 138-151).  Here a
standard logger with the same role: chatty in debug, silent in release.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("based_renderer_tpu")


def configure(debug: bool = False):
    level = logging.DEBUG if debug or os.environ.get("BRT_DEBUG") else logging.WARNING
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[brt %(levelname).1s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)


def dprint(msg: str, *args):
    logger.debug(msg, *args)
