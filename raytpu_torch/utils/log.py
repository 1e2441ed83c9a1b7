"""The port's own copy of ``raytpu/utils/log.py`` (the port imports nothing
of ``raytpu``).

Structured, severity-colored logging: the analog of the reference's
ANSI-colored Vulkan debug callback (``src/main.cpp:18-23,112-136``):
verbose/info to stdout, warning/error to stderr with color, plus the
fail-fast :func:`fail` mirroring ``throwExceptionVulkanAPI``
(``src/main.cpp:138-147``).
"""

from __future__ import annotations

import sys
import time
from typing import NoReturn

RESET = "\033[0m"
COLORS = {
    "verbose": "\033[90m",  # gray
    "info": "\033[37m",     # white
    "warning": "\033[33m",  # yellow
    "error": "\033[31m",    # red
}
_LEVELS = {"verbose": 0, "info": 1, "warning": 2, "error": 3}

_min_level = "info"


def set_level(level: str) -> None:
    global _min_level
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level!r}")
    _min_level = level


def _emit(level: str, msg: str) -> None:
    if _LEVELS[level] < _LEVELS[_min_level]:
        return
    stream = sys.stderr if level in ("warning", "error") else sys.stdout
    ts = time.strftime("%H:%M:%S")
    stream.write(f"{COLORS[level]}[{ts} raytpu_torch {level}] {msg}{RESET}\n")
    stream.flush()


def verbose(msg: str) -> None:
    _emit("verbose", msg)


def info(msg: str) -> None:
    _emit("info", msg)


def warning(msg: str) -> None:
    _emit("warning", msg)


def error(msg: str) -> None:
    _emit("error", msg)


class RaytpuError(RuntimeError):
    """Fail-fast renderer error (``throwExceptionVulkanAPI`` analog)."""


def fail(msg: str) -> NoReturn:
    error(msg)
    raise RaytpuError(msg)
