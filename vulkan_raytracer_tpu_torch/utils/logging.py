"""ANSI log lines and progress bars, as ``vulkan_raytracer_tpu/utils/logging.py``
prints them (reference: src/logging.cpp), with the level filter of the
VKRT_LOG_LEVEL environment variable."""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}
_LEVEL = _LEVELS.get(os.environ.get("VKRT_LOG_LEVEL", "INFO").upper(), 20)

_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_RED = "\x1b[31m"
_RESET = "\x1b[0m"


def _log(level: str, colour: str, fmt: str, *args) -> None:
    if _LEVELS[level] < _LEVEL:
        return
    msg = fmt % args if args else fmt
    stream = sys.stderr if level == "ERROR" else sys.stdout
    print(f"{colour}[{level}]{_RESET} {msg}", file=stream, flush=True)


def debug(fmt: str, *args) -> None:
    _log("DEBUG", _GREEN, fmt, *args)


def info(fmt: str, *args) -> None:
    _log("INFO", _GREEN, fmt, *args)


def warn(fmt: str, *args) -> None:
    _log("WARN", _YELLOW, fmt, *args)


def error(fmt: str, *args) -> None:
    _log("ERROR", _RED, fmt, *args)


def progress_bar(current: int, total: int, width: int = 20, text: str = "") -> None:
    """In-place ANSI progress bar (logging.cpp:3-18 equivalent)."""
    if _LEVEL > 20 or total <= 0:
        return
    frac = min(max(current / total, 0.0), 1.0)
    filled = int(frac * width)
    bar = "#" * filled + "-" * (width - filled)
    end = "\n" if current >= total else "\r"
    print(f"[{bar}] {current}/{total} {text}\x1b[K", end=end, flush=True)


class Timer:
    """Wall-clock scope timer for set-up phases (application.cpp:367,402)."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        info("%s took %.3fs", self.label, time.perf_counter() - self.t0)
