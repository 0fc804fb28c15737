"""Stream logger with the reference's verbosity levels.

Mirrors src/log.h:18-132: levels ERROR..DEBUG4 selected by the ``-v``
flag (default INFO, src/hhdecl.cpp:8), messages to stderr prefixed
``- <time> LEVEL:``.  Progress lines in the search drivers ("HMMs passed
2nd prefilter", hhprefilter.cpp:508-606 style) go through INFO.
"""

from __future__ import annotations

import sys
import time

ERROR, WARNING, INFO, DEBUG, DEBUG1, DEBUG2, DEBUG3, DEBUG4 = range(8)

_NAMES = ["ERROR", "WARNING", "INFO", "DEBUG",
          "DEBUG1", "DEBUG2", "DEBUG3", "DEBUG4"]

_reporting_level = INFO


def set_level(v: int) -> None:
    """Log::from_int (src/log.h:86-108): clamp to [ERROR, DEBUG4]."""
    global _reporting_level
    _reporting_level = max(ERROR, min(DEBUG4, int(v)))


def get_level() -> int:
    return _reporting_level


def log(level: int, msg: str) -> None:
    """HH_LOG(level) << msg (src/log.h:110-115): drop if above the
    reporting level, else stderr with timestamp prefix."""
    if level > _reporting_level:
        return
    now = time.strftime("%H:%M:%S", time.localtime())
    indent = "\t" * (level - DEBUG if level > DEBUG else 0)
    print(f"- {now} {_NAMES[level]}: {indent}{msg}",
          file=sys.stderr, flush=True)


def error(msg: str) -> None:
    log(ERROR, msg)


def warning(msg: str) -> None:
    log(WARNING, msg)


def info(msg: str) -> None:
    log(INFO, msg)


def debug(msg: str) -> None:
    log(DEBUG, msg)
