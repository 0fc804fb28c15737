"""Profiler hooks for the search stages.

* ``annotate(name)`` — a ``torch.profiler.record_function`` range (an
  NVTX range as well when a card is in use) around the search funnel's
  stages, so host phases and kernels line up in one timeline.
* stage timers — ``enable_stage_timers()`` accumulates wall time per
  annotated stage (and per ``stage_add`` call) into a dict.  The search
  also counts two events there: ``funnel_blocks`` (blocks the score
  sweep filtered) and ``funnel_dropped`` (searches whose funnel switched
  itself off after a block that kept >= 90% of its templates).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time

import torch


# wall-clock accumulation per annotated stage (enabled by
# enable_stage_timers(); read by chip_smoke.py for the host/device split)
_STAGE_TIMERS: dict | None = None


def enable_stage_timers() -> dict:
    """Start accumulating per-stage wall time; returns the live dict
    (stage name -> seconds)."""
    global _STAGE_TIMERS
    _STAGE_TIMERS = {}
    return _STAGE_TIMERS


def disable_stage_timers() -> None:
    global _STAGE_TIMERS
    _STAGE_TIMERS = None


def stage_add(name: str, seconds: float) -> None:
    """Accumulate ``seconds`` under ``name`` in the live stage-timer
    dict (no-op when timers are off)."""
    timers = _STAGE_TIMERS
    if timers is not None:
        timers[name] = timers.get(name, 0.0) + seconds


@contextlib.contextmanager
def annotate(name: str):
    """Named span in the profiler timeline (record_function, plus an
    NVTX range when CUDA is initialised)."""
    timers = _STAGE_TIMERS
    t0 = time.perf_counter() if timers is not None else 0.0
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if timers is not None:
            timers[name] = (timers.get(name, 0.0)
                            + time.perf_counter() - t0)


@contextlib.contextmanager
def gc_paused():
    """Pause the cyclic garbage collector for a search's hot loop (a
    query allocates ~15k Hit objects plus numpy views; generational GC
    otherwise fires mid-search).  Re-entrant and exception-safe, and a
    no-op if the collector was already disabled by the caller."""
    was_enabled = gc.isenabled()
    if was_enabled:
        gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def gc_paused_fn(fn):
    """Decorator form of `gc_paused` for the search entry points."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with gc_paused():
            return fn(*args, **kwargs)
    return wrapper
