"""Profiler hooks for the search stages.

* ``HHSUITE_TPU_TORCH_PROFILE=<dir>`` — every CLI command runs inside
  ``trace_if_enabled()``: a ``torch.profiler`` trace of the CPU and (when
  a card is present) CUDA activity, written into <dir> as a Chrome trace
  (``trace-<pid>-<ns>.json``; open it in Perfetto or chrome://tracing).
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
import os
import threading
import time

import torch

PROFILE_ENV = "HHSUITE_TPU_TORCH_PROFILE"


def profile_dir() -> str | None:
    """The trace directory named by ``HHSUITE_TPU_TORCH_PROFILE``, or
    None when the variable is unset or empty."""
    d = os.environ.get(PROFILE_ENV, "").strip()
    return d or None


@contextlib.contextmanager
def trace_if_enabled():
    """Trace the enclosed block with ``torch.profiler`` (CPU and CUDA
    activities) into :func:`profile_dir` when it is set; a no-op
    otherwise."""
    d = profile_dir()
    if not d:
        yield
        return
    os.makedirs(d, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        d, f"trace-{os.getpid()}-{time.time_ns()}.json"))


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


# gc_paused nesting across threads: the collector is process-wide, so
# concurrent searches (tools/batch.py's worker threads) count their
# pauses under one lock; the first entry disables it, the last exit
# restores what the first entry found
_GC_LOCK = threading.Lock()
_GC_DEPTH = 0
_GC_RESTORE = False


@contextlib.contextmanager
def gc_paused():
    """Pause the cyclic garbage collector for a search's hot loop (a
    query allocates ~15k Hit objects plus numpy views; generational GC
    otherwise fires mid-search).  Re-entrant, safe across threads and
    exceptions: the collector stays off until the last open pause of
    any thread closes, and is re-enabled only if it was on when the
    first one opened."""
    global _GC_DEPTH, _GC_RESTORE
    with _GC_LOCK:
        if _GC_DEPTH == 0:
            _GC_RESTORE = gc.isenabled()
            gc.disable()
        _GC_DEPTH += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_DEPTH -= 1
            if _GC_DEPTH == 0 and _GC_RESTORE:
                gc.enable()


def gc_paused_fn(fn):
    """Decorator form of `gc_paused` for the search entry points."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with gc_paused():
            return fn(*args, **kwargs)
    return wrapper
