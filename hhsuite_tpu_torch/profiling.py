"""Profiler hooks for the search stages: spans, stage timers, counters.

* ``HHSUITE_TPU_TORCH_PROFILE=<dir>`` — every CLI command runs inside
  ``trace_if_enabled()``: a ``torch.profiler`` trace of the CPU and (when
  a card is present) CUDA activity on every thread of the process,
  written into <dir> as a Chrome trace (``trace-<pid>-<ns>.json``; open
  it in Perfetto or chrome://tracing).  Host spans and kernels share one
  clock.
* ``annotate(name)`` — the one way to time a stage: a span.  Each thread
  keeps its own stack of open spans.  While a profiler runs, a span is a
  record-function range whose arguments are (request id, span id, parent
  span id), shown as the event's "Concrete Inputs" in a trace taken with
  ``record_shapes`` (``trace_if_enabled`` takes one so); an NVTX range
  as well when CUDA is initialised.  With no profiler and no stage
  timers a span costs a flag test.
* ``request(kind)`` — a top-level span, ``<kind>_query``, that gives the
  thread a fresh request id: every span opened below it carries that id,
  so one query's spans can be picked out of concurrent clients.
* stage timers — ``enable_stage_timers()`` returns the dict where
  closing spans add, under one lock, their wall seconds (``name``),
  their wall seconds less those of their direct children
  (``name:self``) and the thread's CPU seconds in them (``name:cpu``).
  ``stage_add`` adds counts there, under ``n:<name>``, one call a
  launch or a block: the funnel's ``n:funnel_*``, the backtrace
  launches' lanes and cells (``n:bt_*.<variant>``),
  ``n:kernel_builds``.  :func:`held` adds the seconds spent waiting
  for a shared lock (``lock_wait``) and the waits (``n:lock_waits``).
  So a key with no colon holds seconds (:func:`wall_seconds`).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# a record-function range whose arguments are integers
from torch._C._autograd import (_record_function_with_args_enter as _rf_enter,
                                _record_function_with_args_exit as _rf_exit)

PROFILE_ENV = "HHSUITE_TPU_TORCH_PROFILE"


def profile_dir() -> str | None:
    """The trace directory named by ``HHSUITE_TPU_TORCH_PROFILE``, or
    None when the variable is unset or empty."""
    d = os.environ.get(PROFILE_ENV, "").strip()
    return d or None


def _all_threads_config():
    """A profiler configuration that records every thread's host events
    (``profile_all_threads``), or None where this torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace_if_enabled():
    """Trace the enclosed block with ``torch.profiler`` (CPU and CUDA
    activities, every thread, span ids as record-function inputs) into
    :func:`profile_dir` when it is set; a no-op otherwise."""
    d = profile_dir()
    if not d:
        yield
        return
    os.makedirs(d, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    cfg = _all_threads_config()
    kw = {} if cfg is None else {"experimental_config": cfg}
    with torch.profiler.profile(activities=acts, record_shapes=True,
                                **kw) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        d, f"trace-{os.getpid()}-{time.time_ns()}.json"))


# the live stage-timer dict (enable_stage_timers()); every write to it
# holds _LOCK
_STAGE_TIMERS: dict | None = None
_LOCK = threading.Lock()
# the prefix of a count's key: a key with no colon holds seconds
COUNT = "n:"
# per thread: the stack of open spans and the current request id
_LOCAL = threading.local()
_REQUEST_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)
# the clocks a span reads (tests inject their own)
_clock = time.perf_counter
_cpu_clock = time.thread_time_ns
_cuda_initialized = torch.cuda.is_initialized


def enable_stage_timers() -> dict:
    """Start accumulating per-stage seconds and counts; returns the live
    dict (key -> seconds or count).  Read it under no lock: copy it with
    ``dict(...)`` once the work is done."""
    global _STAGE_TIMERS
    _STAGE_TIMERS = {}
    return _STAGE_TIMERS


def disable_stage_timers() -> None:
    global _STAGE_TIMERS
    _STAGE_TIMERS = None


def wall_seconds(timers: dict) -> dict:
    """The entries of a stage-timer dict that are a span's wall seconds
    or a lock's wait (``lock_wait``): the keys with no colon."""
    return {k: v for k, v in timers.items() if ":" not in k}


def stage_add(name, value=1) -> None:
    """Add the count ``value`` under ``"n:" + name`` in the live
    stage-timer dict; with a dict for ``name``, add each of its
    (name, count) so under one acquisition of the lock.  A no-op when
    timers are off."""
    timers = _STAGE_TIMERS
    if timers is None:
        return
    counts = name if isinstance(name, dict) else {name: value}
    with _LOCK:
        for key, n in counts.items():
            key = COUNT + key
            timers[key] = timers.get(key, 0) + n


class _Thread:
    """A thread's spans: the stack of open ones and the request id."""

    __slots__ = ("stack", "request")

    def __init__(self):
        self.stack: list = []
        self.request = 0


def _thread() -> _Thread:
    try:
        return _LOCAL.t
    except AttributeError:
        _LOCAL.t = _Thread()
        return _LOCAL.t


class annotate:
    """Named span (a context manager): see the module's docstring."""

    __slots__ = ("name", "_timers", "_t0", "_cpu0", "_child", "_rf",
                 "_nvtx", "_th", "_sid")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        timers = self._timers = _STAGE_TIMERS
        prof = _autograd_profiler._is_profiler_enabled
        nvtx = self._nvtx = _cuda_initialized()
        if nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if timers is None and not prof:
            self._th = None
            return self
        th = self._th = _thread()
        stack = th.stack
        self._child = 0.0
        if prof:
            self._sid = sid = next(_SPAN_IDS)
            self._rf = _rf_enter(self.name, th.request, sid,
                                 stack[-1]._sid if stack else 0)
        else:
            self._sid = 0
            self._rf = None
        stack.append(self)
        if timers is not None:      # the CPU interval inside the wall one
            self._t0 = _clock()
            self._cpu0 = _cpu_clock()
        return self

    def __exit__(self, *exc):
        th = self._th
        if th is not None:
            timers = self._timers
            if timers is not None:
                cpu = (_cpu_clock() - self._cpu0) * 1e-9
                wall = _clock() - self._t0
            stack = th.stack
            if stack[-1] is self:
                stack.pop()
            else:     # a span closed out of order
                stack.remove(self)
            if self._rf is not None:
                _rf_exit(self._rf)
            if timers is not None:
                if stack:
                    stack[-1]._child += wall
                name = self.name
                k_self, k_cpu = name + ":self", name + ":cpu"
                with _LOCK:
                    get = timers.get
                    timers[name] = get(name, 0.0) + wall
                    timers[k_self] = get(k_self, 0.0) + wall - self._child
                    timers[k_cpu] = get(k_cpu, 0.0) + cpu
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def annotated(name: str):
    """Decorator: the function's calls are :class:`annotate` spans."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def request(kind: str):
    """One query: the span ``<kind>_query`` under a fresh request id,
    which every span the thread opens inside it carries; yields the
    id."""
    th = _thread()
    rid, prev = next(_REQUEST_IDS), th.request
    th.request = rid
    try:
        with annotate(kind + "_query"):
            yield rid
    finally:
        th.request = prev


@contextlib.contextmanager
def held(lock):
    """Hold ``lock`` (a shared lock of concurrent queries).  With timers
    on, a wait for it is counted (``n:lock_waits``) and its seconds go
    under ``lock_wait``; a free lock writes nothing."""
    timers = _STAGE_TIMERS
    if timers is None:
        lock.acquire()
    elif not lock.acquire(blocking=False):
        t0 = _clock()
        lock.acquire()
        wait = _clock() - t0
        with _LOCK:
            timers["lock_wait"] = timers.get("lock_wait", 0.0) + wait
            key = COUNT + "lock_waits"
            timers[key] = timers.get(key, 0) + 1
    try:
        yield
    finally:
        lock.release()


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
