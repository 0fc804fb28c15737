"""What the metric readers share: a run's rate, per-query spans, its
latency tail, the device's idle share and a kernel's roofline share.
Each returns None where the run has nothing to read."""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np


def rate(ctx) -> Optional[float]:
    """Queries that completed in the window over the time from its start
    to the last completion inside it."""
    done = ctx["done"]
    if not done:
        return None
    return len(done) / (max(r["te"] for r in done) - ctx["window_start"])


def latency_p95(ctx) -> Optional[float]:
    """95th percentile of the seconds of every query completed in the
    window."""
    lat = [r["te"] - r["ts"] for r in ctx["done"]]
    return float(np.percentile(lat, 95)) if lat else None


def span_per_query(ctx, span: str) -> Optional[float]:
    """A program span's seconds over the window and its drain, summed
    over the client threads, per query run in that time."""
    n = len(ctx["all"])
    if not n or span not in ctx["timers"]:
        return None
    return ctx["timers"][span] / n


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced time in which no operation ran on the
    device."""
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(ctx, count: str) -> Optional[float]:
    """Percent of a kernel's traced device time that the chip's published
    peak needs for the work of the traced queries: the larger of
    operations over the peak rate and bytes over the peak bandwidth,
    over the kernel's time.  ``count`` names the kernel's work count in
    rooflines/."""
    tr = ctx["trace"]
    if tr is None:
        return None
    bench = ctx["bench_dir"]
    mod = ctx["load_module"](os.path.join(bench, "rooflines", count + ".py"))
    with open(os.path.join(bench, "rooflines", "peaks.json")) as f:
        peaks = json.load(f)
    pat = re.compile(mod.KERNEL)
    seconds = sum(v for k, v in tr["kernels"].items() if pat.search(k))
    ok = [r for r in ctx["all"] if "error" not in r]
    if not seconds or not ok:
        return None
    ops = nbytes = 0.0
    for r in ok:
        o, b = mod.work(r["length"], ctx["db"], ctx["config"],
                        ctx["traffic"])
        ops += o
        nbytes += b
    least = max(ops / peaks[mod.PEAK], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
