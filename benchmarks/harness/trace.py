"""The traced run: torch.profiler (CPU and CUDA activity) over the
window and its drain, reduced to device busy time, device time by
kernel, and idle gaps labelled by the program's host spans."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple


# idle gaps shorter than this are summed unlabelled; a labelled gap looks
# at the SPAN_SCAN host spans that started last before its end
SHORT_GAP_NS = 1_000_000
SPAN_SCAN = 4000
# device activity that is work on the card (not the runtime calls or the
# device-side ranges of host annotations, which the trace also holds)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)


def union_length(iv: List[Tuple[int, int]]
                 ) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of a union of [start, end) intervals, and the union."""
    total, merged = 0, []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                total += e - merged[-1][1]
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
            total += e - s
    return total, merged


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.window_s = None

    def start(self) -> None:
        if not self.on:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """busy_s, window_s, device seconds and launches by kernel, and
        the breakdown the result line carries."""
        import sys

        events = self.prof.profiler.kineto_results.events()
        dev, spans = [], []
        kinds: Dict[str, int] = defaultdict(int)
        for ev in events:
            s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if "CUDA" in str(ev.device_type()):
                # torch 2.11's events carry no activity kind
                kind = (str(ev.activity_type())
                        if hasattr(ev, "activity_type") else "")
                kinds[kind] += 1
                if kind in DEVICE_WORK or not kind:
                    dev.append((s, e, ev.name()))
            elif ev.is_user_annotation():
                spans.append((s, e, ev.name()))
        # where the trace gives no activity kind, the device-side ranges
        # of host annotations carry the annotations' names
        names = {n for _s, _e, n in spans}
        dev = [x for x in dev if x[2] not in names]
        by_kernel: Dict[str, float] = defaultdict(float)
        launches: Dict[str, int] = defaultdict(int)
        for s, e, n in dev:
            k = short_name(n)
            by_kernel[k] += (e - s) * 1e-9
            launches[k] += 1
        print(f"trace: device events by kind {dict(kinds)}, "
              f"{len(spans)} host spans", file=sys.stderr)
        busy_ns, merged = union_length([(s, e) for s, e, _n in dev])
        gaps = self._gaps(merged, dev, spans)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy_ns * 1e-9,
            "window_s": self.window_s,
            "kernels": dict(by_kernel),
            "launches": dict(launches),
            "breakdown": {
                "device_ops": [[n, v] for n, v in top],
                "idle_gaps": gaps,
            },
        }

    @staticmethod
    def _gaps(merged, dev, spans) -> list:
        """Idle time between device activity, summed by the host span
        that overlaps each gap most (the program's annotated stages, as
        the profiler records them on the calling thread: client 0's),
        the ten largest."""
        if not dev:
            return []
        lo = min(min(s for s, _e, _n in dev),
                 min((s for s, _e, _n in spans), default=dev[0][0]))
        hi = max(max(e for _s, e, _n in dev),
                 max((e for _s, e, _n in spans), default=dev[0][1]))
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        import bisect

        spans = sorted(spans)
        starts = [s for s, _e, _n in spans]
        by_label: Dict[str, float] = defaultdict(float)
        for gs, ge in gaps:
            if ge - gs < SHORT_GAP_NS:
                by_label["(gaps under 1 ms)"] += (ge - gs) * 1e-9
                continue
            best, label = (0, 0), "(no host span)"
            hi = bisect.bisect_left(starts, ge)
            for s, e, n in spans[max(0, hi - SPAN_SCAN): hi]:
                # the span that covers most of the gap; of equals, the
                # innermost (shortest)
                key = (min(e, ge) - max(s, gs), s - e)
                if key[0] > 0 and key > best:
                    best, label = key, n
            by_label[label] += (ge - gs) * 1e-9
        return [[n, v] for n, v in
                sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
