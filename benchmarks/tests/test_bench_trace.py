"""The trace's reduction: device work is kernels, copies and sets, not the
device-side ranges of host annotations, whether or not the events carry
an activity kind (torch 2.11's do not)."""

import types

import pytest

import tiny  # noqa: F401
from harness.trace import Tracer, short_name, union_length


class Event:
    def __init__(self, name, start, dur, device, kind=None, user=False):
        self._v = (name, start, dur, device, user)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _tracer(events):
    t = Tracer(True)
    t.window_s = 1.0
    res = types.SimpleNamespace(events=lambda: events)
    t.prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))
    return t


@pytest.mark.parametrize("kinds", [True, False], ids=["kinds", "no-kinds"])
def test_reduce(kinds):
    k = (lambda x: x) if kinds else (lambda x: None)
    ev = [
        Event("host_realign", 0, 10_000_000, "CPU", user=True),
        Event("host_realign", 0, 9_000_000, "CUDA", k("gpu_user_annotation")),
        Event("void (anonymous namespace)::vit_score_kernel<false, 2, 8>"
              "(float const*)", 1_000_000, 2_000_000, "CUDA", k("kernel")),
        Event("Memcpy HtoD (Pageable -> Device)", 5_000_000, 1_000_000,
              "CUDA", k("gpu_memcpy")),
    ]
    if kinds:
        ev.append(Event("cudaLaunchKernel", 0, 8_000_000, "CUDA",
                        "cuda_runtime"))
    out = _tracer(ev).reduce()
    assert out["busy_s"] == pytest.approx(0.003)
    assert set(out["kernels"]) == {
        "(anonymous namespace)::vit_score_kernel<false, 2, 8>",
        "Memcpy HtoD "}
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["host_realign"] == pytest.approx(0.007)


def test_helpers():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == (4, [(0, 3), (5, 6)])
    assert short_name("void k<a<b>, 2>(int, float)") == "k<a<b>, 2>"
