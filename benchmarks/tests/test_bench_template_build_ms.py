"""The reader of the set-up's template_build span: the hand-computed value
on a hand-made run, and nothing where the program has no such span or
count (as before it had them)."""

import json
import os

import pytest

import tiny
from harness.runner import load_module


def _read(ctx):
    return load_module(os.path.join(tiny.BENCH, "metrics",
                                    "template_build_ms.setup.py")).read(ctx)


def test_template_build_ms():
    """The set-up's template_build seconds over its builds, in ms."""
    timers = {"template_build": 12.0, "n:template_builds": 8000,
              "host_template_prep": 20.0}
    assert _read({"setup_timers": timers}) == pytest.approx(1.5, rel=1e-12)


@pytest.mark.parametrize("timers", [
    {"host_template_prep": 20.0},
    {"template_build": 12.0},
    {"template_build": 0.0, "n:template_builds": 0},
])
def test_template_build_ms_absent(timers):
    assert _read({"setup_timers": timers}) is None


def test_manifest_lists_template_build_ms():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        m = {m["name"]: m for m in json.load(f)["per_layer"]}[
            "template_build_ms.setup"]
    assert m["workloads"] == ["pdb70.hhpred"]
    assert (m["moves"], m["layer"]) == ("setup_s", "template prep")
