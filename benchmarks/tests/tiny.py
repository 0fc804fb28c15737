"""A copy of the benchmark at a size a CPU test run can hold: the same
BENCHMARK.json, traffic mixes, metrics and work counts, with each
configuration's database cut down."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the database of each configuration at test size
TINY_DB = {"pdb70": {"families": 2, "members_per_family": 16, "L0": 80}}


def make_root(tmp: str) -> str:
    """A root under ``tmp`` holding BENCHMARK.json and benchmarks/ with
    the data files; returns the root."""
    root = os.path.join(tmp, "root")
    bench = os.path.join(root, "benchmarks")
    os.makedirs(bench)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for d in ("traffic", "metrics", "rooflines"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(bench, d))
    os.makedirs(os.path.join(bench, "configs"))
    for name in os.listdir(os.path.join(BENCH, "configs")):
        with open(os.path.join(BENCH, "configs", name)) as f:
            cfg = json.load(f)
        cfg["db"].update(TINY_DB.get(cfg["name"], {}))
        with open(os.path.join(bench, "configs", name), "w") as f:
            json.dump(cfg, f)
    return root


def manifest(root: str):
    from harness.runner import Manifest

    return Manifest(root, os.path.join(root, "benchmarks"))
