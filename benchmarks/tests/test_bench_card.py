"""A short run of each cell on the card, as the benchmark's command runs
it: a result line with ``correct`` true."""

import json
import os
import subprocess
import sys

import pytest

import tiny

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "10",
                        "--trace", "0"], cwd=tiny.ROOT, capture_output=True,
                       text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checked"]
