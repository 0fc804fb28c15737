"""The kernels' work counts agree with hand counts at tiny shapes, and a
share never reads above 100% for work done at the peak."""

import json
import os

import tiny
from harness import readings
from harness.runner import load_module

RL = os.path.join(tiny.BENCH, "rooflines")
PEAKS = json.load(open(os.path.join(RL, "peaks.json")))
DB = {"entries": 3, "residues": 5 + 7 + 9}
CFG_SS = {"db": {"ss": True}}


def test_sweep_count_by_hand():
    m = load_module(os.path.join(RL, "vit_score_kernel.py"))
    ops, nbytes = m.work(4, DB, CFG_SS, {"ss": True})
    assert ops == 4 * 21 * 75
    cols = 21 + 2 * 3 + 4 + 2
    assert nbytes == cols * 27 * 4 + 3 * 4 + 21 + 4
    ops0, _ = m.work(4, DB, CFG_SS, {"ss": False})
    assert ops0 == 4 * 21 * 74


def _ctx(seconds, kernel):
    return {"trace": {"kernels": {kernel: seconds}},
            "bench_dir": tiny.BENCH, "load_module": load_module,
            "all": [{"length": 4}], "db": DB, "config": CFG_SS,
            "traffic": {"ss": True}}


def test_share_at_the_peak_is_100():
    m = load_module(os.path.join(RL, "vit_score_kernel.py"))
    ops, nbytes = m.work(4, DB, CFG_SS, {"ss": True})
    t = max(ops / PEAKS["f32_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
    share = readings.roofline(_ctx(t, "vit_score_kernel<false, 2, 8>"),
                              "vit_score_kernel")
    assert abs(share - 100.0) < 1e-9


def test_other_kernels_are_not_counted():
    ctx = _ctx(1.0, "vit_bt_kernel<true, true, true>")
    assert readings.roofline(ctx, "vit_score_kernel") is None


def test_no_trace_reads_nothing():
    ctx = _ctx(1.0, "x")
    ctx["trace"] = None
    assert readings.roofline(ctx, "vit_score_kernel") is None
    assert readings.idle_share(ctx) is None
