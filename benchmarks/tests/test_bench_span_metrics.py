"""The readers of the program's inner spans and counters: each gives the
hand-computed value on a hand-made run, and nothing where the program
has no such span or counter (as before it had them) or where the run
was not traced."""

import json
import os

import pytest

import tiny
from harness.runner import load_module

PER_QUERY = {
    "vit_bt_prep_s_per_query.search": "vit_bt_prep",
    "vit_light_hits_s_per_query.search": "vit_light_hits",
    "vit_self_s_per_query.search": "viterbi_search:self",
    "realign_template_prep_s_per_query.search": "realign_template_prep",
    "hhr_write_s_per_query.search": "host_output",
    "lock_wait_s_per_query.search": "lock_wait",
}
PEAKS = json.load(open(os.path.join(tiny.BENCH, "rooflines", "peaks.json")))


def reader(name):
    return load_module(os.path.join(tiny.BENCH, "metrics",
                                    name + ".py")).read


def _ctx(timers, trace=None, queries=4):
    return {"timers": timers, "trace": trace,
            "all": [{"length": 300}] * queries,
            "bench_dir": tiny.BENCH, "load_module": load_module}


@pytest.mark.parametrize("metric", sorted(PER_QUERY))
def test_span_per_query(metric):
    key = PER_QUERY[metric]
    read = reader(metric)
    assert read(_ctx({key: 6.0, "other": 1.0})) == 1.5
    assert read(_ctx({"other": 1.0})) is None
    assert read(_ctx({key: 6.0}, queries=0)) is None


def test_lock_wait_reads_zero_where_no_query_waited():
    read = reader("lock_wait_s_per_query.search")
    assert read(_ctx({"hhsearch_query": 10.0})) == 0.0
    assert read(_ctx({"hhsearch_query": 10.0}, queries=0)) is None


def test_query_offcpu():
    read = reader("query_offcpu_s_per_query.search")
    t = {"hhsearch_query": 10.0, "hhsearch_query:cpu": 6.0}
    assert read(_ctx(t)) == 1.0
    assert read(_ctx({"hhsearch_query": 10.0})) is None
    assert read(_ctx({})) is None


def test_bt_roofline_by_hand():
    """Cells of K2 (74 operations a cell, one byte written), K3 with SS
    (75) and K3 with exclusions and SS (75, two bytes) at the f32 peak."""
    read = reader("bt_roofline_share")
    timers = {"n:bt_cells.k2": 1000, "n:bt_cells.k3_ss": 2000,
              "n:bt_cells.k3_co_ss": 3000, "n:bt_lanes.k2": 9,
              "host_realign": 1.0}
    ops = 1000 * 74 + 2000 * 75 + 3000 * 75
    at_peak = ops / PEAKS["f32_flops_per_s"]
    assert ops / PEAKS["f32_flops_per_s"] > (
        (1000 + 2000 + 2 * 3000) / PEAKS["hbm_bytes_per_s"])
    trace = {"kernels": {"vit_bt_kernel<true, true, true>": at_peak / 2,
                         "vit_bt_kernel<false, true, true>": at_peak / 2,
                         "vit_score_kernel<false, 2, 8>": 5.0}}
    assert read(_ctx(timers, trace)) == pytest.approx(100.0, rel=1e-12)
    trace["kernels"]["vit_bt_kernel<false, false, true>"] = at_peak
    assert read(_ctx(timers, trace)) == pytest.approx(50.0, rel=1e-12)


def test_bt_roofline_reads_nothing_without_its_inputs():
    read = reader("bt_roofline_share")
    trace = {"kernels": {"vit_bt_kernel<true, true, true>": 1.0}}
    assert read(_ctx({"n:bt_cells.k2": 10}, None)) is None
    assert read(_ctx({"viterbi_search": 1.0}, trace)) is None
    assert read(_ctx({"n:bt_cells.k2": 10},
                     {"kernels": {"vit_score_kernel<false, 2, 8>": 1.0}})
                ) is None


def test_manifest_lists_them_for_the_cell():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in (*PER_QUERY, "query_offcpu_s_per_query.search",
                 "bt_roofline_share"):
        m = per_layer[name]
        assert m["workloads"] == ["pdb70.hhpred"]
        assert m["moves"] == "search_queries_per_s"
        assert callable(reader(name))
