"""The port's tracing module (``hhsuite_tpu_torch/profiling.py``): stage
timers that sum exactly under threads, the self and CPU seconds of
nested spans, the spans of every thread in an operator's profile with
one id a request, and the backtrace launches' counters against the hits
of a search."""

import glob
import json
import sys
import threading
import time

import pytest
import torch

from hhsuite_tpu_torch import profiling as P
from hhsuite_tpu_torch.search import engine
from hhsuite_tpu_torch.search import viterbi_search as vs_mod
from test_torch_ss import FIX, _par, _ss_db, funnel_set  # noqa: F401


def _tick_clock(monkeypatch):
    """A wall clock per thread that advances one second a reading."""
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t
    monkeypatch.setattr(P, "_clock", clock)


def test_stage_timers(monkeypatch):
    """With timers off nothing is written.  Real clocks: a span's CPU
    seconds lie within its wall seconds, and spans closed out of order
    still count.  An injected clock, 4 threads x 10,000 counts and nested
    spans: every sum exact, and a parent's self time is its time less its
    direct children's."""
    d = P.enable_stage_timers()
    P.disable_stage_timers()
    with P.request("hhsearch"):
        with P.annotate("x"):
            P.stage_add("n")
            P.stage_add({"m": 1})
        with P.held(threading.Lock()):
            pass
    assert d == {}

    timers = P.enable_stage_timers()
    try:
        with P.annotate("outer"):
            with P.annotate("sleep"):
                time.sleep(0.05)
            sum(range(100_000))
        a, b = P.annotate("a"), P.annotate("b")
        a.__enter__()
        b.__enter__()
        a.__exit__(None, None, None)
        b.__exit__(None, None, None)
    finally:
        P.disable_stage_timers()
    for name in ("outer", "sleep", "a", "b"):
        assert 0.0 <= timers[name + ":cpu"] <= timers[name]
    assert timers["sleep"] >= 0.05
    assert timers["sleep:cpu"] < 0.5 * timers["sleep"]
    assert timers["outer:self"] == pytest.approx(
        timers["outer"] - timers["sleep"], abs=1e-12)

    _tick_clock(monkeypatch)
    n, nthreads = 10_000, 4
    shared = threading.Lock()

    def work():
        for _ in range(n):
            P.stage_add("count")
            P.stage_add({"pair": 2, "half": 0.5})
            with P.held(shared):
                pass
            with P.annotate("parent"):       # readings 1 and 6: 5 s
                with P.annotate("child"):    # 2 and 3: 1 s
                    pass
                with P.annotate("child"):    # 4 and 5: 1 s
                    pass

    timers = P.enable_stage_timers()
    threads = [threading.Thread(target=work) for _ in range(nthreads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
        P.disable_stage_timers()
    assert not any(t.is_alive() for t in threads)
    runs = n * nthreads
    assert timers["n:count"] == runs
    assert timers["n:pair"] == 2 * runs and timers["n:half"] == 0.5 * runs
    assert timers["parent"] == 5.0 * runs
    assert timers["child"] == 2.0 * runs
    assert timers["child:self"] == 2.0 * runs
    assert timers["parent:self"] == timers["parent"] - timers["child"]
    assert timers["parent:self"] == 3.0 * runs
    waits = timers.get("n:lock_waits", 0)
    assert 0 <= waits <= runs
    assert ("lock_wait" in timers) == bool(waits)
    assert set(P.wall_seconds(timers)) == {"parent", "child"} | (
        {"lock_wait"} if waits else set())


def test_profile_holds_every_thread_and_one_id_a_request(tmp_path,
                                                         monkeypatch):
    """An operator's profile (``trace_if_enabled``) records the spans of
    a second thread, and two requests open at once carry different ids;
    a span's parent is the span that holds it."""
    monkeypatch.setenv(P.PROFILE_ENV, str(tmp_path))
    both_open = threading.Barrier(2)
    ids = {}

    def client(kind):
        with P.request(kind) as rid:
            ids[kind] = rid
            both_open.wait()
            with P.annotate("inner_" + kind):
                torch.ones(4).sum()
            both_open.wait()

    with P.trace_if_enabled():
        other = threading.Thread(target=client, args=("b",))
        other.start()
        client("a")
        other.join()
    (path,) = glob.glob(str(tmp_path / "trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert spans["inner_a"]["tid"] != spans["inner_b"]["tid"]
    assert spans["a_query"]["tid"] == spans["inner_a"]["tid"]

    def args(name):    # (request id, span id, parent span id)
        return [int(v) for v in spans[name]["args"]["Concrete Inputs"]]

    assert ids["a"] != ids["b"]
    for kind in ("a", "b"):
        rid, sid, parent = args(f"{kind}_query")
        assert rid == ids[kind] and parent == 0
        assert args("inner_" + kind) == [rid, args("inner_" + kind)[1],
                                          sid]


def _spy_searches(monkeypatch):
    """Record the hits of every viterbi_search call."""
    seen = []
    real = vs_mod.viterbi_search

    def spy(par, q, templates, **kw):
        hits = real(par, q, templates, **kw)
        seen.append((q, hits))
        return hits
    monkeypatch.setattr(engine, "viterbi_search", spy)
    monkeypatch.setattr(vs_mod, "viterbi_search", spy)
    return seen


def _bt_totals(timers, what):
    return sum(v for k, v in timers.items()
               if k.startswith("n:" + what + "."))


def test_backtrace_counters_match_the_hits(tmp_path, monkeypatch,
                                           funnel_set):  # noqa: F811
    """A warm CPU hhsearch on the small SS database: the lanes the
    backtrace launches counted are the full hits, their real cells the
    sum of q.L x t.L over them; the request and its stages are timed, a
    span's direct children and its self time adding up to it.  With the
    funnel forced on, the light hits are counted apart and the lanes are
    the full hits alone."""
    seen = _spy_searches(monkeypatch)
    # the batched realign (R1-R4's plain versions on the CPU)
    monkeypatch.setattr(engine, "_use_device_realign",
                        lambda par, selected, device: True)
    db = engine.HHDatabase(_ss_db(tmp_path))
    with open(f"{FIX}/query_ss.a3m") as f:
        query = f.read()
    # the first query builds the database's resident pack
    engine.run_hhsearch(_par(), query, db, "query_ss.a3m", device="cpu")
    seen.clear()
    timers = P.enable_stage_timers()
    try:
        engine.run_hhsearch(_par(), query, db, "query_ss.a3m",
                            device="cpu")
    finally:
        P.disable_stage_timers()
    full = [(q, h) for q, hits in seen for h in hits if not h.light]
    assert full
    assert _bt_totals(timers, "bt_lanes") == len(full)
    assert _bt_totals(timers, "bt_cells") == sum(q.L * h.L for q, h in full)
    assert (_bt_totals(timers, "bt_cells_padded")
            >= _bt_totals(timers, "bt_cells"))
    assert timers["n:bt_launches.k3_ss"] >= 1       # SS in the DP: K3
    for name in ("hhsearch_query", "viterbi_search", "vit_bt_prep",
                 "host_hitbuild", "realign_template_prep"):
        assert timers[name] > 0.0 and name + ":self" in timers
    for name, children in (
            ("host_realign", ("realign_template_prep",
                              "posterior_mac_realign_batch")),
            ("posterior_mac_realign_batch", ("host_realign_assemble",
                                             "posterior_fetch_wait",
                                             "host_realign_write")),
            ("hhsearch_query", ("host_query_prep", "host_template_prep",
                                "viterbi_search", "promote_light_hits",
                                "host_premerge", "host_realign"))):
        assert timers[name] == pytest.approx(
            timers[name + ":self"] + sum(timers[c] for c in children),
            rel=1e-9)

    par, q, templates, ss = funnel_set
    monkeypatch.setattr(vs_mod, "_funnel_ok", lambda dev: True)
    timers = P.enable_stage_timers()
    try:
        hits = vs_mod.viterbi_search(par, q, templates, ss_matrices=ss,
                                     device="cpu")
    finally:
        P.disable_stage_timers()
    light = sum(h.light for h in hits)
    assert light
    assert timers["n:funnel_swept"] == len(templates)
    assert timers["n:funnel_light"] == light
    assert timers["n:funnel_full"] == len(templates) - light
    assert _bt_totals(timers, "bt_lanes") == len(hits) - light
    assert _bt_totals(timers, "bt_cells") == sum(
        q.L * h.L for h in hits if not h.light)
    assert timers["vit_light_hits"] > 0.0


def test_template_build_once_a_cold_build(tmp_path, monkeypatch):
    """A cold build of a prepared template writes one ``template_build``
    span and one ``n:template_builds``; a cache hit, in the prepared or
    the search hand-out, writes neither; another weights flag is another
    cold build.  With the tick clock each span reads 1 s."""
    from hhsuite_tpu_torch.matrices import get_substitution_matrix

    import shutil

    for f in ("a3m", "cs219"):                  # a3m only: built from MSAs
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(f"{FIX}/multi_{f}{ext}", tmp_path / f"db_{f}{ext}")
    _tick_clock(monkeypatch)
    db = engine.HHDatabase(str(tmp_path / "db"))
    par = _par()
    mats = get_substitution_matrix(par.matrix)
    names = [n for n, _l in db.init_no_prefilter()][:3]
    d = P.enable_stage_timers()
    try:
        for n in names:
            db.get_template_hmm_prepared(n, par, mats)
        cold = dict(d)
        for n in names:
            db.get_template_hmm_prepared(n, par, mats)
            db._prepared_cache_entry(n, par, mats)
        warm = dict(d)
        db.get_template_hmm_prepared(names[0], par, mats,
                                     use_global_weights=0)
        other = dict(d)
    finally:
        P.disable_stage_timers()
    assert cold["n:template_builds"] == 3
    assert cold["template_build"] == 3.0
    assert "template_build:self" in cold and "template_build:cpu" in cold
    assert warm == cold
    assert other["n:template_builds"] == 4
    assert other["template_build"] == 4.0
