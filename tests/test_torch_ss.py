"""Secondary structure in the port's Viterbi search, on the CPU (plain
versions of the kernels).

* the golden SS search (``query_ss.a3m`` against ``ss_db_*``, ``-ssm 2``)
  held to the tolerances of tests/test_ss_scoring.py, and ``-ssm 1``;
* the same search against the JAX package's ``run_hhsearch`` (scores and
  E-values with the correlation term off, as test_torch_hhsearch.py);
* the plain Viterbi with K3's SS input, the LUT form, bit-identical to
  the same call with the host fill ``build_ss_score`` in all three SS
  modes;
* the SS funnel (K6 sweep with the SS LUT, forced on as in
  test_torch_funnel.py) against the single-pass search.
"""

import copy
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hhsuite_tpu_torch.constants import MAXCF, NDSSP, NSSPRED, Parameters
from hhsuite_tpu_torch.io.alignments import print_alignments
from hhsuite_tpu_torch.io.results import print_m8
from hhsuite_tpu_torch.matrices import get_ss_matrices, get_substitution_matrix
from hhsuite_tpu_torch.ops.viterbi_lanes import (viterbi_score_lanes,
                                                 viterbi_score_lanes_fused)
from hhsuite_tpu_torch.search import viterbi_search as vs_mod
from hhsuite_tpu_torch.search.engine import HHDatabase, run_hhsearch
from hhsuite_tpu_torch.search.query import (prepare_query_hmm,
                                            prepare_template_hmm,
                                            read_query_text)
from test_torch_funnel import _truncate_a3m

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _ss_db(tmp):
    for f in ("a3m", "cs219"):
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(f"{FIX}/ss_db_{f}{ext}", tmp / f"db_{f}{ext}")
    return str(tmp / "db")


def _par(ssm=2, corr=None):
    par = Parameters()
    par.nocontxt = True
    par.prefilter = False
    par.num_rounds = 1
    par.ssm = ssm
    if corr is not None:
        par.corr = corr
    return par


def _search(base, par):
    with open(f"{FIX}/query_ss.a3m") as f:
        query = f.read()
    return run_hhsearch(par, query, HHDatabase(base), "query_ss.a3m",
                        device="cpu")


@pytest.fixture(scope="module")
def ss_db(tmp_path_factory):
    return _ss_db(tmp_path_factory.mktemp("ssdb"))


@pytest.fixture(scope="module")
def ss_search(ss_db):
    par = _par()
    q, hitlist = _search(ss_db, par)
    return par, q, hitlist


def test_ss_scores_match_golden(ss_search):
    _par_, _q, hitlist = ss_search
    h = hitlist.hits[0]
    assert h.matched_cols == 431
    assert (h.i1, h.i2, h.j1, h.j2) == (1, 431, 1, 431)
    assert abs(h.score - 1376.0) < 0.2
    assert abs(h.score_ss - 34.6) < 0.05
    h2 = hitlist.hits[1]
    assert abs(h2.score - 14.4) < 0.2
    assert abs(h2.score_ss - 0.5) < 0.05


def test_ss_m8_token_tolerant(ss_search):
    par, q, hitlist = ss_search
    got = print_m8(q, hitlist, par.nseqdis, par.p, par.E)
    with open(f"{FIX}/golden_ss.m8") as f:
        want = f.read()
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        gt, wt = g.split("\t"), w.split("\t")
        assert gt[:10] == wt[:10]
        assert abs(float(gt[10]) - float(wt[10])) \
            <= 0.02 * max(float(wt[10]), 1e-300)
        assert abs(float(gt[11]) - float(wt[11])) <= 0.15


def test_ss_hhr_rows_present(ss_search):
    par, q, hitlist = ss_search
    out = print_alignments(q, hitlist, par, get_substitution_matrix(0).S)
    assert "Q ss_pred" in out and "T ss_pred" in out
    with open(f"{FIX}/golden_ss.hhr") as f:
        want = [ln for ln in f.read().splitlines()
                if ln.startswith("Q ss_pred")]
    assert [ln for ln in out.splitlines()
            if ln.startswith("Q ss_pred")] == want


def test_ssm1_scores_ss_after_alignment(ss_search, ss_db):
    """-ssm 1: SS is scored along the backtrace but not added in the DP
    (hhviterbi.cpp:175, 230-236)."""
    _par2, _q, hitlist2 = ss_search
    _q1, hl1 = _search(ss_db, _par(ssm=1))
    h1, h2 = hl1.hits[0], hitlist2.hits[0]
    assert h1.score_ss == pytest.approx(h2.score_ss, abs=0.05)
    assert h1.ssm1 == 3 and h1.ssm2 == 0
    assert h2.ssm2 == 3 and h2.ssm1 == 0
    assert h1.score == pytest.approx(h2.score, abs=0.2)


def test_ss_search_matches_jax(ss_db):
    """Same hit table as the JAX package on the SS fixtures; scores and
    E-values with the correlation term off (the profile dot's summation
    order, see test_torch_hhsearch.py)."""
    from hhsuite_tpu.constants import Parameters as JParameters
    from hhsuite_tpu.search.engine import HHDatabase as JHHDatabase
    from hhsuite_tpu.search.engine import run_hhsearch as jax_run_hhsearch

    par = _par(corr=0.0)
    jpar = JParameters()
    jpar.nocontxt, jpar.prefilter, jpar.num_rounds = True, False, 1
    jpar.ssm, jpar.corr = 2, 0.0
    with open(f"{FIX}/query_ss.a3m") as f:
        query = f.read()
    _q, got = _search(ss_db, par)
    _jq, want = jax_run_hhsearch(jpar, query, JHHDatabase(ss_db),
                                 "query_ss.a3m")

    def table(hl):
        return [(str(h.entry), h.irep, h.i1, h.i2, h.j1, h.j2, h.score,
                 h.score_ss, h.Eval) for h in hl.hits]

    g, w = table(got), table(want)
    assert len(g) == len(w) >= 2
    assert [x[:6] for x in g] == [x[:6] for x in w]
    np.testing.assert_allclose([x[6] for x in g], [x[6] for x in w],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose([x[7] for x in g], [x[7] for x in w],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose([x[8] for x in g], [x[8] for x in w],
                               rtol=1e-4)


# ------------------------------------------------------ SS table form --

def _fake_hmm(rng, L, dssp):
    n = L + 2
    return SimpleNamespace(
        L=L,
        ss_pred=rng.integers(0, NSSPRED, n).astype(np.int8),
        ss_conf=rng.integers(0, MAXCF, n).astype(np.int8),
        ss_dssp=rng.integers(0, NDSSP, n).astype(np.int8) if dssp
        else np.zeros(n, np.int8))


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("mode", [vs_mod.PRED_PRED, vs_mod.PRED_DSSP,
                                  vs_mod.DSSP_PRED])
def test_ss_table_matches_host_fill(mode, local):
    """viterbi_batch with the SS term as build_ss_lut's table (K3's form
    on the card) == viterbi_batch with build_ss_score's padded host
    matrix: score, i2, j2 and every backtrace byte bit for bit, padding
    lanes and columns included."""
    from hhsuite_tpu_torch.ops.viterbi import viterbi_batch
    from test_torch_viterbi import make_inputs

    rng = np.random.default_rng(mode)
    mats = get_ss_matrices(1.0)
    q = _fake_hmm(rng, 37, mode == vs_mod.DSSP_PRED)
    lengths = (64, 40, 1, 57)
    batch = [_fake_hmm(rng, L, mode == vs_mod.PRED_DSSP) for L in lengths]
    Lt_max, Bp, ssw = 64, 6, 0.11
    qp, qtr, tp, ttr, _tl, _co, _ss = make_inputs(q.L, Lt_max, Bp, seed=mode)
    t_L = np.array(list(lengths) + [0] * (Bp - len(batch)), np.int32)
    for b in range(Bp):                 # pad past each lane's length
        tp[b, t_L[b] + 1:] = 0.0
        ttr[b, t_L[b] + 1:] = -np.finfo(np.float32).max
    dense = np.zeros((Bp, q.L + 1, Lt_max + 1), np.float32)
    for b, t in enumerate(batch):
        dense[b, :, : t.L + 1] = vs_mod.build_ss_score(
            q, t, mode, ssw, mats.S73, mats.S37, mats.S33)
    lut, qidx, tidx = vs_mod.build_ss_lut(q, batch, mode, ssw, mats.S73,
                                          mats.S37, mats.S33, Lt_max)
    assert qidx.dtype == np.int32 and qidx.max() + tidx.max() < len(lut)
    tidx = np.pad(tidx, ((0, Bp - len(batch)), (0, 0)))
    args = [torch.from_numpy(x) for x in (qp, qtr, tp, ttr)]
    tl = torch.from_numpy(t_L)
    want = viterbi_batch(*args, None, tl, -0.03, local=local,
                         ss_score=torch.from_numpy(dense))
    got = viterbi_batch(*args, None, tl, -0.03, local=local,
                        ss_lut=torch.from_numpy(lut),
                        ss_qidx=torch.from_numpy(qidx),
                        ss_tidx=torch.from_numpy(tidx))
    for a, b in zip(got, want):
        a, b = a.numpy(), b.numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)
    plain = viterbi_batch(*args, None, tl, -0.03, local=local)
    assert not np.array_equal(plain[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("pred, conf", [(NSSPRED - 1, MAXCF), (0, -1)])
def test_ss_lut_offsets_checked(pred, conf):
    """An offset past either end of the table is refused on the host (the
    kernels read the table without a bound)."""
    rng = np.random.default_rng(0)
    mats = get_ss_matrices(1.0)
    q = _fake_hmm(rng, 9, False)
    q.ss_pred[1:], q.ss_conf[1:] = NSSPRED - 1, MAXCF - 1
    t = _fake_hmm(rng, 5, False)
    args = (vs_mod.PRED_PRED, 0.11, mats.S73, mats.S37, mats.S33, 8)
    lut, qidx, tidx = vs_mod.build_ss_lut(q, [t], *args)
    assert int(qidx.max()) + int(tidx.max()) < len(lut)
    t.ss_pred[3], t.ss_conf[3] = pred, conf
    with pytest.raises(ValueError, match="out of range"):
        vs_mod.build_ss_lut(q, [t], *args)


# ----------------------------------------------------------- SS funnel --

def _perturb_ss(rng, t, frac):
    """Reassign a fraction of a template's predicted SS states and
    confidences (columns 1..L)."""
    L = t.L
    pick = rng.random(L) < frac
    t.ss_pred[1: L + 1] = np.where(pick, rng.integers(1, NSSPRED, L),
                                   t.ss_pred[1: L + 1]).astype(np.int8)
    t.ss_conf[1: L + 1] = np.where(pick, rng.integers(1, MAXCF, L),
                                   t.ss_conf[1: L + 1]).astype(np.int8)


def _cut_ss_query(ncols):
    """query_ss.a3m cut to its first ``ncols`` columns; the ss_conf row
    (digits, which _truncate_a3m does not count) is cut to the same."""
    with open(f"{FIX}/query_ss.a3m") as f:
        lines = _truncate_a3m(f.read(), ncols).splitlines()
    k = lines.index(next(ln for ln in lines if ln.startswith(">ss_conf")))
    lines[k + 1] = lines[k + 1][:ncols]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def funnel_set():
    """A 120-column cut of query_ss.a3m and 14 templates made from it with
    perturbed profiles and SS rows."""
    par = Parameters()
    par.nocontxt = True
    par.prefilter = False
    par.corr = 0.0
    par.altali = 1
    par.Z = par.B = 3
    par.z = par.b = 1
    par.realign_max = 3
    par.early_stopping_filter = False
    par.smin = 1e9       # keep light hits in play
    mats = get_substitution_matrix(par.matrix)
    ss = get_ss_matrices(par.ssa)
    text = _cut_ss_query(120)
    q, _qali, fmt = read_query_text(par, text, "query_ss.a3m", mats)
    prepare_query_hmm(par, q, mats, fmt)
    assert q.nss_pred >= 0 and q.L == 120

    t0 = read_query_text(par, text, "tmpl.a3m", mats)[0]
    rng = np.random.RandomState(0)
    ss_rng = np.random.default_rng(1)
    templates = []
    for k in range(14):
        t = copy.deepcopy(t0)
        noise = 1.0 + 0.5 * rng.rand(*t.f.shape) * (k / 10.0)
        t.f = (t.f * noise).astype(np.float32)
        t.f /= np.maximum(t.f.sum(axis=1, keepdims=True), 1e-30)
        _perturb_ss(ss_rng, t, 0.05 * k)
        t.name = t.file = f"t{k:02d}"
        prepare_template_hmm(par, q, t, mats, 0)
        templates.append((f"t{k:02d}", t))
    return par, q, templates, ss


def _funnel_run(par, q, templates, ss):
    """The search with the funnel forced on; returns the hits and, per
    sweep launch, (kernel, SS table given, si_mode)."""
    n = (viterbi_score_lanes.launches, viterbi_score_lanes_fused.launches)
    calls = []
    k6, k1 = vs_mod.viterbi_score_lanes, vs_mod.viterbi_score_lanes_fused

    def spy6(*a, **kw):
        calls.append(("K6", kw.get("ss_lut") is not None, None))
        return k6(*a, **kw)

    def spy1(*a, **kw):
        calls.append(("K1", False, kw.get("si_mode")))
        return k1(*a, **kw)

    orig = vs_mod._funnel_ok
    vs_mod._funnel_ok = lambda dev: True
    vs_mod.viterbi_score_lanes = spy6
    vs_mod.viterbi_score_lanes_fused = spy1
    try:
        fun = vs_mod.viterbi_search(par, q, templates, ss_matrices=ss,
                                    device="cpu")
    finally:
        vs_mod._funnel_ok = orig
        vs_mod.viterbi_score_lanes = k6
        vs_mod.viterbi_score_lanes_fused = k1
    # plain versions on the CPU: no kernel launch counted
    assert (viterbi_score_lanes.launches,
            viterbi_score_lanes_fused.launches) == n
    return fun, calls


@pytest.fixture(scope="module")
def ss_funnel(funnel_set):
    par, q, templates, ss = funnel_set
    base = vs_mod.viterbi_search(par, q, templates, ss_matrices=ss,
                                 device="cpu")
    fun, calls = _funnel_run(par, q, templates, ss)
    return par, base, fun, [c[1] for c in calls]


def test_ss_funnel_sweeps_with_k6_lut(ss_funnel):
    _par_, _base, _fun, calls = ss_funnel
    assert calls and all(calls)


def test_ss_funnel_full_hits_match(ss_funnel):
    par, base, fun, _calls = ss_funnel
    by_entry = {h.entry: h for h in base}
    full = [h for h in fun if not h.light]
    assert len(full) >= 2 * max(par.Z, par.B, par.realign_max)
    assert len(fun) == len(base)
    for h in full:
        ref = by_entry[h.entry]
        assert (h.score, h.score_ss) == (ref.score, ref.score_ss)
        assert (h.i1, h.i2, h.j1, h.j2) == (ref.i1, ref.i2, ref.j1, ref.j2)
        np.testing.assert_array_equal(h.states, ref.states)


def test_ss_funnel_light_scores_carry_ss(ss_funnel):
    """A light hit's score is K6's sweep score, SS included: the
    single-pass score plus its score_ss (which the full hit subtracts),
    within K6's tolerance against the backtrace kernel (rtol 2e-6 /
    atol 1e-4) and one f32 rounding of the subtraction."""
    _par_, base, fun, _calls = ss_funnel
    by_entry = {h.entry: h for h in base}
    lights = [h for h in fun if h.light]
    assert lights
    for h in lights:
        ref = by_entry[h.entry]
        assert ref.score_ss != 0.0
        want = np.float64(ref.score) + np.float64(ref.score_ss)
        assert h.score == pytest.approx(want, rel=2e-6, abs=1e-4)
        assert h.score_ss == 0.0 and h.nsteps == 0


# ------------------------------------------- no-SS sweep (SI mode knob) --

SI_MODES = {"fused": ("K1", False, "fast"), "exact": ("K1", False, "exact"),
            "split": ("K6", False, None)}


@pytest.fixture(scope="module")
def si_mode_runs(funnel_set):
    """The same set with SS out of the DP (-ssm 0): the single-pass
    search, and the funnel under each HHSUITE_TPU_SI_MODE."""
    par, q, templates, ss = funnel_set
    par = copy.copy(par)
    par.ssm = 0
    base = vs_mod.viterbi_search(par, q, templates, ss_matrices=ss,
                                 device="cpu")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode in SI_MODES:
            mp.setenv("HHSUITE_TPU_SI_MODE", mode)
            runs[mode] = _funnel_run(par, q, templates, ss)
    return base, runs


@pytest.mark.parametrize("mode", sorted(SI_MODES))
def test_si_mode_sweep(si_mode_runs, mode):
    """Each mode sweeps with its kernel; full hits equal the single-pass
    search; light hits carry the sweep score (the fast log2's tolerance
    for fused, K6's for exact and split)."""
    base, runs = si_mode_runs
    fun, calls = runs[mode]
    assert calls and set(calls) == {SI_MODES[mode]}
    by_entry = {h.entry: h for h in base}
    assert len(fun) == len(base)
    lights = [h for h in fun if h.light]
    assert lights and len(lights) < len(fun)
    tol = dict(rel=1e-3, abs=0.1) if mode == "fused" else \
        dict(rel=2e-6, abs=1e-4)
    for h in fun:
        ref = by_entry[h.entry]
        if h.light:
            assert h.score == pytest.approx(ref.score, **tol)
        else:
            assert (h.score, h.i1, h.i2, h.j1, h.j2) == (
                ref.score, ref.i1, ref.i2, ref.j1, ref.j2)


def test_si_mode_split_equals_exact(si_mode_runs):
    """K6 with no SS is K1 exact's arithmetic: the same hits, bit for
    bit, light hits included."""
    _base, runs = si_mode_runs

    def table(hits):
        return [(h.entry, h.light, h.score, h.i1, h.i2, h.j1, h.j2)
                for h in hits]

    assert table(runs["split"][0]) == table(runs["exact"][0])


def test_si_mode_rejects_unknown(monkeypatch):
    monkeypatch.setenv("HHSUITE_TPU_SI_MODE", "bf16")
    with pytest.raises(ValueError, match="HHSUITE_TPU_SI_MODE"):
        vs_mod._lanes_impl()


# -------------------------------------------------- SS benchmark database --

def test_build_ss_db(tmp_path):
    """Deterministic, the family's sequences and cs219 unchanged, SS rows
    of the sequence's length over {H, E, C} with digits 0-9, read back by
    the port's query reader."""
    from hhsuite_tpu_torch.io.ffindex import FFindexDatabase
    from hhsuite_tpu_torch.tools.benchdb import (build_bench_db, build_ss_db,
                                                 ss_composition)

    fam = str(tmp_path / "fam")
    query = build_bench_db(fam, n_templates=16, L0=120, with_hhm=False)
    q1 = build_ss_db(str(tmp_path / "ss1"), fam, query)
    q2 = build_ss_db(str(tmp_path / "ss2"), fam, query)
    assert q1 == q2
    for suffix in ("a3m", "cs219"):
        for ext in (".ffdata", ".ffindex"):
            a = (tmp_path / f"ss1_{suffix}{ext}").read_bytes()
            assert a == (tmp_path / f"ss2_{suffix}{ext}").read_bytes()
    for ext in (".ffdata", ".ffindex"):
        assert (tmp_path / f"ss1_cs219{ext}").read_bytes() \
            == (tmp_path / f"fam_cs219{ext}").read_bytes()
    assert not (tmp_path / "ss1_hhm.ffindex").exists()

    fdb = FFindexDatabase(f"{fam}_a3m.ffdata", f"{fam}_a3m.ffindex")
    sdb = FFindexDatabase(str(tmp_path / "ss1_a3m.ffdata"),
                          str(tmp_path / "ss1_a3m.ffindex"))
    assert [e.name for e in sdb.entries] == [e.name for e in fdb.entries]
    texts = [(fdb.read_text(e.name), sdb.read_text(e.name))
             for e in fdb.entries] + [(query, q1)]
    for fam_text, ss_text in texts:
        rows = ss_text.split("\n")
        assert rows[0].startswith(">ss_pred") and rows[2].startswith(
            ">ss_conf")
        assert "\n".join(rows[4:]) == fam_text
        seq = fam_text.split("\n")[1]
        assert len(rows[1]) == len(rows[3]) == len(seq)
        assert set(rows[1]) <= set("HEC") and rows[3].isdigit()
    comp = ss_composition(str(tmp_path / "ss1"))
    assert comp["H"] > 0.1 and comp["E"] > 0.05 and comp["C"] > 0.1

    par = Parameters()
    mats = get_substitution_matrix(par.matrix)
    q, _qali, _fmt = read_query_text(par, q1, "q.a3m", mats)
    assert q.nss_pred >= 0 and q.nss_conf >= 0
