"""The port's two-pass funnel (K1 sweep, then the backtrace pass on the
survivors) against the port's single-pass search, both on the CPU with
the kernels' plain versions (mirrors tests/test_viterbi_funnel.py).

(a) every hit that can be displayed/realigned (the top-K) is a full hit
    with a backtrace path identical to the single-pass run;
(b) the light hits carry sweep scores that match the single-pass scores
    (par.corr=0 so the correlation term does not split the two) within
    the fast log2's tolerance (rel 1e-3, abs 0.1).
"""

import copy
import os

import numpy as np
import pytest

from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.core.hit import HitList
from hhsuite_tpu_torch.matrices import get_substitution_matrix
from hhsuite_tpu_torch.search import viterbi_search as vs_mod
from hhsuite_tpu_torch.search.query import (prepare_query_hmm,
                                            prepare_template_hmm,
                                            read_query_text)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _truncate_a3m(text: str, ncols: int) -> str:
    """Cut every sequence after its first ``ncols`` match states."""
    out = []
    for line in text.splitlines():
        if line.startswith((">", "#")):
            out.append(line)
            continue
        kept, nm = [], 0
        for c in line:
            if c.isupper() or c == "-":
                if nm >= ncols:
                    break
                nm += 1
            kept.append(c)
        out.append("".join(kept))
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def searched():
    par = Parameters()
    par.nocontxt = True
    par.prefilter = False
    par.corr = 0.0
    par.altali = 1
    par.Z = par.B = 3
    par.z = par.b = 1
    par.realign_max = 3
    par.early_stopping_filter = False
    # keep the smin rule from swallowing every self-hit so light hits
    # are exercised
    par.smin = 1e9
    mats = get_substitution_matrix(par.matrix)
    with open(f"{FIX}/query.a3m") as f:
        text = _truncate_a3m(f.read(), 120)
    q, _qali, fmt = read_query_text(par, text, "query.a3m", mats)
    prepare_query_hmm(par, q, mats, fmt)

    t0 = read_query_text(par, text, "tmpl.a3m", mats)[0]
    templates = []
    rng = np.random.RandomState(0)
    for k in range(14):
        t = copy.deepcopy(t0)
        noise = 1.0 + 0.5 * rng.rand(*t.f.shape) * (k / 10.0)
        t.f = (t.f * noise).astype(np.float32)
        t.f /= np.maximum(t.f.sum(axis=1, keepdims=True), 1e-30)
        t.name = t.file = f"t{k:02d}"
        prepare_template_hmm(par, q, t, mats, 0)
        templates.append((f"t{k:02d}", t))

    base = vs_mod.viterbi_search(par, q, templates, device="cpu")
    orig = vs_mod._funnel_ok
    vs_mod._funnel_ok = lambda dev: True
    try:
        fun = vs_mod.viterbi_search(par, q, templates, device="cpu")
    finally:
        vs_mod._funnel_ok = orig
    return par, base, fun, q, templates


def test_funnel_full_hits_match(searched):
    par, base, fun, _q, _tmpls = searched
    by_entry = {h.entry: h for h in base}
    n_full = 0
    for h in fun:
        if h.light:
            continue
        n_full += 1
        ref = by_entry[h.entry]
        assert h.score == ref.score
        assert (h.i1, h.i2, h.j1, h.j2) == (ref.i1, ref.i2, ref.j1, ref.j2)
        assert h.matched_cols == ref.matched_cols
        np.testing.assert_array_equal(h.states, ref.states)
    assert n_full >= min(len(base), 2 * max(par.Z, par.B, par.realign_max))


def test_funnel_light_scores_match(searched):
    _par, base, fun, _q, _tmpls = searched
    by_entry = {h.entry: h for h in base}
    lights = [h for h in fun if h.light]
    assert lights, "expected some light hits with 14 templates and K=6"
    for h in lights:
        ref = by_entry[h.entry]
        assert h.score == pytest.approx(ref.score, rel=1e-3, abs=0.1)
        assert h.nsteps == 0 and h.matched_cols == 0


def test_funnel_keeps_all_hits(searched):
    _par, base, fun, _q, _tmpls = searched
    assert len(fun) == len(base)
    assert {h.entry for h in fun} == {h.entry for h in base}


def test_promote_light_hits(searched):
    """Any light hit whose E-value lands inside the merge window must be
    replaced by a full hit whose path matches the single-pass run."""
    par, base, fun, q, templates = searched
    hitlist = HitList()
    hitlist.N_searched = len(templates)
    hitlist.extend(copy.deepcopy(fun))
    hitlist.sort()
    hitlist.calculate_pvalues(q, par.loc, par.ssm, par.ssw)
    lights = [h for h in hitlist if h.light]
    assert lights
    par2 = copy.deepcopy(par)
    evals = sorted(h.Eval for h in lights)
    par2.e = evals[len(evals) // 2] / 100.0
    assert vs_mod.promote_light_hits(par2, q, hitlist, templates,
                                     device="cpu")
    hitlist.sort()
    hitlist.calculate_pvalues(q, par2.loc, par2.ssm, par2.ssw)
    by_entry = {h.entry: h for h in base}
    for h in hitlist:
        if h.Eval <= 100.0 * par2.e:
            assert not h.light
        if h.light:
            continue
        ref = by_entry[h.entry]
        assert h.score == ref.score
        assert h.matched_cols == ref.matched_cols


def test_generic_path_matches_resident_pack(searched):
    """Per-batch packing (the path past the device-memory budget) gives
    the same hits as the resident pack."""
    par, base, _fun, q, templates = searched
    alt = vs_mod.viterbi_search(par, q, templates, device="cpu",
                                resident_pack=vs_mod.PACK_DISABLED)
    key = lambda h: (h.entry, h.irep, h.score, h.i1, h.i2, h.j1, h.j2)  # noqa
    assert sorted(map(key, alt)) == sorted(map(key, base))
