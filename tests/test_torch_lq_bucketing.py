"""The port's query-length bucketing against the unbucketed search, on
the CPU with the kernels' plain versions.

On the resident-pack path (``viterbi_search``'s default) the kernels see
the query padded to a multiple of 32 rows; the funnel's score sweep
(K1) then also sees row L+1 (ROADMAP C), while the backtrace passes
exclude the padding through ``Lq_true``.  With ``resident_pack=
PACK_DISABLED`` the batches are packed per launch at the query's own
length.  Both must give the same hits — full and light, with the same
scores, end cells and paths — through the funnel and the altali loop.
"""

import copy
import os

import numpy as np
import pytest

from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.matrices import get_substitution_matrix
from hhsuite_tpu_torch.search import viterbi_search as vs_mod
from hhsuite_tpu_torch.search.query import (prepare_query_hmm,
                                            prepare_template_hmm,
                                            read_query_text)
from test_torch_funnel import _truncate_a3m

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def fixture_text():
    with open(f"{FIX}/query.a3m") as f:
        return f.read()


def _hit_key(h):
    return (h.entry, h.irep, h.light, h.score, h.i1, h.i2, h.j1, h.j2,
            h.matched_cols, tuple(h.states.tolist()))


@pytest.mark.parametrize("altali", [1, 4])
@pytest.mark.parametrize("Lq", [70, 90, 100])
def test_bucketed_query_gives_the_unbucketed_hits(fixture_text, monkeypatch,
                                                  Lq, altali):
    par = Parameters()
    par.nocontxt = True
    par.prefilter = False
    par.altali = altali
    par.Z = par.B = par.realign_max = 1     # K_cap 2 < 6: light hits
    par.z = par.b = 1
    par.early_stopping_filter = False
    mats = get_substitution_matrix(par.matrix)
    q, _qali, fmt = read_query_text(par, _truncate_a3m(fixture_text, Lq),
                                    "query.a3m", mats)
    prepare_query_hmm(par, q, mats, fmt)
    assert q.L == Lq and Lq % 32      # the pack path pads the query
    t0 = read_query_text(par, _truncate_a3m(fixture_text, 120), "t.a3m",
                         mats)[0]
    rng = np.random.RandomState(Lq)
    templates = []
    for k in range(6):
        t = copy.deepcopy(t0)
        t.f = (t.f * (1.0 + 0.3 * k * rng.rand(*t.f.shape))).astype(
            np.float32)
        if k >= 3:      # unrelated templates, below smin: light hits
            t.f[1:-1] = t.f[1:-1][rng.permutation(t.L)]
        t.f /= np.maximum(t.f.sum(axis=1, keepdims=True), 1e-30)
        t.name = t.file = f"t{k}"
        prepare_template_hmm(par, q, t, mats, 0)
        templates.append((f"t{k}", t))
    monkeypatch.setattr(vs_mod, "_funnel_ok", lambda dev: True)
    bucketed = vs_mod.viterbi_search(par, q, templates, device="cpu")
    unbucketed = vs_mod.viterbi_search(par, q, templates, device="cpu",
                                       resident_pack=vs_mod.PACK_DISABLED)
    assert any(h.light for h in bucketed)
    assert (altali > 1) == any(h.irep > 1 for h in bucketed)
    assert sorted(map(_hit_key, bucketed)) == sorted(map(_hit_key,
                                                         unbucketed))
