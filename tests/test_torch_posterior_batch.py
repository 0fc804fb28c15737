"""The port's batched F/B/MAC decoder (ops/posterior_batch.py, the plain
versions of R1-R4) against the JAX package's (hhsuite_tpu/ops/
posterior_batch.py) on the CPU, the same inputs to both.

Inputs: the PF02826 ``query.a3m`` self pair of tests/test_posterior_batch.py
(a strong self-alignment signal), and seeded numpy chunks in the search
path's staging (``chip_smoke.realign_inputs``: corridors from the interval
form, 0-3 exclusion bands, SS factors, a padding lane, ragged ``t_L``).
In global mode the port's lanes exit through their own last column
``t_L``; the JAX ``fb_mac_batch`` reads the padded width there, so a
global chunk is held lane by lane to the JAX decoder of that lane's
unpadded template.  The JAX version reassociates its f32 sums (``lax.associative_scan``), the
port's follow its kernels' segment order, so they meet within the JAX
tests' own tolerances: score rel 1e-3 / abs 0.05 (banded rel 2e-4 /
abs 2e-3), p_mm rtol 5e-3 / atol 1e-5, i2 and j2 equal, b_mac agreement
above 0.995, walks equal.  The mask builder and the packed walk payload
are exactly the JAX package's.
"""

import copy
import os

import numpy as np
import pytest
import torch

from chip_smoke import REALIGN_MACT, REALIGN_SHIFT, realign_inputs
from hhsuite_tpu_torch.ops import posterior_batch as PB

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def qt_pair():
    from hhsuite_tpu.constants import Parameters
    from hhsuite_tpu.matrices import get_substitution_matrix
    from hhsuite_tpu.search.engine import prepare_query_hmm, read_query_text
    from hhsuite_tpu.search.posterior import (prepare_query_transitions,
                                              prepare_template_transitions)

    par = Parameters()
    par.nocontxt = True
    mats = get_substitution_matrix(par.matrix)
    with open(os.path.join(FIX, "query.a3m")) as f:
        text = f.read()
    q, _qali, fmt = read_query_text(par, text, "query.a3m", mats)
    prepare_query_hmm(par, q, mats, fmt)
    # the prepared query doubles as the template, its emissions divided
    # by the background as IncludeNullModelInHMM does (hhhmm.cpp:2059)
    t = copy.deepcopy(q)
    t.p = (t.p / mats.pb[None, :]).astype(t.p.dtype)
    q.log2lin_transitions()
    prepare_query_transitions(q)
    t.log2lin_transitions()
    prepare_template_transitions(t)
    return par, q, t


def _jax(qp, qtr, tp, ttr, co, ss_f, ss0, local, t_L):
    from hhsuite_tpu.ops.posterior_batch import fb_mac_batch

    out = fb_mac_batch(qp, qtr, tp, ttr, co, REALIGN_SHIFT, REALIGN_MACT,
                       ss_fpow2=ss_f, ss0_fpow2=ss0, local=local, t_L=t_L)
    return [np.asarray(x) for x in out]


def _port(qp, qtr, tp, ttr, co, ss_f, ss0, local, t_L):
    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x))

    out = PB.fb_mac_batch(t(qp), t(qtr), t(tp), t(ttr), t(co),
                          REALIGN_SHIFT, REALIGN_MACT, t(ss_f), t(ss0),
                          local, t(t_L))
    return [x.numpy() for x in out]


def _walks_equal(j, p, kmax):
    """The JAX and the port walks of each decoder's own outputs agree
    in positions, states, counts and (to f32 tolerance) posteriors."""
    from hhsuite_tpu.ops.posterior_batch import mac_walk

    _s, jb, ji, jj, jp = j
    _s, pb, pi, pj, pp = p
    wj = [np.asarray(x) for x in mac_walk(jb, jp, ji, jj, kmax=kmax)]
    wp = [x.numpy() for x in PB.mac_walk(*(torch.from_numpy(x) for x in
                                           (pb, pp, pi, pj)), kmax)]
    for k in (0, 1, 2, 4, 5, 6):        # st, ii, jj, n, mm_count, empty
        np.testing.assert_array_equal(wj[k], wp[k])
    np.testing.assert_allclose(wj[3], wp[3], rtol=5e-3, atol=1e-5)
    return wp[4]


def _compare(j, p, score_tol):
    js, jb, ji, jj, jp = j
    ps, pb, pi, pj, pp = p
    fin = np.isfinite(js)
    np.testing.assert_array_equal(fin, np.isfinite(ps))
    np.testing.assert_allclose(ps[fin], js[fin], **score_tol)
    ok = np.isfinite(jp)           # the JAX global padding lane is 0/0
    np.testing.assert_allclose(pp[ok], jp[ok], rtol=5e-3, atol=1e-5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pj, jj)
    assert (pb == jb).mean() > 0.995


@pytest.mark.parametrize("local", [True, False])
def test_fixture_pair_matches_jax(qt_pair, local):
    par, q, t = qt_pair
    Lq, Lt = q.L, t.L
    co = np.zeros((1, Lq + 1, Lt + 1), bool)
    args = (q.p.astype(np.float32), q.tr.astype(np.float32),
            t.p.astype(np.float32)[None], t.tr.astype(np.float32)[None],
            co, None, None, local, np.array([Lt], np.int32))
    j, p = _jax(*args), _port(*args)
    _compare(j, p, dict(rtol=1e-3, atol=0.05))
    assert _walks_equal(j, p, Lq + Lt + 2)[0] > 100


def test_fixture_pair_banded_batched_ss(qt_pair):
    """B = 3: the full lane, a +-40 band, and a padding lane (every cell
    off); with SS factors on the band lane."""
    par, q, t = qt_pair
    Lq, Lt = q.L, t.L
    ii, jj = np.meshgrid(np.arange(Lq + 1), np.arange(Lt + 1),
                         indexing="ij")
    band = np.abs(ii - jj) > 40
    band[0, :] = False
    co = np.stack([np.zeros_like(band), band, np.ones_like(band)])
    rng = np.random.default_rng(7)
    ss_f = np.ones((3, Lq + 1, Lt + 1), np.float32)
    ss_f[1] = np.exp2(rng.uniform(-0.5, 0.5, (Lq + 1, Lt + 1)))
    ss0 = np.array([1.0, 1.3, 1.0], np.float32)
    tp = np.stack([t.p.astype(np.float32)] * 2 + [np.zeros_like(t.p,
                                                                np.float32)])
    ttr = np.stack([t.tr.astype(np.float32)] * 2
                   + [np.zeros_like(t.tr, np.float32)])
    args = (q.p.astype(np.float32), q.tr.astype(np.float32), tp, ttr, co,
            ss_f, ss0, True, np.array([Lt, Lt, 0], np.int32))
    j, p = _jax(*args), _port(*args)
    _compare(j, p, dict(rtol=2e-4, atol=2e-3))
    n = _walks_equal(j, p, Lq + Lt + 2)
    assert n[0] > 100 and n[1] > 100 and n[2] == 0
    assert np.isfinite(p[0][2])


# (Lq, Lt_pad, B, exclusion bands, SS, local, extras): seeded chunks
SEEDED = [(30, 128, 4, 0, False, True, "pad"),
          (41, 256, 3, 3, True, True, ""),
          (25, 128, 4, 2, True, False, "pad"),
          (1, 128, 2, 0, False, True, "")]


def _lane(args, out, b):
    """Lane b of a chunk's inputs and of the port's outputs, cut to the
    lane's own template width; asserts the cut columns are empty."""
    qp, qtr, tp, ttr, co, ss_f, ss0, local, t_L = args
    L = int(t_L[b])

    def cut(x, w):
        return None if x is None else x[b: b + 1, ..., :w]

    s, bm, i2, j2, pm = out
    assert not bm[b, :, L + 1:].any() and not pm[b, :, L + 1:].any()
    lane_args = (qp, qtr, tp[b: b + 1, : L + 2], ttr[b: b + 1, : L + 2],
                 cut(co, L + 1), cut(ss_f, L + 1),
                 None if ss0 is None else ss0[b: b + 1], local,
                 t_L[b: b + 1])
    return lane_args, [s[b: b + 1], cut(bm, L + 1), i2[b: b + 1],
                       j2[b: b + 1], cut(pm, L + 1)]


@pytest.mark.parametrize("case", SEEDED, ids=lambda c: "-".join(map(str, c)))
def test_seeded_chunks_match_jax(case):
    Lq, Lt_pad, B, P, ss, local, extras = case
    x = realign_inputs(Lq, Lt_pad, B, P, ss, seed=3 * Lq + B, device="cpu",
                       extras=extras)

    def n(k):
        return None if x[k] is None else x[k].numpy()

    args = (n("qp"), n("qtr"), n("tp"), n("ttr"), n("co"), n("ss_f"),
            n("ss0"), local, n("t_L"))
    p = _port(*args)
    if local:
        j = _jax(*args)
        _compare(j, p, dict(rtol=1e-3, atol=0.05))
        _walks_equal(j, p, x["kmax"])
        return
    # global: each lane against the JAX decoder of its unpadded template
    lanes = [b for b in range(B) if args[-1][b] > 0]
    assert len(set(int(args[-1][b]) for b in lanes)) > 1     # ragged
    for b in lanes:
        lane_args, p_b = _lane(args, p, b)
        j_b = _jax(*lane_args)
        _compare(j_b, p_b, dict(rtol=1e-3, atol=0.05))
        _walks_equal(j_b, p_b, Lq + int(args[-1][b]) + 2)
        assert np.isfinite(p_b[0]).all()
    if "pad" in extras:
        assert (p[2][-1], p[3][-1]) == (0, 0)


def test_mask_builder_matches_jax():
    """realign_mask_device on the intervals of seeded paths (0-3 bands,
    a padding lane, ragged lengths) equals the JAX package's."""
    from hhsuite_tpu.ops.posterior_batch import realign_mask_device as jmask

    from hhsuite_tpu_torch.ops.viterbi import band_intervals

    rng = np.random.default_rng(11)
    Lq, Lt_pad, B, P = 37, 128, 5, 3
    Wj = Lt_pad + 1
    rect = np.zeros((B, 4), np.int32)
    corner = np.zeros(B, np.int32)
    tL = np.zeros(B, np.int32)
    F = [np.ones((B, Wj), np.int16), np.zeros((B, Wj), np.int16),
         np.ones((B, Lq + 1), np.int16), np.zeros((B, Lq + 1), np.int16)]
    E = [np.ones((B, P, Wj), np.int16), np.zeros((B, P, Wj), np.int16),
         np.ones((B, P, Lq + 1), np.int16),
         np.zeros((B, P, Lq + 1), np.int16)]
    for b in range(B - 1):
        L = int(rng.integers(40, Lt_pad + 1))
        tL[b] = L
        corner[b] = int(rng.integers(0, L + 1))
        i = np.sort(rng.choice(np.arange(1, Lq + 1), 20, replace=False))
        j = np.sort(rng.choice(np.arange(1, L + 1), 20, replace=False))
        rect[b] = (i[0], j[0], i[-1], j[-1])
        for k, v in enumerate(band_intervals(i[::-1], j[::-1], 40, Lq, L,
                                             Lq + 1, L + 1)):
            F[k][b, : len(v)] = v
        for p in range(b % (P + 1)):
            ei = np.sort(rng.choice(np.arange(1, Lq + 1), 10, replace=False))
            ej = np.sort(rng.choice(np.arange(1, L + 1), 10, replace=False))
            for k, v in enumerate(band_intervals(ei, ej, 2, Lq, L, Lq + 1,
                                                 L + 1)):
                E[k][b, p, : len(v)] = v
    args = (rect, corner, tL, *F, *E)
    want = np.asarray(jmask(*args))
    got = PB.realign_mask_device(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_walk_matches_jax(qt_pair):
    """mac_walk_packed8's payload and its host unpack equal the JAX
    package's, byte for byte, on the same decoder outputs (an empty
    lane among them)."""
    from hhsuite_tpu.ops.posterior_batch import mac_walk_packed8 as jpack
    from hhsuite_tpu.ops.posterior_batch import mac_walk_unpack8 as junpack

    x = realign_inputs(24, 128, 4, 1, False, seed=5, device="cpu",
                       extras="empty,pad")
    score, b, i2, j2, pmm = PB.fb_mac_batch(
        x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], REALIGN_SHIFT,
        REALIGN_MACT, t_L=x["t_L"])
    kmax = x["kmax"]
    got = PB.mac_walk_packed8(b, pmm, i2, j2, score, kmax).numpy()
    want = np.asarray(jpack(b.numpy(), pmm.numpy(), i2.numpy(), j2.numpy(),
                            score.numpy(), kmax=kmax))
    np.testing.assert_array_equal(got, want)
    for a, w in zip(PB.mac_walk_unpack8(got, kmax), junpack(want, kmax)):
        np.testing.assert_array_equal(a, w)
    assert PB.mac_walk_unpack8(got, kmax)[3][1] == 0
