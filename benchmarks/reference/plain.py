"""A plain NumPy HHsearch: the reference that the benchmark's check holds
the program to.

Written from HH-suite's published recurrences (Soding 2005, Remmert et
al. 2012, Steinegger et al. 2019) at HH-suite 3.3's hhsearch defaults,
for the profiles the benchmark's databases hold: single-sequence a3m
entries with predicted secondary structure.  It imports nothing of the
program.  It reads only the raw tables that HH-suite itself ships
(``data/hhsuite_tables.npz``: the Gonnet matrix and the confusion table
and background of predicted against observed secondary structure) and
HH-suite's constants, written below.

Math is exact float64 (``log2``, ``exp2``), where the program uses
HH-suite's fast polynomial approximations in float32; the MAC step runs
in float32 with HH-suite's order of operations, as the program does.

* ``profile``: a single-sequence profile HMM: transitions with their
  pseudocounts, substitution-matrix amino-acid pseudocounts, the
  background ``pav``.
* ``viterbi``: the local HMM-HMM Viterbi with the secondary-structure
  term, anti-diagonal by anti-diagonal, batched over templates, with its
  backtrace, the score with the correlation term and the SS score taken
  out, and the P-value and E-value of the hit.
* ``realign``: forward, backward (log space) and the MAC alignment.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "hhsuite_tables.npz")

AA = "ARNDCQEGHILKMFPSTWYV"
_AA_CODE = np.full(256, -1, np.int64)
for _k, _c in enumerate(AA):
    _AA_CODE[ord(_c)] = _AA_CODE[ord(_c.lower())] = _k
for _c, _to in (("B", "D"), ("Z", "E"), ("U", "C")):
    _AA_CODE[ord(_c)] = _AA_CODE[ord(_c.lower())] = AA.index(_to)
ANY = 20                  # X and every other letter: the background
_SS_CODE = np.zeros(256, np.int64)
for _k, _c in enumerate("-HEC"):
    _SS_CODE[ord(_c)] = _k
_CF_CODE = np.zeros(256, np.int64)
for _k in range(10):
    _CF_CODE[ord("0") + _k] = _k + 1

# transitions, in HH-suite's order
M2M, M2I, M2D, I2M, I2I, D2M, D2D = range(7)
# states of an alignment's steps
STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6

# hhsearch's defaults (HH-suite 3.3, src/hhdecl.cpp)
DEFAULTS = {
    "shift": -0.03, "corr": 0.1, "ssw": 0.11, "ssw_realign": 0.11,
    "mact": 0.3501, "gapb": 1.0, "gapd": 0.15, "gape": 1.0, "gapf": 0.6,
    "gapg": 0.6, "gaph": 0.6, "gapi": 0.6, "pca": 1.0, "pcb": 1.5,
    "e": 1e-3, "path_width": 40,
}

# the EVD fits of local HMM-HMM scores, lamda and mu against the lengths
# and diversities of both profiles (HH-suite, src/hhhitlist-inl.h)
_LAMDA = (np.array([-0.73195, -1.43792, -1.18839, -3.01141]),
          np.array([[-0.52356, -3.37650, 1.12984, -0.46796],
                    [-4.71361, 0.14166, 1.66807, 0.16383],
                    [-0.94895, -1.24358, -1.20293, 0.95434],
                    [-0.00318, 0.53022, -0.04914, -0.77046]]),
          np.array([2.45630, 3.02905, 2.53803, 2.64379]))
_MU = (np.array([-4.25264, -3.63484, -5.86653, -4.78472, -2.76356,
                 -2.21580]),
       np.array([[1.96172, 1.07181, -7.41256, 0.26471],
                 [0.84643, 1.46777, -1.04800, -0.51425],
                 [1.42697, 1.99927, 0.64647, 0.27834],
                 [1.34216, 1.64064, 0.35538, -8.08311],
                 [2.30046, 1.31700, -0.46435, -0.46803],
                 [0.90090, -3.53067, 0.59212, 1.47503]]),
       np.array([-1.26036, 1.52812, 1.58413, -1.90409, 0.92803, -0.66871]))

LN2 = math.log(2.0)
NEG = -np.inf


@dataclass
class Tables:
    pb: np.ndarray      # (20,) background frequencies
    R: np.ndarray       # (20, 20) R[a, b] = P(a | b)
    S33: np.ndarray     # (4, 11, 4, 11) log2-odds of two predicted states


def tables(path: str = DATA) -> Tables:
    t = np.load(path)
    P = t["gonnet"].astype(np.float64).reshape(20, 20) * 1e-6
    P /= P.sum()
    pb = P.sum(axis=1)
    ppred = t["ss_ppred"].astype(np.float64).reshape(11, 4, 8)
    pobs = t["ss_pobs"].astype(np.float64)
    p73 = ppred.transpose(2, 1, 0)[1:]            # (A, B, cf), A observed
    S33 = np.log2(np.einsum("abc,ade,a->bcde", p73, p73, pobs[1:]))
    return Tables(pb=pb, R=P / pb[None, :], S33=S33)


# ------------------------------------------------------------- profiles ----

@dataclass
class Entry:
    """One single-sequence a3m entry."""
    name: str
    longname: str
    seq: str
    ss_pred: Optional[str] = None
    ss_conf: Optional[str] = None


def read_a3m(text: str) -> Entry:
    recs = [r for r in text.split(">") if r.strip()]
    rows = {}
    main = None
    for r in recs:
        head, _, body = r.partition("\n")
        seq = "".join(body.split())
        key = head.split()[0]
        if key in ("ss_pred", "ss_conf"):
            rows[key] = seq
        elif main is None:
            main = (head.strip(), seq)
    if main is None:
        raise ValueError("an a3m entry without a sequence")
    head, seq = main
    return Entry(head.split()[0], head, seq, rows.get("ss_pred"),
                 rows.get("ss_conf"))


@dataclass
class Profile:
    name: str
    longname: str
    L: int
    p: np.ndarray          # (L+2, 20) emissions with pseudocounts
    tr: np.ndarray         # (L+1, 7) log2 transitions, pseudocounts in
    pav: np.ndarray        # (20,) background of the profile
    neff: float
    ss_pred: np.ndarray    # (L+2,) 0 = none
    ss_conf: np.ndarray    # (L+2,)
    has_ss: bool


def transition_pseudocounts(tr, neff_m, neff_i, neff_d, L, par=DEFAULTS):
    """HH-suite's transition pseudocounts (log2 in and out): the
    observed transitions of each state, weighted by its diversity,
    mixed with gap priors; gap-open log-odds scaled by gapf/gapg, the
    extensions by gaph/gapi."""
    pM2D = pM2I = par["gapd"] * 0.0286
    pM2M = 1.0 - pM2D - pM2I
    pII = par["gape"] / (par["gape"] - 1.0 + 1.0 / 0.75)
    pIM = 1.0 - pII
    pDD, pDM = pII, pIM
    b = par["gapb"]
    tiny = float(np.finfo(np.float32).tiny)
    out = tr.copy()
    ex = np.exp2(tr)
    with np.errstate(divide="ignore"):
        nm = neff_m[: L + 1] - 1.0
        p0 = nm * ex[:, M2M] + b * pM2M
        p1 = nm * ex[:, M2D] + b * pM2D
        p2 = nm * ex[:, M2I] + b * pM2I
        p1[[0, L]] = 0.0
        p2[[0, L]] = 0.0
        s = p0 + p1 + p2 + tiny
        out[:, M2M] = np.log2(p0 / s)
        out[:, M2D] = np.log2(p1 / s) * par["gapf"]
        out[:, M2I] = np.log2(p2 / s) * par["gapg"]
        p0 = neff_i[: L + 1] * ex[:, I2M] + b * pIM
        p1 = neff_i[: L + 1] * ex[:, I2I] + b * pII
        s = p0 + p1 + tiny
        out[:, I2M] = np.log2(p0 / s)
        out[:, I2I] = np.log2(p1 / s) * par["gapi"]
        p0 = neff_d[: L + 1] * ex[:, D2M] + b * pDM
        p1 = neff_d[: L + 1] * ex[:, D2D] + b * pDD
        p1[L] = 0.0
        s = p0 + p1 + tiny
        out[:, D2M] = np.log2(p0 / s)
        out[:, D2D] = np.log2(p1 / s) * par["gaph"]
    return out


def profile(entry: Entry, tab: Tables, par=DEFAULTS) -> Profile:
    """The profile HMM of a single sequence."""
    codes = _AA_CODE[np.frombuffer(entry.seq.encode(), np.uint8)]
    codes = np.where(codes < 0, ANY, codes)
    L = len(codes)
    f = np.tile(tab.pb, (L + 2, 1))
    res = np.nonzero(codes < ANY)[0]
    f[1 + res] = 0.0
    f[1 + res, codes[res]] = 1.0
    neff_m = np.ones(L + 2)
    neff_i = np.zeros(L + 2)
    neff_d = np.zeros(L + 2)
    neff_m[0] = neff_i[0] = neff_d[0] = 99.999
    tr = np.full((L + 1, 7), NEG)
    tr[:, M2M] = 0.0
    tr[[0, L], I2M] = 0.0
    tr[0, D2M] = 0.0
    tr = transition_pseudocounts(tr, neff_m, neff_i, neff_d, L, par)
    return _finish(entry, f, tr, neff_m, 1.0, L, tab, par)


def _finish(entry, f, tr, neff_m, neff, L, tab, par):
    """Amino-acid pseudocounts from the substitution matrix, admixed by
    each column's diversity, and the profile's background."""
    g = f @ tab.R.T
    tau = np.minimum(1.0, par["pca"] / (1.0 + neff_m / par["pcb"]))[:, None]
    p = (1.0 - tau) * f + tau * g
    acc = tab.pb * 100.0 / neff + p[1: L + 1].sum(axis=0)
    pav = acc / acc.sum()
    p[0] = p[L + 1] = pav
    ss_pred = np.zeros(L + 2, np.int64)
    ss_conf = np.zeros(L + 2, np.int64)
    has_ss = entry.ss_pred is not None
    if has_ss:
        ss_pred[1: L + 1] = _SS_CODE[np.frombuffer(
            entry.ss_pred.encode(), np.uint8)][:L]
        if entry.ss_conf is not None:
            ss_conf[1: L + 1] = _CF_CODE[np.frombuffer(
                entry.ss_conf.encode(), np.uint8)][:L]
        else:
            ss_conf[1: L + 1] = 5
    return Profile(entry.name, entry.longname, L, p, tr, pav, float(neff),
                   ss_pred, ss_conf, has_ss)


def odds(t: Profile, q_pav: np.ndarray) -> np.ndarray:
    """The template's emissions over the null model, the mean of both
    profiles' backgrounds (hhsearch's column score 1)."""
    return t.p / (0.5 * (q_pav + t.pav))[None, :]


# -------------------------------------------------------------- Viterbi ----

@dataclass
class Hit:
    name: str
    L: int
    score: float
    score_ss: float
    i: np.ndarray          # steps, end to start
    j: np.ndarray
    states: np.ndarray
    i1: int
    j1: int
    i2: int
    j2: int
    evalue: float = 0.0
    log_evalue: float = 0.0
    rank_key: float = 0.0               # HH-suite's sort key, best first
    pairs: Optional[frozenset] = None   # the MAC realignment's pairs


def ss_scores(q: Profile, t: Profile, tab: Tables) -> np.ndarray:
    """(Lq+2, Lt+2) log2-odds of predicted against predicted state,
    0 where either side has no prediction."""
    if not (q.has_ss and t.has_ss):
        return np.zeros((q.L + 2, t.L + 2))
    return tab.S33[q.ss_pred[:, None], q.ss_conf[:, None],
                   t.ss_pred[None, :], t.ss_conf[None, :]]


def _pad_rows(x: np.ndarray, n: int, fill: float) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill)
    out[: x.shape[0]] = x
    return out


def viterbi(q: Profile, temps: Sequence[Profile], tab: Tables, rnd=None,
            par=DEFAULTS) -> List[Hit]:
    """The best local alignment of the query with each template and its
    score, with the SS term in the recurrence (hhsearch -ssm 2).
    ``rnd``, where given, rounds the inputs and every sum of the
    recurrence (the control runs it in a lower precision)."""
    rnd = rnd or (lambda x: x)
    dtype = np.float64
    B = len(temps)
    Lq = q.L
    Ls = np.array([t.L for t in temps])
    Lt = int(Ls.max())
    W = Lq + 1
    S = np.full((B, Lq + 1, Lt + 1), NEG)
    Sraw, SSv = [], []
    for b, t in enumerate(temps):
        with np.errstate(divide="ignore"):
            raw = np.log2(q.p @ odds(t, q.pav).T)
        ssv = par["ssw"] * ss_scores(q, t, tab)
        Sraw.append(raw)
        SSv.append(ssv)
        S[b, 1:, 1: t.L + 1] = (raw + par["shift"] + ssv)[1: Lq + 1,
                                                          1: t.L + 1]
    S = rnd(S)
    qtr = rnd(q.tr)
    ttr = rnd(np.stack([_pad_rows(t.tr, Lt + 2, NEG) for t in temps]))
    ii = np.arange(W)
    im1 = np.maximum(ii - 1, 0)
    zero = dtype(0.0)
    neg = np.full((B, W), NEG, dtype)

    def up(x):
        return np.concatenate([neg[:, :1], x[:, :-1]], axis=1)

    def boundary(d):
        jj = d - ii
        on = ((ii == 0) | (jj == 0)) & (jj >= 0)
        on = on[None, :] & (jj[None, :] <= Ls[:, None])
        return np.where(on, zero, dtype(NEG))

    mm1, mm2 = boundary(1), boundary(0)
    gd1 = im1_ = dg1 = mi1 = neg
    gd2 = im2 = dg2 = mi2 = neg
    bt = np.zeros((B, Lq + 1, Lt + 1), np.uint8)
    best = np.full(B, NEG)
    bi = np.zeros(B, np.int64)
    bj = np.zeros(B, np.int64)
    qm2m, qi2m, qd2m = qtr[im1, M2M], qtr[im1, I2M], qtr[im1, D2M]
    qm2d, qd2d = qtr[im1, M2D], qtr[im1, D2D]
    qm2i0, qi2i0 = qtr[ii, M2I], qtr[ii, I2I]
    bix = np.arange(B)[:, None]
    for d in range(2, Lq + Lt + 1):
        jj = d - ii
        jc = np.clip(jj, 0, Lt)
        jm = np.clip(jj - 1, 0, Lt)
        on = (ii >= 1)[None, :] & (jj >= 1)[None, :] & \
            (jj[None, :] <= Ls[:, None])
        t_m2m, t_d2m, t_i2m = ttr[bix, jm, M2M], ttr[bix, jm, D2M], \
            ttr[bix, jm, I2M]
        t_m2d, t_d2d = ttr[bix, jm, M2D], ttr[bix, jm, D2D]
        t_m2i0, t_i2i0 = ttr[bix, jc, M2I], ttr[bix, jc, I2I]
        c = [rnd(rnd(up(mm2) + qm2m) + t_m2m), rnd(rnd(up(gd2) + qm2m)
                                                   + t_d2m),
             rnd(rnd(up(im2) + qi2m) + t_m2m), rnd(rnd(up(dg2) + qd2m)
                                                   + t_m2m),
             rnd(rnd(up(mi2) + qm2m) + t_i2m)]
        code = np.full((B, W), STOP, np.uint8)
        top = np.full((B, W), zero)
        for k, st in zip(range(5), (MM, GD, IM, DG, MI)):
            better = c[k] > top
            code = np.where(better, st, code)
            top = np.where(better, c[k], top)
        mm_new = rnd(top + S[bix, ii[None, :], jc])
        a_dg, b_dg = rnd(up(mm1) + qm2d), rnd(up(dg1) + qd2d)
        a_mi = rnd(rnd(up(mm1) + qm2m) + t_m2i0)
        b_mi = rnd(rnd(up(mi1) + qm2m) + t_i2i0)
        a_gd, b_gd = rnd(mm1 + t_m2d), rnd(gd1 + t_d2d)
        a_im = rnd(rnd(mm1 + qm2i0) + t_m2m)
        b_im = rnd(rnd(im1_ + qi2i0) + t_m2m)
        byte = (code | np.where(a_gd > b_gd, 8, 0)
                | np.where(a_im > b_im, 16, 0)
                | np.where(a_dg > b_dg, 32, 0)
                | np.where(a_mi > b_mi, 64, 0)).astype(np.uint8)
        rows = np.nonzero(on.any(axis=0))[0]
        if rows.size:
            sel = on[:, rows]
            cur = bt[:, rows, jj[rows]]
            bt[:, rows, jj[rows]] = np.where(sel, byte[:, rows], cur)
        mm_new = np.where(on, mm_new, boundary(d))
        dg_new = np.where(on, np.maximum(a_dg, b_dg), neg)
        mi_new = np.where(on, np.maximum(a_mi, b_mi), neg)
        gd_new = np.where(on, np.maximum(a_gd, b_gd), neg)
        im_new = np.where(on, np.maximum(a_im, b_im), neg)
        cand = np.where(on, mm_new, NEG)
        k = cand.argmax(axis=1)
        v = cand[np.arange(B), k]
        upd = v > best
        best = np.where(upd, v, best)
        bi = np.where(upd, k, bi)
        bj = np.where(upd, d - k, bj)
        mm2, gd2, im2, dg2, mi2 = mm1, gd1, im1_, dg1, mi1
        mm1, gd1, im1_, dg1, mi1 = mm_new, gd_new, im_new, dg_new, mi_new
    hits = []
    for b, t in enumerate(temps):
        i_s, j_s, st = backtrace(bt[b], int(bi[b]), int(bj[b]))
        mm = st == MM
        sv = np.where(mm, Sraw[b][i_s, j_s], 0.0)
        score_ss = float(SSv[b][i_s[mm], j_s[mm]].sum())
        corr = sum(float((sv[lag:] * sv[:-lag]).sum()) for lag in (1, 2, 3, 4))
        score = float(best[b]) - score_ss + par["corr"] * corr
        hits.append(Hit(t.name, t.L, score, score_ss, i_s, j_s, st,
                        int(i_s[-1]), int(j_s[-1]), int(bi[b]),
                        int(bj[b])))
    return hits


def backtrace(bt: np.ndarray, i: int, j: int):
    """The path into the best cell, end to start; the first step's state
    counts as a match, as in HH-suite."""
    i_s, j_s, st = [], [], []
    state = MM
    while state != STOP:
        i_s.append(i)
        j_s.append(j)
        st.append(state)
        b = int(bt[i, j])
        if state == MM:
            if i <= 1 or j <= 1:
                state = STOP
            else:
                state = b & 7
                i -= 1
                j -= 1
        elif state in (GD, IM):
            if j <= 1:
                state = STOP
            else:
                if b & (8 if state == GD else 16):
                    state = MM
                j -= 1
        elif state in (DG, MI):
            if i <= 1:
                state = STOP
            else:
                if b & (32 if state == DG else 64):
                    state = MM
                i -= 1
        else:
            state = STOP
    st[-1] = MM
    return (np.array(i_s, np.int64), np.array(j_s, np.int64),
            np.array(st, np.int64))


def _nn(x, bias, w, v):
    return (1.0 / (1.0 + np.exp(-(x @ w.T + bias)))) @ v


def calibrate(hits: List[Hit], q: Profile, t_neff: Dict[str, float],
              n_searched: int) -> None:
    """P- and E-value from the EVD whose lamda and mu HH-suite's fits give
    for these lengths and diversities, and HH-suite's sort key (the
    P-value with the SS score in part), best first."""
    for h in hits:
        x = np.array([math.log(q.L) / math.log(1000.0),
                      math.log(h.L) / math.log(1000.0), q.neff / 10.0,
                      t_neff[h.name] / 10.0])
        lam = float(_nn(x, *_LAMDA))
        mu = 20.0 * float(_nn(x, *_MU))
        z = lam * (h.score - mu)
        if z > 10:
            logp = -z
            pval = math.exp(-z)
        else:
            pval = -math.expm1(-math.exp(-z))
            logp = math.log(pval)
        h.log_evalue = logp + math.log(n_searched)
        h.evalue = math.exp(h.log_evalue)
        base = logp if logp < -10.0 else math.log(-math.log1p(-pval))
        h.rank_key = (base / 0.45 - min(lam * h.score_ss,
                                        max(0.0, 0.2 * (h.score - 8.0)))
                      / 0.45 - 3.0)


# --------------------------------------------------------------- realign ----

def _linear_query(q: Profile) -> np.ndarray:
    tr = np.exp2(q.tr)
    tr[0, [M2D, M2I, I2M, I2I, D2M, D2D]] = 0.0
    L = q.L
    tr[L, M2M] = 1.0
    tr[L, [M2D, M2I, I2M, I2I]] = 0.0
    tr[L, D2M] = 1.0
    return tr


def _linear_template(t: Profile) -> np.ndarray:
    tr = np.exp2(t.tr)
    L = t.L
    for r in (0, L):
        tr[r] = 0.0
        tr[r, M2M] = 1.0
    tr[L, D2M] = 1.0
    return tr


def realign_mask(hit: Hit, Lq: int, Lt: int, width: int) -> np.ndarray:
    """Cells off limits to the realignment: all but the rectangles before
    and after the Viterbi alignment and a corridor of ``width`` around
    its path."""
    co = np.ones((Lq + 1, Lt + 1), bool)
    co[1: hit.i1, 1: hit.j1] = False
    co[hit.i2 + 1:, hit.j2 + 1:] = False
    for i, j in zip(hit.i.tolist(), hit.j.tolist()):
        co[max(1, i - width): min(Lq, i + width) + 1, j] = False
        co[i, max(1, j - width): min(Lt, j + width) + 1] = False
    co[0, :] = False
    co[:, 0] = False
    return co


def _lse(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = np.maximum(m, x)
    safe = np.where(np.isfinite(m), m, 0.0)
    s = sum(np.exp(x - safe) for x in xs)
    with np.errstate(divide="ignore"):
        return np.where(np.isfinite(m), safe + np.log(s), NEG)


def realign(q: Profile, temps: Sequence[Profile], hits: Sequence[Hit],
            tab: Tables, low=None, par=DEFAULTS) -> List[tuple]:
    """The MAC realignment of each hit (its template ``temps[k]``):
    posteriors by forward and backward in log space within the hit's
    corridor, then HH-suite's maximum-accuracy alignment at threshold
    ``mact``.  Returns each realignment's aligned pairs and its path
    (end to start).  ``low`` (the control) runs forward and backward in
    float32 and the MAC step through the rounding ``low``."""
    ft = np.float32 if low is not None else np.float64
    B = len(hits)
    Lq = q.L
    Ls = np.array([t.L for t in temps])
    Lt = int(Ls.max())
    W = Lq + 1
    with np.errstate(divide="ignore"):
        lq = np.log(_linear_query(q))
        lt = np.stack([_pad_rows(np.log(_linear_template(t)), Lt + 2, NEG)
                       for t in temps])
    logE = np.full((B, Lq + 2, Lt + 2), NEG)
    co = np.ones((B, Lq + 2, Lt + 2), bool)
    for b, (t, h) in enumerate(zip(temps, hits)):
        with np.errstate(divide="ignore"):
            e = np.log(q.p @ odds(t, q.pav).T)
        ss = ss_scores(q, t, tab)
        ssl = par["ssw_realign"] * ss * LN2
        # HH-suite's boundary terms: row 1 scores no SS, and column 1
        # scores row 1's state against the template's end (no state)
        ssl[1, :] = 0.0
        if q.has_ss and t.has_ss:
            ssl[2:, 1] = par["ssw_realign"] * tab.S33[
                q.ss_pred[1], q.ss_conf[1], 0, 0] * LN2
        logE[b, : Lq + 2, : t.L + 2] = e + par["shift"] * LN2 + ssl
        co[b, : Lq + 1, : t.L + 1] = realign_mask(
            h, Lq, t.L, par["path_width"])
        co[b, 0, :] = co[b, :, 0] = True
    lq, lt, logE = lq.astype(ft), lt.astype(ft), logE.astype(ft)
    ii = np.arange(W)
    bix = np.arange(B)[:, None]
    neg = np.full((B, W), NEG, ft)

    def up(x):
        return np.concatenate([neg[:, :1], x[:, :-1]], axis=1)

    def down(x):
        return np.concatenate([x[:, 1:], neg[:, :1]], axis=1)

    # forward
    F = np.full((B, Lq + 1, Lt + 1), NEG, ft)
    p1 = dict.fromkeys(("mm", "gd", "im", "dg", "mi"), neg)
    p2 = dict(p1)
    im1 = np.maximum(ii - 1, 0)
    for d in range(2, Lq + Lt + 1):
        jj = d - ii
        jc = np.clip(jj, 0, Lt)
        jm = np.clip(jj - 1, 0, Lt + 1)
        on = (ii >= 1)[None, :] & (jj >= 1)[None, :] & \
            (jj[None, :] <= Ls[:, None])
        on = on & ~co[bix, ii[None, :], jc]
        lqp = lq[im1]
        tm1 = lt[bix, jm]
        t0 = lt[bix, jc]
        pred = _lse(up(p2["mm"]) + lqp[:, M2M] + tm1[..., M2M],
                    up(p2["gd"]) + lqp[:, M2M] + tm1[..., D2M],
                    up(p2["im"]) + lqp[:, I2M] + tm1[..., M2M],
                    up(p2["dg"]) + lqp[:, D2M] + tm1[..., M2M],
                    up(p2["mi"]) + lqp[:, M2M] + tm1[..., I2M])
        mm = logE[bix, ii[None, :], jc] + np.logaddexp(0.0, pred)
        gd = np.logaddexp(p1["mm"] + tm1[..., M2D], p1["gd"] + tm1[..., D2D])
        im = np.logaddexp(p1["mm"] + lq[ii, M2I] + tm1[..., M2M],
                          p1["im"] + lq[ii, I2I] + tm1[..., M2M])
        dg = np.logaddexp(up(p1["mm"]) + lqp[:, M2D],
                          up(p1["dg"]) + lqp[:, D2D])
        mi = np.logaddexp(up(p1["mm"]) + lqp[:, M2M] + t0[..., M2I],
                          up(p1["mi"]) + lqp[:, M2M] + t0[..., I2I])
        new = {k: np.where(on, v, NEG) for k, v in
               (("mm", mm), ("gd", gd), ("im", im), ("dg", dg), ("mi", mi))}
        rows = np.nonzero(on.any(axis=0))[0]
        F[:, rows, jj[rows]] = np.where(on[:, rows], new["mm"][:, rows],
                                        F[:, rows, jj[rows]])
        p2, p1 = p1, new
    flat = F.reshape(B, -1)
    mx = flat.max(axis=1)
    log_pf = mx + np.log(np.exp(-mx) + np.exp(flat - mx[:, None]).sum(axis=1))

    # backward
    Bm = np.full((B, Lq + 1, Lt + 1), NEG, ft)
    n1 = dict.fromkeys(("mm", "gd", "im", "dg", "mi"), neg)
    n2 = dict(n1)
    ip1 = np.minimum(ii + 1, Lq)
    last_row = ii == Lq
    for d in range(Lq + Lt, 1, -1):
        jj = d - ii
        jc = np.clip(jj, 0, Lt)
        jp = np.clip(jj + 1, 0, Lt + 1)
        on = (ii >= 1)[None, :] & (jj >= 1)[None, :] & \
            (jj[None, :] <= Ls[:, None])
        on = on & ~co[bix, ii[None, :], jc]
        edge = last_row[None, :] | (jj[None, :] == Ls[:, None])
        t0 = lt[bix, jc]
        lqi = lq[ii]
        pm = down(n2["mm"]) + logE[bix, ip1[None, :], jp]
        mm = _lse(np.zeros((B, W), ft), pm + lqi[:, M2M] + t0[..., M2M],
                  n1["gd"] + t0[..., M2D],
                  n1["im"] + lqi[:, M2I] + t0[..., M2M],
                  down(n1["dg"]) + lqi[:, M2D],
                  down(n1["mi"]) + lqi[:, M2M] + t0[..., M2I])
        gd = np.logaddexp(pm + lqi[:, M2M] + t0[..., D2M],
                          n1["gd"] + t0[..., D2D])
        im = np.logaddexp(pm + lqi[:, I2M] + t0[..., M2M],
                          n1["im"] + lqi[:, I2I] + t0[..., M2M])
        dg = np.logaddexp(pm + lqi[:, D2M] + t0[..., M2M],
                          down(n1["dg"]) + lqi[:, D2D])
        mi = np.logaddexp(pm + lqi[:, M2M] + t0[..., I2M],
                          down(n1["mi"]) + lqi[:, M2M] + t0[..., I2I])
        new = {"mm": np.where(edge, ft(0.0), mm)}
        for k, v in (("gd", gd), ("im", im), ("dg", dg), ("mi", mi)):
            new[k] = np.where(edge, NEG, v)
        new = {k: np.where(on, v, NEG) for k, v in new.items()}
        rows = np.nonzero(on.any(axis=0))[0]
        Bm[:, rows, jj[rows]] = np.where(on[:, rows], new["mm"][:, rows],
                                         Bm[:, rows, jj[rows]])
        n2, n1 = n1, new
    with np.errstate(invalid="ignore"):
        post = np.exp(F + Bm - log_pf[:, None, None])
    return mac(post, co[:, : Lq + 1, : Lt + 1], Ls, par["mact"], low)


def mac(post: np.ndarray, co: np.ndarray, Ls: np.ndarray, mact: float,
        low=None) -> List[tuple]:
    """HH-suite's maximum-accuracy alignment (local) over each hit's
    posteriors ``post`` (B, Lq+1, Lt+1), anti-diagonal by anti-diagonal:
    float32 in HH-suite's order of operations (each result rounded by
    ``low``, where given), its backtrace and its boundary rule (no step
    leaves row 1 or column 1).  Returns (pairs, path) a hit."""
    f32 = np.float32
    if low is None:
        def r(x):
            return x
    else:
        def r(x):
            return low(x).astype(f32)
    B, W, _ = post.shape
    Lq, Lt = W - 1, post.shape[2] - 1
    P = r(np.nan_to_num(post).astype(f32))
    m32 = f32(mact)
    half = f32(0.5) * m32
    off = f32(-np.finfo(f32).tiny)
    ii = np.arange(W)
    bix = np.arange(B)[:, None]
    zero = np.zeros((B, W), f32)

    def up(x):
        return np.concatenate([zero[:, :1], x[:, :-1]], axis=1)

    S = np.full((B, W, Lt + 1), -np.inf, f32)
    code = np.zeros((B, W, Lt + 1), np.uint8)
    s1 = s2 = zero
    for d in range(2, Lq + Lt + 1):
        jj = d - ii
        jc = np.clip(jj, 0, Lt)
        grid = (ii >= 1)[None, :] & (jj >= 1)[None, :] & \
            (jj[None, :] <= Ls[:, None])
        shut = co[bix, ii[None, :], jc]
        p = P[bix, ii[None, :], jc]
        t1 = r(p - m32)
        t2 = r(r(up(s2) + p) - m32)
        t3 = r(up(s1) - half)
        t4 = r(s1 - half)
        mx = np.where(t1 > t2, t1, t2)
        c = np.where(t1 > t2, STOP, MM)
        c = np.where(t3 > mx, MI, c)
        mx = np.where(t3 > mx, t3, mx)
        c = np.where(t4 > mx, IM, c)
        mx = np.where(t4 > mx, t4, mx)
        live = grid & ~shut
        new = np.where(live, mx, np.where(grid, off, f32(0))).astype(f32)
        rows = np.nonzero(grid.any(axis=0))[0]
        S[:, rows, jj[rows]] = np.where(live[:, rows], new[:, rows],
                                        S[:, rows, jj[rows]])
        code[:, rows, jj[rows]] = np.where(live[:, rows], c[:, rows],
                                           code[:, rows, jj[rows]])
        s2, s1 = s1, new
    out = []
    for b in range(B):
        flat = int(np.argmax(S[b].reshape(-1)))
        i, j = divmod(flat, Lt + 1)
        bb = code[b].copy()
        bb[:, 1] = STOP
        bb[1, :] = STOP
        if bb[i, j] != MM:
            out.append((frozenset(), [(i, j)]))
            continue
        pairs, path = [], []
        state = MM
        while state != STOP:
            state = int(bb[i, j])
            path.append((i, j))
            if state in (MM, STOP):
                pairs.append((i, j))
            if state == MM:
                i -= 1
                j -= 1
            elif state == IM:
                j -= 1
            elif state == MI:
                i -= 1
        out.append((frozenset(pairs), path))
    return out


# -------------------------------------------------------------- premerge ----

GAPC, ENDGAP = 21, 22        # codes of a gap and of a gap at a row's end


def merge_row(path: List[Tuple[int, int]], tseq: str, Lq: int) -> str:
    """The template's row in the query's columns, through an alignment's
    path (end to start): its residue in the query column it meets first,
    lower case where the query does not advance, gaps for the query
    columns it skips and outside the alignment (HH-suite's merge of a
    template into the query MSA)."""
    steps = path[::-1]
    i1, j1 = steps[0]
    i2, j2 = steps[-1]
    first_i: Dict[int, int] = {}
    for i, j in steps:
        first_i.setdefault(j, i)
    out = ["-"] * (i1 - 1) + [tseq[j1 - 1].upper()]
    iprev = i1
    for j in range(j1 + 1, j2 + 1):
        i = first_i[j]
        c = tseq[j - 1]
        if i == iprev:
            out.append(c.lower())
        else:
            out.extend("-" * (i - iprev - 1))
            out.append(c.upper())
        iprev = i
    out.extend("-" * (Lq - i2))
    return "".join(out)


def _rows_to_codes(rows: List[str], L: int):
    """Match-column codes (N, L+2) and insert counts (N, L+1) of a3m rows
    whose upper-case letters and gaps are the query's columns; a row's
    leading and trailing gaps are end gaps."""
    N = len(rows)
    X = np.full((N, L + 2), ENDGAP, np.int64)
    I = np.zeros((N, L + 1), np.int64)
    for k, row in enumerate(rows):
        col = 0
        for c in row:
            if c.islower():
                I[k, col] += 1
                continue
            col += 1
            if c == "-":
                X[k, col] = GAPC
            else:
                a = _AA_CODE[ord(c)]
                X[k, col] = a if a >= 0 else ANY
        if col != L:
            raise ValueError("an a3m row with another number of columns")
        body = X[k, 1: L + 1]
        res = np.nonzero(body != GAPC)[0]
        if res.size:
            body[: res[0]] = ENDGAP
            body[res[-1] + 1:] = ENDGAP
        else:
            body[:] = ENDGAP
    return X, I


def _keep(X: np.ndarray, L: int, max_seqid=90.0, min_cov=0.0):
    """HH-suite's filter as far as small merged MSAs need it: a row more
    than ``max_seqid`` % identical to an earlier kept one, or covering
    fewer than ``min_cov`` % of the columns, goes."""
    body = X[:, 1: L + 1]
    res = body < 20
    nres = res.sum(axis=1)
    keep = nres * 100.0 >= min_cov * L
    keep[0] = True
    for k in range(1, len(X)):
        for kk in range(k):
            if not keep[kk] or not keep[k]:
                continue
            both = res[k] & res[kk]
            same = (body[k] == body[kk]) & both
            if same.sum() * 100.0 > max_seqid * min(nres[k], nres[kk]):
                keep[k] = False
    return keep


def msa_profile(rows: List[str], entry: Entry, tab: Tables, par=DEFAULTS
                ) -> Profile:
    """The profile HMM of a query MSA (a3m rows, the query first), by
    HH-suite's weighting: each column's sequences weighted on the block
    of columns they share (Henikoff weights), the column's diversity from
    the entropy of that block; insert and delete transitions by global
    weights; the pseudocounts as for one sequence, admixed by each
    column's diversity."""
    L = len(entry.seq)
    X, I = _rows_to_codes(rows, L)
    keep = _keep(X, L, min_cov=max(min(int(25.0 / L * 100 + 0.5), 70), 0))
    X, I = X[keep], I[keep]
    N = len(X)
    body = X[:, 1: L + 1]
    isaa = body < 20
    nres = isaa.sum(axis=1)
    # global weights
    wg = np.full(N, 1e-6)
    for i in range(L):
        col = body[:, i]
        cnt = np.bincount(col, minlength=23)
        naa = max(1, int((cnt[:20] > 0).sum()))
        on = col < 20
        wg[on] += 1.0 / (cnt[col[on]] * naa * (nres[on] + 30.0))
    wg /= wg.sum()
    # position-specific weights of the match states
    member = body < ANY                         # (N, L)
    W = np.zeros((L, N))
    neff_col = np.zeros(L)
    for i in range(L):
        m = member[:, i]
        ns = int(m.sum())
        if ns == 0:
            neff_col[i] = 0.0
            continue
        sub = body[m]
        n = np.stack([np.bincount(sub[:, j], minlength=23)
                      for j in range(L)])
        good = np.nonzero(n[:, ENDGAP] <= 0.1 * ns)[0]
        if good.size == 0:
            w = np.where(m, wg, 0.0)
            neff_col[i] = 1.0
            W[i] = w
            continue
        j0, j1 = int(good[0]), int(good[-1])
        ncol = j1 - j0 + 1
        if ncol < 10:
            w = np.where(m, wg, 0.0)
        else:
            blk = n[j0: j1 + 1, :20]
            naa = (blk > 0).sum(axis=1)
            contrib = np.zeros((ncol, 23))
            with np.errstate(divide="ignore"):
                contrib[:, :20] = np.where(blk > 0, 1.0 / (naa[:, None] * blk),
                                           0.0)
            w = np.full(N, 1e-8)
            w[m] = 1e-8 + contrib[np.arange(ncol)[None, :],
                                  sub[:, j0: j1 + 1]].sum(axis=1)
        W[i] = w
        # diversity: the entropy of the block's weighted profile
        wsub = w[m]
        f = np.zeros((ncol, 20))
        for k in range(len(sub)):
            cols = sub[k, j0: j1 + 1]
            aa = cols < 20
            f[np.arange(ncol)[aa], cols[aa]] += wsub[k]
        s = f.sum(axis=1, keepdims=True)
        f = np.where(s > 0, f / np.where(s > 0, s, 1.0), f)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = np.where(f > 1e-10, -f * np.log2(f), 0.0).sum()
        neff_col[i] = 2.0 ** (ent / ncol)
    # emissions
    fr = np.tile(tab.pb, (L + 2, 1))
    for i in range(L):
        on = isaa[:, i]
        v = np.bincount(body[on, i], weights=W[i][on], minlength=20)[:20]
        if v.sum() > 0:
            fr[i + 1] = v / v.sum()
    # match-state transitions
    tr = np.full((L + 1, 7), NEG)
    nxt = X[:, 2: L + 2]
    cur = body < ANY
    nI = I[:, 1: L + 1] > 0
    to_m = ~nI & (nxt <= ANY)
    to_d = ~nI & ~(nxt <= ANY) & (nxt == GAPC)
    wT = W.T
    tiny = float(np.finfo(np.float32).tiny)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_mm = (wT * (cur & to_m)).sum(axis=0)
        t_mi = (wT * (cur & nI)).sum(axis=0)
        t_md = (wT * (cur & to_d)).sum(axis=0)
        s = t_mm + t_mi + t_md + tiny
        tr[1:, M2M] = np.log2(t_mm / s)
        tr[1:, M2I] = np.log2(t_mi / s)
        tr[1:, M2D] = np.log2(t_md / s)
    tr[[0, L], M2M] = 0.0
    tr[[0, L], M2I] = tr[[0, L], M2D] = NEG
    neff = float(neff_col.sum() / L)
    neff_m = np.concatenate([[99.999], np.where(neff_col == 0, 1.0,
                                                 neff_col), [1.0]])
    nlim = max(10.0, neff + 1.0)
    scale = math.log2((nlim - neff) / (nlim - 1.0))

    def diversity(mask):
        cnt = mask.sum(axis=0)
        w = (wg[:, None] * mask).sum(axis=0) - 1.0 / N
        d = np.where(w < 0, 1.0, nlim - (nlim - 1.0) * np.exp2(scale * w))
        return np.where(cnt > 0, d, 0.0), cnt

    # insert-state transitions (global weights)
    mI = I[:, 1: L + 1] > 0
    neff_i_col, cI = diversity(mI)
    t_im = (wg[:, None] * mI).sum(axis=0)
    t_ii = (wg[:, None] * mI * (I[:, 1: L + 1] - 1)).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tr[1:, I2M] = np.where(cI > 0, np.log2(t_im / (t_im + t_ii)), NEG)
        tr[1:, I2I] = np.where(cI > 0, np.log2(t_ii / (t_im + t_ii)), NEG)
    tr[[0, L], I2M] = 0.0
    tr[[0, L], I2I] = NEG
    # delete-state transitions (global weights)
    mD = body == GAPC
    neff_d_col, cD = diversity(mD)
    t_dd = (wg[:, None] * (mD & (nxt == GAPC))).sum(axis=0)
    t_dm = (wg[:, None] * (mD & (nxt != GAPC) & (nxt <= ANY))).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tr[1:, D2M] = np.where(cD > 0, np.log2(t_dm / (t_dm + t_dd)), NEG)
        tr[1:, D2D] = np.where(cD > 0, np.log2(t_dd / (t_dm + t_dd)), NEG)
    tr[0, D2M] = 0.0
    tr[0, D2D] = NEG
    neff_i = np.concatenate([[99.999], neff_i_col, [0.0]])
    neff_d = np.concatenate([[99.999], neff_d_col, [0.0]])
    tr = transition_pseudocounts(tr, neff_m, neff_i, neff_d, L, par)
    return _finish(entry, fr, tr, neff_m, neff, L, tab, par)


def premerge(q: Profile, entry: Entry, ranked: List[Tuple[Hit, Profile,
                                                           str]],
             tab: Tables, n: int = 3, low=None, par=DEFAULTS) -> Profile:
    """HH-suite's premerge: of the ``n`` best hits (``ranked``: hit,
    template profile and sequence, best first), each at or under ``-e``
    is realigned against the query profile as it stands, merged into the
    query MSA, and the profile is built again from the MSA."""
    rows = [entry.seq.upper()]
    cur = q
    for h, t, tseq in ranked[:n]:
        if h.evalue > par["e"]:
            continue
        (_pairs, path), = realign(cur, [t], [h], tab, low=low, par=par)
        if len(path) < 2:
            continue
        rows.append(merge_row(path, tseq, q.L))
        cur = msa_profile(rows, entry, tab, par)
    return cur
