"""Hit records, EVD statistics and hit-list level score calibration.

Parity targets: Hit (src/hhhit.h:30-196) including CalcEvalScoreProbab /
CalcProbab (src/hhhit.h:136-195), the EVD neural-network regressions
(src/hhhitlist-inl.h:27-105), P-value functions (src/hhhit-inl.h:38-58),
HitList::CalculatePvalues (src/hhhitlist.cpp:499-531) and
CalculateHHblitsEvalues (src/hhhitlist.cpp:463-494).

The NN evaluations are vectorized over hits (a (H,4) @ (4,hidden) matmul),
keeping double precision like the reference's double-based logistic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import fastmath as fm
from ..constants import LAMDA_GLOB

MM = 2   # pair-state code (hhhmm.h)

LOG1000 = math.log(1000.0)

# --- EVD neural net weights (hhhitlist-inl.h:27-105) ---
_LAMDA_BIAS = np.array([-0.73195, -1.43792, -1.18839, -3.01141])
_LAMDA_W = np.array([
    [-0.52356, -3.37650, 1.12984, -0.46796],
    [-4.71361, 0.14166, 1.66807, 0.16383],
    [-0.94895, -1.24358, -1.20293, 0.95434],
    [-0.00318, 0.53022, -0.04914, -0.77046]])
_LAMDA_V = np.array([2.45630, 3.02905, 2.53803, 2.64379])

_MU_BIAS = np.array([-4.25264, -3.63484, -5.86653, -4.78472, -2.76356,
                     -2.21580])
_MU_W = np.array([
    [1.96172, 1.07181, -7.41256, 0.26471],
    [0.84643, 1.46777, -1.04800, -0.51425],
    [1.42697, 1.99927, 0.64647, 0.27834],
    [1.34216, 1.64064, 0.35538, -8.08311],
    [2.30046, 1.31700, -0.46435, -0.46803],
    [0.90090, -3.53067, 0.59212, 1.47503]])
_MU_V = np.array([-1.26036, 1.52812, 1.58413, -1.90409, 0.92803, -0.66871])

_ALPHA_BIAS = np.array([7.89636, 3.68944, 2.05448, 3.69149])
_AB_W = np.array([
    [-6.72336, -4.73393, -2.15446, -4.75140],
    [-14.54957, 4.05462, 0.57951, 3.55780],
    [2.08289, -1.81976, -1.19936, -17.35097],
    [1.53268, -8.13514, -2.50677, 1.51106]])
_ALPHA_V = np.array([6.37397, -0.36254, 0.16279, -1.32174])
_ALPHA_OUT_BIAS = 1.33439
_BETA_V = np.array([-2.27841, -7.79426, -9.53092, 3.65717])
_BETA_OUT_BIAS = 5.43347


def _nn(inputs, W, bias, V):
    """inputs (H,4) -> (H,) sum of logistic hidden units times V."""
    act = inputs @ W.T + bias[None, :]
    hidden = 1.0 / (1.0 + np.exp(-act))
    return hidden @ V


def lamda_nn(Lqnorm, Ltnorm, Nqnorm, Ntnorm):
    x = np.stack(np.broadcast_arrays(Lqnorm, Ltnorm, Nqnorm, Ntnorm),
                 axis=-1).reshape(-1, 4)
    return _nn(x, _LAMDA_W, _LAMDA_BIAS, _LAMDA_V)


def mu_nn(Lqnorm, Ltnorm, Nqnorm, Ntnorm):
    x = np.stack(np.broadcast_arrays(Lqnorm, Ltnorm, Nqnorm, Ntnorm),
                 axis=-1).reshape(-1, 4)
    return 20.0 * _nn(x, _MU_W, _MU_BIAS, _MU_V)


def alpha_nn(Lqnorm, Ltnorm, Nqnorm, Ntnorm):
    x = np.stack(np.broadcast_arrays(Lqnorm, Ltnorm, Nqnorm, Ntnorm),
                 axis=-1).reshape(-1, 4)
    a = _nn(x, _AB_W, _ALPHA_BIAS, _ALPHA_V)
    return 1.0 / (1.0 + np.exp(-(a + _ALPHA_OUT_BIAS)))


def beta_nn(Lqnorm, Ltnorm, Nqnorm, Ntnorm):
    x = np.stack(np.broadcast_arrays(Lqnorm, Ltnorm, Nqnorm, Ntnorm),
                 axis=-1).reshape(-1, 4)
    b = _nn(x, _AB_W, _ALPHA_BIAS, _BETA_V)
    return 1.0 / (1.0 + np.exp(-(b + _BETA_OUT_BIAS)))


def _h_evd(x, lamda, mu):
    """lamda*(x-mu) with f32 input quantization then f64 math
    (hhhit-inl.h float params); shape-preserving for array inputs."""
    lam = np.asarray(lamda, np.float32).astype(np.float64)
    xx = np.asarray(x, np.float32).astype(np.float64)
    m = np.asarray(mu, np.float32).astype(np.float64)
    return lam * (xx - m)


def pvalue(x, lamda, mu):
    """hhhit-inl.h:44-47 (float inputs, double math)."""
    h = _h_evd(x, lamda, mu)
    return np.where(h > 10, np.exp(-h), 1.0 - np.exp(-np.exp(-h)))


def log_pvalue(x, lamda, mu):
    """hhhit-inl.h:49-53."""
    h = _h_evd(x, lamda, mu)
    with np.errstate(over="ignore", divide="ignore"):
        # h >> 0 makes the inner term exactly 0.0 and log() -inf; that
        # branch is discarded by the h > 10 selector below
        mid = np.log(1.0 - np.exp(-np.exp(-h)))
    return np.where(h > 10, -h, np.where(h < -2.5, -np.exp(-np.exp(-h)),
                                         mid))


@dataclass(slots=True)
class Hit:
    """One query-template alignment (src/hhhit.h:30-147).

    ``slots=True``: tens of thousands of hits are built per query and
    the E-value/sort loops touch every one — slot storage cuts both
    the per-instance footprint and attribute-access cost ~2x.  Every
    post-init attribute (realign matrices, altali step arrays, ...)
    is declared below."""

    name: str = ""
    longname: str = ""
    fam: str = ""
    file: str = ""
    entry: object = None

    score: float = 0.0
    score_ss: float = 0.0
    score_aass: float = 0.0
    score_sort: float = 0.0
    Pval: float = 1.0
    Pvalt: float = 1.0
    logPval: float = 0.0
    logPvalt: float = 0.0
    Eval: float = 1e6
    logEval: float = 0.0
    Probab: float = 0.0
    Pforward: float = 0.0

    L: int = 0
    irep: int = 1
    lastrep: int = 0
    # score-only funnel hit: no backtrace path, never printed with an
    # alignment or realigned (see viterbi_search two-pass funnel)
    light: bool = False

    n_display: int = 0
    sname: List[str] = field(default_factory=list)
    seq: List[str] = field(default_factory=list)
    nss_dssp: int = -1
    nsa_dssp: int = -1
    nss_pred: int = -1
    nss_conf: int = -1
    nfirst: int = -1
    ncons: int = -1

    nsteps: int = 0
    i: Optional[np.ndarray] = None        # (nsteps+1,) 1-based
    j: Optional[np.ndarray] = None
    states: Optional[np.ndarray] = None
    S: Optional[np.ndarray] = None
    S_ss: Optional[np.ndarray] = None
    P_posterior: Optional[np.ndarray] = None
    i1: int = 0
    i2: int = 0
    j1: int = 0
    j2: int = 0
    matched_cols: int = 0
    ssm1: int = 0
    ssm2: int = 0
    self_hit: int = 0
    sum_of_probs: float = 0.0
    Neff_HMM: float = 0.0
    realign_around_viterbi: bool = False
    min_overlap: int = 0

    # template SS state arrays (for output rendering / SS rescoring)
    ss_dssp: Optional[np.ndarray] = None
    ss_pred: Optional[np.ndarray] = None
    ss_conf: Optional[np.ndarray] = None
    sa_dssp: Optional[np.ndarray] = None

    # realign/-omat products and altali bookkeeping (assigned by the
    # posterior decoder and output writers)
    P_MM: object = None
    alt_i: object = None
    alt_j: object = None
    forward_matrix: object = None
    backward_matrix: object = None
    posterior_matrix: object = None
    forward_profile: object = None
    backward_profile: object = None

    def init_from_hmm(self, q, t, nseqdis: int, ssm: int):
        """initHitFromHMM (src/hhhit.cpp:235-318): copy display info from t
        and derive ssm1/ssm2 flags for CalcProbab."""
        self.longname = t.longname
        self.name = t.name
        self.fam = t.fam
        self.file = t.file
        nd = min(t.n_display,
                 nseqdis + (t.nss_dssp >= 0) + (t.nsa_dssp >= 0)
                 + (t.nss_pred >= 0) + (t.nss_conf >= 0) + (t.ncons >= 0))
        # slicing already yields fresh lists; no list() re-copy needed
        self.sname = t.sname[: nd]
        self.seq = t.seq[: nd]
        self.n_display = nd
        # SS usage flags (hhhit.cpp:289-317)
        self.ssm1 = self.ssm2 = 0
        if ssm in (1, 2):
            val = 0
            if t.nss_dssp >= 0 and q.nss_pred >= 0:
                val = 1
            elif q.nss_dssp >= 0 and t.nss_pred >= 0:
                val = 2
            elif q.nss_pred >= 0 and t.nss_pred >= 0:
                val = 3
            if ssm == 1:
                self.ssm1 = val
            else:
                self.ssm2 = val
        elif ssm in (3, 4):
            val = 3 if (q.nss_pred >= 0 and t.nss_pred >= 0) else 0
            if ssm == 3:
                self.ssm1 = val
            else:
                self.ssm2 = val
        self.nss_dssp = t.nss_dssp
        self.nsa_dssp = t.nsa_dssp
        self.nss_pred = t.nss_pred
        self.nss_conf = t.nss_conf
        self.nfirst = t.nfirst
        self.ncons = t.ncons
        self.L = t.L
        self.Neff_HMM = t.Neff_HMM
        # shared read-only views: nothing downstream writes to a hit's
        # SS arrays (display/scoring only index them), and per-hit
        # copies cost ~40 us x tens of thousands of hits
        self.ss_dssp = t.ss_dssp
        self.ss_pred = t.ss_pred
        self.ss_conf = t.ss_conf
        self.sa_dssp = t.sa_dssp

    def calc_eval_score_probab(self, N_searched, lamda, loc, ssm, ssw):
        """CalcEvalScoreProbab (hhhit.h:136-147).

        Degenerate scores (a fully-cell-off altali lane reports
        -FLT_MAX) flow through as C float math does — log(0) = -inf,
        exp(+inf) = inf, no exception — so they sort last with
        Probab 0 exactly like the reference binary."""
        self.Eval = math.exp(self.logPval + math.log(N_searched))
        self.logEval = self.logPval + math.log(N_searched)
        if self.logPval < -10.0:
            base = self.logPval
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                base = float(np.log(-np.log(1.0 - np.float64(self.Pval))))
        self.score_aass = (base / 0.45
                           - min(lamda * self.score_ss,
                                 max(0.0, 0.2 * (self.score - 8.0))) / 0.45
                           - 3.0)
        self.score_sort = self.score_aass
        self.Probab = self._calc_probab(loc, ssm, ssw)

    def _calc_probab(self, loc, ssm, ssw):
        """CalcProbab (hhhit.h:151-195)."""
        s = -self.score_aass
        if s > 200:
            return 100.0
        if loc:
            if ssm and (self.ssm1 or self.ssm2) and ssw > 0:
                a, b, c, d = math.sqrt(6000.0), 5.0, math.sqrt(0.12), 64.0
            else:
                a, b, c, d = math.sqrt(4000.0), 5.0, math.sqrt(0.15), 68.0
        else:
            if ssm > 0 and ssw > 0:
                a, b, c, d = math.sqrt(4000.0), 6.0, math.sqrt(0.13), 68.0
            else:
                a, b, c, d = math.sqrt(6000.0), 5.0, math.sqrt(0.10), 74.0
        with np.errstate(over="ignore"):
            t = float(a * np.exp(-np.float64(s) / b)
                      + c * np.exp(-np.float64(s) / d))
        return float(100.0 / (1.0 + t * t))

    def sort_key(self):
        """operator< (hhhit.h:122-133): ascending score_sort, then file."""
        return (self.score_sort, self.file)

    def calculate_similarity(self, q, S) -> float:
        """Hit::calculateSimilarity (hhhit.cpp:127-164) for the -omat
        header.  Preserves the reference's off-by-one: mappings are
        0-based residue strings indexed with the 1-based alignment
        coordinates (the out-of-range read at the last column becomes a
        zero contribution here)."""
        from ..core.alignment import AA2I_TABLE

        tmap = [c for c in self.seq[self.nfirst][1:]
                if c != "." and not c.islower()]
        qmap = [c for c in q.seq[q.nfirst][1:]
                if c != "." and not c.islower()]
        sim = 0.0
        for step in range(self.nsteps, 0, -1):
            if self.states[step] == MM:
                ii, jj = int(self.i[step]), int(self.j[step])
                qc = qmap[ii] if ii < len(qmap) else "\0"
                tc = tmap[jj] if jj < len(tmap) else "\0"
                qa = AA2I_TABLE[ord(qc) & 0xFF]
                ta = AA2I_TABLE[ord(tc) & 0xFF]
                if 0 <= qa < 20 and 0 <= ta < 20:
                    sim += float(S[qa, ta])
        return sim / max(self.matched_cols, 1)


class HitList:
    """Sorted list of hits with score calibration."""

    def __init__(self):
        self.hits: List[Hit] = []
        self.N_searched = 0

    def append(self, hit: Hit):
        self.hits.append(hit)

    def extend(self, hits):
        self.hits.extend(hits)

    def __iter__(self):
        return iter(self.hits)

    def __len__(self):
        return len(self.hits)

    def sort(self):
        """Stable ascending sort by (score_sort, file) — operator<
        (hhhit.h:122-133).  Vectorized via np.lexsort (stable, same
        ordering as the tuple-key list sort) for large lists; falls
        back to the tuple sort when keys are non-finite (NaN tuple
        comparisons have list.sort semantics the reference's
        float operator< shares)."""
        hits = self.hits
        if len(hits) > 64:
            ss = np.array([h.score_sort for h in hits], np.float64)
            if not np.isnan(ss).any():
                files = np.array([h.file or "" for h in hits])
                order = np.lexsort((files, ss))
                self.hits = [hits[int(k)] for k in order]
                return
        hits.sort(key=Hit.sort_key)

    def resort(self):
        """ResortList (list.h:710): insertion re-sort by operator<, i.e.
        (score_sort, file) — E-value updates don't change the key."""
        self.sort()

    def calculate_pvalues(self, q, loc: int, ssm: int, ssw: float):
        """CalculatePvalues (hhhitlist.cpp:499-531); the per-hit NN
        regressions and EVD P-values run as one batched evaluation over
        the whole list (same f32 input quantization element-wise)."""
        if self.N_searched == 0:
            self.N_searched = 1
        hits = self.hits
        if not hits:
            return
        n = len(hits)
        if loc:
            ql = np.float32(math.log(q.L) / LOG1000)
            qn = np.float32(q.Neff_HMM / 10.0)
            # divide in f64 first, THEN quantize to f32 (matches the
            # scalar np.float32(math.log(L) / LOG1000) order)
            tl = (np.array([math.log(h.L) for h in hits], np.float64)
                  / LOG1000).astype(np.float32)
            tn = (np.array([h.Neff_HMM for h in hits], np.float64)
                  / 10.0).astype(np.float32)
            qlv = np.full(n, ql, np.float32)
            qnv = np.full(n, qn, np.float32)
            lamda_v = lamda_nn(qlv, tl, qnv, tn)
            mu_v = mu_nn(qlv, tl, qnv, tn)
        else:
            lamda_v = np.full(n, LAMDA_GLOB)
            mu_v = np.full(n, 3.0)
        scores = np.array([h.score for h in hits], np.float64)
        logp_v = log_pvalue(scores, lamda_v, mu_v)
        pval_v = pvalue(scores, lamda_v, mu_v)
        # CalcEvalScoreProbab + CalcProbab vectorized over the list —
        # identical f64 element-wise math to the scalar methods.
        # Eval uses libm exp (math.exp) like the scalar method and the
        # reference's C exp(): numpy's vectorized exp rounds ~4% of
        # values one ulp differently, which can flip a hit sitting
        # exactly on a display/merge threshold
        logN = math.log(self.N_searched)
        logeval_v = logp_v + logN
        eval_v = np.fromiter((math.exp(v) for v in logeval_v),
                             np.float64, count=n)
        with np.errstate(divide="ignore", invalid="ignore"):
            base = np.where(logp_v < -10.0, logp_v,
                            np.log(-np.log(1.0 - pval_v)))
        ss_v = np.array([h.score_ss for h in hits], np.float64)
        aass = (base / 0.45
                - np.minimum(lamda_v * ss_v,
                             np.maximum(0.0, 0.2 * (scores - 8.0))) / 0.45
                - 3.0)
        s = -aass
        if loc:
            if ssm and ssw > 0:
                ssflag = np.array([bool(h.ssm1 or h.ssm2) for h in hits])
            else:
                ssflag = np.zeros(n, bool)
            a = np.where(ssflag, math.sqrt(6000.0), math.sqrt(4000.0))
            b = np.float64(5.0)
            c = np.where(ssflag, math.sqrt(0.12), math.sqrt(0.15))
            d = np.where(ssflag, 64.0, 68.0)
        else:
            if ssm > 0 and ssw > 0:
                a, b, c, d = math.sqrt(4000.0), 6.0, math.sqrt(0.13), 68.0
            else:
                a, b, c, d = math.sqrt(6000.0), 5.0, math.sqrt(0.10), 74.0
        with np.errstate(over="ignore", invalid="ignore"):
            t = a * np.exp(-s / b) + c * np.exp(-s / d)
            probab = np.where(s > 200.0, 100.0, 100.0 / (1.0 + t * t))
        for k, hit in enumerate(hits):
            hit.logPval = float(logp_v[k])
            hit.Pval = float(pval_v[k])
            hit.Eval = float(eval_v[k])
            hit.logEval = float(logeval_v[k])
            hit.score_aass = float(aass[k])
            hit.score_sort = hit.score_aass
            hit.Probab = float(probab[k])
        self.sort()

    def calculate_hhblits_evalues(self, q, dbsize, alphaa, alphab, alphac,
                                  prefilter_evalue_thresh):
        """CalculateHHblitsEvalues (hhhitlist.cpp:463-494)."""
        log_Pcut = math.log(prefilter_evalue_thresh / dbsize)
        log_dbsize = math.log(float(dbsize))
        hits = self.hits
        neff = np.array([h.Neff_HMM for h in hits], np.float64)
        logp = np.array([h.logPval for h in hits], np.float64)
        alpha = alphaa + alphab * (neff - 1) * (1 - alphac * (q.Neff_HMM - 1))
        logeval = logp + log_dbsize + alpha * log_Pcut
        # libm exp, matching the scalar method / reference C exp()
        ev = np.fromiter((math.exp(v) for v in logeval),
                         np.float64, count=len(hits))
        for k, hit in enumerate(hits):
            hit.Eval = float(ev[k])
            hit.logEval = float(logeval[k])
        self.resort()
