"""Profile HMM: per-column emissions, transitions, pseudocounts, null model.

Parity targets in the reference: ``HMM`` (src/hhhmm.h:19-160) and its
methods AddTransitionPseudocounts (src/hhhmm.cpp:1722-1810),
PreparePseudocounts (:1811-1818), AddAminoAcidPseudocounts (:1874-1966),
CalculateAminoAcidBackground (:2040-2057), IncludeNullModelInHMM
(:2059-2144), Log2LinTransitionProbs (:2305-2318) and tag neutralization
(:2319-2360).  Arrays are (L+2)-row float32 so column i of the profile is
row i (row 0 = begin state, row L+1 = end state).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import fastmath as fm
from ..constants import (D2D, D2M, I2I, I2M, M2D, M2I, M2M, NAA, NTRANS)

FLT_MIN = float(np.finfo(np.float32).tiny)


class HMM:
    """A profile HMM over internal aa order (A R N D C Q E G H I L K M F P
    S T W Y V)."""

    def __copy__(self):
        """Shallow shell copy — same semantics as the default
        copy.copy but ~10x faster (no __reduce_ex__ round-trip); the
        search path hands out one shell per template per query."""
        c = self.__class__.__new__(self.__class__)
        c.__dict__.update(self.__dict__)
        return c

    def __init__(self, L: int = 0, maxseqdis: int = 10238):
        self.maxseqdis = maxseqdis
        self.alloc(L)
        self.name = ""
        self.longname = ""
        self.fam = ""
        self.file = ""
        self.sname: List[str] = []
        self.seq: List[str] = []          # display seqs, index 1 = first char
        self.n_display = 0
        self.n_seqs = 0
        self.N_in = 0
        self.N_filtered = 0
        self.L = L
        self.Neff_HMM = 0.0
        self.lamda = 0.0
        self.mu = 0.0
        self.trans_lin = 0                # 0: tr in log2, 1: linear
        self.has_pseudocounts = False
        self.divided_by_local_bg_freqs = False
        self.nss_dssp = self.nsa_dssp = -1
        self.nss_pred = self.nss_conf = -1
        self.nfirst = self.ncons = -1

    def alloc(self, L: int):
        self.L = L
        n = L + 2
        self.f = np.zeros((n, NAA), dtype=np.float32)   # raw frequencies
        self.g = np.zeros((n, NAA), dtype=np.float32)   # full-pc frequencies
        self.p = np.zeros((n, NAA), dtype=np.float32)   # admixed profile
        self.tr = np.full((n, NTRANS), -100000.0, dtype=np.float32)
        self.Neff_M = np.zeros(n, dtype=np.float32)
        self.Neff_I = np.zeros(n, dtype=np.float32)
        self.Neff_D = np.zeros(n, dtype=np.float32)
        self.pav = np.zeros(NAA, dtype=np.float32)
        self.l = np.zeros(n, dtype=np.int32)            # MSA column of match i
        self.ss_dssp = np.zeros(n, dtype=np.int8)
        self.sa_dssp = np.zeros(n, dtype=np.int8)
        self.ss_pred = np.zeros(n, dtype=np.int8)
        self.ss_conf = np.zeros(n, dtype=np.int8)

    @property
    def has_ss_dssp(self):
        return self.nss_dssp >= 0

    @property
    def has_ss_pred(self):
        return self.nss_pred >= 0

    # ------------------------------------------------------ pseudocounts ----
    def add_transition_pseudocounts(self, gapd=0.15, gape=1.0, gapf=0.6,
                                    gapg=0.6, gaph=0.6, gapi=0.6, gapb=1.0):
        """hhhmm.cpp:1722-1810.  tr must be in log2 space."""
        if gapb <= 0:
            return
        if self.trans_lin == 1:
            raise RuntimeError("transition pseudocounts on linear probs")
        if self.trans_lin == 2:
            raise RuntimeError("transition pseudocounts added twice")
        L = self.L
        tr = self.tr

        pM2D = pM2I = np.float32(gapd * 0.0286)
        pM2M = np.float32(1.0) - pM2D - pM2I
        pII = np.float32(1.0 * gape / (gape - 1 + 1.0 / 0.75))
        pIM = np.float32(1.0) - pII
        pDD = pII
        pDM = pIM
        gapb = np.float32(gapb)

        i = np.arange(0, L + 1)
        nm = self.Neff_M[i] - np.float32(1.0)
        p0 = nm * fm.fpow2(tr[i, M2M]) + gapb * pM2M
        p1 = nm * fm.fpow2(tr[i, M2D]) + gapb * pM2D
        p2 = nm * fm.fpow2(tr[i, M2I]) + gapb * pM2I
        p1[0] = p2[0] = 0.0
        p1[L] = p2[L] = 0.0
        s = p0 + p1 + p2 + np.float32(FLT_MIN)
        tr[i, M2M] = fm.fast_log2(p0 / s)
        tr[i, M2D] = fm.fast_log2(p1 / s) * np.float32(gapf)
        tr[i, M2I] = fm.fast_log2(p2 / s) * np.float32(gapg)

        p0 = self.Neff_I[i] * fm.fpow2(tr[i, I2M]) + gapb * pIM
        p1 = self.Neff_I[i] * fm.fpow2(tr[i, I2I]) + gapb * pII
        s = p0 + p1 + np.float32(FLT_MIN)
        tr[i, I2M] = fm.fast_log2(p0 / s)
        tr[i, I2I] = fm.fast_log2(p1 / s) * np.float32(gapi)

        p0 = self.Neff_D[i] * fm.fpow2(tr[i, D2M]) + gapb * pDM
        p1 = self.Neff_D[i] * fm.fpow2(tr[i, D2D]) + gapb * pDD
        p1[L] = 0.0
        s = p0 + p1 + np.float32(FLT_MIN)
        tr[i, D2M] = fm.fast_log2(p0 / s)
        tr[i, D2D] = fm.fast_log2(p1 / s) * np.float32(gaph)
        self.trans_lin = 2

    def prepare_pseudocounts(self, R: np.ndarray):
        """g[i][a] = sum_b R[a][b] f[i][b]  (hhhmm.cpp:1811-1818)."""
        self.g[:, :] = (self.f @ R.T).astype(np.float32)

    def add_amino_acid_pseudocounts(self, pcm=2, pca=1.0, pcb=1.5, pcc=1.0):
        """p = (1-tau) f + tau g with diversity-dependent tau
        (hhhmm.cpp:1874-1966)."""
        if self.has_pseudocounts:
            pcm = 0
        L = self.L
        sl = slice(1, L + 1)
        if pcm == 0:
            self.p[sl] = self.f[sl]
        elif pcm == 1:
            tau = np.float32(pca)
            self.p[sl] = (1.0 - tau) * self.f[sl] + tau * self.g[sl]
        elif pcm == 2:
            neff = self.Neff_M[sl].astype(np.float32)
            if pcc == 1.0:
                tau = np.minimum(np.float32(1.0),
                                 np.float32(pca)
                                 / (np.float32(1.0)
                                    + neff / np.float32(pcb)))
            else:
                tau = np.minimum(np.float32(1.0),
                                 np.float32(pca)
                                 / (np.float32(1.0)
                                    + (neff / np.float32(pcb))
                                    ** np.float32(pcc)))
            tau = tau[:, None].astype(np.float32)
            self.p[sl] = ((np.float32(1.0) - tau) * self.f[sl]
                          + tau * self.g[sl])
        elif pcm == 3:
            x = self.Neff_M[sl] / np.float32(pcb)
            pca_ = np.float32(0.793 + 0.048 * (pcb - 10.0))
            tau = np.maximum(np.float32(0.0),
                             pca_ * (1 - x + np.float32(pcc) * x * (1 - x)))
            tau = tau[:, None].astype(np.float32)
            self.p[sl] = ((np.float32(1.0) - tau) * self.f[sl]
                          + tau * self.g[sl])
        if pcm != 0:
            self.has_pseudocounts = True

    def calculate_aa_background(self, pb: np.ndarray):
        """pav from p + pb pseudocount; sets p[0] = p[L+1] = pav
        (hhhmm.cpp:2040-2057)."""
        L = self.L
        pav = (pb * np.float32(100.0) / np.float32(self.Neff_HMM))
        pav = pav.astype(np.float32)
        # sequential accumulation per aa over columns 1..L (float32)
        acc = pav.astype(np.float32)
        for i in range(1, L + 1):
            acc = acc + self.p[i]
        s = np.float32(0.0)
        for a in range(NAA):
            s = np.float32(s + acc[a])
        self.pav = (acc / s).astype(np.float32)
        self.p[0] = self.pav
        self.p[L + 1] = self.pav

    def null_vector(self, q: "HMM", columnscore: int,
                    pb: np.ndarray) -> np.ndarray:
        """The null distribution include_null_model divides by
        (hhhmm.cpp:2059-2138), without mutating anything."""
        if columnscore == 0:
            pnul = pb
        elif columnscore == 1:
            pnul = np.float32(0.5) * (q.pav + self.pav)
        elif columnscore == 2:
            pnul = self.pav
        elif columnscore == 3:
            pnul = q.pav
        else:
            raise NotImplementedError(f"columnscore {columnscore}")
        return pnul

    def include_null_model(self, q: "HMM", columnscore: int, pb: np.ndarray):
        """Divide template p by the null distribution (hhhmm.cpp:2059-2144).

        After this, p holds odds-ratios (p[j][a] / pnul[a]).
        """
        pnul = self.null_vector(q, columnscore, pb)
        # single-precision division like the reference's float pnul[20]
        # loop (hhhmm.cpp:2139-2142); also what the device-resident
        # template pack replays on TPU (IEEE f32 divide, bit-exact)
        pnul32 = np.asarray(pnul, dtype=np.float32)
        self.p[: self.L + 2] = (self.p[: self.L + 2].astype(np.float32)
                                / pnul32[None, :])
        self.pnul_used = pnul32
        return pnul

    def log2lin_transitions(self):
        """hhhmm.cpp:2305-2318."""
        if self.trans_lin == 1:
            return
        self.trans_lin = 1
        self.tr[: self.L + 1] = fm.fpow2(self.tr[: self.L + 1])

    def lin2log_transitions(self):
        if self.trans_lin != 1:
            return
        self.trans_lin = 0
        self.tr[: self.L + 1] = fm.flog2(self.tr[: self.L + 1])

    def calc_neff(self) -> float:
        s = 0.0
        for i in range(1, self.L + 1):
            e = 0.0
            for a in range(NAA):
                v = self.p[i, a]
                if v > 1e-10:
                    e -= v * np.log2(v)
            s += 2.0 ** e
        return s / self.L
