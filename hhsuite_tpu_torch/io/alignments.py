"""Pairwise query-template alignment rendering for hhr/FASTA/A2M/A3M.

Ports HalfAlignment (src/hhhalfalignment.cpp:1-372) and FullAlignment
(src/hhfullalignment.cpp:1-470) with the exact format strings of
FullAlignment::PrintHeader/PrintHHR — the hhr per-hit blocks are part of
the diff oracle surface.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..constants import NAA, aa2i
from ..core.hit import Hit
from ..core.hmm import HMM

STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6
NLEN = 14


def _match_chr(c):
    return c.upper() if "a" <= c <= "z" else ("-" if c == "." else c)


def _insert_chr(c):
    if "A" <= c <= "Z":
        return c.lower()
    if ("0" <= c <= "9") or c == "-":
        return "."
    return c


def _word_chr(c):
    return 1 if c.isalpha() else 0


def _score_chr(S):
    return "=" if S < -1.5 else ("-" if S < -0.5 else
                                 ("." if S < 0.5 else
                                  ("+" if S < 1.5 else "|")))


def _posterior_chr(PP):
    return chr(48 + max(0, min(9, int(10.0 * PP))))


class HalfAlignment:
    """One side (query or template) of the rendered alignment."""

    def __init__(self):
        self.n = 0
        self.pos = 0
        self.seq: List[str] = []
        self.sname: List[str] = []
        self.s: List[List[str]] = []
        self.l: List[np.ndarray] = []
        self.m: List[np.ndarray] = []
        self.h: List[int] = []
        self.nss_dssp = self.nss_pred = self.nss_conf = -1
        self.nsa_dssp = self.ncons = -1
        self.L = 0

    def set(self, name, seqs, snames, n, L, n1, n2, n3, n4, nc):
        """hhhalfalignment.cpp:52-119: compute residue/position indices."""
        self.nss_dssp, self.nss_pred, self.nss_conf = n1, n2, n3
        self.nsa_dssp, self.ncons = n4, nc
        self.seq = seqs
        self.sname = snames
        self.n = n
        self.L = L
        self.pos = 0
        self.s = [[] for _ in range(n)]
        self.l = [np.zeros(L + 10, dtype=np.int32) for _ in range(n)]
        self.m = [np.zeros(L + 10, dtype=np.int32) for _ in range(n)]
        self.h = [0] * n
        for k in range(n):
            self.m[k][0] = 0
            if k == nc:
                for i in range(1, L + 1):
                    self.m[k][i] = self.l[k][i] = i
                self.m[k][L + 1] = self.l[k][L + 1] = L
                continue
            i = 1
            mm = 1
            ll = 1
            sk = seqs[k]
            while mm < len(sk) and sk[mm]:
                c = sk[mm]
                if _match_chr(c) == c and i <= L:
                    self.l[k][i] = ll
                    self.m[k][i] = mm
                    i += 1
                if _word_chr(c):
                    ll += 1
                mm += 1
            self.l[k][i] = ll - 1
            self.m[k][i] = mm

    def add_inserts(self, i):
        for k in range(self.n):
            sk = self.seq[k]
            for mm in range(self.m[k][i] + 1, self.m[k][i + 1]):
                if mm < len(sk):
                    self.s[k].append(sk[mm])
                    self.h[k] += 1

    def fill_up_gaps(self):
        self.pos = max(self.h) if self.h else 0
        for k in range(self.n):
            while self.h[k] < self.pos:
                self.s[k].append(".")
                self.h[k] += 1

    def add_inserts_and_fill_up_gaps(self, i):
        self.add_inserts(i)
        self.fill_up_gaps()

    def add_char(self, c):
        for k in range(self.n):
            self.s[k].append(c)
            self.h[k] += 1
        self.pos += 1

    def add_column(self, i):
        for k in range(self.n):
            mk = self.m[k][i]
            self.s[k].append(self.seq[k][mk] if mk < len(self.seq[k])
                             else "-")
            self.h[k] += 1
        self.pos += 1

    def add_column_as_insert(self, i):
        for k in range(self.n):
            mk = self.m[k][i]
            c = self.seq[k][mk] if mk < len(self.seq[k]) else "-"
            if c != "-" and not ("0" <= c <= "9"):
                self.s[k].append(_insert_chr(c))
                self.h[k] += 1
        self.pos += 1


class FullAlignment:
    """Query/template double alignment (hhfullalignment.cpp)."""

    def __init__(self):
        self.qa = HalfAlignment()
        self.ta = HalfAlignment()
        self.symbol: dict = {}
        self.posterior: dict = {}
        self.identities = 0
        self.score_sim = 0.0
        self.has_posterior = False

    def add_gaps(self):
        while self.qa.pos < self.ta.pos:
            self.qa.add_char(".")
        while self.ta.pos < self.qa.pos:
            self.ta.add_char(".")

    def add_columns(self, i, j, prev_state, state, S, PP):
        qa, ta = self.qa, self.ta
        if state == MM:
            self.add_gaps()
            self.symbol[qa.pos] = _score_chr(S)
            self.posterior[qa.pos] = _posterior_chr(PP)
            qa.add_column(i)
            ta.add_column(j)
            qa.add_inserts_and_fill_up_gaps(i)
            ta.add_inserts_and_fill_up_gaps(j)
        elif state in (GD, IM):
            if (state == GD and prev_state == DG) or \
               (state == IM and prev_state == MI):
                self.add_gaps()
            self.symbol[ta.pos] = "Q"
            self.posterior[ta.pos] = " "
            ta.add_column(j)
            ta.add_inserts_and_fill_up_gaps(j)
        elif state in (DG, MI):
            if (state == DG and prev_state == GD) or \
               (state == MI and prev_state == IM):
                self.add_gaps()
            self.symbol[qa.pos] = "T"
            self.posterior[qa.pos] = " "
            qa.add_column(i)
            qa.add_inserts_and_fill_up_gaps(i)

    def build(self, q: HMM, hit: Hit, nseqdis: int, S: np.ndarray):
        """hhfullalignment.cpp:123-199."""
        self.identities = 0
        self.score_sim = 0.0
        self.symbol = {}
        self.posterior = {}
        qa, ta = self.qa, self.ta
        n = min(q.n_display,
                nseqdis + (q.nss_dssp >= 0) + (q.nsa_dssp >= 0)
                + (q.nss_pred >= 0) + (q.nss_conf >= 0) + (q.ncons >= 0))
        qa.set(q.name, q.seq, q.sname, n, q.L, q.nss_dssp, q.nss_pred,
               q.nss_conf, q.nsa_dssp, q.ncons)
        n = max(hit.nfirst + 1,
                min(hit.n_display,
                    nseqdis + (hit.nss_dssp >= 0) + (hit.nsa_dssp >= 0)
                    + (hit.nss_pred >= 0) + (hit.nss_conf >= 0)
                    + (hit.ncons >= 0)))
        ta.set(hit.name, hit.seq, hit.sname, n, hit.L, hit.nss_dssp,
               hit.nss_pred, hit.nss_conf, hit.nsa_dssp, hit.ncons)

        self.has_posterior = hit.P_posterior is not None
        state = MM
        for step in range(hit.nsteps, 0, -1):
            prev_state = state
            state = int(hit.states[step])
            PP = (float(hit.P_posterior[step])
                  if hit.P_posterior is not None else 0.0)
            self.add_columns(int(hit.i[step]), int(hit.j[step]),
                             prev_state, state,
                             float(hit.S[step]) if hit.S is not None
                             else 0.0, PP)
            if state == MM:
                i, j = int(hit.i[step]), int(hit.j[step])
                qs = q.seq[q.nfirst]
                ts = hit.seq[hit.nfirst]
                mi = qa.m[q.nfirst][i]
                mj = ta.m[hit.nfirst][j]
                qc = qs[mi] if mi < len(qs) else "-"
                tc = ts[mj] if mj < len(ts) else "-"
                if qc == tc and qc != "-":
                    self.identities += 1
                ai, at = aa2i(qc), aa2i(tc)
                if 0 <= ai < NAA and 0 <= at < NAA:
                    self.score_sim += float(S[ai, at])
        self.add_gaps()
        # terminating '\0' column (counted in pos, never printed) — the
        # reference's print loops run to pos-1
        qa.add_char("\0")
        ta.add_char("\0")

        # '.' -> '-' where one HMM has a gap (Q/T symbols cleared)
        for hh in range(1, qa.pos):
            sym = self.symbol.get(hh, " ")
            if sym == "Q":
                self.symbol[hh] = " "
                for k in range(qa.n):
                    if hh < len(qa.s[k]) and qa.s[k][hh] == ".":
                        qa.s[k][hh] = "-"
            elif sym == "T":
                self.symbol[hh] = " "
                for k in range(ta.n):
                    if hh < len(ta.s[k]) and ta.s[k][hh] == ".":
                        ta.s[k][hh] = "-"

    def print_header(self, q: HMM, hit: Hit) -> str:
        """hhfullalignment.cpp:206-216."""
        mc = max(hit.matched_cols, 1)
        return (">%s\n" % hit.longname
                + "Probab=%-.2f  E-value=%-.2g  Score=%-.2f  "
                "Aligned_cols=%i  Identities=%i%%  Similarity=%-.3f  "
                "Sum_probs=%.1f  Template_Neff=%-.3f\n\n"
                % (hit.Probab, hit.Eval, hit.score, hit.matched_cols,
                   int(math.floor(100.0 * self.identities / mc + 0.5)),
                   self.score_sim / mc, hit.sum_of_probs, hit.Neff_HMM))

    def print_hhr(self, hit: Hit, showconf, showcons, showdssp, showpred,
                  aliwidth) -> str:
        """hhfullalignment.cpp:219-399."""
        out = []
        qa, ta = self.qa, self.ta
        lq = [int(qa.l[k][hit.i1]) for k in range(qa.n)]
        lt = [int(ta.l[k][hit.j1]) for k in range(ta.n)]
        iq = hit.i1
        jt = hit.j1
        hh = 0
        while hh < ta.pos - 1:
            hend = min(hh + aliwidth, qa.pos - 1)

            def name_of(names, k):
                return names[k].split()[0] if names[k].split() else names[k]

            # query SS annotation rows
            for k in range(qa.n):
                if k not in (qa.nss_dssp, qa.nsa_dssp, qa.nss_pred,
                             qa.nss_conf):
                    continue
                if k == qa.nsa_dssp:
                    continue
                if k == qa.nss_dssp and not showdssp:
                    continue
                if k in (qa.nss_pred, qa.nss_conf) and not showpred:
                    continue
                if k == qa.nss_conf and not showconf:
                    continue
                line = "Q %-*.*s      " % (NLEN, NLEN, name_of(qa.sname, k))
                if k == qa.nss_pred and qa.nss_conf >= 0:
                    for h in range(hh, hend):
                        c = qa.s[k][h]
                        cc = qa.s[qa.nss_conf][h]
                        line += chr(ord(c) + 32) if "0" <= cc <= "6" else c
                else:
                    line += "".join(qa.s[k][hh:hend])
                out.append(line)
            # query sequences
            for k in range(qa.n):
                if k in (qa.nss_dssp, qa.nsa_dssp, qa.nss_pred,
                         qa.nss_conf, qa.ncons):
                    continue
                line = "Q %-*.*s %4i " % (NLEN, NLEN, name_of(qa.sname, k),
                                          lq[k])
                for h in range(hh, hend):
                    line += qa.s[k][h]
                    lq[k] += _word_chr(qa.s[k][h])
                line += " %4i (%i)" % (lq[k] - 1, int(qa.l[k][qa.L + 1]))
                out.append(line)
            # query consensus
            if showcons and qa.ncons >= 0:
                k = qa.ncons
                line = "Q %-*.*s %4i " % (NLEN, NLEN, name_of(qa.sname, k),
                                          iq)
                for h in range(hh, hend):
                    if qa.s[k][h] == "x":
                        qa.s[k][h] = "~"
                    if qa.s[k][h] not in "-.":
                        iq += 1
                    line += qa.s[k][h]
                line += " %4i (%i)" % (iq - 1, qa.L)
                out.append(line)
            # score symbols
            line = "  %*.*s      " % (NLEN, NLEN, " ")
            line += "".join(self.symbol.get(h, " ") for h in range(hh, hend))
            out.append(line)
            # template consensus
            if showcons and ta.ncons >= 0:
                k = ta.ncons
                line = "T %-*.*s %4i " % (NLEN, NLEN, name_of(ta.sname, k),
                                          jt)
                for h in range(hh, hend):
                    if ta.s[k][h] == "x":
                        ta.s[k][h] = "~"
                    if ta.s[k][h] not in "-.":
                        jt += 1
                    line += ta.s[k][h]
                line += " %4i (%i)" % (jt - 1, ta.L)
                out.append(line)
            # template sequences
            for k in range(ta.n):
                if k in (ta.nss_dssp, ta.nsa_dssp, ta.nss_pred,
                         ta.nss_conf, ta.ncons):
                    continue
                line = "T %-*.*s %4i " % (NLEN, NLEN, name_of(ta.sname, k),
                                          lt[k])
                for h in range(hh, hend):
                    line += ta.s[k][h]
                    lt[k] += _word_chr(ta.s[k][h])
                line += " %4i (%i)" % (lt[k] - 1, int(ta.l[k][ta.L + 1]))
                out.append(line)
            # template SS annotation rows
            for k in range(ta.n):
                if k not in (ta.nss_dssp, ta.nss_pred, ta.nss_conf):
                    continue
                if k == ta.nsa_dssp:
                    continue
                if k == ta.nss_dssp and not showdssp:
                    continue
                if k in (ta.nss_pred, ta.nss_conf) and not showpred:
                    continue
                if k == ta.nss_conf and not showconf:
                    continue
                line = "T %-*.*s      " % (NLEN, NLEN, name_of(ta.sname, k))
                if k == ta.nss_pred and ta.nss_conf >= 0:
                    for h in range(hh, hend):
                        c = ta.s[k][h]
                        cc = ta.s[ta.nss_conf][h]
                        line += chr(ord(c) + 32) if "0" <= cc <= "6" else c
                else:
                    line += "".join(ta.s[k][hh:hend])
                out.append(line)
            # confidence row
            if self.has_posterior:
                line = "%-*.*s        " % (NLEN, NLEN,
                                           "Confidence                     ")
                line += "".join(self.posterior.get(h, " ")
                                for h in range(hh, hend))
                out.append(line)
            hh = hend
            out.append("")
            out.append("")
        return "\n".join(out) + "\n"

    def _print_a2m_half(self, ha, showcons, showdssp, showpred,
                        aliwidth, transform=None) -> str:
        """One half of PrintA2M (hhfullalignment.cpp:401-449): wrap at
        aliwidth with the reference's newline-before-char loop; stop at
        the terminating NUL column."""
        out = []
        for k in range(ha.n):
            if k == ha.nsa_dssp:
                continue
            if k == ha.nss_dssp and not showdssp:
                continue
            if k in (ha.nss_pred, ha.nss_conf) and not showpred:
                continue
            if k == ha.ncons and not showcons:
                continue
            out.append(">" + ha.sname[k] + "\n")
            chars = []
            hh = -aliwidth
            for c in ha.s[k]:
                if c == "\0":
                    break
                if transform is not None:
                    c = transform(c)
                    if c is None:
                        continue
                if hh == 0:
                    chars.append("\n")
                    hh -= aliwidth
                chars.append(c)
                hh += 1
            out.append("".join(chars) + "\n")
        return "".join(out)

    def print_a2m(self, showcons, showdssp, showpred, aliwidth,
                  transform=None) -> str:
        """FullAlignment::PrintA2M (hhfullalignment.cpp:401-449)."""
        return (self._print_a2m_half(self.qa, showcons, showdssp,
                                     showpred, aliwidth, transform)
                + self._print_a2m_half(self.ta, showcons, showdssp,
                                       showpred, aliwidth, transform)
                + "\n")

    def print_fasta(self, showcons, showdssp, showpred, aliwidth) -> str:
        """PrintFASTA: uppercase, '.' -> '-'
        (hhfullalignment.cpp:454-459 + HalfAlignment::ToFASTA)."""
        def tf(c):
            return "-" if c == "." else c.upper()

        return self.print_a2m(showcons, showdssp, showpred, aliwidth, tf)

    def print_a3m(self, showcons, showdssp, showpred, aliwidth) -> str:
        """PrintA3M: drop '.' (hhfullalignment.cpp:464-469)."""
        def tf(c):
            return None if c == "." else c

        return self.print_a2m(showcons, showdssp, showpred, aliwidth, tf)


def print_alignments(q: HMM, hitlist, par, S: np.ndarray,
                     outformat: int = 0) -> str:
    """HitList::PrintAlignments (hhhitlist.cpp:179-228).

    outformat 0 = hhr blocks, 1 = FASTA, 2 = A2M, 3 = A3M
    (FullAlignment::PrintFASTA/PrintA2M/PrintA3M,
    hhfullalignment.cpp:401-469)."""
    out = ""
    nhits = 0
    for hit in hitlist:
        if nhits >= par.B:
            break
        if nhits >= par.b and hit.Probab < par.p:
            break
        if nhits >= par.b and hit.Eval > par.E:
            continue
        if hit.light:
            continue  # funnel hit without a backtrace path
        nhits += 1
        fa = FullAlignment()
        fa.build(q, hit, par.nseqdis, S)
        out += "No %i\n" % nhits
        if outformat == 0:
            out += fa.print_header(q, hit)
            out += fa.print_hhr(hit, par.showconf, par.showcons,
                                par.showdssp, par.showpred, par.aliwidth)
        elif outformat == 1:
            out += fa.print_fasta(par.showcons, par.showdssp,
                                  par.showpred, par.aliwidth)
        elif outformat == 2:
            out += fa.print_a2m(par.showcons, par.showdssp, par.showpred,
                                par.aliwidth)
        else:
            out += fa.print_a3m(par.showcons, par.showdssp, par.showpred,
                                par.aliwidth)
    return out
