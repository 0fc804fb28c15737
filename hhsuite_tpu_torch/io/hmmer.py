"""HMMER2 / HMMER3 profile import.

Behavioral port of HMM::ReadHMMer (src/hhhmm.cpp:696-1207) and
HMM::ReadHMMer3 (src/hhhmm.cpp:1208-1717): emission scores are converted
back to probabilities (HMMER3 stores -ln p, HMMER2 stores
1000*log2(p/null)), transitions to log2, the consensus/annotation
sequence becomes the display sequence, and Neff is entropy-derived
(HMMER3: fitted from EFFN).  Models arrive with pseudocounts already
included (has_pseudocounts = True), so PrepareTemplateHMM/
PrepareQueryHMM add none (format=1 path).

Deviation from the reference: the COMPO/NULE background overwrites the
GLOBAL pb array there; here it is kept per-HMM (``hmm.pb_hmmer``) and
used for this model's null-model preparation only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .. import fastmath as fm
from ..constants import (D2D, D2M, HMMSCALE, I2I, I2M, M2D, M2I, M2M, NAA,
                         S2A, i2aa)
from ..core.hmm import HMM

_SS_MAP = {"H": 1, "E": 2, "C": 3, "S": 4, "T": 5, "G": 6, "B": 7,
           "I": 3, "~": 3}


def _tokens(line: str) -> List[str]:
    return line.split()


def _strflta(tok: str, deflt: float = 99999.0) -> float:
    if tok == "*":
        return deflt
    return float(tok)


def _strinta(tok: str, deflt: int = -99999) -> int:
    if tok == "*":
        return deflt
    return int(tok)


def _log2_expneg(v: float) -> np.float32:
    """log2((float)exp(-v)) with C's float truncation of the exp."""
    return np.float32(math.log2(np.float32(math.exp(-v))) if
                      np.float32(math.exp(-v)) > 0 else -99999.0)


def _scop_fam(desc_first_word: Optional[str]) -> str:
    if (not desc_first_word or len(desc_first_word) < 2
            or desc_first_word[1] != "."
            or "." not in desc_first_word[3:]):
        return ""
    return desc_first_word[:511]


def _finish(q: HMM, i: int, L: int, name: str, longname: str, desc: str,
            showcons: int, annot: bool, annotchr: List[str],
            ss_seq: List[str], dssp: bool, pb: np.ndarray):
    """Common tail (hhhmm.cpp:1059-1207 / 1576-1716)."""
    q.L = L = i
    parts = []
    if longname:
        parts.append(longname)
    if name:
        parts.append(name)
    if desc:
        parts.append(desc)
    q.longname = " ".join(parts)[:32764]
    q.name = name[:511]
    q.fam = q.fam or ""

    k = len(q.sname)
    # consensus / display sequence (hhhmm.cpp:1628-1684)
    amax = np.argmax(q.f[1:L + 1, :NAA], axis=1)
    pmax = q.f[np.arange(1, L + 1), amax]
    if showcons:
        cons = "".join(
            i2aa(int(a)) if p > 0.6 else
            (i2aa(int(a)).lower() if p > 0.4 else "x")
            for a, p in zip(amax, pmax))
        q.sname.append("Consensus")
        q.seq.append("-" + cons)
        q.ncons = k
        k += 1
        q.sname.append(q.longname)
        disp = "".join(i2aa(int(a)) for a in amax)
        q.seq.append("-" + disp)
    else:
        q.sname.append(q.longname)
        disp = "".join(i2aa(int(a)) for a in amax)
        q.seq.append("-" + disp)
    if annot:
        q.seq[-1] = "-" + "".join((annotchr[j] or "-")
                                  for j in range(1, L + 1))
    q.nfirst = k
    k += 1
    q.n_display = k
    q.n_seqs = k

    if q.Neff_HMM == 0:
        neff = np.float32(0.0)
        for ii in range(1, L + 1):
            S = np.float32(0.0)
            fi = q.f[ii]
            for a in range(20):
                if fi[a] > 1e-10:
                    S = np.float32(S - np.float32(fi[a]
                                                  * fm.fast_log2(fi[a])))
            neff = np.float32(neff + np.float32(fm.fpow2(S)))
        q.Neff_HMM = float(np.float32(neff / np.float32(L)))

    q.Neff_M[0:L + 1] = 10.0
    q.Neff_I[0:L + 1] = 10.0
    q.Neff_D[0:L + 1] = 10.0
    q.Neff_M[L + 1] = 1.0
    q.Neff_I[L + 1] = 0.0
    q.Neff_D[L + 1] = 0.0

    q.f[0, :20] = pb[:20]
    q.f[L + 1, :20] = pb[:20]
    q.pb_hmmer = pb.copy()
    q.has_pseudocounts = True
    q.trans_lin = 0


def read_hmmer3(text: str, showcons: int = 0,
                pb: Optional[np.ndarray] = None, filestr: str = "",
                maxres: int = 20001) -> HMM:
    """HMM::ReadHMMer3 (src/hhhmm.cpp:1208-1717)."""
    pb = (np.full(NAA, 0.05, np.float32) if pb is None
          else np.asarray(pb, np.float32).copy())
    lines = text.splitlines()
    li = 0
    q = HMM()
    name = longname = desc = ""
    L = 0
    i = 0
    annot = False
    dssp = False
    annotchr: List[str] = []
    ss_seq: List[str] = []
    ss_pred_str = ""
    ss_conf_str = ""
    sa_dssp_str = ""

    # header
    while li < len(lines):
        line = lines[li]
        li += 1
        s = line.strip()
        if not s or line.startswith("HMMER"):
            continue
        if line.startswith("//"):
            break
        key = line[:4]
        if key == "NAME" and not name:
            name = s[4:].strip().split()[0] if s[4:].strip() else ""
        elif key == "ACC ":
            longname = s[4:].strip()[:32764]
        elif key == "DESC":
            desc = s[4:].strip()[:32764]
            first = desc.split()[0] if desc.split() else None
            q.fam = _scop_fam(first)
        elif key == "LENG":
            L = int(s.split()[1])
        elif key == "NSEQ":
            q.N_in = q.N_filtered = int(s.split()[1])
        elif key == "EFFN":
            effn = float(s.split()[1])
            q.Neff_HMM = (-1.403534 * effn ** 0.1
                          + 4.428118 * effn ** 0.5
                          - 0.2885410 * effn - 1.108568)
        elif line.startswith("SSPRD"):
            ss_pred_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("SSCON"):
            ss_conf_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("SADSS"):
            sa_dssp_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("HMM"):
            q.alloc(max(L, 1))
            annotchr = [""] * (L + 2)
            ss_seq = [""] * (L + 2)
            li += 1                          # transition labels line
            toks = _tokens(lines[li])
            li += 1
            if toks and toks[0] == "COMPO":
                for a in range(20):
                    pb[S2A[a]] = np.float32(
                        math.exp(-1.0 * _strflta(toks[a + 1])))
                toks = _tokens(lines[li])
                li += 1
            # line with 0-state insert probabilities was just consumed
            toks = _tokens(lines[li])
            li += 1
            for a in range(D2D + 1):
                q.tr[0, a] = _log2_expneg(_strflta(toks[a]))
            next_i = 0
            while li < len(lines):
                line = lines[li]
                li += 1
                if line.startswith("//") or line.startswith("#"):
                    break
                if not line.strip():
                    continue
                toks = _tokens(line)
                next_i = int(toks[0])
                i += 1
                if i > L:
                    break
                for a in range(20):
                    q.f[i, S2A[a]] = np.float32(
                        math.exp(-1.0 * _strflta(toks[a + 1])))
                # tokens after the 20 values: MAP is skipped, the
                # next word supplies BOTH the annotation character and
                # the SS character — the reference's ptr is not advanced
                # between the two reads (hhhmm.cpp:1488-1496), so the CS
                # column is never actually consulted
                rest = toks[21:]
                if rest:
                    ann = rest[1] if len(rest) > 1 else "-"
                    annotchr[i] = ann[0].upper()
                    if ann[0] not in "- Xx":
                        annot = True
                    cs = ann[0]
                    if cs in _SS_MAP:
                        q.ss_dssp[i] = _SS_MAP[cs]
                        ss_seq[i] = cs
                        if cs != "~":
                            dssp = True
                    elif cs in "-.X":
                        q.ss_dssp[i] = 0
                        ss_seq[i] = "-"
                    else:
                        q.ss_dssp[i] = 0
                        ss_seq[i] = cs
                li += 1                      # skip insert emission line
                toks = _tokens(lines[li])
                li += 1
                for a in range(D2D + 1):
                    q.tr[i, a] = _log2_expneg(_strflta(toks[a]))
    if L == 0 or i == 0:
        raise ValueError("no match states in HMMER3 model")

    _attach_specials(q, dssp, ss_seq, ss_pred_str, ss_conf_str,
                     sa_dssp_str, i)
    _finish(q, i, L, name, longname, desc, showcons, annot, annotchr,
            ss_seq, dssp, pb)
    base = filestr.rsplit("/", 1)[-1]
    q.file = base.rsplit(".", 1)[0] if "." in base else base
    return q


def _attach_specials(q: HMM, dssp: bool, ss_seq: List[str],
                     ss_pred_str: str, ss_conf_str: str,
                     sa_dssp_str: str, L: int):
    """Register ss_dssp / ss_pred / ss_conf / sa_dssp display rows."""
    from ..core.alignment import _CF2I, _SS2I

    k = 0
    if sa_dssp_str:
        q.nsa_dssp = k
        q.sname.append("sa_dssp")
        q.seq.append("-" + sa_dssp_str[:L])
        k += 1
    if ss_pred_str:
        q.nss_pred = k
        q.sname.append("ss_pred")
        q.seq.append("-" + ss_pred_str[:L])
        for i in range(1, min(len(ss_pred_str), L) + 1):
            q.ss_pred[i] = max(_SS2I[ord(ss_pred_str[i - 1]) & 0xFF], 0)
        k += 1
    if ss_conf_str:
        q.nss_conf = k
        q.sname.append("ss_conf")
        q.seq.append("-" + ss_conf_str[:L])
        for i in range(1, min(len(ss_conf_str), L) + 1):
            q.ss_conf[i] = max(_CF2I[ord(ss_conf_str[i - 1]) & 0xFF], 0)
        k += 1
    elif ss_pred_str:
        q.ss_conf[1:L + 1] = 5   # hhhmm.cpp:1623-1625
    if dssp:
        q.nss_dssp = k
        q.sname.append("ss_dssp")
        q.seq.append("-" + "".join(c if c else "-"
                                   for c in ss_seq[1:L + 1]))
        k += 1


def read_hmmer2(text: str, showcons: int = 0,
                pb: Optional[np.ndarray] = None, filestr: str = "",
                maxres: int = 20001) -> HMM:
    """HMM::ReadHMMer (src/hhhmm.cpp:696-1207), the HMMER2 format:
    integer scores 1000*log2(p/null)."""
    pb = (np.full(NAA, 0.05, np.float32) if pb is None
          else np.asarray(pb, np.float32).copy())
    lines = text.splitlines()
    li = 0
    q = HMM()
    name = longname = desc = ""
    L = 0
    i = 0
    annot = False
    dssp = False
    annotchr: List[str] = []
    ss_seq: List[str] = []
    ss_pred_str = ""
    ss_conf_str = ""
    sa_dssp_str = ""

    while li < len(lines):
        line = lines[li]
        li += 1
        s = line.strip()
        if not s or line.startswith("HMMER"):
            continue
        if line.startswith("//"):
            break
        key = line[:4]
        if key == "NAME" and not name:
            name = s[4:].strip().split()[0] if s[4:].strip() else ""
        elif key == "ACC ":
            longname = s[4:].strip()[:32764]
        elif key == "DESC":
            desc = s[4:].strip()[:32764]
            first = desc.split()[0] if desc.split() else None
            q.fam = _scop_fam(first)
        elif key == "LENG":
            L = int(s.split()[1])
        elif key == "NSEQ":
            q.N_in = q.N_filtered = int(s.split()[1])
        elif key == "NULE":
            toks = s[4:].split()
            for a in range(20):
                pb[S2A[a]] = np.float32(
                    0.05 * fm.fpow2(np.float32(_strinta(toks[a])
                                               / HMMSCALE)))
        elif key == "EVD ":
            toks = s[4:].split()
            lam, mu = float(toks[0]), float(toks[1])
            if lam < 0:
                lam = mu = 0.0
            q.lamda, q.mu = lam, mu
        elif line.startswith("SSPRD"):
            ss_pred_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("SSCON"):
            ss_conf_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("SADSS"):
            sa_dssp_str += s[5:].strip().split()[0] \
                if s[5:].strip() else ""
        elif line.startswith("HMM"):
            q.alloc(max(L, 1))
            annotchr = [""] * (L + 2)
            ss_seq = [""] * (L + 2)
            li += 1                          # transition labels line
            toks = _tokens(lines[li])
            li += 1
            for a in range(M2D + 1):
                q.tr[0, a] = np.float32(_strinta(toks[a]) / HMMSCALE)
            q.tr[0, I2M] = q.tr[0, D2M] = 0.0
            q.tr[0, I2I] = q.tr[0, D2D] = -99999.0
            next_i = 0
            while li < len(lines):
                line = lines[li]
                li += 1
                if line.startswith("//") or line.startswith("#"):
                    break
                if not line.strip():
                    continue
                toks = _tokens(line)
                next_i = int(toks[0])
                i += 1
                if i > L:
                    break
                for a in range(20):
                    q.f[i, S2A[a]] = np.float32(
                        pb[S2A[a]] * fm.fpow2(np.float32(
                            _strinta(toks[a + 1]) / HMMSCALE)))
                # insert emission line: first word = annotation char
                ins = _tokens(lines[li])
                li += 1
                if ins:
                    annotchr[i] = ins[0][0].upper()
                    if ins[0][0] not in "- Xx":
                        annot = True
                # transition line: SS char then 7 transitions
                trline = lines[li]
                li += 1
                tt = _tokens(trline)
                cs = tt[0][0] if tt else "-"
                if cs in _SS_MAP:
                    q.ss_dssp[i] = _SS_MAP[cs]
                    ss_seq[i] = cs
                    if cs != "~":
                        dssp = True
                elif cs in "-.X":
                    q.ss_dssp[i] = 0
                    ss_seq[i] = "-"
                else:
                    q.ss_dssp[i] = 0
                    ss_seq[i] = cs
                for a in range(D2D + 1):
                    q.tr[i, a] = np.float32(_strinta(tt[a + 1])
                                            / HMMSCALE)
    if L == 0 or i == 0:
        raise ValueError("no match states in HMMER2 model")

    _attach_specials(q, dssp, ss_seq, ss_pred_str, ss_conf_str,
                     sa_dssp_str, i)
    _finish(q, i, L, name, longname, desc, showcons, annot, annotchr,
            ss_seq, dssp, pb)
    base = filestr.rsplit("/", 1)[-1]
    q.file = base.rsplit(".", 1)[0] if "." in base else base
    return q
