"""Result writers: hit-list summary, blasttab (m8), scores, alitab.

printf-exact ports of HitList::PrintHitList (src/hhhitlist.cpp:15-97),
PrintM8File (:276-326), PrintScoreFile (:327-376) and WriteToAlifile
(:377-463) — these formats are the diff oracles of data/test.sh.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..core.hit import Hit, HitList
from ..core.hmm import HMM
from ..profiling import annotated

STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6


def _cpp_float(x: float) -> str:
    """Mimic std::ostream << float (6 significant digits, %g-style)."""
    s = f"{float(x):.6g}"
    return s


@annotated("host_output")
def print_hit_list(q: HMM, hitlist: HitList, maxdbstrlen=200, z=10, Z=500,
                   p=20.0, E=1e6, argv: Optional[List[str]] = None,
                   datestr: Optional[str] = None) -> str:
    """hhhitlist.cpp:15-97."""
    out = []
    out.append(f"Query         {q.longname}")
    out.append(f"Match_columns {q.L}")
    out.append(f"No_of_seqs    {q.N_filtered} out of {q.N_in}")
    out.append(f"Neff          {_cpp_float(q.Neff_HMM)}")
    out.append(f"Searched_HMMs {hitlist.N_searched}")
    out.append("Date          " + (datestr or time.ctime()))
    cmd = ""
    for a in (argv or []):
        if len(a) <= maxdbstrlen:
            cmd += a + " "
        else:
            cmd += f"<{len(a)}characters> "
    out.append("Command       " + cmd)
    out.append("")
    out.append(" No Hit                             Prob E-value P-value"
               "  Score    SS Cols Query HMM  Template HMM")
    nhits = 0
    for hit in hitlist:
        if nhits >= Z:
            break
        if nhits >= z and hit.Probab < p:
            break
        if nhits >= z and hit.Eval > E:
            continue
        nhits += 1
        s = "%3i %-30.30s    " % (nhits, hit.longname)
        if hit.Eval >= 1e-99:
            Estr = "%7.2G" % hit.Eval
        else:
            Estr = "%7.0E" % hit.Eval
        if hit.Pval >= 1e-99:
            Pstr = "%7.2G" % hit.Pval
        else:
            Pstr = "%7.0E" % hit.Pval
        line = "%-34.34s %5.1f %7s %7s " % (s, hit.Probab, Estr, Pstr)
        sstr = "%6.1f" % hit.score
        line += "%-6.6s %5.1f %4i %4i-%-4i %4i-%-4i(%i)" % (
            sstr, hit.score_ss, hit.matched_cols, hit.i1, hit.i2,
            hit.j1, hit.j2, hit.L)
        out.append(line)
    out.append("")
    return "\n".join(out) + "\n"


def print_m8(q: HMM, hitlist: HitList, nhits_min_b=10, p=20.0, E=1e6) -> str:
    """Blasttab format (hhhitlist.cpp:276-326)."""
    out = []
    nhits = 0
    qseq = q.seq[q.nfirst] if q.nfirst >= 0 and q.seq else ""
    for hit in hitlist:
        if nhits >= nhits_min_b and hit.Probab < p:
            break
        if nhits >= nhits_min_b and hit.Eval > E:
            continue
        gap_open = 0
        mismatch = 0
        match = 0
        is_gap_open = False
        tseq = hit.seq[hit.nfirst] if hit.nfirst >= 0 and hit.seq else ""
        for step in range(hit.nsteps, 0, -1):
            st = hit.states[step]
            if st == GD or st == DG:
                if not is_gap_open:
                    gap_open += 1
                is_gap_open = True
            elif st == MM:
                jj = int(hit.j[step])
                ii = int(hit.i[step])
                tc = tseq[jj] if jj < len(tseq) else "\x00"
                qc = qseq[ii] if ii < len(qseq) else "\x00"
                if tc == qc:
                    match += 1
                else:
                    mismatch += 1
                is_gap_open = False
            else:
                is_gap_open = False
        out.append("%s\t%s\t%1.3f\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%.2E\t%.1f"
                   % (q.name, hit.name, float(match) / float(hit.L),
                      hit.L, mismatch, gap_open, hit.i1, hit.i2, hit.j1,
                      hit.j2, hit.Eval, -hit.score_aass))
    return "\n".join(out) + ("\n" if out else "")


def _scop_id(fam: str):
    """ScopID (hhutil-inl.h): fam 'a.1.2.3' -> cl 'a', fold 'a.1',
    sfam 'a.1.2'; non-scop families give empty strings."""
    parts = fam.split(".")
    if len(parts) >= 2 and len(parts[0]) == 1 and parts[0].isalpha():
        cl = parts[0]
        fold = ".".join(parts[:2]) if len(parts) >= 2 else ""
        sfam = ".".join(parts[:3]) if len(parts) >= 3 else ""
        return cl, fold, sfam
    return "", "", ""


def print_score_file(q: HMM, hitlist: HitList) -> str:
    """hhhitlist.cpp:327-375 (exact format strings)."""
    out = []
    out.append("NAME  " + q.longname)
    out.append("FAM   " + q.fam)
    out.append("FILE  " + q.file)
    out.append("LENG  %i" % q.L)
    out.append("TARGET                FAMILY   REL  LEN  COL  LOG-PVA"
               "  S-AASS PROBAB  SCORE  LOG-EVAL")
    qcl, qfold, qsfam = _scop_id(q.fam)
    seen = set()
    for hit in hitlist:
        if hit.name in seen:
            continue
        seen.add(hit.name)
        hcl, hfold, hsfam = _scop_id(hit.fam)
        if hit.name == q.name:
            n = 5
        elif hit.fam and hit.fam == q.fam:
            n = 4
        elif hsfam and hsfam == qsfam:
            n = 3
        elif hfold and hfold == qfold:
            n = 2
        elif hcl and hcl == qcl:
            n = 1
        else:
            n = 0
        out.append("%-20s %-10s %1i %5i %3i %8.3f %7.2f %6.2f %7.2f %8.3f"
                   % (hit.name, hit.fam, n, hit.L, hit.matched_cols,
                      -1.443 * hit.logPval, -hit.score_aass, hit.Probab,
                      hit.score, -1.443 * hit.logEval))
    return "\n".join(out) + "\n"


def write_alitab(q: HMM, hitlist: HitList, b=10, B=500, z=10, Z=500,
                 p=20.0, E=1e6) -> str:
    """HitList::WriteToAlifile (hhhitlist.cpp:377-463)."""
    out = []
    nhits = 0
    for hit in hitlist:
        if nhits >= max(B, Z):
            break
        if nhits >= max(b, z) and hit.Probab < p:
            break
        if nhits >= max(b, z) and hit.Eval > E:
            continue
        out.append(">%s" % hit.longname)
        has_post = hit.P_posterior is not None
        if has_post:
            if hit.nss_dssp >= 0:
                out.append("    i     j  score     SS  probab  dssp")
                for step in range(hit.nsteps, 0, -1):
                    if hit.states[step] == MM:
                        out.append(
                            "%5i %5i %6.2f %6.2f %7.4f %5c"
                            % (hit.i[step], hit.j[step], hit.S[step],
                               hit.S_ss[step], hit.P_posterior[step],
                               hit.seq[hit.nss_dssp][hit.j[step]]))
            else:
                out.append("missing dssp")
                out.append("    i     j  score     SS  probab")
                for step in range(hit.nsteps, 0, -1):
                    if hit.states[step] == MM:
                        out.append("%5i %5i %6.2f %6.2f %7.4f"
                                   % (hit.i[step], hit.j[step],
                                      hit.S[step], hit.S_ss[step],
                                      hit.P_posterior[step]))
        else:
            out.append("    i     j  score     SS")
            for step in range(hit.nsteps, 0, -1):
                if hit.states[step] == MM:
                    out.append("%5i %5i %6.2f %6.2f"
                               % (hit.i[step], hit.j[step], hit.S[step],
                                  hit.S_ss[step]))
        nhits += 1
    return "\n".join(out) + ("\n" if out else "")


# --------------------------------------------------------------- -omat ----

def _float_to_8_bit(x: float) -> int:
    """4-bit-exponent/4-bit-mantissa minifloat (hhutil.cpp:69-89)."""
    import struct

    bits = struct.unpack("<I", struct.pack("<f", float(np.float32(x))))[0]
    e = (bits & 0x7F800000) - 939524096
    e = (e & 0x07800000) >> 19
    m = (bits & 0x00780000) >> 19
    return (e | m) & 0xFF


def _u16be(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _sparse_block(entries) -> bytes:
    """Run-encoded sparse matrix block (hhhitlist.cpp:729-816):
    (u16 i, u16 j) header whenever a new run starts, then one minifloat
    byte per consecutive-j cell; 0x00 run terminator; u16 0 end."""
    out = bytearray()
    last_i = last_j = -1
    for (i, j, v) in entries:
        if last_i != i or last_j + 1 != j:
            if last_i != -1:
                out.append(0)
            out += _u16be(i)
            out += _u16be(j)
        out.append(_float_to_8_bit(v))
        last_i, last_j = i, j
    out.append(0)
    out += _u16be(0)
    return bytes(out)


def print_matrices(q: HMM, hitlist: HitList, filter_matrices: bool,
                   max_number_matrices: int, S) -> bytes:
    """HitList::PrintMatrices (hhhitlist.cpp:558-818): binary posterior /
    forward / backward sparse matrices for downstream modelling tools."""
    protein_max_length = 4000
    if q.L >= protein_max_length:
        return b""
    tolerance = 0.10
    hits = []
    for hit in hitlist:
        if getattr(hit, "forward_profile", None) is None or \
                getattr(hit, "backward_profile", None) is None:
            continue
        fsum = float(hit.forward_profile[1: q.L + 1].sum())
        bsum = float(hit.backward_profile[1: q.L + 1].sum())
        if (1.0 - tolerance < fsum < 1.0 + tolerance
                and 1.0 - tolerance < bsum < 1.0 + tolerance
                and len(hit.forward_matrix) > 0
                and len(hit.backward_matrix) > 0
                and len(hit.posterior_matrix) > 0):
            hits.append(hit)

    picked = [True] * len(hits)
    chosen = len(hits)
    prob_thr = 20
    for i1 in range(len(hits) - 1, -1, -1):
        it = hits[i1]
        if it.Probab < prob_thr or it.L >= protein_max_length:
            picked[i1] = False
            chosen -= 1
        elif picked[i1]:
            for i2 in range(i1 - 1, -1, -1):
                c = hits[i2]
                if (picked[i2] and it.name == c.name
                        and it.irep == c.irep) or it.Probab < prob_thr:
                    picked[i2] = False
                    chosen -= 1

    if filter_matrices and hits:
        n = len(hits)
        sim = np.zeros((n, n))
        for k in range(n):
            sim[k, k] = 1.0
            for kk in range(k + 1, n):
                a, b = hits[k], hits[kk]
                v = float(np.sum(
                    np.sqrt(a.forward_profile[1: q.L + 1]
                            * b.forward_profile[1: q.L + 1])
                    + np.sqrt(a.backward_profile[1: q.L + 1]
                              * b.backward_profile[1: q.L + 1]))) / 2.0
                sim[k, kk] = sim[kk, k] = v
        while chosen > max_number_matrices:
            max_val, max_idx = 0.0, 0
            for k in range(n):
                ssum = sum(sim[k, kp] for kp in range(n)
                           if picked[kp] and picked[k])
                if ssum > max_val:
                    max_val, max_idx = ssum, k
            picked[max_idx] = False
            chosen -= 1

    if chosen == 0:
        return b""

    out = bytearray()
    out += q.name.encode() + b"\x00"
    out += _u16be(q.L)
    for idx, hit in enumerate(hits):
        if not picked[idx]:
            continue
        out += hit.name.encode() + b"\x00"
        out += _u16be(hit.L)
        out.append(int(hit.Probab) & 0xFF)
        simv = int(hit.calculate_similarity(q, S) * 10) & 0xFFFF
        out += _u16be(simv)
        out += _sparse_block(hit.backward_matrix)
        out += _sparse_block(hit.forward_matrix)
        out += _sparse_block(hit.posterior_matrix)
    return bytes(out)
