"""HHM profile file format, byte-compatible with the reference.

Writer mirrors HMM::WriteToFile (src/hhhmm.cpp:2173-2299), reader mirrors
HMM::Read (src/hhhmm.cpp:202-690).  Values are fixed-point
``-round(log2(p) * 1000)`` with '*' for zero probability (HMMSCALE=1000,
src/hhdecl.h:39).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, TextIO

import numpy as np

from .. import fastmath as fm
from ..constants import D2D, HMMSCALE, NAA, NTRANS, S2A

_S2A20 = np.array(S2A[:20], dtype=np.int64)
from ..core.hmm import HMM


def _iround(x: float) -> int:
    return int(math.floor(x + 0.5))


def _sout(v: int) -> str:
    return "*\t" if v >= 99999 else f"{v}\t"


def write_hhm(q: HMM, pb: np.ndarray, max_seqid=90, coverage=0, qid=0,
              Ndiff=100, qsc=-20.0, argv: Optional[List[str]] = None,
              datestr: Optional[str] = None) -> str:
    """Render an HHM file (hhhmm.cpp:2173-2299)."""
    if q.trans_lin == 1:
        raise RuntimeError("cannot write HMM with linear transitions")
    out = []
    out.append("HHsearch 1.5")
    out.append(f"NAME  {q.longname}")
    out.append(f"FAM   {q.fam}")
    out.append("COM   " + "".join(
        (a if len(a) <= 100 else f"<{len(a)} characters>") + " "
        for a in (argv or [])))
    out.append("DATE  " + (datestr or time.ctime()))
    out.append(f"LENG  {q.L} match states, {int(q.l[q.L])} columns in multiple alignment")
    out.append("")
    out.append(f"FILT  {q.N_filtered} out of {q.N_in} sequences passed filter"
               f" (-id {max_seqid} -cov {coverage} -qid {qid} -qsc {qsc:g}"
               f" -diff {Ndiff})")
    out.append("NEFF  %-4.1f" % q.Neff_HMM)
    if q.has_pseudocounts:
        out.append("PCT   true")
    out.append("SEQ")
    for nidx in range(q.n_display):
        out.append(">" + q.sname[nidx])
        s = q.seq[nidx][1:]
        for j in range(0, len(s), 100):
            out.append(s[j:j + 100])
    out.append("#")

    out.append("NULL   " + "".join(
        _sout(-_iround(float(fm.fast_log2(np.float32(pb[S2A[a]])))
                       * HMMSCALE)) for a in range(20)))

    out.append("HMM    " + "".join(
        "ACDEFGHIKLMNPQRSTVWY"[a] + "\t" for a in range(20)))
    out.append("       M->M\tM->I\tM->D\tI->M\tI->I\tD->M\tD->D\tNeff\tNeff_I\tNeff_D")

    line = "       "
    for a in range(D2D + 1):
        line += _sout(-_iround(float(q.tr[0, a]) * HMMSCALE))
    line += _sout(_iround(float(q.Neff_M[0]) * HMMSCALE))
    line += _sout(_iround(float(q.Neff_I[0]) * HMMSCALE))
    line += _sout(_iround(float(q.Neff_D[0]) * HMMSCALE))
    out.append(line)

    seqf = q.seq[q.nfirst] if q.nfirst >= 0 else "-" * (q.L + 1)
    # vectorized fixed-point conversion, same rounding order as the
    # scalar loop: f32 log2 -> python float (f64) -> *1000 -> floor+0.5
    L = q.L
    p_ints = np.minimum(-np.floor(
        fm.fast_log2(q.p[1: L + 1][:, _S2A20].astype(np.float32))
        .astype(np.float64) * HMMSCALE + 0.5), 99999).astype(np.int64)
    tr_ints = np.minimum(
        -np.floor(q.tr[1: L + 1, : D2D + 1].astype(np.float64)
                  * HMMSCALE + 0.5), 99999).astype(np.int64)
    ne_ints = np.floor(np.stack(
        [np.asarray(q.Neff_M[1: L + 1], np.float64),
         np.asarray(q.Neff_I[1: L + 1], np.float64),
         np.asarray(q.Neff_D[1: L + 1], np.float64)], axis=1)
        * HMMSCALE + 0.5).astype(np.int64)
    h = 1
    for i in range(1, L + 1):
        while h < len(seqf) and seqf[h].islower():
            h += 1
        c = seqf[h] if h < len(seqf) else "-"
        h += 1
        row = p_ints[i - 1]
        line = ("%1s %-4i " % (c, i)
                + "".join(_sout(v) for v in row.tolist())
                + "%-i" % int(q.l[i]))
        out.append(line)
        out.append("       "
                   + "".join(_sout(v) for v in tr_ints[i - 1].tolist())
                   + "".join(_sout(v) for v in ne_ints[i - 1].tolist()))
        out.append("")
    out.append("//")
    return "\n".join(out) + "\n"


def write_hhm_file(q: HMM, path: str, pb: np.ndarray, **kw):
    text = write_hhm(q, pb, **kw)
    with open(path, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------

def _strinta(tokens, idx):
    """Next integer, '*' = 99999 (util.cpp:175-196, default deflt=99999)."""
    if idx >= len(tokens):
        return None, idx
    t = tokens[idx]
    if t == "*":
        return 99999, idx + 1
    return int(t), idx + 1


_SEQ_TABS = None


def _seq_tabs():
    """bytes.translate (map, delete) pairs per SEQ-row category: the
    same keep/transform rules as the per-char genexprs below, but run
    in C (the SEQ block is ~60% of read_hhm time for deep MSAs)."""
    global _SEQ_TABS
    if _SEQ_TABS is None:
        from ..core.alignment import (_SS2I, _SA2I, ss2ss, AA2I_TABLE)

        ident = bytes(range(256))

        def build(keep, xform=None):
            delete = bytes(c for c in range(256) if not keep(c))
            if xform is None:
                return ident, delete
            table = bytes((ord(xform(chr(c))) if keep(c) else c)
                          for c in range(256))
            return table, delete

        _SEQ_TABS = {
            "ss_dssp": build(lambda c: 0 <= _SS2I[c] <= 7 and c != ord("."),
                             ss2ss),
            "sa_dssp": build(lambda c: _SA2I[c] >= 0),
            "ss_pred": build(lambda c: 0 <= _SS2I[c] <= 3 and c != ord("."),
                             ss2ss),
            "ss_conf": build(lambda c: c == ord("-")
                             or chr(c).isdigit()),
            "resid": build(lambda c: AA2I_TABLE[c] >= 0 and c != ord(".")),
        }
    return _SEQ_TABS


def _filter_seq_line(line: str, kind: str) -> str:
    table, delete = _seq_tabs()[kind]
    return (line.encode("latin-1").translate(table, delete)
            .decode("latin-1"))


def _parse_body_native(q: HMM, lines, li: int, L: int,
                       maxres: int) -> bool:
    """Parse the per-column records with the C++ hot loop
    (native/hhsuite_native.cpp:parse_hhm_body); the raw fixed-point
    ints are converted with the same vectorized numpy expressions as
    the pure-Python loop, so the resulting HMM is bit-identical.
    Returns False when the native module is unavailable."""
    from ..native import load as load_native

    nat = load_native()
    if nat is None or not hasattr(nat, "parse_hhm_body"):
        return False
    body = "\n".join(lines[li:])
    nrows, tr_b, f_b, l_b = nat.parse_hhm_body(
        body.encode("latin-1"), L, maxres)
    q.alloc(L)
    trneff = np.frombuffer(tr_b, dtype=np.int32).reshape(L + 1, 10)
    r = nrows + 1                       # rows 0..nrows carry parsed data
    q.tr[:r, :NTRANS] = (-trneff[:r, :NTRANS].astype(np.float32)
                         / HMMSCALE)
    neff = trneff[:r, NTRANS:].astype(np.float32) / HMMSCALE
    q.Neff_M[:r] = neff[:, 0]
    q.Neff_M[1:r][q.Neff_M[1:r] == 0] = 1
    q.Neff_I[:r] = neff[:, 1]
    q.Neff_D[:r] = neff[:, 2]
    if nrows:
        fv = np.frombuffer(f_b, dtype=np.int32).reshape(nrows, 20)
        vals = fm.fpow2(np.float32(-fv.astype(np.float32)) / HMMSCALE)
        q.f[np.arange(1, nrows + 1)[:, None], _S2A20[None, :]] = vals
        q.l[1: nrows + 1] = np.frombuffer(l_b, dtype=np.int32)
    return True


def read_hhm(text: str, pb_out: Optional[np.ndarray] = None,
             nseqdis: int = 10238, maxres: int = 20001) -> HMM:
    """Parse an HHM file (hhhmm.cpp:202-690)."""
    from ..core.alignment import _SS2I, _SA2I, _CF2I, ss2ss

    q = HMM()
    lines = text.splitlines()
    li = 0
    L = 0
    cols_f = None
    cols_tr = None
    neffs = None
    lcol = None

    def getline():
        nonlocal li
        if li >= len(lines):
            return None
        s = lines[li]
        li += 1
        return s

    pb_local = None
    while True:
        line = getline()
        if line is None or line.startswith("//"):
            break
        if not line.strip():
            continue
        if line.startswith("HH"):
            continue
        key4 = line[:4].strip()
        if key4 == "NAME":
            rest = line[4:].strip()
            q.longname = rest if rest else "undefined"
            q.name = (rest.split() or ["undefined"])[0]
        elif line.startswith("FAM"):
            q.fam = line[3:].strip()
        elif key4 == "FILE":
            q.file = line[4:].strip()
        elif key4 == "LENG":
            nums = [int(t) for t in line[4:].replace(",", " ").split()
                    if t.lstrip("-").isdigit()]
            L = nums[0]
        elif key4 in ("FILT", "NSEQ"):
            nums = [int(t) for t in line[4:].replace("(", " ").split()
                    if t.lstrip("-").isdigit()]
            if len(nums) >= 2:
                q.N_filtered, q.N_in = nums[0], nums[1]
            elif nums:
                q.N_filtered = q.N_in = nums[0]
        elif key4 == "NEFF" or line.startswith("NAA"):
            try:
                q.Neff_HMM = float(line[6:].split()[0])
            except (ValueError, IndexError):
                pass
        elif line.startswith("EVD"):
            t = line[6:].split()
            q.lamda, q.mu = float(t[0]), float(t[1])
        elif line.startswith("PCT"):
            q.has_pseudocounts = True
        elif key4 in ("DESC", "COM", "DATE") or line.startswith("COM") \
                or line.startswith("DATE"):
            continue
        elif line.startswith("SEQ"):
            names, seqs = [], []
            cur: List[str] = []
            specials = {}
            while True:
                line = getline()
                if line is None or line.startswith("#"):
                    break
                if line.startswith(">"):
                    if cur or names:
                        seqs.append("-" + "".join(cur))
                        cur = []
                    hdr = line[1:]
                    k = len(names)
                    if hdr.startswith("ss_dssp"):
                        q.nss_dssp = k
                    elif hdr.startswith("sa_dssp"):
                        q.nsa_dssp = k
                    elif hdr.startswith("ss_pred"):
                        q.nss_pred = k
                    elif hdr.startswith("ss_conf"):
                        q.nss_conf = k
                    elif hdr.startswith("Cons-") or hdr.startswith("Consensus"):
                        q.ncons = k
                    elif q.nfirst == -1:
                        q.nfirst = k
                    names.append(hdr.split()[0] if hdr.split() else hdr)
                else:
                    k = len(names) - 1
                    if k == q.nss_dssp:
                        cur.append(_filter_seq_line(line, "ss_dssp"))
                    elif k == q.nsa_dssp:
                        cur.append(_filter_seq_line(line, "sa_dssp"))
                    elif k == q.nss_pred:
                        cur.append(_filter_seq_line(line, "ss_pred"))
                    elif k == q.nss_conf:
                        cur.append(_filter_seq_line(line, "ss_conf"))
                    else:
                        cur.append(_filter_seq_line(line, "resid"))
            if names:
                seqs.append("-" + "".join(cur))
            q.sname = names
            q.seq = seqs
            q.n_seqs = len(names)
            q.n_display = len(names)
        elif line.startswith("NULL"):
            t = line[4:].split()
            pb_local = np.zeros(NAA, dtype=np.float32)
            vals = np.array([99999 if t[a] == "*" else int(t[a])
                             for a in range(20)], dtype=np.float64)
            pb_local[_S2A20] = fm.fpow2(
                (-vals / HMMSCALE).astype(np.float32))
            if pb_out is not None:
                pb_out[:] = pb_local
        elif line.startswith("HMM"):
            getline()  # transition header line
            if _parse_body_native(q, lines, li, L, maxres):
                break
            line = getline()
            t = line.split()
            q.alloc(L)
            idx = 0
            for a in range(NTRANS):
                v, idx = _strinta(t, idx)
                q.tr[0, a] = np.float32(-v) / HMMSCALE
            v, idx = _strinta(t, idx)
            q.Neff_M[0] = np.float32(v) / HMMSCALE
            v, idx = _strinta(t, idx)
            q.Neff_I[0] = np.float32(v) / HMMSCALE
            v, idx = _strinta(t, idx)
            q.Neff_D[0] = np.float32(v) / HMMSCALE
            i = 0
            f_rows: List[np.ndarray] = []
            f_idx: List[int] = []
            while True:
                line = getline()
                if line is None or line.startswith("//") \
                        or line.startswith("#"):
                    break
                if not line.strip():
                    continue
                t = line.split()
                i += 1
                if i > L or i > maxres - 2:
                    getline()
                    continue
                # t = [res, i, 20 values..., l]; emissions collected and
                # run through ONE vectorized fpow2 after the loop
                # (elementwise, so bit-identical to the scalar loop)
                vals = t[2:22]
                f_rows.append(np.array([99999 if v == "*" else int(v)
                                        for v in vals], dtype=np.int64))
                f_idx.append(i)
                q.l[i] = int(t[22]) if len(t) > 22 else i
                line = getline()
                t = line.split()
                idx = 0
                for a in range(NTRANS):
                    v, idx = _strinta(t, idx)
                    q.tr[i, a] = np.float32(-v) / HMMSCALE
                v, idx = _strinta(t, idx)
                q.Neff_M[i] = np.float32(v) / HMMSCALE
                if q.Neff_M[i] == 0:
                    q.Neff_M[i] = 1
                v, idx = _strinta(t, idx)
                q.Neff_I[i] = np.float32(v) / HMMSCALE
                v, idx = _strinta(t, idx)
                q.Neff_D[i] = np.float32(v) / HMMSCALE
            if f_rows:
                fv = fm.fpow2(np.float32(-np.stack(f_rows)) / HMMSCALE)
                q.f[np.asarray(f_idx)[:, None], _S2A20[None, :]] = fv
            break

    q.L = min(L, maxres - 2) if L else 0
    if pb_local is None:
        from ..matrices import get_substitution_matrix
        pb_local = get_substitution_matrix(0).pb
    q.f[0] = pb_local
    q.f[q.L + 1] = pb_local
    q.Neff_M[q.L + 1] = 1.0
    q.Neff_I[q.L + 1] = 0.0
    q.Neff_D[q.L + 1] = 0.0

    # extract SS state arrays from special display sequences
    for attr, nidx, tab in [("ss_dssp", q.nss_dssp, _SS2I),
                            ("sa_dssp", q.nsa_dssp, _SA2I),
                            ("ss_pred", q.nss_pred, _SS2I),
                            ("ss_conf", q.nss_conf, _CF2I)]:
        if nidx >= 0 and nidx < len(q.seq):
            s = q.seq[nidx][1:]
            arr = getattr(q, attr)
            codes = np.frombuffer(s.encode("latin-1"),
                                  dtype=np.uint8).astype(np.int64)
            m = min(len(codes), q.L)
            arr[1:m + 1] = tab[codes[:m]]
    return q


def read_hhm_file(path: str, **kw) -> HMM:
    with open(path) as f:
        return read_hhm(f.read(), **kw)
