"""Multiple sequence alignment: reading, match-state assignment, filtering.

Behavioral parity with the reference Alignment class (src/hhalignment.cpp):
A3M/A2M/FASTA reading (:181-545), match-state assignment ``compress``
(:822-1330), the greedy max-diversity identity filter ``filter2``
(:1598-1973), and display filtering (:1416-1465).  The data layout is
array-first: the MSA is a dense int8 matrix ``X[k][i]`` (residues 0-19,
ANY=20, GAP=21, ENDGAP=22) plus insert counts ``I[k][i]`` — the same
encoding the reference uses, which downstream profile math consumes as
batched tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_TRACE_FILTER = bool(os.environ.get("HHSUITE_TPU_TRACE_FILTER"))

from ..constants import (ANY, ENDGAP, GAP, NAA, PLTY_GAPEXTD, PLTY_GAPOPEN,
                         aa2i)

# ---------------------------------------------------------------------------
# char classification tables (vectorized aa2i / ss2i / sa2i / cf2i)
# ---------------------------------------------------------------------------

AA2I_TABLE = np.full(256, -2, dtype=np.int16)
for _c in range(256):
    try:
        AA2I_TABLE[_c] = aa2i(chr(_c))
    except ValueError:
        pass
for _c in range(33):
    AA2I_TABLE[_c] = -1

_SS2I = np.full(256, -2, dtype=np.int16)
for _ch, _v in [(".", 0), ("-", 0), ("X", 0), ("H", 1), ("E", 2), ("C", 3),
                ("~", 3), ("S", 4), ("T", 5), ("G", 6), ("B", 7), ("I", 3),
                (" ", -1), ("\t", -1), ("\n", -1)]:
    _SS2I[ord(_ch)] = _v
    if _ch.isalpha():
        _SS2I[ord(_ch.lower())] = _v

_SA2I = np.full(256, -2, dtype=np.int16)
for _ch, _v in [(".", 0), ("-", 0), ("A", 1), ("B", 2), ("C", 3), ("D", 4),
                ("E", 5), ("F", 6), (" ", -1), ("\t", -1), ("\n", -1)]:
    _SA2I[ord(_ch)] = _v
    if _ch.isalpha():
        _SA2I[ord(_ch.lower())] = _v

_CF2I = np.zeros(256, dtype=np.int16)
_CF2I[ord("-")] = 0
_CF2I[ord(".")] = 0
for _d in range(10):
    _CF2I[ord("0") + _d] = _d + 1

I2SS = "-HECSTGBI"
I2SA = "-ABCDEF"
I2CF = "-0123456789"


def ss2ss(c: str) -> str:
    """Normalize alternative DSSP symbols (hhutil-inl.h:215-240)."""
    if c == "~" or c == "I":
        return "C"
    if c == "i":
        return "c"
    if c in "HECSTGBhecstgb.":
        return c
    return "-"


def match_chr(c: str) -> str:
    return c.upper() if "a" <= c <= "z" else ("-" if c == "." else c)


def insert_chr(c: str) -> str:
    if "A" <= c <= "Z":
        return c.lower()
    if ("0" <= c <= "9") or c == "-":
        return "."
    return c


def qsort_int(v: np.ndarray, k: List[int], left: int, right: int, up: int):
    """Reference quicksort (util.cpp:247-274) — identical element order,
    including tie behavior, so greedy filters visit sequences identically.
    Dispatches to the C++ twin for large inputs (the permutation depends
    only on the partition scheme, which both implement verbatim)."""
    if right - left > 64:
        from ..native import load as _load_native

        nat = _load_native()
        if nat is not None and hasattr(nat, "qsort_int"):
            vv = np.ascontiguousarray(np.asarray(v, dtype=np.int32))
            kk = np.array(k, dtype=np.int32)
            out = nat.qsort_int(vv.tobytes(), kk.tobytes(),
                                int(left), int(right), int(up))
            k[:] = np.frombuffer(out, dtype=np.int32).tolist()
            return
    stack = [(left, right)]
    while stack:
        lo, hi = stack.pop()
        if lo >= hi:
            continue
        mid = (lo + hi) // 2
        k[lo], k[mid] = k[mid], k[lo]
        last = lo
        pivot = v[k[lo]]
        if up == 1:
            for i in range(lo + 1, hi + 1):
                if v[k[i]] < pivot:
                    last += 1
                    k[last], k[i] = k[i], k[last]
        else:
            for i in range(lo + 1, hi + 1):
                if v[k[i]] > pivot:
                    last += 1
                    k[last], k[i] = k[i], k[last]
        k[lo], k[last] = k[last], k[lo]
        stack.append((lo, last - 1))
        stack.append((last + 1, hi))


class Alignment:
    """An MSA with reference-compatible bookkeeping.

    ``seqs[k]`` holds the displayable text with a leading '-' placeholder so
    that index 1 is the first residue, as in the reference (seq[k][0] unused).
    """

    def __init__(self):
        self.names: List[str] = []
        self.seqs: List[str] = []
        self.keep: Optional[np.ndarray] = None
        self.display: Optional[np.ndarray] = None
        self.kss_dssp = self.ksa_dssp = -1
        self.kss_pred = self.kss_conf = -1
        self.kfirst = -1
        self.n_display = 0
        self.N_in = 0
        self.N_ss = 0
        self.N_filtered = 0
        self.L = 0
        self.X: Optional[np.ndarray] = None   # (N, L+2) int8
        self.I: Optional[np.ndarray] = None   # (N, L+1) int32
        self.l: Optional[np.ndarray] = None   # (L+1,) column index of match i
        self.wg: Optional[np.ndarray] = None  # (N,) float32 global weights
        self.nres: Optional[np.ndarray] = None
        self.first: Optional[np.ndarray] = None
        self.last: Optional[np.ndarray] = None
        self.ksort: Optional[List[int]] = None
        self.name = ""
        self.longname = ""
        self.fam = ""
        self.file = ""
        self.readCommentLine = False

    # ------------------------------------------------------------- read ----
    @classmethod
    def from_a3m_text(cls, text: str, infile: str = "", mark: int = 0,
                      maxseq: int = 65535, nseqdis: int = 1) -> "Alignment":
        """Parse A3M/A2M/FASTA text (hhalignment.cpp:181-545).

        Classifies special sequences (>ss_dssp/>sa_dssp/>ss_pred/>ss_conf,
        >ss_*/>sa_* annotations, skipped >aa_*), sets keep/display flags and
        extracts name/longname from '#' line or first sequence header.
        """
        self = cls()
        base = os.path.basename(infile)
        self.file = base.rsplit(".", 1)[0] if "." in base else base

        names: List[str] = []
        raw: List[List[str]] = []
        keep: List[int] = []
        display: List[int] = []
        skip_sequence = False
        k = -1

        for line in text.splitlines():
            if line.startswith(">"):
                if k >= maxseq - 1:
                    break
                skip_sequence = False
                hdr = line[1:].strip()
                if hdr.startswith("@"):
                    hdr = hdr[1:].strip()
                kk = k + 1  # tentative index of this sequence
                if line.startswith(">ss_dssp"):
                    if self.kss_dssp < 0:
                        d, ke = 2, 0
                        self.kss_dssp = kk
                        self.N_ss += 1
                        self.n_display += 1
                    else:
                        skip_sequence = True
                        continue
                elif line.startswith(">sa_dssp"):
                    if self.ksa_dssp < 0:
                        d, ke = 2, 0
                        self.ksa_dssp = kk
                        self.N_ss += 1
                        self.n_display += 1
                    else:
                        skip_sequence = True
                        continue
                elif line.startswith(">ss_pred"):
                    if self.kss_pred < 0:
                        d, ke = 2, 0
                        self.kss_pred = kk
                        self.N_ss += 1
                        self.n_display += 1
                    else:
                        skip_sequence = True
                        continue
                elif line.startswith(">ss_conf"):
                    if self.kss_conf < 0:
                        d, ke = 2, 0
                        self.kss_conf = kk
                        self.N_ss += 1
                        self.n_display += 1
                    else:
                        skip_sequence = True
                        continue
                elif line.startswith(">ss_") or line.startswith(">sa_"):
                    d, ke = 2, 0
                    self.N_ss += 1
                    self.n_display += 1
                elif line.startswith(">aa_"):
                    skip_sequence = True
                    continue
                elif self.kfirst < 0:
                    word = hdr.split()[0] if hdr.split() else ""
                    if "_consensus" in word:
                        d, ke = 2, 0
                    else:
                        d, ke = 2, 2
                    self.n_display += 1
                    self.kfirst = kk
                elif mark == 0:
                    d, ke = 1, 1
                    self.n_display += 1
                elif line[1:2] == "@" and self.n_display - self.N_ss < nseqdis:
                    d, ke = 2, 2
                    self.n_display += 1
                elif mark == 1:
                    d, ke = 1, 1
                    self.n_display += 1
                else:
                    d, ke = 0, 1
                k += 1
                names.append(hdr if hdr else f"no_name_{k}")
                raw.append([])
                keep.append(ke)
                display.append(d)
            elif line.startswith("#"):
                if self.name:
                    continue
                rest = line[1:].lstrip()
                self.longname = rest[:32764]
                self.name = rest.split()[0][:511] if rest.split() else ""
                self.readCommentLine = True
            elif not skip_sequence:
                if k == -1:
                    continue
                # filter valid chars for this sequence class
                if keep[k] or k == self.kfirst:
                    tab = AA2I_TABLE
                    chars = [c for c in line if tab[ord(c) & 0xFF] >= 0]
                elif k == self.kss_dssp:
                    chars = [ss2ss(c) for c in line
                             if 0 <= _SS2I[ord(c) & 0xFF] <= 7]
                elif k == self.ksa_dssp:
                    chars = [c for c in line if _SA2I[ord(c) & 0xFF] >= 0]
                elif k == self.kss_pred:
                    chars = [ss2ss(c) for c in line
                             if 0 <= _SS2I[ord(c) & 0xFF] <= 3]
                elif k == self.kss_conf:
                    chars = [c for c in line
                             if c in "-." or c.isdigit()]
                elif display[k]:
                    chars = [c for c in line
                             if c in "-.AB" or c.isdigit()]
                else:
                    chars = []
                raw[k].extend(chars)

        if k < 0:
            raise ValueError(f"No sequences found in file {infile}")
        self.N_in = k + 1
        self.names = names
        self.seqs = ["-" + "".join(r) for r in raw]
        self.keep = np.array(keep, dtype=np.int8)
        self.display = np.array(display, dtype=np.int8)

        if self.kfirst < 0 or (self.N_in - self.N_ss
                               - (1 if keep[self.kfirst] == 0 else 0)) == 0:
            raise ValueError(f"MSA file {infile} contains no master sequence")

        if not self.name:
            self.longname = names[self.kfirst][:32764]
            self.name = (names[self.kfirst].split() or [""])[0][:511]
            nm = self.name
            parts = names[self.kfirst].split()
            if (len(parts) >= 2 and len(parts[1]) >= 3 and parts[1][0].islower()
                    and parts[1][1] == "." and parts[1][2].isdigit()):
                self.name = nm.lower()
                self.fam = parts[1]
            elif (nm.startswith("PF") and len(nm) >= 4 and nm[2].isdigit()
                  and nm[3].isdigit()):
                self.fam = nm
        return self

    @classmethod
    def from_file(cls, path: str, **kw) -> "Alignment":
        with open(path) as f:
            return cls.from_a3m_text(f.read(), infile=path, **kw)

    # --------------------------------------------------------- compress ----
    def compress(self, M: int = 1, Mgaps: int = 50, maxres: int = 20001,
                 infile: str = ""):
        """Match-state assignment -> X, I arrays (hhalignment.cpp:822-1330).

        M=1: a2m/a3m uppercase/'-' match, lowercase insert, '.' ignored.
        M=2: columns with < Mgaps% (weighted) gaps become match states.
        M=3: residues of the first sequence define match states.
        """
        N = self.N_in
        # single sequence with few match states -> switch to -M first
        if M == 1:
            s = self.seqs[self.kfirst][1:]
            match_states = sum(1 for c in s if ("A" <= c <= "Z") or c == "-")
            if match_states < 6 and self.N_in - self.N_ss <= 1:
                M = 3

        if M == 1:
            self._compress_m1(maxres, infile)
        elif M == 2:
            self._compress_m2(Mgaps, maxres)
        elif M == 3:
            self._compress_m3(maxres)
        else:
            raise ValueError(f"bad match-state assignment mode {M}")

        if self.L <= 0:
            raise ValueError(
                f"Alignment {infile} contains no match states; consider -M first")

    def _endgap_rewrite(self):
        """Leading/trailing GAP -> ENDGAP for kept sequences (:978-986)."""
        X = self.X
        L = self.L
        body = X[:, 1:L + 1]
        isgap = body == GAP
        notgap = ~isgap
        lead = np.cumsum(notgap, axis=1) == 0     # before first non-gap
        trail = (np.cumsum(notgap[:, ::-1], axis=1) == 0)[:, ::-1]
        m = (isgap & (lead | trail)) & (self.keep[:, None] > 0)
        body[m] = ENDGAP

    def _compress_m1(self, maxres: int, infile: str):
        N = self.N_in
        # remove '.' from all seqs
        self.seqs = [s.replace(".", "") for s in self.seqs]
        cols = {}
        for k in range(N):
            s = self.seqs[k][1:]
            if not (self.keep[k] or k in (self.kfirst, self.kss_dssp,
                                          self.kss_pred, self.ksa_dssp,
                                          self.kss_conf)):
                continue
            arr = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
            is_low = (arr >= ord("a")) & (arr <= ord("z"))
            cols[k] = (arr, is_low, int((~is_low).sum()))
        # reference tracks L = imin over match-state counts and errors on
        # mismatch (hhalignment.cpp:968-1046)
        L = min((c[2] for c in cols.values()), default=0)
        L = min(L, maxres - 2)
        self.L = L
        if any(min(c[2], maxres - 2) != L for c in cols.values()):
            raise ValueError(
                f"sequences in {infile} do not all have the same number of "
                f"match states (A3M format error)")

        X = np.full((N, L + 2), GAP, dtype=np.int8)
        X[:, 0] = ANY
        I = np.zeros((N, L + 1), dtype=np.int32)
        # persistent-X semantics (hhalignment.cpp:929-932 `if (keep[k])`):
        # the reference never clears X rows of filtered-out sequences, so
        # a later Filter2/FilterForDisplay still sees their residues
        # (nres, ksort tie order).  Carry the old rows over.
        if self.X is not None:
            ncopy = min(self.X.shape[0], N)
            wcopy = min(self.X.shape[1], L + 2)
            rows = [k for k in range(ncopy) if k not in cols]
            if rows:
                X[rows, :wcopy] = self.X[rows, :wcopy]
                wI = min(self.I.shape[1], L + 1)
                I[rows, :wI] = self.I[rows, :wI]
        for k, (arr, is_low, nmatch) in cols.items():
            mpos = np.nonzero(~is_low)[0]
            codes = arr[mpos].astype(np.int64)
            if self.keep[k] or k == self.kfirst:
                X[k, 1:L + 1] = AA2I_TABLE[codes[:L]].astype(np.int8)
                # I[k][i] = number of lowercase inserts between match i and
                # i+1 (I[k][0]: before the first match state)
                cl = np.concatenate([[0], np.cumsum(is_low)])
                before = cl[mpos]  # lowercase count before each match col
                counts = np.diff(np.concatenate([[0], before,
                                                 [is_low.sum()]]))
                I[k, 0:L + 1] = counts[0:L + 1]
            elif k == self.kss_dssp or k == self.kss_pred:
                X[k, 1:L + 1] = _SS2I[codes[:L]].astype(np.int8)
            elif k == self.ksa_dssp:
                X[k, 1:L + 1] = _SA2I[codes[:L]].astype(np.int8)
            elif k == self.kss_conf:
                X[k, 1:L + 1] = _CF2I[codes[:L]].astype(np.int8)
        self.X = X
        self.I = I
        self._endgap_rewrite()
        self.l = np.arange(L + 1, dtype=np.int32)

    def _compress_m2(self, Mgaps: int, maxres: int):
        N = self.N_in
        Lfull = len(self.seqs[self.kfirst]) - 1
        codes = np.full((N, Lfull + 1), GAP, dtype=np.int16)
        for k in range(N):
            if not (self.keep[k] or k in (self.kss_dssp, self.kss_pred,
                                          self.ksa_dssp, self.kss_conf)):
                continue
            s = self.seqs[k][1:]
            if len(s) != Lfull:
                raise ValueError("sequences do not all have the same length")
            arr = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
            codes[k, 1:] = AA2I_TABLE[arr.astype(np.int64)]
        keepm = self.keep > 0
        Xf = codes
        self.nres = np.zeros(N, dtype=np.int32)
        self.nres[keepm] = (Xf[keepm, 1:] < NAA).sum(axis=1)
        # quick per-seq weights (hhalignment.cpp:1039-1062)
        wg = np.full(N, 0.0, dtype=np.float32)
        Xk = Xf[:, 1:]
        for li in range(Lfull):
            col = Xk[keepm, li]
            nl = np.bincount(col[col < 20], minlength=20)
            naa = int((nl > 0).sum()) or 1
            valid = keepm & (Xf[:, li + 1] < 20)
            denom = (nl[Xf[valid, li + 1]] * naa
                     * (self.nres[valid] + 30.0)).astype(np.float64)
            contrib = np.zeros(N)
            contrib[valid] = 1.0 / denom
            wg = (wg.astype(np.float64) + contrib).astype(np.float32)
        self.wg = wg
        # endgap rewrite on full-length matrix
        body = Xf[:, 1:]
        isgap = body == GAP
        notgap = ~isgap
        lead = np.cumsum(notgap, axis=1) == 0
        trail = (np.cumsum(notgap[:, ::-1], axis=1) == 0)[:, ::-1]
        body[(isgap & (lead | trail)) & keepm[:, None]] = ENDGAP
        # weighted gap percentage per column
        res = np.where((body < GAP) & keepm[:, None], wg[:, None], 0).sum(0)
        gap = np.where((body == GAP) & keepm[:, None], wg[:, None], 0).sum(0)
        percent = 100.0 * gap / (res + gap)
        is_match = percent <= float(Mgaps)
        self._project_match_columns(Xf, is_match, maxres, aa_codes=True)

    def _compress_m3(self, maxres: int):
        N = self.N_in
        Lfull = len(self.seqs[0]) - 1
        for k in range(1, N):
            if len(self.seqs[k]) - 1 != Lfull:
                raise ValueError("sequences do not all have the same length")
        firstseq = self.seqs[self.kfirst][1:]
        is_match = np.array([c.isalpha() for c in firstseq], dtype=bool)
        codes = np.full((N, Lfull + 1), GAP, dtype=np.int16)
        for k in range(N):
            s = self.seqs[k][1:]
            arr = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
            codes[k, 1:] = AA2I_TABLE[arr.astype(np.int64)]
        self._project_match_columns(codes, is_match, maxres, aa_codes=True)
        self._endgap_rewrite()

    def _project_match_columns(self, codes, is_match, maxres, aa_codes):
        """Shared tail of M=2/3: keep match columns, fold others into I."""
        N = self.N_in
        mcols = np.nonzero(is_match)[0]
        if len(mcols) > maxres - 2:
            mcols = mcols[: maxres - 2]
        L = len(mcols)
        X = np.full((N, L + 2), GAP, dtype=np.int8)
        X[:, 0] = ANY
        I = np.zeros((N, L + 1), dtype=np.int32)
        newseqs = list(self.seqs)
        for k in range(N):
            s = self.seqs[k][1:]
            if self.keep[k]:
                X[k, 1:L + 1] = codes[k, 1:][mcols].astype(np.int8)
                ins = (~is_match) & (codes[k, 1:] < GAP)
                # count inserts between consecutive match columns
                seg = np.searchsorted(mcols, np.nonzero(ins)[0], side="left")
                I[k, :] = np.bincount(seg, minlength=L + 1)[: L + 1]
                out = []
                for li, c in enumerate(s):
                    if is_match[li]:
                        out.append(match_chr(c))
                    elif codes[k, li + 1] < GAP:
                        out.append(insert_chr(c))
                newseqs[k] = "-" + "".join(out)
            elif k in (self.kss_dssp, self.kss_pred):
                X[k, 1:L + 1] = _SS2I[
                    np.frombuffer(s.encode("latin-1"),
                                  dtype=np.uint8).astype(np.int64)][mcols]
                newseqs[k] = "-" + "".join(match_chr(s[li]) for li in mcols)
            elif k == self.ksa_dssp:
                X[k, 1:L + 1] = _SA2I[
                    np.frombuffer(s.encode("latin-1"),
                                  dtype=np.uint8).astype(np.int64)][mcols]
                newseqs[k] = "-" + "".join(match_chr(s[li]) for li in mcols)
            elif k == self.kss_conf:
                X[k, 1:L + 1] = _CF2I[
                    np.frombuffer(s.encode("latin-1"),
                                  dtype=np.uint8).astype(np.int64)][mcols]
                newseqs[k] = "-" + "".join(s[li] for li in mcols)
        self.seqs = newseqs
        self.X = X
        self.I = I
        self.L = L
        self.l = np.zeros(L + 1, dtype=np.int32)
        self.l[1:] = mcols + 1

    # ----------------------------------------------------------- filter ----
    def _first_last_nres(self):
        if self.first is not None:
            return
        L = self.L
        body = self.X[:, 1:L + 1]
        isres = body < NAA
        any_res = isres.any(axis=1)
        first = np.where(any_res, isres.argmax(axis=1) + 1, L + 1)
        lastr = np.where(any_res,
                         L - isres[:, ::-1].argmax(axis=1), L)
        # reference: if no residue, first=L+1, last=0
        lastr = np.where(any_res, lastr, 0)
        self.first = first.astype(np.int32)
        self.last = lastr.astype(np.int32)
        if self.nres is None or len(self.nres) != self.N_in:
            nres = isres.sum(axis=1).astype(np.int32)
            self.nres = nres
            self.keep[nres == 0] = 0
        if self.ksort is None:
            self.ksort = list(range(self.N_in))
            qsort_int(self.nres, self.ksort, self.kfirst + 1,
                      self.N_in - 1, -1)

    def filter_for_display(self, max_seqid, mark, S, coverage, qid, qsc,
                           nseqdis):
        """hhalignment.cpp:1416-1465."""
        if mark:
            return self.n_display
        display = self.display
        for kk in (self.kss_dssp, self.ksa_dssp, self.kss_pred, self.kss_conf):
            if kk >= 0:
                display[kk] = 0
        n_display = 0
        seqid = min(10, max_seqid)
        dummy = display.copy()
        if np.count_nonzero(dummy[: self.N_in]) < nseqdis:
            # the seqid relaxation loop can never reach nseqdis (the
            # display-eligible count bounds every filter2 result), so
            # it provably runs to completion and keeps the final
            # filter2(seqid=max_seqid) — run only that one (hhmake on
            # small MSAs otherwise pays ~80 no-op filter passes)
            n_display = self.filter2(dummy, coverage, qid, qsc, 20,
                                     max_seqid, 0, S)
        else:
            while n_display < nseqdis and seqid <= max_seqid:
                dummy = display.copy()
                n_display = self.filter2(dummy, coverage, qid, qsc, 20,
                                         seqid, 0, S)
                seqid += 1
        if n_display > nseqdis:
            # reference backs off two steps from the post-loop seqid
            dummy = display.copy()
            n_display = self.filter2(dummy, coverage, qid, qsc, 20,
                                     seqid - 2, 0, S)
        self.display = dummy
        for kk in (self.kss_dssp, self.ksa_dssp, self.kss_pred, self.kss_conf):
            if kk >= 0:
                self.display[kk] = 1
                n_display += 1
        self.n_display = n_display
        return n_display

    def filter(self, max_seqid, S, coverage, qid, qsc, Ndiff):
        self.N_filtered = self.filter2(self.keep, coverage, qid, qsc, 20,
                                       max_seqid, Ndiff, S)
        return self.N_filtered

    def filter_neff(self, use_global_weights, mark, cons, showcons,
                    max_seqid, coverage, Neff, pb, S, Sim):
        """Alignment::FilterNeff (hhalignment.cpp:1973-2028): shrink the
        alignment's diversity to a target Neff by searching a -qsc
        threshold with mixed bisection / linear interpolation."""
        from .hmm import HMM
        from .profile import frequencies_and_transitions

        TOLX = 0.01
        TOLY = 0.02
        keep_orig = self.keep.copy()

        def neff_of_current():
            q = HMM()
            frequencies_and_transitions(self, q, use_global_weights,
                                        mark, cons, showcons, pb, Sim)
            return q.Neff_HMM

        def filter_by_qsc(x):
            self.keep[:] = keep_orig
            self.filter2(self.keep, coverage, 0, x, max_seqid + 1,
                         max_seqid, 0, S)
            return neff_of_current()

        x0, x1 = -1.0, 4.0
        x = 0.0
        y = y0 = neff_of_current()
        if abs(Neff - y0) < TOLY or y0 < Neff:
            return
        y1 = filter_by_qsc(x1)
        if abs(Neff - y1) < TOLY:
            return
        while True:
            if y1 == y0:
                return
            w = 0.5
            x = (w * 0.5 * (x0 + x1)
                 + (1 - w) * (x0 + (Neff - y0) * (x1 - x0) / (y1 - y0)))
            y = filter_by_qsc(x)
            if y > Neff:
                x0, y0 = x, y
            else:
                x1, y1 = x, y
            if not (abs(Neff - y) > TOLY and x1 - x0 > TOLX):
                break

    def filter2(self, keep, coverage, qid, qsc, seqid1, seqid2, Ndiff, S):
        """Greedy max-diversity filter (hhalignment.cpp:1598-1963).

        Mutates ``keep`` in place; returns number of accepted sequences.
        """
        N_in = self.N_in
        L = self.L
        X = self.X[:, : L + 2]
        self._first_last_nres()
        first, last, nres = self.first, self.last, self.nres
        ksort = self.ksort
        WFIL = 25

        if _TRACE_FILTER:
            import sys as _sys
            print(f"F2BEGIN\t{N_in}\t{L}\t{coverage}\t{qid}\t{seqid1}"
                  f"\t{seqid2}\t{Ndiff}", file=_sys.stderr)
            print("F2KEEP" + "".join(str(int(x)) for x in
                                     np.asarray(keep)[:N_in]),
                  file=_sys.stderr)

        if _TRACE_FILTER:
            import sys as _sys
            print("F2KSORT " + " ".join(f"{k}:{int(nres[k])}"
                                        for k in ksort), file=_sys.stderr)

        in_ = np.zeros(N_in, dtype=np.int8)
        n = 0
        for k in range(N_in):
            if keep[k] == 2:
                in_[k] = 2
                n += 1
        inkk = np.array([in_[ksort[kk]] for kk in range(N_in)], dtype=np.int8)

        Npos = np.zeros(L + 2, dtype=np.int32)
        kf = self.kfirst
        Npos[first[kf]: last[kf] + 1] = 1
        Nmax = np.zeros(L + 2, dtype=np.int32)
        idmaxwin = np.full(L + 2, -1, dtype=np.int32)
        seqid_prev = np.full(N_in, -1, dtype=np.int32)
        diffNmax = Ndiff
        qdiff_max_frac = 0.9999 - 0.01 * qid

        if Ndiff <= 0 or Ndiff >= N_in:
            seqid1 = seqid2
            Ndiff = N_in
            diffNmax = Ndiff

        body = X[:, 1: L + 1]
        isaa = body < 20

        # coverage / qsc / qid rejection (hhalignment.cpp:1705-1770)
        for k in range(N_in):
            if keep[k] == 0 or keep[k] == 2:
                continue
            if 100 * nres[k] < coverage * L:
                keep[k] = 0
                continue
            if qsc > -10:
                qsc_min = qsc * nres[k]
                qsc_sum = self._qsc_sum(k, S)
                if qsc_sum < qsc_min:
                    keep[k] = 0
                    continue
            if qdiff_max_frac < 0.999:
                qdiff_max = int(qdiff_max_frac * nres[k] + 0.9999)
                sl = slice(first[k] - 1, last[k])
                diff = int((isaa[k, sl]
                            & (body[k, sl] != body[kf, sl])).sum())
                if diff >= qdiff_max:
                    keep[k] = 0
                    continue

        nn = int((np.asarray(keep) > 0).sum())
        if nn == 0:
            for k in range(N_in):
                if self.display[k] != 2:
                    keep[k] = 1
                    break

        if seqid1 > seqid2:
            return nn

        # accepted-set arrays for the vectorized pairwise check: row m
        # holds the m-th sequence that entered the comparison set (in
        # ksort order), plus an isaa cumsum row for windowed coverage
        acc_rows = np.empty(N_in, dtype=np.int64)
        acc_body = np.empty((N_in, L), dtype=body.dtype)
        acc_isaa = np.empty((N_in, L), dtype=bool)
        acc_cum = np.empty((N_in, L + 1), dtype=np.int32)
        acc_first = np.empty(N_in, dtype=np.int32)
        acc_last = np.empty(N_in, dtype=np.int32)

        seqid = seqid1
        seqid_step = 0
        diffNmax_prev = 0
        while seqid <= seqid2:
            stop = True
            diffNmax_prev = diffNmax
            diffNmax = 0
            # windowed max of N (hhalignment.cpp:1816-1831)
            for i in range(1, L + 1):
                j0 = max(1, min(L - 2 * WFIL + 1, i - WFIL))
                j1 = min(L, max(2 * WFIL, i + WFIL))
                mx = int(Npos[j0: j1 + 1].max()) if j1 >= j0 else 0
                if Nmax[i] < mx:
                    Nmax[i] = mx
                if Nmax[i] < Ndiff:
                    stop = False
                    idmaxwin[i] = seqid
                    if diffNmax < Ndiff - Nmax[i]:
                        diffNmax = Ndiff - Nmax[i]
            if stop:
                break

            # the comparison set for candidate kk is every jj < kk with
            # inkk[jj] != 0; it is rebuilt incrementally per seqid round
            m = 0

            def _acc_add(j):
                nonlocal m
                acc_rows[m] = j
                acc_body[m] = body[j]
                acc_isaa[m] = isaa[j]
                acc_cum[m, 0] = 0
                np.cumsum(isaa[j].astype(np.int32), out=acc_cum[m, 1:])
                acc_first[m] = first[j]
                acc_last[m] = last[j]
                m += 1

            for kk in range(N_in):
                if inkk[kk]:
                    _acc_add(ksort[kk])
                    continue
                k = ksort[kk]
                if not keep[k]:
                    continue
                if keep[k] == 2:
                    inkk[kk] = 2
                    _acc_add(k)
                    continue
                if seqid >= 100:
                    in_[k] = inkk[kk] = 1
                    n += 1
                    _acc_add(k)
                    continue
                seqidk = float(seqid1)
                sl = idmaxwin[first[k]: last[k] + 1]
                if sl.size:
                    seqidk = max(seqidk, float(sl.max()))
                if seqid == seqid_prev[k]:
                    continue
                seqid_prev[k] = seqid
                diff_min_frac = 0.9999 - 0.01 * seqidk

                # vectorized over the accepted set: same quantities as
                # the reference's jj loop (hhalignment.cpp:1848-1928) —
                # diff_suff from the window SPAN (int() truncation),
                # cov_kj recounted as both-residue columns inside the
                # window, diffv over the whole row
                rejected = False
                if m:
                    fk, lk = int(first[k]), int(last[k])
                    fj = np.maximum(fk, acc_first[:m])
                    lj = np.minimum(lk, acc_last[:m])
                    span = lj - fj + 1
                    diff_suff = np.trunc(
                        diff_min_frac * np.minimum(int(nres[k]), span)
                        + 0.999)
                    isaa_k = isaa[k]
                    hi = np.maximum(lj, fj - 1)
                    rows_m = np.arange(m)
                    term1 = (acc_cum[rows_m, hi]
                             - acc_cum[rows_m, fj - 1])
                    gpos = np.nonzero(~isaa_k)[0]
                    if gpos.size:
                        inw = ((gpos[None, :] >= (fj - 1)[:, None])
                               & (gpos[None, :] < lj[:, None]))
                        term2 = (acc_isaa[:m][:, gpos] & inw).sum(axis=1)
                        cov = term1 - term2
                    else:
                        cov = term1
                    diffv = ((acc_body[:m] != body[k])
                             & acc_isaa[:m] & isaa_k).sum(axis=1)
                    rejmask = ((diffv < diff_suff)
                               & (diffv < diff_min_frac * cov))
                    rejected = bool(np.any(rejmask))
                    if _TRACE_FILTER and rejected:
                        ridx = int(np.nonzero(rejmask)[0][0])
                        import sys as _sys
                        print(f"F2REJ\t{seqid}\t{k}\t"
                              f"{int(acc_rows[ridx])}\t{int(diffv[ridx])}"
                              f"\t{int(diff_suff[ridx])}\t{int(cov[ridx])}"
                              f"\t{diff_min_frac:.6f}", file=_sys.stderr)
                if _TRACE_FILTER:
                    import sys as _sys
                    print(f"F2DEC\t{seqid}\t{kk}\t{k}\t{int(not rejected)}",
                          file=_sys.stderr)
                if not rejected:
                    in_[k] = inkk[kk] = 1
                    n += 1
                    Npos[first[k]: last[k] + 1] += 1
                    _acc_add(k)

            seqid_step = max(1, min(5, diffNmax
                                    // (diffNmax_prev - diffNmax + 1)
                                    * seqid_step // 2))
            seqid += seqid_step

        keep[:] = in_
        return n

    def _qsc_sum(self, k: int, S) -> float:
        """Score-per-column sum with query (hhalignment.cpp:1718-1747)."""
        kf = self.kfirst
        first, last = self.first, self.last
        body = self.X[:, 1: self.L + 1]
        qsc_sum = 0.0
        gapq = gapk = 0
        for i in range(first[k], last[k] + 1):
            xk = body[k, i - 1]
            xq = body[kf, i - 1]
            if xk < 20:
                gapk = 0
                if xq < 20:
                    gapq = 0
                    qsc_sum += float(S[xq, xk])
                elif xq == ANY:
                    continue
                else:
                    qsc_sum -= PLTY_GAPEXTD if gapq else PLTY_GAPOPEN
                    gapq += 1
            elif xk == ANY:
                continue
            elif xq < 20:
                gapq = 0
                qsc_sum -= PLTY_GAPEXTD if gapk else PLTY_GAPOPEN
                gapk += 1
        return qsc_sum
