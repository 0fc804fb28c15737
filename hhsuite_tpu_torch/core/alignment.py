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

# the kinds of record from_a3m_text reads, and the characters each keeps
# (hhalignment.cpp:400-480), by code point & 0xFF; ss2ss's output by code
# point for the SS rows
(_REC_NONE, _REC_AA, _REC_SS_DSSP, _REC_SA, _REC_SS_PRED, _REC_CONF,
 _REC_DISPLAY) = range(7)
_REC_KEEPS = np.zeros((7, 256), dtype=bool)
_REC_KEEPS[_REC_AA] = AA2I_TABLE >= 0
_REC_KEEPS[_REC_SS_DSSP] = (_SS2I >= 0) & (_SS2I <= 7)
_REC_KEEPS[_REC_SA] = _SA2I >= 0
_REC_KEEPS[_REC_SS_PRED] = (_SS2I >= 0) & (_SS2I <= 3)
for _c in b"-.0123456789":
    _REC_KEEPS[_REC_CONF, _c] = _REC_KEEPS[_REC_DISPLAY, _c] = True
_REC_KEEPS[_REC_DISPLAY, [ord("A"), ord("B")]] = True

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


# the codes of an a3m's match states (-M a3m): residues, SS states, SA
# states, SS confidences
_M1_CODES = np.stack([AA2I_TABLE, _SS2I, _SA2I, _CF2I]).astype(np.int8)

# ss2ss, match_chr, insert_chr and str.isalpha as tables over the latin-1
# characters
_SS2SS = np.array([ord(ss2ss(chr(c))) for c in range(256)], dtype=np.uint32)
_MATCH_CHR = np.array([ord(match_chr(chr(c))) for c in range(256)],
                      dtype=np.uint8)
_INSERT_CHR = np.array([ord(insert_chr(chr(c))) for c in range(256)],
                       dtype=np.uint8)
_ISALPHA = np.array([chr(c).isalpha() for c in range(256)], dtype=bool)


# what each kind of record writes for a kept character: ss2ss's letter in
# the SS rows, the character elsewhere (by code point & 0xFF: characters
# past 0xFF are the SS rows' '-' and themselves elsewhere)
_REC_SS = np.zeros(7, dtype=bool)
_REC_SS[[_REC_SS_DSSP, _REC_SS_PRED]] = True
_REC_OUT = np.where(_REC_SS[:, None], _SS2SS[None, :],
                    np.arange(256, dtype=np.uint32)[None, :]).astype("<u4")


def _codepoints(s: str) -> np.ndarray:
    """The code points of ``s``, one uint32 a character."""
    return np.frombuffer(s.encode("utf-32-le", "surrogatepass"), dtype="<u4")


def _latin1(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def _filter_records(texts: List[str], kinds: np.ndarray) -> List[str]:
    """The characters of each record's text that its kind keeps
    (``_REC_*``), the SS rows' through ss2ss: one code-point array for
    all records, looked up by code point & 0xFF like the reference's
    char tables; the digits of the SS confidence and display rows are
    str.isdigit's."""
    cp = _codepoints("".join(texts))
    rec = np.repeat(np.arange(len(texts)),
                    np.fromiter(map(len, texts), np.int64, len(texts)))
    kind = kinds[rec]
    low = cp & 0xFF
    keep = _REC_KEEPS[kind, low]
    out = _REC_OUT[kind, low]
    if cp.max(initial=0) >= 128:
        wide = cp >= 128
        digits = wide & ((kind == _REC_CONF) | (kind == _REC_DISPLAY))
        keep[digits] = [chr(c).isdigit() for c in cp[digits].tolist()]
        big = cp >= 256
        out[big] = np.where(_REC_SS[kind[big]], ord("-"), cp[big])
    kept = out[keep].tobytes().decode("utf-32-le", "surrogatepass")
    ends = np.cumsum(np.bincount(rec[keep], minlength=len(texts))).tolist()
    return [kept[a:b] for a, b in zip([0] + ends[:-1], ends)]


def filter_windows(L: int, wfil: int):
    """The windows [j0, j1] of filter2's windowed max of N for columns
    i = 1..L (hhalignment.cpp:1816-1831): [i - wfil, i + wfil] clamped to
    lie inside 1..L, 2 * wfil columns wide at the ends."""
    i = np.arange(1, L + 1)
    j0 = np.maximum(1, np.minimum(L - 2 * wfil + 1, i - wfil))
    j1 = np.minimum(L, np.maximum(2 * wfil, i + wfil))
    return j0, j1


def window_max(v: np.ndarray, j0: np.ndarray, j1: np.ndarray) -> np.ndarray:
    """The max of v[j0 - 1 .. j1 - 1] for each window: the larger of two
    power-of-two blocks that cover it (a sparse table's lookup), the
    blocks as wide as the narrowest window allows."""
    w = int((j1 - j0).min()) + 1
    p, span = v, 1
    while 2 * span <= w:                  # p[i]: max of v[i : i + span]
        p = np.maximum(p[:-span], p[span:])
        span *= 2
    return np.maximum(p[j0 - 1], p[j1 - span])


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
        raw: List[List[str]] = []     # a record's sequence lines
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
            elif not skip_sequence and k >= 0:
                raw[k].append(line)

        if k < 0:
            raise ValueError(f"No sequences found in file {infile}")
        self.N_in = k + 1
        self.names = names
        # the characters valid for each record's class
        kinds = np.full(self.N_in, _REC_NONE, dtype=np.int8)
        kinds[np.array(display, dtype=bool)] = _REC_DISPLAY
        for kk, kind in ((self.kss_conf, _REC_CONF),
                         (self.kss_pred, _REC_SS_PRED),
                         (self.ksa_dssp, _REC_SA),
                         (self.kss_dssp, _REC_SS_DSSP)):
            if kk >= 0:
                kinds[kk] = kind
        kinds[np.array(keep, dtype=bool)] = _REC_AA
        if self.kfirst >= 0:
            kinds[self.kfirst] = _REC_AA
        self.seqs = ["-" + s for s in
                     _filter_records(["".join(r) for r in raw], kinds)]
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
            cp = _codepoints(self.seqs[self.kfirst][1:])
            match_states = int(np.count_nonzero(
                ((cp >= ord("A")) & (cp <= ord("Z"))) | (cp == ord("-"))))
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
        L = self.L
        body = self.X[:, 1:L + 1]
        notgap = body != GAP
        # a row's first and last non-gap column (none: every column leads)
        first = np.where(notgap.any(axis=1), notgap.argmax(axis=1), L)
        last = L - 1 - notgap[:, ::-1].argmax(axis=1)
        col = np.arange(L)
        m = ~notgap & ((col < first[:, None]) | (col > last[:, None]))
        body[m & (self.keep[:, None] > 0)] = ENDGAP

    def _compress_m1(self, maxres: int, infile: str):
        N = self.N_in
        # remove '.' from all seqs
        self.seqs = [s.replace(".", "") for s in self.seqs]
        # the rows that get match states, and the table of each one's codes
        tabs = []
        for k in range(N):
            if self.keep[k] or k == self.kfirst:
                tabs.append((k, 0))
            elif k in (self.kss_dssp, self.kss_pred):
                tabs.append((k, 1))
            elif k == self.ksa_dssp:
                tabs.append((k, 2))
            elif k == self.kss_conf:
                tabs.append((k, 3))
        rows = np.array([k for k, _t in tabs], dtype=np.int64)
        texts = [self.seqs[k][1:] for k, _t in tabs]
        b = _latin1("".join(texts))
        rec = np.repeat(np.arange(len(tabs)),
                        np.fromiter(map(len, texts), np.int64, len(tabs)))
        is_low = (b >= ord("a")) & (b <= ord("z"))
        nmatch = np.bincount(rec[~is_low], minlength=len(tabs))
        # reference tracks L = imin over match-state counts and errors on
        # mismatch (hhalignment.cpp:968-1046)
        L = min(int(nmatch.min()), maxres - 2)
        self.L = L
        if np.any(np.minimum(nmatch, maxres - 2) != L):
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
            old = np.setdiff1d(np.arange(ncopy), rows)
            if old.size:
                X[old, :wcopy] = self.X[old, :wcopy]
                wI = min(self.I.shape[1], L + 1)
                I[old, :wI] = self.I[old, :wI]
        # j: the matches before each character in its row, so match j + 1
        # for an uppercase one and insert slot j for a lowercase one
        before = np.cumsum(~is_low) - (~is_low)
        j = before - np.concatenate(([0], np.cumsum(nmatch)[:-1]))[rec]
        tab = np.array([t for _k, t in tabs], dtype=np.int64)[rec]
        m = ~is_low & (j < L)
        X[rows[rec[m]], 1 + j[m]] = _M1_CODES[tab[m], b[m]]
        # I[k][i] = number of lowercase inserts between match i and i+1
        # (I[k][0]: before the first match state), residue rows only
        ins = is_low & (tab == 0) & (j <= L)
        np.add.at(I, (rows[rec[ins]], j[ins]), 1)
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
            codes[k, 1:] = AA2I_TABLE[_latin1(s)]
        keepm = self.keep > 0
        Xf = codes
        self.nres = np.zeros(N, dtype=np.int32)
        self.nres[keepm] = (Xf[keepm, 1:] < NAA).sum(axis=1)
        # quick per-seq weights (hhalignment.cpp:1039-1062): wg[k] +=
        # 1 / (nl * naa * (nres + 30)) column by column, each sum rounded
        # to float32 from a double addend (no whole-array accumulate
        # rounds so), so only that sum runs a column at a time
        Xk = Xf[:, 1:].astype(np.int64)
        res = keepm[:, None] & (Xk >= 0) & (Xk < 20)
        cols = np.broadcast_to(np.arange(Lfull), Xk.shape)
        nl = np.bincount(cols[res] * 20 + Xk[res],
                         minlength=Lfull * 20).reshape(Lfull, 20)
        naa = np.maximum((nl > 0).sum(axis=1), 1)
        valid = keepm[:, None] & (Xk < 20)
        denom = ((nl[cols, np.where(valid, Xk, 0)] * naa[None, :])
                 * (self.nres + 30.0)[:, None])
        contrib = np.where(valid, 1.0 / np.where(valid, denom, 1.0), 0.0)
        wg = np.zeros(N, dtype=np.float32)
        for li in range(Lfull):
            wg = (wg.astype(np.float64) + contrib[:, li]).astype(np.float32)
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
        codes = np.full((N, Lfull + 1), GAP, dtype=np.int16)
        for k in range(N):
            codes[k, 1:] = AA2I_TABLE[_latin1(self.seqs[k][1:])]
        is_match = _ISALPHA[_latin1(self.seqs[self.kfirst][1:])]
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
            if self.keep[k]:
                b = _latin1(self.seqs[k][1:])
                X[k, 1:L + 1] = codes[k, 1:][mcols].astype(np.int8)
                ins = (~is_match) & (codes[k, 1:] < GAP)
                # count inserts between consecutive match columns
                seg = np.searchsorted(mcols, np.nonzero(ins)[0], side="left")
                I[k, :] = np.bincount(seg, minlength=L + 1)[: L + 1]
                out = np.where(is_match, _MATCH_CHR[b],
                               _INSERT_CHR[b])[is_match | ins]
                newseqs[k] = "-" + out.tobytes().decode("latin-1")
            elif k in (self.kss_dssp, self.kss_pred, self.ksa_dssp,
                       self.kss_conf):
                b = _latin1(self.seqs[k][1:])[mcols]
                if k == self.kss_conf:
                    X[k, 1:L + 1] = _CF2I[b]
                else:
                    tab = _SA2I if k == self.ksa_dssp else _SS2I
                    X[k, 1:L + 1] = tab[b]
                    b = _MATCH_CHR[b]
                newseqs[k] = "-" + b.tobytes().decode("latin-1")
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

        in_ = np.where(np.asarray(keep)[:N_in] == 2, 2, 0).astype(np.int8)
        n = int(np.count_nonzero(in_))
        inkk = in_[np.asarray(ksort, dtype=np.int64)]

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

        j0, j1 = filter_windows(L, WFIL)
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
            diffNmax_prev = diffNmax
            # windowed max of N (hhalignment.cpp:1816-1831)
            nmax = Nmax[1: L + 1]
            np.maximum(nmax, window_max(Npos[1: L + 1], j0, j1), out=nmax)
            short = nmax < Ndiff
            if not short.any():
                break
            idmaxwin[1: L + 1][short] = seqid
            diffNmax = int((Ndiff - nmax[short]).max())

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
        """Score-per-column sum with query (hhalignment.cpp:1718-1747):
        a column where both have a residue scores S; one where one side
        has a gap against the other's residue costs a gap open, or an
        extension where that side's previous such column came after its
        last residue column (an ANY on either side is no column); summed
        in column order."""
        kf = self.kfirst
        sl = slice(self.first[k] - 1, self.last[k])
        xk = self.X[k, 1: self.L + 1][sl].astype(np.int64)
        xq = self.X[kf, 1: self.L + 1][sl].astype(np.int64)
        rk, rq = xk < 20, xq < 20
        gk, gq = ~rk & (xk != ANY), ~rq & (xq != ANY)
        term = np.zeros(len(xk), dtype=np.float64)
        both = rk & rq
        term[both] = S[xq[both], xk[both]]
        # a gap in q against a residue of k; q's run of gaps ends where q
        # has a residue against anything but ANY.  The same for k, whose
        # run ends at any residue of k
        for gap, reset in ((rk & gq, rq & (xk != ANY)), (gk & rq, rk)):
            at = np.flatnonzero(gap | reset)
            ev = gap[at]
            ext = ev & np.concatenate(([False], ev[:-1]))
            term[at[ev]] = -np.where(ext[ev], PLTY_GAPEXTD, PLTY_GAPOPEN)
        used = both | (rk & gq) | (gk & rq)
        return float(np.add.accumulate(term[used])[-1]) if used.any() else 0.0
