"""Context-state library: cs219 alphabet + AS219 translation.

Ports the needed slice of the vendored CS-BLAST library: ContextLibrary /
ContextProfile text parsing (src/cs/context_library-inl.h,
src/cs/context_profile-inl.h:81-145; fixed-point ``p = 2^(-v/1000)``),
the multinomial Emission (src/cs/emission.h:36-103) and
CalculatePosteriorProbs / TranslateIntoStateSequence
(src/cs/context_library-inl.h:92-142).

For the cs219 alphabet (window length 1) the translation collapses to one
matmul: ``post ∝ log prior_k + w_center · (counts_i · log p_k)`` — an MXU
workload over all columns at once.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

AS219_SIZE = 219

# cs::AA character mapping (src/cs/aa.cc:41-64); unknown chars -> 0 ('A')
CS_CHAR_TO_INT = np.zeros(256, dtype=np.uint8)
for _c, _v in zip("ARNDCQEGHILKMFPSTWYV", range(20)):
    CS_CHAR_TO_INT[ord(_c)] = _v
    CS_CHAR_TO_INT[ord(_c.lower())] = _v
for _c, _v in [("B", 3), ("J", 20), ("O", 20), ("U", 4), ("X", 20),
               ("Z", 6)]:
    CS_CHAR_TO_INT[ord(_c)] = _v
    CS_CHAR_TO_INT[ord(_c.lower())] = _v
CS_CHAR_TO_INT[ord("-")] = 21
CS_CHAR_TO_INT[ord(".")] = 21
CS_ANY, CS_GAP, CS_ENDGAP = 20, 21, 22

_KSCALE = 1000.0


@dataclass
class ContextLibrary:
    """K context profiles of window length wlen."""

    priors: np.ndarray        # (K,) linear priors
    probs: np.ndarray         # (K, wlen, 20) linear probabilities
    wlen: int

    @property
    def size(self):
        return self.priors.shape[0]

    @classmethod
    def from_text(cls, text: str) -> "ContextLibrary":
        lines = iter(text.splitlines())
        first = next(lines)
        if not first.startswith("ContextLibrary"):
            raise ValueError("not a ContextLibrary stream")
        size = wlen = None
        for line in lines:
            if line.startswith("SIZE"):
                size = int(line.split()[1])
            elif line.startswith("LENG"):
                wlen = int(line.split()[1])
                break
        priors = np.zeros(size, dtype=np.float64)
        probs = np.zeros((size, wlen, 20), dtype=np.float64)
        k = -1
        is_log = False
        for line in lines:
            if line.startswith("ContextProfile"):
                k += 1
            elif line.startswith("PRIOR"):
                priors[k] = float(line.split()[1])
            elif line.startswith("ISLOG"):
                is_log = line.split()[1] == "T"
            elif line and line[0].isdigit():
                t = line.split()
                i = int(t[0]) - 1
                v = -np.array([float(x) for x in t[1:21]]) / _KSCALE
                probs[k, i] = np.power(2.0, v)
                if is_log:
                    probs[k, i] = np.log(probs[k, i])
        if is_log:
            raise NotImplementedError("log-space library files")
        return cls(priors=priors, probs=probs, wlen=wlen)

    @classmethod
    def default_cs219(cls) -> "ContextLibrary":
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "data", "cs219.lib")
        with open(path) as f:
            return cls.from_text(f.read())


def emission_weights(wlen: int, w_center: float, w_decay: float
                     ) -> np.ndarray:
    """Positional window weights (src/cs/emission.h:37-55)."""
    center = (wlen - 1) // 2
    w = np.zeros(wlen, dtype=np.float64)
    w[center] = w_center
    for i in range(1, center + 1):
        w[center - i] = w[center + i] = w_center * w_decay ** i
    return w


def translate_to_states(counts: np.ndarray, lib: ContextLibrary,
                        w_center: float = 1000.0,
                        return_posteriors: bool = False):
    """Column count profile -> AS219 state sequence
    (TranslateIntoStateSequence for wlen == 1).

    counts: (L, 20) count profile columns (normalized to Neff).
    Returns (L,) uint8 states, optionally with (L, K) posteriors.
    """
    if lib.wlen != 1:
        raise NotImplementedError("only wlen==1 abstract-state libraries")
    logp = np.log(lib.probs[:, 0, :])           # (K, 20)
    logprior = np.log(lib.priors)               # (K,)
    act = counts @ logp.T * w_center + logprior[None, :]
    # ties: first maximum (reference scans k ascending with strict >)
    states = np.argmax(act, axis=1).astype(np.uint8)
    if return_posteriors:
        m = act.max(axis=1, keepdims=True)
        e = np.exp(act - m)
        post = e / e.sum(axis=1, keepdims=True)
        return states, post
    return states


def cs_alignment_from_a3m(text: str):
    """cs::Alignment A3M reading (src/cs/alignment-inl.h:280-330 + Init).

    Returns (match_matrix (L, N) uint8 codes with ENDGAP marking, headers).
    Sequences named ss_pred/ss_conf/ss_dssp are dropped; '>' name lines
    starting '#' treated as comment.
    """
    headers: List[str] = []
    seqs: List[str] = []
    cur: Optional[List[str]] = None
    for line in text.splitlines():
        if line.startswith(">"):
            if cur is not None:
                seqs.append("".join(cur))
            headers.append(line[1:])
            cur = []
        elif line.startswith("#") and cur is None:
            continue
        elif cur is not None:
            cur.append(line.strip())
    if cur is not None:
        seqs.append("".join(cur))

    keepidx = [k for k, h in enumerate(headers)
               if not (h.startswith("ss_pred") or h.startswith("ss_conf")
                       or h.startswith("ss_dssp"))]
    headers = [headers[k] for k in keepidx]
    seqs = [seqs[k] for k in keepidx]

    def is_match_chr(c):
        return c.isupper() or c == "-"

    nmatch = sum(1 for c in seqs[0] if is_match_chr(c))
    for k, s in enumerate(seqs[1:], 1):
        nm = sum(1 for c in s if is_match_chr(c))
        if nm != nmatch:
            raise ValueError(
                f"sequence {k} has {nm} match columns, expected {nmatch}")
        if "." in s:
            raise ValueError(f"sequence {k} in A3M contains '.' gaps")

    # A3M -> A2M: expand insert blocks to shared columns ('.' fills)
    N = len(seqs)
    split = []
    max_ins = np.zeros(nmatch + 1, dtype=np.int64)
    for s in seqs:
        blocks: List[List[str]] = [[] for _ in range(nmatch + 1)]
        matches: List[str] = []
        mi = 0
        for c in s:
            if is_match_chr(c):
                matches.append(c)
                mi += 1
            else:
                blocks[mi].append(c)
        split.append((matches, blocks))
        for i in range(nmatch + 1):
            max_ins[i] = max(max_ins[i], len(blocks[i]))

    ncols = int(nmatch + max_ins.sum())
    full = np.full((ncols, N), CS_GAP, dtype=np.uint8)
    is_match = np.zeros(ncols, dtype=bool)
    col = 0
    col_starts = []
    for i in range(nmatch + 1):
        col_starts.append(col)
        col += int(max_ins[i])
        if i < nmatch:
            is_match[col] = True
            col += 1
    for k, (matches, blocks) in enumerate(split):
        for i in range(nmatch + 1):
            b = blocks[i]
            if b:
                codes = CS_CHAR_TO_INT[
                    np.frombuffer("".join(b).encode("latin-1"),
                                  dtype=np.uint8).astype(np.int64)]
                full[col_starts[i]: col_starts[i] + len(b), k] = codes
        mcodes = CS_CHAR_TO_INT[
            np.frombuffer("".join(matches).encode("latin-1"),
                          dtype=np.uint8).astype(np.int64)]
        full[is_match, k] = mcodes

    # endgap marking over the FULL A2M (cs::Alignment::Init:89-95):
    # leading inserts stop the endgap run
    for k in range(N):
        colk = full[:, k]
        i = 0
        while i < ncols and colk[i] == CS_GAP:
            colk[i] = CS_ENDGAP
            i += 1
        i = ncols - 1
        while i >= 0 and colk[i] == CS_GAP:
            colk[i] = CS_ENDGAP
            i -= 1
    M = full[is_match, :].copy()
    return M, headers


def cs_alignment_from_fasta(text: str, match_assign=None):
    """cs::Alignment FASTA reading + match assignment
    (src/cs/cstranslate_app.h:577-583): match columns from sequence 0's
    residues (kAssignMatchColsByQuery) or, with ``match_assign``, the
    -M gap rule (AssignMatchColumnsByGapRule, alignment-inl.h:501-530:
    weighted gap percentage against a threshold, ENDGAPs ignored)."""
    headers: List[str] = []
    seqs: List[str] = []
    cur: Optional[List[str]] = None
    for line in text.splitlines():
        if line.startswith(">"):
            if cur is not None:
                seqs.append("".join(cur))
            headers.append(line[1:])
            cur = []
        elif line.startswith("#") and cur is None:
            continue
        elif cur is not None:
            cur.append(line.strip())
    if cur is not None:
        seqs.append("".join(cur))
    keepidx = [k for k, h in enumerate(headers)
               if not (h.startswith("ss_pred") or h.startswith("ss_conf")
                       or h.startswith("ss_dssp"))]
    headers = [headers[k] for k in keepidx]
    seqs = [seqs[k] for k in keepidx]
    ncols = len(seqs[0])
    for k, s in enumerate(seqs[1:], 1):
        if len(s) != ncols:
            raise ValueError(f"FASTA sequence {k} length mismatch")
    N = len(seqs)
    full = np.zeros((ncols, N), dtype=np.uint8)
    for k, s in enumerate(seqs):
        full[:, k] = CS_CHAR_TO_INT[
            np.frombuffer(s.upper().encode("latin-1"),
                          dtype=np.uint8).astype(np.int64)]
    for k in range(N):      # endgap marking (cs::Alignment::Init)
        colk = full[:, k]
        i = 0
        while i < ncols and colk[i] == CS_GAP:
            colk[i] = CS_ENDGAP
            i += 1
        i = ncols - 1
        while i >= 0 and colk[i] == CS_GAP:
            colk[i] = CS_ENDGAP
            i -= 1
    if match_assign is None:
        # AssignMatchColumnsBySequence(0): residues of the first seq
        is_match = full[:, 0] < CS_ANY
    else:
        wg, _neff = cs_global_weights(full)
        thr = float(match_assign)
        res = np.where(full < CS_ANY, wg[None, :], 0.0).sum(axis=1)
        gap = np.where((full >= CS_ANY) & (full != CS_ENDGAP),
                       wg[None, :], 0.0).sum(axis=1)
        tot = res + gap
        with np.errstate(divide="ignore", invalid="ignore"):
            if thr > 1.0:        # percentage between 1 and 100
                is_match = np.where(tot > 0,
                                    100.0 * gap / tot <= thr, False)
            else:                # decimal fraction
                is_match = np.where(tot > 0, res / tot > thr, False)
    M = full[is_match, :].copy()
    return M, headers


def cs_global_weights(M: np.ndarray):
    """GlobalWeightsAndDiversity (src/cs/alignment-inl.h:697-770).

    M: (L, N) code matrix (match columns).  Returns (wg (N,), neff).
    """
    L, N = M.shape
    isaa = M < CS_ANY
    n = isaa.sum(axis=0).astype(np.float64)           # residues per seq
    wg = np.zeros(N, dtype=np.float64)
    adiffs = np.zeros(L, dtype=np.int64)
    counts = np.zeros((L, 20), dtype=np.int64)
    for a in range(20):
        counts[:, a] = (M == a).sum(axis=1)
    adiffs = (counts > 0).sum(axis=1)
    adiffs[adiffs == 0] = 1
    denom = np.where(isaa, counts[np.arange(L)[:, None],
                                  np.clip(M, 0, 19)].astype(np.float64), 1.0)
    contrib = np.where(isaa, 1.0 / (adiffs[:, None] * denom * n[None, :]),
                       0.0)
    wg = contrib.sum(axis=0)
    s = wg.sum()
    if s:
        wg = wg / s
    # diversity
    neff = 0.0
    for i in range(L):
        fj = np.zeros(20)
        np.add.at(fj, M[i][isaa[i]], wg[isaa[i]])
        tot = fj.sum()
        if tot:
            fj /= tot
        nz = fj > 1e-10
        neff -= (fj[nz] * np.log2(fj[nz])).sum()
    return wg, 2.0 ** (neff / L)


def cs_position_specific_weights(M: np.ndarray):
    """PositionSpecificWeightsAndDiversity (src/cs/alignment-inl.h:772-876).

    Returns (w (L, N) float64, neff (L,)).
    """
    L, N = M.shape
    wg, _ = cs_global_weights(M)
    isaa = M < CS_ANY
    w = np.zeros((L, N), dtype=np.float64)
    neff = np.zeros(L, dtype=np.float64)

    member = isaa.copy()                        # (L, N)
    pat, inv = np.unique(member, axis=0, return_inverse=True)
    neff_pat = np.zeros(len(pat))
    w_pat = np.zeros((len(pat), N))
    arange = np.arange(L)
    for p in range(len(pat)):
        m = pat[p]
        nseqi = int(m.sum())
        sub = M[:, m]                           # (L, nm)
        flat = (arange[:, None] * 23 + sub).ravel()
        n = np.bincount(flat, minlength=L * 23).reshape(L, 23)
        ok = n[:, CS_ENDGAP] <= 0.1 * nseqi
        ndiff = (n[:, :20] > 0).sum(axis=1)
        ok &= ndiff > 0
        ncoli = int(ok.sum())
        wi = np.zeros(N)
        if ncoli:
            with np.errstate(divide="ignore"):
                wc = np.where(n[:, :20] > 0,
                              1.0 / (n[:, :20] * ndiff[:, None]), 0.0)
            wc_full = np.zeros((L, 23))
            wc_full[:, :20] = wc
            gather = wc_full[arange[:, None], sub] * ok[:, None]
            wi[m] = gather.sum(axis=0)
        s = wi.sum()
        if s:
            wi = wi / s
        if ncoli < 10:
            wi = np.where(m, wg, 0.0)
        # neff from subalignment entropy over ok columns; all columns
        # at once via a weighted bincount over (column, residue) pairs
        ne = 0.0
        if ncoli:
            wsel = wi[m]                        # (nm,)
            valid = sub < CS_ANY                # (L, nm)
            codes = np.where(valid, sub, 20)
            flatc = (arange[:, None] * 21 + codes).ravel()
            wts = np.where(valid, wsel[None, :], 0.0).ravel()
            fj_all = np.bincount(flatc, weights=wts,
                                 minlength=L * 21).reshape(L, 21)[:, :20]
            fj_all = fj_all[ok]
            tot = fj_all.sum(axis=1, keepdims=True)
            fj_all = np.divide(fj_all, tot, out=fj_all,
                               where=tot > 0)
            nz = fj_all > 1e-10
            lg = np.where(nz, np.log2(fj_all, where=nz), 0.0)
            ne = -(np.where(nz, fj_all * lg, 0.0)).sum()
        neff_pat[p] = 2.0 ** (ne / ncoli) if ncoli > 0 else 1.0
        w_pat[p] = wi
    # columns with empty membership: reference keeps previous wi/neff;
    # unique-pattern mapping reproduces that except for the leading run
    # of empty columns (neff=0 there)
    neff = neff_pat[inv]
    w = w_pat[inv]
    empty = ~member.any(axis=1)
    if empty.any():
        # reference: no change -> carry previous (0 for leading)
        prev_ne = 0.0
        prev_w = np.zeros(N)
        for i in range(L):
            if empty[i]:
                neff[i] = prev_ne
                w[i] = prev_w
            else:
                prev_ne = neff[i]
                prev_w = w[i]
    return w, neff


def count_profile_from_a3m(text: str, pos_weights: bool = True,
                           match_assign=None, informat: str = "a3m"):
    """cs::CountProfile from an A3M (src/cs/count_profile-inl.h:32-59).

    Returns (counts (L, 20) float64 normalized to neff, neff (L,), name).
    """
    if informat in ("fas", "fasta"):
        M, headers = cs_alignment_from_fasta(text,
                                             match_assign=match_assign)
    else:
        M, headers = cs_alignment_from_a3m(text)
    L, N = M.shape
    isaa = M < CS_ANY
    counts = np.zeros((L, 20), dtype=np.float64)
    if pos_weights:
        w, neff = cs_position_specific_weights(M)
        for i in range(L):
            np.add.at(counts[i], M[i][isaa[i]], w[i][isaa[i]])
    else:
        wg, neff_g = cs_global_weights(M)
        neff = np.full(L, neff_g)
        for i in range(L):
            np.add.at(counts[i], M[i][isaa[i]], wg[isaa[i]])
    # Normalize(counts, neff): scale each row to sum neff[i]
    s = counts.sum(axis=1)
    nz = s > 0
    counts[nz] *= (neff[nz] / s[nz])[:, None]
    name = headers[0] if headers else ""
    return counts, neff, name


# AS219 serialization characters (src/cs/as.cc:195: codes 33..255
# minus '*' 42, '-' 45, '.' 46, '>' 62 — exactly 219 states)
AS219_CHARS = [c for c in range(33, 256) if c not in (42, 45, 46, 62)]


def write_state_profile(posteriors: np.ndarray, name: str = "") -> str:
    """CountProfile<AS219>::Write (src/cs/count_profile-inl.h:106-131):
    the `-O prf` output format — per-column AS219 posteriors as
    negative log2 fixed-point (kScale=1000, '*' for zero), NEFF 1."""
    import math

    out = ["CountProfile"]
    if name:
        out.append(f"NAME\t{name}")
    L, K = posteriors.shape
    out.append(f"LENG\t{L}")
    out.append(f"ALPH\t{K}")
    out.append("COUNTS\t" + "\t".join(chr(c) for c in AS219_CHARS[:K])
               + "\tNEFF")
    for i in range(L):
        row = [str(i + 1)]
        for a in range(K):
            p = posteriors[i, a]
            if p == 0.0:
                row.append("*")
            else:
                row.append(str(-int(math.floor(math.log2(p) * 1000
                                               + 0.5))))
        row.append("1000")      # neff fixed at one (cstranslate_app.h)
        out.append("\t".join(row))
    out.append("//")
    return "\n".join(out) + "\n"


def cstranslate_a3m(text: str, lib: Optional[ContextLibrary] = None,
                    w_center: float = 1000.0, pc_engine=None,
                    pc_admix: float = 0.9, pc_ali: float = 12.0,
                    match_assign=None, return_profile: bool = False,
                    informat: str = "a3m"):
    """cstranslate -i <a3m>: a3m -> AS219 byte sequence
    (src/cs/cstranslate_app.h:126-163 ffindex path).

    With ``pc_engine`` (a Crf/LibraryPseudocounts engine), applies
    context-specific pseudocounts with CSBlastAdmix(pc_admix, pc_ali)
    and renormalizes the count profile to Neff before translation,
    exactly like ReadProfile (src/cs/cstranslate_app.h:561-597:
    ``counts = AddTo(profile, admix); Normalize(counts, neff)``).

    ``match_assign`` applies only to FASTA inputs (``informat='fas'``,
    like the reference where -M touches FASTA alignments only,
    cstranslate_app.h:577-583): None = match columns from the first
    sequence's residues, a number = the gap-percentage rule.
    ``return_profile=True`` additionally returns the (L, 219)
    posterior profile (`-O prf`)."""
    if lib is None:
        lib = ContextLibrary.default_cs219()
    counts, neff, _ = count_profile_from_a3m(text,
                                             match_assign=match_assign,
                                             informat=informat)
    if pc_engine is not None:
        from .pseudocounts import CSBlastAdmix, add_to_profile

        admix = CSBlastAdmix(pc_admix, pc_ali)
        safe_neff = np.where(neff > 0, neff, 1.0)
        p = add_to_profile(pc_engine, counts, safe_neff, admix)
        counts = p * neff[:, None]
    states, post = translate_to_states(counts, lib, w_center=w_center,
                                       return_posteriors=True)
    seq = bytes(states.tolist())
    if return_profile:
        return seq, post
    return seq


def default_pc_engine(modelfile: Optional[str] = None,
                      weight_center: float = 1.6,
                      weight_decay: float = 0.85):
    """Build the cstranslate pseudocount engine (SetupPseudocountEngine,
    src/cs/cstranslate_app.h:434-470).

    ``modelfile=None`` is the reference's ``internal`` default: the
    embedded ``context_data.lib`` resource.  The reference build this
    framework is tested against embeds the cs219 library content there
    (the upstream checkout ships no separate context_data.lib), so the
    internal engine is a wlen-1 LibraryPseudocounts over cs219.lib.
    A ``.crf`` path selects the CRF engine instead.
    """
    from .pseudocounts import Crf, CrfPseudocounts, LibraryPseudocounts

    if modelfile is None:
        return LibraryPseudocounts(ContextLibrary.default_cs219(),
                                   weight_center, weight_decay)
    if modelfile.endswith(".crf"):
        return CrfPseudocounts(Crf.from_file(modelfile))
    with open(modelfile) as f:
        plib = ContextLibrary.from_text(f.read())
    return LibraryPseudocounts(plib, weight_center, weight_decay)
