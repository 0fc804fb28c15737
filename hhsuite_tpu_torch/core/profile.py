"""MSA -> profile HMM: position-specific weights, frequencies, transitions.

Vectorized reimplementation of Alignment::FrequenciesAndTransitions and its
three helpers (src/hhalignment.cpp:2047-3390).  The reference walks columns
incrementally, updating subalignment counts when the membership set changes;
here each *unique membership pattern* is processed once with dense tensor
ops (count matrices via bincount; weight gathers via fancy indexing), which
maps onto batched matmuls on device and is exactly equivalent to the
reference's change-tracking because columns with identical membership share
all derived quantities.

Float32 accumulation points that feed quantized HHM output use the
reference's fast-math functions (fast_log2 / fpow2 / flog2) bit-exactly.
The only intentional numeric divergence is the x86 approximate-reciprocal
`rcpps` (w_contrib, hhalignment.cpp:2527-2535): we use exact division, so
derived weights can drift by the instruction's ~4e-4 relative error (the
reference itself is not reproducible across ISAs there).
"""

from __future__ import annotations

import numpy as np

from .. import fastmath as fm
from ..constants import (ANY, D2D, D2M, ENDGAP, GAP, I2I, I2M, M2D, M2I, M2M,
                         MAXENDGAPFRAC, NAA, NCOLMIN)
from .alignment import Alignment
from .hmm import HMM

NCODE = 23   # aa 0-19, ANY, GAP, ENDGAP


def _seq_sum_f32(arr):
    if len(arr) == 0:
        return np.float32(0.0)
    return np.cumsum(arr.astype(np.float32), dtype=np.float32)[-1]


def global_weights(X: np.ndarray, in_: np.ndarray, nres: np.ndarray,
                   L: int) -> np.ndarray:
    """Global sequence weights wg (hhalignment.cpp:2083-2107).

    wg[k] starts at 1e-6 and accumulates 1/(ni*naa*(nres+30)) per column in
    the reference's float32 order; normalized to sum 1.
    """
    N = X.shape[0]
    wg = np.full(N, 1e-6, dtype=np.float32)
    inm = in_ > 0
    body = X[:, 1:L + 1].astype(np.int64)
    denom_base = (nres + 30.0).astype(np.float64)
    for i in range(L):
        col = body[inm, i]
        ni = np.bincount(col, minlength=NCODE)
        naa = int((ni[:20] > 0).sum()) or 1
        valid = inm & (body[:, i] < 20)
        if valid.any():
            contrib = np.zeros(N, dtype=np.float64)
            d = np.float32(ni[body[valid, i]] * naa) * np.float32(
                denom_base[valid])
            # C: 1.0 / float(ni*naa*(nres+30.0)) -> double recip of f32 cast
            contrib[valid] = 1.0 / (ni[body[valid, i]] * naa
                                    * denom_base[valid]).astype(np.float32)
            wg = (wg.astype(np.float64) + contrib).astype(np.float32)
    s = _seq_sum_f32(wg)
    if s != 0:
        wg = (wg * np.float32(1.0 / s)).astype(np.float32)
    return wg


def frequencies_and_transitions(ali: Alignment, q: HMM,
                                use_global_weights: int = 0,
                                mark: int = 0, cons: int = 0,
                                showcons: int = 1,
                                pb: np.ndarray = None,
                                Sim: np.ndarray = None,
                                in_: np.ndarray = None) -> HMM:
    """Alignment -> HMM q (hhalignment.cpp:2047-2404)."""
    if in_ is None:
        in_ = ali.keep
    L = ali.L
    N = ali.N_in
    q.alloc(L)
    q.L = L
    q.N_in = N
    q.N_filtered = ali.N_filtered

    X = ali.X
    if ali.nres is None:
        ali._first_last_nres()

    if ali.N_filtered > 1:
        wg = global_weights(X, in_, ali.nres, L)
        ali.wg = wg
        X[:, 0] = ENDGAP
        X[:, L + 1] = ENDGAP
        _m_state(ali, q, use_global_weights, in_, pb, wg)
        _i_state(ali, q, in_, wg)
        _d_state(ali, q, in_, wg)
    else:
        _single_sequence(ali, q, in_, pb)

    q.l[1:L + 1] = ali.l[1:L + 1]
    if not q.name:
        q.name = ali.name
    if not q.longname:
        q.longname = ali.longname
    if not q.fam:
        q.fam = ali.fam
    q.file = ali.file

    _copy_display(ali, q, mark, cons, showcons, pb, Sim)

    q.lamda = 0.0
    q.mu = 0.0
    q.trans_lin = 0
    q.has_pseudocounts = False
    q.divided_by_local_bg_freqs = False
    return q


# ---------------------------------------------------------------------------

def _m_state(ali: Alignment, q: HMM, use_global_weights, in_, pb, wg):
    """Amino_acid_frequencies_and_transitions_from_M_state
    (hhalignment.cpp:2404-2700)."""
    L, N = ali.L, ali.N_in
    X = ali.X
    I = ali.I
    inm = in_ > 0
    body = X[:, 1:L + 1].astype(np.int64)     # (N, L) codes at 1..L
    Neff = np.zeros(L + 1, dtype=np.float32)

    if use_global_weights:
        WI = np.broadcast_to(wg, (L + 1, N)).copy()
        WI[0] = 0
        neff_from_entropy = False
    else:
        # membership pattern of each column: seqs with residue at i
        member = inm[None, :] & (body.T < ANY)        # (L, N) for i=1..L
        # unique patterns -> column groups
        pat, inv = np.unique(member, axis=0, return_inverse=True)
        WI = np.zeros((L + 1, N), dtype=np.float32)
        Neff_pat = np.zeros(len(pat), dtype=np.float32)
        arangeL = np.arange(L)
        for pidx in range(len(pat)):
            m = pat[pidx]
            nseqi = int(m.sum())
            # n[j][a] counts over subalignment (j = 1..L)
            sub = body[m]                               # (nm, L)
            flat = (arangeL[None, :] * NCODE + sub).ravel()
            n = np.bincount(flat, minlength=L * NCODE).reshape(L, NCODE)
            # jmin/jmax: columns without too many endgaps
            bad = n[:, ENDGAP] > MAXENDGAPFRAC * nseqi
            good_idx = np.nonzero(~bad)[0]
            if len(good_idx) == 0:
                jmin, jmax = L + 1, 0
            else:
                jmin, jmax = int(good_idx[0]) + 1, int(good_idx[-1]) + 1
            ncol = jmax - jmin + 1

            if ncol < NCOLMIN:
                wi = np.where(m, wg, np.float32(0.0)).astype(np.float32)
            else:
                win = slice(jmin - 1, jmax)
                nwin = n[win]
                naa = (nwin[:, :20] > 0).sum(axis=1)
                denom = (naa[:, None] * nwin[:, :20]).astype(np.float32)
                with np.errstate(divide="ignore"):
                    w_contrib = np.where(
                        nwin[:, :20] > 0,
                        (np.float32(1.0) / denom), np.float32(0.0))
                w_full = np.zeros((jmax - jmin + 1, NCODE), dtype=np.float32)
                w_full[:, :20] = w_contrib
                gathered = w_full[np.arange(jmax - jmin + 1)[None, :],
                                  sub[:, win]]
                wi = np.full(N, 1e-8, dtype=np.float32)
                wi[m] = (np.float32(1e-8)
                         + gathered.sum(axis=1, dtype=np.float64)
                         ).astype(np.float32)

            # Neff from entropy of subalignment profile over jmin..jmax
            ne = np.float32(0.0)
            if ncol > 0:
                win = slice(jmin - 1, jmax)
                subw = sub[:, win]
                wsel = wi[m]
                ncols_w = jmax - jmin + 1
                flatw = (np.arange(ncols_w)[None, :] * NCODE + subw).ravel()
                wrep = np.repeat(wsel, ncols_w)
                f = np.bincount(flatw, weights=wrep,
                                minlength=ncols_w * NCODE).reshape(
                                    ncols_w, NCODE).astype(np.float32)
                faa = f[:, :NAA]
                s = faa.sum(axis=1, dtype=np.float32)
                nz = s != 0
                faa = np.where(nz[:, None],
                               faa * (np.float32(1.0)
                                      / np.where(nz, s, 1))[:, None],
                               faa).astype(np.float32)
                contrib = np.where(faa > 1e-10,
                                   -faa * fm.fast_log2(faa), np.float32(0.0))
                ne = np.float32(contrib.sum(dtype=np.float64))
                ne = fm.fpow2(np.float32(ne / ncol))
            else:
                ne = np.float32(1.0)
            Neff_pat[pidx] = ne
            WI[1 + np.nonzero(inv == pidx)[0], :] = wi
        Neff[1:] = Neff_pat[inv]

    # frequencies q.f[i] from wi (all i at once)
    onehot_codes = body                               # (N, L)
    f = np.zeros((L + 1, NAA), dtype=np.float32)
    for a in range(NAA):
        f[1:, a] = (WI[1:] * ((onehot_codes.T == a) & inm[None, :])).sum(
            axis=1, dtype=np.float64).astype(np.float32)
    s = f[1:].sum(axis=1, dtype=np.float32)
    nz = s != 0
    fn = np.where(nz[:, None],
                  (f[1:] * (np.float32(1.0) / np.where(nz, s, 1))[:, None]),
                  pb[None, :]).astype(np.float32)
    q.f[1:L + 1] = fn
    q.f[0] = pb
    q.f[L + 1] = pb

    # transitions from M state
    XT = X.astype(np.int64)
    curM = (XT[:, 1:L + 1] < ANY) & inm[:, None]          # (N, L)
    nextI = I[:, 1:L + 1] > 0
    nextM = XT[:, 2:L + 2] <= ANY
    nextD = XT[:, 2:L + 2] == GAP
    w = WI[1:].T                                          # (N, L)
    tM2I = (w * (curM & nextI)).sum(axis=0, dtype=np.float64)
    tM2M = (w * (curM & ~nextI & nextM)).sum(axis=0, dtype=np.float64)
    tM2D = (w * (curM & ~nextI & ~nextM & nextD)).sum(axis=0,
                                                      dtype=np.float64)
    tM2M = tM2M.astype(np.float32)
    tM2I = tM2I.astype(np.float32)
    tM2D = tM2D.astype(np.float32)
    ssum = tM2M + tM2I + tM2D + np.float32(np.finfo(np.float32).tiny)
    q.tr[1:L + 1, M2M] = fm.flog2(tM2M / ssum)
    q.tr[1:L + 1, M2I] = fm.flog2(tM2I / ssum)
    q.tr[1:L + 1, M2D] = fm.flog2(tM2D / ssum)
    q.tr[0, M2M] = 0
    q.tr[0, M2I] = q.tr[0, M2D] = -100000
    q.tr[L, M2M] = 0
    q.tr[L, M2I] = q.tr[L, M2D] = -100000

    q.Neff_M[0] = 99.999
    if use_global_weights:
        # Neff from residue fraction (hhalignment.cpp:2652-2672)
        ent = np.where(q.f[1:L + 1] > 1e-10,
                       -q.f[1:L + 1] * fm.fast_log2(q.f[1:L + 1]), 0)
        neff_i = fm.fpow2(ent.sum(axis=1, dtype=np.float32))
        q.Neff_HMM = float(np.float32(
            neff_i.sum(dtype=np.float64) / L))
        Nlim = np.float32(max(10.0, q.Neff_HMM + 1.0))
        scale = fm.flog2(np.float32(
            (Nlim - q.Neff_HMM) / (Nlim - np.float32(1.0))))
        hasres = (XT[:, 1:L + 1] <= ANY) & inm[:, None]
        w_M = (wg[:, None] * hasres).sum(axis=0, dtype=np.float64).astype(
            np.float32) - np.float32(1.0 / ali.N_filtered)
        q.Neff_M[1:L + 1] = np.where(
            w_M < 0, np.float32(1.0),
            Nlim - (Nlim - np.float32(1.0)) * fm.fpow2(
                (scale * w_M).astype(np.float32)))
    else:
        neff_col = Neff[1:L + 1].copy()
        q.Neff_HMM = float(np.float32(
            neff_col.sum(dtype=np.float64) / L))
        neff_col[neff_col == 0] = 1.0
        q.Neff_M[1:L + 1] = neff_col


def _i_state(ali: Alignment, q: HMM, in_, wg):
    """Transitions_from_I_state, fast global-weights branch
    (hhalignment.cpp:3106-3160)."""
    L, N = ali.L, ali.N_in
    I = ali.I
    inm = in_ > 0
    Nlim = np.float32(max(10.0, q.Neff_HMM + 1.0))
    scale = fm.flog2(np.float32((Nlim - np.float32(q.Neff_HMM))
                                / (Nlim - np.float32(1.0))))
    mI = inm[:, None] & (I[:, 1:L + 1] > 0)              # (N, L)
    ncol = mI.sum(axis=0)
    w_I = (wg[:, None] * mI).sum(axis=0, dtype=np.float64).astype(
        np.float32) - np.float32(1.0 / ali.N_filtered)
    tI2M = (wg[:, None] * mI).sum(axis=0, dtype=np.float64).astype(np.float32)
    tI2I = (wg[:, None] * mI * (I[:, 1:L + 1] - 1)).sum(
        axis=0, dtype=np.float64).astype(np.float32)
    have = ncol > 0
    s = tI2M + tI2I
    with np.errstate(divide="ignore", invalid="ignore"):
        q.tr[1:L + 1, I2M] = np.where(have, fm.flog2(tI2M / s), -100000)
        q.tr[1:L + 1, I2I] = np.where(have, fm.flog2(tI2I / s), -100000)
    neff = np.where(have,
                    np.where(w_I < 0, np.float32(1.0),
                             Nlim - (Nlim - np.float32(1.0))
                             * fm.fpow2((scale * w_I).astype(np.float32))),
                    np.float32(0.0))
    q.Neff_I[1:L + 1] = neff
    q.tr[0, I2M] = 0
    q.tr[0, I2I] = -100000
    q.tr[L, I2M] = 0
    q.tr[L, I2I] = -100000
    q.Neff_I[0] = 99.999


def _d_state(ali: Alignment, q: HMM, in_, wg):
    """Transitions_from_D_state, fast global-weights branch
    (hhalignment.cpp:3325-3360)."""
    L, N = ali.L, ali.N_in
    X = ali.X.astype(np.int64)
    inm = in_ > 0
    Nlim = np.float32(max(10.0, q.Neff_HMM + 1.0))
    scale = fm.flog2(np.float32((Nlim - np.float32(q.Neff_HMM))
                                / (Nlim - np.float32(1.0))))
    mD = inm[:, None] & (X[:, 1:L + 1] == GAP)
    ncol = mD.sum(axis=0)
    w_D = (wg[:, None] * mD).sum(axis=0, dtype=np.float64).astype(
        np.float32) - np.float32(1.0 / ali.N_filtered)
    nextD = X[:, 2:L + 2] == GAP
    nextM = X[:, 2:L + 2] <= ANY
    tD2D = (wg[:, None] * (mD & nextD)).sum(axis=0, dtype=np.float64).astype(
        np.float32)
    tD2M = (wg[:, None] * (mD & ~nextD & nextM)).sum(
        axis=0, dtype=np.float64).astype(np.float32)
    have = ncol > 0
    s = tD2M + tD2D
    with np.errstate(divide="ignore", invalid="ignore"):
        q.tr[1:L + 1, D2M] = np.where(have, fm.flog2(tD2M / s), -100000)
        q.tr[1:L + 1, D2D] = np.where(have, fm.flog2(tD2D / s), -100000)
    neff = np.where(have,
                    np.where(w_D < 0, np.float32(1.0),
                             Nlim - (Nlim - np.float32(1.0))
                             * fm.fpow2((scale * w_D).astype(np.float32))),
                    np.float32(0.0))
    q.Neff_D[1:L + 1] = neff
    q.tr[0, D2M] = 0
    q.tr[0, D2D] = -100000
    q.Neff_D[0] = 99.999


def _single_sequence(ali: Alignment, q: HMM, in_, pb):
    """N_filtered == 1 branch (hhalignment.cpp:2126-2157)."""
    L = ali.L
    ks = [k for k in range(ali.N_in) if in_[k]]
    k = ks[0] if ks else ali.N_in - 1
    X = ali.X
    q.Neff_HMM = 1.0
    q.Neff_M[: L + 2] = 1.0
    q.Neff_I[: L + 2] = 0.0
    q.Neff_D[: L + 2] = 0.0
    body = X[k, : L + 2].astype(np.int64)
    f = np.zeros((L + 2, NAA), dtype=np.float32)
    isres = body < ANY
    f[np.nonzero(isres)[0], body[isres]] = 1.0
    f[~isres] = pb
    q.f[: L + 2] = f
    q.tr[: L + 2, :] = -100000.0
    q.tr[: L + 1, M2M] = 0
    q.tr[0, I2M] = 0
    q.tr[L, I2M] = 0
    q.tr[0, D2M] = 0
    q.Neff_M[0] = q.Neff_I[0] = q.Neff_D[0] = 99.999


def _copy_display(ali: Alignment, q: HMM, mark, cons, showcons, pb, Sim):
    """Displayed sequences, SS strings, consensus (hhalignment.cpp:2196-2400).
    """
    L = ali.L
    q.nss_dssp = q.nsa_dssp = q.nss_pred = q.nss_conf = q.nfirst = -1
    q.ncons = -1
    n = 0
    sname: list = []
    seq: list = []
    if ali.kss_dssp >= 0:
        q.nss_dssp = n
        n += 1
    if ali.ksa_dssp >= 0:
        q.nsa_dssp = n
        n += 1
    if ali.kss_pred >= 0:
        q.nss_pred = n
        n += 1
    if ali.kss_conf >= 0:
        q.nss_conf = n
        n += 1
    while len(sname) < n:
        sname.append("")
        seq.append("")

    cons_seq = None
    first_cons_seq = None
    if showcons or cons:
        from ..constants import AA_INTERNAL
        fmat = q.f[1:L + 1]
        diff = fmat - pb[None, :]
        maxw = diff.max(axis=1)
        maxa = np.where(maxw > 0, diff.argmax(axis=1), ANY)
        chars_cons = []
        chars_first = []
        for i in range(L):
            a = int(maxa[i])
            letter = AA_INTERNAL[a] if a < ANY else "X"
            if showcons:
                w = 0.0
                if a < NAA:
                    w = float((fmat[i] * Sim[a] * Sim[a]).sum())
                    w *= float(q.Neff_M[i + 1]) / (q.Neff_HMM + 1.0)
                if w > 0.6:
                    chars_cons.append(letter.upper())
                elif w > 0.4:
                    chars_cons.append(letter.lower())
                else:
                    chars_cons.append("x")
            if cons:
                chars_first.append(letter.upper())
        if showcons:
            q.ncons = n
            n += 1
            sname.append("Consensus")
            seq.append("-" + "".join(chars_cons))
        if cons:
            q.nfirst = n
            n += 1
            sname.append(ali.name + "_consensus")
            seq.append("-" + "".join(chars_first))

    kfirst_eff = -1 if cons else ali.kfirst
    maxseqdis = getattr(q, "maxseqdis", 10238)
    for k in range(ali.N_in):
        if not ali.display[k]:
            continue
        if n >= maxseqdis:
            # reference caps at q->maxseqdis (hhalignment.cpp:2296-2301)
            break
        if k == ali.kss_dssp:
            nn = q.nss_dssp
            sname[nn] = ali.names[k]
            seq[nn] = ali.seqs[k]
            continue
        if k == ali.ksa_dssp:
            nn = q.nsa_dssp
            sname[nn] = ali.names[k]
            seq[nn] = ali.seqs[k]
            continue
        if k == ali.kss_pred:
            nn = q.nss_pred
            sname[nn] = ali.names[k]
            seq[nn] = ali.seqs[k]
            continue
        if k == ali.kss_conf:
            nn = q.nss_conf
            sname[nn] = ali.names[k]
            seq[nn] = ali.seqs[k]
            continue
        if k == kfirst_eff:
            q.nfirst = n
        sname.append(ali.names[k])
        seq.append(ali.seqs[k])
        n += 1
    q.sname = sname
    q.seq = seq
    q.n_display = n
    q.n_seqs = n

    # secondary structure codes
    if ali.kss_dssp >= 0:
        q.ss_dssp[1:L + 1] = ali.X[ali.kss_dssp, 1:L + 1]
    if ali.ksa_dssp >= 0:
        q.sa_dssp[1:L + 1] = ali.X[ali.ksa_dssp, 1:L + 1]
    if ali.kss_pred >= 0:
        q.ss_pred[1:L + 1] = ali.X[ali.kss_pred, 1:L + 1]
        if ali.kss_conf >= 0:
            q.ss_conf[1:L + 1] = ali.X[ali.kss_conf, 1:L + 1]
        else:
            q.ss_conf[1:L + 1] = 5
