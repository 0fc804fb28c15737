"""Batched Forward/Backward/MAC posterior decoding for MAC realignment:
R1-R4, CUDA C++ in ``csrc/posterior.cu``.

The reference decodes one hit at a time with scalar double loops
(src/hhforwardalgorithm.cpp, src/hhbackwardalgorithm.cpp,
src/hhmacalgorithm.cpp, src/hhbacktracemac.cpp); the JAX package
decodes a batch of hits in f32 (hhsuite_tpu/ops/posterior_batch.py:
``fb_mac_batch`` a ``lax.scan`` over query rows with
``lax.associative_scan`` chains along each row, ``mac_walk`` the device
backtrace).  Here the same f32 recurrences run as four kernels, each
with its plain PyTorch version beside it:

* R1 :func:`fb_forward` — the Forward rows: MM/MI/DG from the row above,
  the same-row GD and IM affine chains, Pmax over j >= 2, the per-row
  scale and Pforward (``fb_mac_batch`` :139-224);
* R2 :func:`fb_backward` — the Backward rows (reverse affine chains),
  each fused into the posterior ``p_mm = fwd * bwd / Pforward`` as it is
  done; no backward matrix is kept (:226-279);
* R3 :func:`mac_dp` — the MAC rows (a max-plus chain), the backtrace
  codes with the reference's tie order STOP < MM < MI < IM and the
  strict row-major argmax (:281-351);
* R4 :func:`mac_walk_packed8` — the MAC backtrace walk with the path
  posteriors, written straight into the packed payload of ``12 + 5 *
  kmax`` bytes a lane (``mac_walk`` :470 + ``mac_walk_packed8`` :418).

:func:`fb_mac_rows` chains R1-R3 (the realign path's form: it keeps the
search scores, so no Forward score is computed); :func:`fb_mac_batch`
adds the score with the JAX signature, computed on the host (numpy f32,
from R1's Pforward and row scales, the same code for both devices).  In
global mode every exit through a template's last column is at the
lane's own ``t_L``, so a lane padded to the chunk's width decodes as its
unpadded template does (the JAX ``fb_mac_batch`` reads the padded width
there, and loses those exits).  :func:`realign_mask_device` builds the
cell-off corridor from its interval form with pointwise torch compares
on either device.

The kernels' association.  A CTA of T = 128 threads decodes one hit; a
row of Wj = Lt + 1 cells is cut into T segments of c = ceil(Wj / T)
contiguous columns (padded to W = T * c with cells that are off and
hold zeros).  A same-row chain is computed in three steps: a sequential
pass inside each segment, a Kogge-Stone scan over the T segment
aggregates (the combine rules of the JAX ``_lin_scan`` and
``_maxplus_scan``), and the carry applied back into the segment.  A row
sum runs sequentially inside the segment, then through a pairwise tree
over T.  The plain versions below compute in exactly that association
on (B, T, c) views, so kernel and plain version are bit-identical on
IEEE f32 (the kernels are built with ``-fmad=false``); both hold to the
JAX package's reassociated f32 within its own tests' tolerances.  R1,
R2 and R3 keep a row in registers up to c = 8 (Wj <= 1024, every warp
running the scans itself); wider rows keep their arrays in shared
memory, or past :data:`SMEM_MAX` in a global scratch.

The SS factors of R1/R2 come in two forms: the dense (B, Lq+1, Lt+1)
matrix ``ss_f`` (the JAX layout), or ``ss_table = (lut, roff, coff)``:
a flat f32 table (entry 0 is 1.0), (B, Lq+1) int32 row offsets and
(B, Lt+1) int32 column offsets, the factor at (b, i, j) being
``lut[roff[b, i] + coff[b, j]]``, or ``lut[0]`` where ``coff[b, j] <
0`` (:func:`ss_expand`; the realign path's form,
``search/posterior.py:PosteriorDecoder.ss_table``).  The kernels stage
the table in shared memory; the plain versions expand it.

On CPU tensors the wrappers run the plain versions; on CUDA tensors
they launch the kernel or raise.  ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

FLT_MAX = float(np.finfo(np.float32).max)
FLT_MIN = float(np.finfo(np.float32).tiny)
FLUSH = FLT_MIN * 100.0
M2M, M2I, M2D, I2M, I2I, D2M, D2D = range(7)
STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6
LAMDA = 0.388

# threads a CTA (one hit); the segment layout of every row follows it
T = 128
# the most entries an SS table may have (csrc/posterior.cu:SS_LUT_MAX)
SS_LUT_MAX = 4096
# dynamic shared memory a CTA may take for its row arrays; wider rows
# keep them in a global scratch instead (the same code, another base)
SMEM_MAX = 160 * 1024

_BOUND = {}


def seg_layout(Wj: int):
    """(c, W): columns a thread and the padded row width T * c."""
    c = max(1, -(-Wj // T))
    return c, T * c


# ---------------------------------------------------------- plain ----

def _mx(a, b):
    """max as the kernels take it: ``a > b ? a : b``."""
    return torch.where(a > b, a, b)


def _pad_cols(x, W, value=0):
    """Pad the last axis to W columns with ``value``."""
    return F.pad(x, (0, W - x.shape[-1]), value=value)


def _sr(x):
    """shift_r: x[j-1], 0 at j = 0."""
    return F.pad(x, (1, 0))[..., :-1]


def _sl(x):
    """shift_l: x[j+1], 0 at the last column."""
    return F.pad(x, (0, 1))[..., 1:]


def _lin_scan(u, a, c, reverse=False):
    """y[j] = u[j] + a[j] * y[j-1] (y[j+1] with ``reverse``) along the
    last axis of (B, T*c), y = 0 before the first column: a sequential
    pass in each segment, a Kogge-Stone scan over the segment aggregates
    with ``_lin_scan``'s combine (a_x * a_y, u_y + a_y * u_x), the carry
    applied back."""
    B = u.shape[0]
    U, A = u.reshape(B, T, c), a.reshape(B, T, c)
    y, p = torch.empty_like(U), torch.empty_like(A)
    prev = None
    for k in (range(c - 1, -1, -1) if reverse else range(c)):
        if prev is None:
            y[..., k], p[..., k] = U[..., k], A[..., k]
        else:
            y[..., k] = U[..., k] + A[..., k] * y[..., prev]
            p[..., k] = A[..., k] * p[..., prev]
        prev = k
    Ag, Ug = p[..., prev].clone(), y[..., prev].clone()
    d = 1
    while d < T:
        An, Un = Ag.clone(), Ug.clone()
        if reverse:
            Un[:, :-d] = Ug[:, :-d] + Ag[:, :-d] * Ug[:, d:]
            An[:, :-d] = Ag[:, d:] * Ag[:, :-d]
        else:
            Un[:, d:] = Ug[:, d:] + Ag[:, d:] * Ug[:, :-d]
            An[:, d:] = Ag[:, :-d] * Ag[:, d:]
        Ag, Ug = An, Un
        d *= 2
    carry = torch.zeros_like(Ug)
    if reverse:
        carry[:, :-1] = Ug[:, 1:]
    else:
        carry[:, 1:] = Ug[:, :-1]
    return (y + p * carry[..., None]).reshape(B, T * c)


def _maxplus_scan(m, dec, c):
    """S[j] = max(m[j], S[j-1] - dec[j]) along the last axis of (B, T*c),
    S[0] = m[0]: as :func:`_lin_scan`, with ``_maxplus_scan``'s combine
    (max(v_y, v_x - d_y), d_x + d_y)."""
    B = m.shape[0]
    M, Dd = m.reshape(B, T, c), dec.reshape(B, T, c)
    s, D = torch.empty_like(M), torch.empty_like(Dd)
    s[..., 0], D[..., 0] = M[..., 0], Dd[..., 0]
    for k in range(1, c):
        s[..., k] = _mx(M[..., k], s[..., k - 1] - Dd[..., k])
        D[..., k] = D[..., k - 1] + Dd[..., k]
    V, Dg = s[..., -1].clone(), D[..., -1].clone()
    d = 1
    while d < T:
        Vn, Dn = V.clone(), Dg.clone()
        Vn[:, d:] = _mx(V[:, d:], V[:, :-d] - Dg[:, d:])
        Dn[:, d:] = Dg[:, :-d] + Dg[:, d:]
        V, Dg = Vn, Dn
        d *= 2
    out = s.clone()
    out[:, 1:] = _mx(s[:, 1:], V[:, :-1, None] - D[:, 1:])
    return out.reshape(B, T * c)


def _tree_sum(x, c):
    """Row sums of (B, T*c): sequential in each segment, then a pairwise
    tree over the T segment sums."""
    B = x.shape[0]
    X = x.reshape(B, T, c)
    acc = X[..., 0].clone()
    for k in range(1, c):
        acc = acc + X[..., k]
    h = T // 2
    while h:
        acc[:, :h] = acc[:, :h] + acc[:, h: 2 * h]
        h //= 2
    return acc[:, 0]


def ss_expand(lut, roff, coff):
    """The dense (B, Lq+1, Wj) SS factors of the table form: one
    gather, ``lut[roff[b, i] + coff[b, j]]``, entry 0 where ``coff < 0``."""
    roff = torch.as_tensor(roff).to(torch.long)
    coff = torch.as_tensor(coff).to(torch.long)
    idx = torch.where(coff[:, None, :] < 0, 0,
                      roff[:, :, None] + coff[:, None, :])
    return torch.as_tensor(lut)[idx]


def _ss_dense(ss_f, ss_table):
    """The plain versions' SS factors: ``ss_f``, or the table expanded."""
    if ss_table is None:
        return ss_f
    if ss_f is not None:
        raise ValueError("give the SS factors dense or as a table, not both")
    return ss_expand(*ss_table)


def _profile_dot(qp, tp, W):
    """PF[b, i, j] = sum_a qp[i, a] * tp[b, j, a], a in order (the
    kernels' sum), columns past tp's padded to W with zeros."""
    q = qp[None, :, None, :]
    t = _pad_cols(tp.transpose(1, 2), W).transpose(1, 2)[:, None]
    acc = q[..., 0] * t[..., 0]
    for a in range(1, 20):
        acc = acc + q[..., a] * t[..., a]
    return acc


def _inputs(qp, qtr, tp, ttr, co, cshift, ss_f):
    """Shared set-up of the plain R1/R2: padded profile products PF1 =
    PF * Cshift and PFC = PF1 * ss, okf (open cells as 1.0, column 0
    closed), template transition rows padded to W."""
    B, Li, Wj = co.shape
    c, W = seg_layout(Wj)
    f32 = torch.float32
    cs = torch.tensor(cshift, dtype=f32, device=tp.device)
    PF1 = _profile_dot(qp[:Li].to(f32), tp[:, :Wj].to(f32), W) * cs
    PFC = PF1 * _pad_cols(ss_f.to(f32), W) if ss_f is not None else PF1
    okf = _pad_cols((~co).to(f32), W)
    okf[:, :, 0] = 0.0
    tt = _pad_cols(ttr[:, :Wj].to(f32).transpose(1, 2), W)   # (B, 7, W)
    return c, W, PF1, PFC, okf, tt


def _last_col(t_L, B, Wj, dev):
    """Each lane's last column (B,) long: ``t_L``, or Lt for every lane."""
    if t_L is None:
        return torch.full((B,), Wj - 1, dtype=torch.long, device=dev)
    return torch.as_tensor(t_L).to(dev, torch.long)


def fb_forward_plain(qp, qtr, tp, ttr, co, cshift, ss_f=None, ss0=None,
                     local=True, t_L=None, ss_table=None):
    """Plain PyTorch version of R1 (any device).  qp (Lq+2, 20), qtr
    (Lq+2, 7) linear query transitions; tp (B, Lt+2, 20), ttr (B, Lt+2,
    7) linear template transitions; co (B, Lq+1, Lt+1) bool cell-off;
    ``cshift`` = 2^shift as an f32 value; ss_f (B, Lq+1, Lt+1) optional
    SS factors (or ``ss_table``, the table form) and ss0 (B,) the
    boundary column's factor; ``t_L`` (B,)
    each lane's true length, the column through which global mode's
    rows above Lq exit (None: column Lt for every lane).  Returns the
    forward MM matrix (B, Lq+1, Lt+1), the row scales (B, Lq+2): three
    ones, then scale[i+1] of rows i = 2..Lq, and Pforward (B,)."""
    B, Li, Wj = co.shape
    Lq = Li - 1
    dev = tp.device
    f32 = torch.float32
    c, W, PF1, PFC, okf, tt = _inputs(qp, qtr, tp, ttr, co, cshift,
                                      _ss_dense(ss_f, ss_table))
    q = qtr.to(f32)
    t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd = (
        tt[:, k] for k in (M2M, M2I, M2D, I2M, I2I, D2M, D2D))
    s0 = (ss0.to(f32) if ss0 is not None
          else torch.ones(B, dtype=f32, device=dev))
    fwd = torch.zeros((B, Li, W), dtype=f32, device=dev)
    scales = torch.ones((B, Lq + 2), dtype=f32, device=dev)
    lc = _last_col(t_L, B, Wj, dev)[:, None]

    # row 1: MM = match probability without the SS factor; the IM and
    # GD prefix chains without the cell-off factor (as the JAX package)
    mm = PF1[:, 1] * okf[:, 1]
    im = _lin_scan((_sr(mm) * q[1, M2I]) * _sr(t_mm), q[1, I2I] * _sr(t_mm),
                   c)
    gd = _lin_scan(_sr(mm) * _sr(t_md), _sr(t_dd), c)
    mi = torch.zeros_like(mm)
    dg = torch.zeros_like(mm)
    fwd[:, 1] = mm
    pfwd = (1.0 + _tree_sum(mm, c) if local
            else mm.gather(1, lc)[:, 0])
    pmin = torch.full((B,), 1.0 if local else 0.0, dtype=f32, device=dev)
    scale_i = torch.ones(B, dtype=f32, device=dev)
    scale_prod = torch.ones(B, dtype=f32, device=dev)
    for i in range(2, Lq + 1):
        scale_prod = torch.where(scale_prod < FLUSH, 0.0,
                                 scale_prod * scale_i)
        qmm, qim, qdm = q[i - 1, M2M], q[i - 1, I2M], q[i - 1, D2M]
        qmd, qdd = q[i - 1, M2D], q[i - 1, D2D]
        qmi, qii = q[i, M2I], q[i, I2I]
        si = scale_i[:, None]
        ok = okf[:, i]
        acc = pmin[:, None] + (_sr(mm) * qmm) * _sr(t_mm)
        acc = acc + (_sr(gd) * qmm) * _sr(t_dm)
        acc = acc + (_sr(im) * qim) * _sr(t_mm)
        acc = acc + (_sr(dg) * qdm) * _sr(t_mm)
        acc = acc + (_sr(mi) * qmm) * _sr(t_im)
        mm_n = (PFC[:, i] * si) * acc
        # jmin cell: a fresh start scaled by the cumulative product, with
        # the boundary SS factor instead of ss(i, 1)
        mm_n[:, 1] = (scale_prod * s0) * PF1[:, i, 1]
        mm_n = mm_n * ok
        dg_n = (si * ((mm * qmd) + (dg * qdd))) * ok
        mi_n = (si * (((mm * qmm) * t_mi) + ((mi * qmm) * t_ii))) * ok
        mm, dg, mi = mm_n, dg_n, mi_n
        gd = _lin_scan((_sr(mm) * _sr(t_md)) * ok, _sr(t_dd) * ok, c)
        im = _lin_scan(((_sr(mm) * qmi) * _sr(t_mm)) * ok,
                       (qii * _sr(t_mm)) * ok, c)
        fwd[:, i] = mm
        # Pmax over j >= 2 only (hhforwardalgorithm.cpp:139-143)
        pmax = mm.clone()
        pmax[:, 1] = 0.0
        pmax = pmax.amax(dim=1)
        pmax = _mx(pmax, torch.zeros_like(pmax))
        scale_next = 1.0 / (pmax + 1.0)
        if local or i == Lq:
            pfwd = (pfwd + _tree_sum(mm, c)) * scale_next
        else:
            pfwd = (pfwd + mm.gather(1, lc)[:, 0]) * scale_next
        pmin = pmin * scale_i
        pmin = torch.where(pmin < FLUSH, 0.0, pmin)
        scales[:, i + 1] = scale_next
        scale_i = scale_next
    return fwd[..., :Wj].contiguous(), scales, pfwd


def _posterior(fw, bw, ok, P):
    return torch.where(ok > 0, (fw * bw) / P[:, None], 0.0)


def fb_backward_plain(qp, qtr, tp, ttr, co, cshift, fwd, scales, pfwd,
                      ss_f=None, local=True, t_L=None, ss_table=None):
    """Plain PyTorch version of R2 (any device): the Backward rows from
    the last query row up, each turned into its posterior row p_mm = fwd
    * bwd / Pforward on open cells (0 elsewhere and in column 0).
    ``fwd``, ``scales``, ``pfwd``: R1's outputs; ``t_L`` as R1's (global
    mode resets each lane's own last column; local mode column Lt, as the
    JAX package: the columns past a lane's are off, so both give the
    same rows); ``ss_f`` / ``ss_table`` as R1's.  Returns p_mm (B, Lq+1,
    Lt+1)."""
    B, Li, Wj = co.shape
    Lq = Li - 1
    f32 = torch.float32
    c, W, _PF1, PFC, okf, tt = _inputs(qp, qtr, tp, ttr, co, cshift,
                                       _ss_dense(ss_f, ss_table))
    q = qtr.to(f32)
    t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd = (
        tt[:, k] for k in (M2M, M2I, M2D, I2M, I2I, D2M, D2D))
    fw = _pad_cols(fwd, W)
    pmm = torch.zeros((B, Li, W), dtype=f32, device=fwd.device)
    sLq1 = scales[:, Lq + 1]
    n_mm = sLq1[:, None] * okf[:, Lq]
    n_dg = torch.zeros_like(n_mm)
    n_mi = torch.zeros_like(n_mm)
    pmm[:, Lq] = _posterior(fw[:, Lq], n_mm, okf[:, Lq], pfwd)
    scale_prod = sLq1.clone()
    pmin = sLq1.clone() if local else torch.zeros_like(sLq1)
    lc = _last_col(None if local else t_L, B, Wj, fwd.device)[:, None]
    for i in range(Lq - 1, 0, -1):
        si1 = scales[:, i + 1]
        scale_prod = scale_prod * si1
        scale_prod = torch.where(scale_prod < FLUSH, 0.0, scale_prod)
        pmin = pmin * si1
        pmin = torch.where(pmin < FLUSH, 0.0, pmin)
        qmm, qim, qii, qmi = q[i, M2M], q[i, I2M], q[i, I2I], q[i, M2I]
        qmd, qdd, qdm = q[i, M2D], q[i, D2D], q[i, D2M]
        s1 = si1[:, None]
        ok = okf[:, i]
        pm = _sl(n_mm * PFC[:, i + 1]) * s1
        gd = _lin_scan(((pm * qmm) * t_dm) * ok, t_dd * ok, c, reverse=True)
        im = _lin_scan(((pm * qim) * t_mm) * ok, (qii * t_mm) * ok, c,
                       reverse=True)
        acc = pmin[:, None] + (pm * qmm) * t_mm
        acc = acc + _sl(gd) * t_md
        acc = acc + (_sl(im) * qmi) * t_mm
        acc = acc + (n_dg * qmd) * s1
        acc = acc + ((n_mi * qmm) * t_mi) * s1
        mm = acc * ok
        dg = (((pm * qdm) * t_mm) + ((n_dg * qdd) * s1)) * ok
        mi = (((pm * qmm) * t_im) + (((n_mi * qmm) * t_ii) * s1)) * ok
        # column Lt: the suffix starts here with the cumulative scale
        mm.scatter_(1, lc, (scale_prod[:, None] * ok.gather(1, lc)))
        pmm[:, i] = _posterior(fw[:, i], mm, ok, pfwd)
        n_mm, n_dg, n_mi = mm, dg, mi
    return pmm[..., :Wj].contiguous()


def mac_dp_plain(p_mm, co, mact, local=True, t_L=None):
    """Plain PyTorch version of R3 (any device): the MAC rows
    S(i, j) = max(p - mact, S(i-1, j-1) + p - mact, S(i-1, j) - mact/2,
    S(i, j-1) - mact/2) with off cells at -FLT_MIN (decay 1e30) and
    column 0 at 0, the backtrace codes (ties STOP < MM < MI < IM, off
    cells and column 0 STOP, row 0 zeros) and the first row-major argmax
    over open cells with i, j >= 1 (in global mode only row Lq and each
    lane's column ``t_L`` (B,), else column Lt); no open cell gives
    (0, 0).  Returns b_mac (B, Lq+1, Lt+1) uint8, i2, j2 (B,) int32."""
    B, Li, Wj = p_mm.shape
    Lq = Li - 1
    dev = p_mm.device
    f32 = torch.float32
    c, W = seg_layout(Wj)
    post = _pad_cols(p_mm.to(f32), W)
    ok = _pad_cols(~co, W, value=False)
    mact = torch.tensor(float(np.float32(mact)), dtype=f32, device=dev)
    half = 0.5 * mact
    S = torch.zeros((B, W), dtype=f32, device=dev)
    S_all = torch.full((B, Li, W), -FLT_MAX, dtype=f32, device=dev)
    b = torch.zeros((B, Li, W), dtype=torch.uint8, device=dev)
    neg = torch.tensor(-FLT_MIN, dtype=f32, device=dev)
    for i in range(1, Lq + 1):
        po, ok_i = post[:, i], ok[:, i]
        t1 = po - mact
        t2 = (_sr(S) + po) - mact
        t3 = S - half
        v = torch.where(t1 > t2, STOP, MM)
        mx = _mx(t1, t2)
        v = torch.where(t3 > mx, MI, v)
        mx = _mx(mx, t3)
        m = torch.where(ok_i, mx, neg)
        m[:, 0] = 0.0
        dec = torch.where(ok_i, half, torch.tensor(1e30, dtype=f32,
                                                    device=dev))
        S = torch.where(ok_i, _maxplus_scan(m, dec, c), neg)
        S[:, 0] = 0.0
        v = torch.where(_sr(S) - half > mx, IM, v)
        bi = torch.where(ok_i, v, STOP).to(torch.uint8)
        bi[:, 0] = STOP
        b[:, i] = bi
        S_all[:, i] = S
    Sm = torch.where(ok, S_all, -FLT_MAX)[..., :Wj]
    if not local:
        lastcol = (torch.as_tensor(t_L).to(dev, torch.long)[:, None, None]
                   if t_L is not None else Wj - 1)
        jj = torch.arange(Wj, device=dev)[None, None, :]
        gmask = (jj == lastcol).expand(B, Li, Wj).clone()
        gmask[:, Lq] = True
        Sm = torch.where(gmask, Sm, -FLT_MAX)
    Sm[:, 0] = -FLT_MAX
    Sm[:, :, 0] = -FLT_MAX
    flat = Sm.reshape(B, -1)
    kbest = torch.argmax(flat, dim=1)
    none = flat.gather(1, kbest[:, None])[:, 0] <= -FLT_MAX
    i2 = torch.where(none, 0, kbest // Wj).to(torch.int32)
    j2 = torch.where(none, 0, kbest % Wj).to(torch.int32)
    return b[..., :Wj].contiguous(), i2, j2


def mac_walk(b_mac, p_mm, i2, j2, kmax):
    """MAC backtrace (hhbacktracemac.cpp:111-185) batched over lanes,
    with the path posteriors, any device: the JAX package's ``mac_walk``
    step by step.  Applies the reference's pre-masking (column 1 and
    row 1 forced STOP).  Returns (states (B, kmax) uint8, ii, jj (B,
    kmax) int16, post (B, kmax) f32, n (B,) recorded steps, mm_count
    (B,), empty (B,) bool for the b[i2, j2] != MM case).  The terminal
    code is recorded as a step; after it every step repeats the stop
    cell."""
    B, Li, Wj = b_mac.shape
    dev = b_mac.device
    b = b_mac.to(torch.int32).clone()
    b[:, :, 1] = STOP
    b[:, 1, 1:] = STOP
    bf = b.reshape(B, Li * Wj)
    pf = p_mm.reshape(B, Li * Wj).to(torch.float32)
    i = i2.to(dev, torch.long)
    j = j2.to(dev, torch.long)
    alive = bf.gather(1, (i * Wj + j)[:, None])[:, 0] == MM
    empty = ~alive
    st = torch.empty((B, kmax), dtype=torch.uint8, device=dev)
    ii = torch.empty((B, kmax), dtype=torch.int16, device=dev)
    jj = torch.empty((B, kmax), dtype=torch.int16, device=dev)
    post = torch.empty((B, kmax), dtype=torch.float32, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    mm_count = torch.zeros(B, dtype=torch.int32, device=dev)
    for k in range(kmax):
        idx = (i * Wj + j)[:, None]
        code = bf.gather(1, idx)[:, 0]
        st[:, k] = code.to(torch.uint8)
        ii[:, k] = i.to(torch.int16)
        jj[:, k] = j.to(torch.int16)
        post[:, k] = pf.gather(1, idx)[:, 0]
        is_mm = code == MM
        n += alive.to(torch.int32)
        mm_count += (is_mm & alive).to(torch.int32)
        go = alive & (is_mm | (code == IM) | (code == MI))
        i = i - (go & (is_mm | (code == MI))).to(torch.long)
        j = j - (go & (is_mm | (code == IM))).to(torch.long)
        alive = go
    return st, ii, jj, post, n, mm_count, empty


def _bytes(x, dtype):
    """(B, k) values of ``dtype`` as their (B, k * size) bytes."""
    return x.to(dtype).contiguous().view(torch.uint8).reshape(x.shape[0],
                                                              -1)


def mac_walk_packed8_plain(b_mac, p_mm, i2, j2, score, kmax):
    """Plain PyTorch version of R4 (any device): :func:`mac_walk` packed
    as the JAX ``mac_walk_packed8``: a (B, 12 + 5 * kmax) int8 row of
    [score f32, i2 int16, j2 int16, n int32, st[kmax] int8,
    post[kmax] f32], little-endian."""
    st, _ii, _jj, post, n, _mm, _empty = mac_walk(b_mac, p_mm, i2, j2,
                                                  kmax)
    score = torch.as_tensor(score).to(b_mac.device)
    return torch.cat([_bytes(score[:, None], torch.float32),
                      _bytes(i2[:, None], torch.int16),
                      _bytes(j2[:, None], torch.int16),
                      _bytes(n[:, None], torch.int32), st,
                      _bytes(post, torch.float32)], dim=1).view(torch.int8)


def mac_walk_unpack8(packed, kmax):
    """Host unpack of :func:`mac_walk_packed8`'s payload (numpy).
    Returns (score, i2, j2, n, mm_count, empty, st, ii, jj, post) with
    the wide :func:`mac_walk` semantics: step positions follow from the
    state codes (MM: -1, -1; IM: 0, -1; MI: -1, 0)."""
    packed = np.ascontiguousarray(np.asarray(packed))
    score = packed[:, 0:4].copy().view(np.float32)[:, 0]
    i2 = packed[:, 4:6].copy().view(np.int16)[:, 0].astype(np.int32)
    j2 = packed[:, 6:8].copy().view(np.int16)[:, 0].astype(np.int32)
    n = packed[:, 8:12].copy().view(np.int32)[:, 0]
    nmax = max(int(n.max()) if n.size else 0, 1)
    st = packed[:, 12: 12 + nmax]
    post = packed[:, 12 + kmax: 12 + kmax + 4 * nmax].copy().view(
        np.float32)
    di = ((st == MM) | (st == MI)).astype(np.int32)
    dj = ((st == MM) | (st == IM)).astype(np.int32)
    ii = i2[:, None] - np.cumsum(di, axis=1) + di
    jj = j2[:, None] - np.cumsum(dj, axis=1) + dj
    live = np.arange(nmax)[None, :] < n[:, None]
    mm_count = ((st == MM) & live).sum(axis=1)
    empty = n == 0
    return score, i2, j2, n, mm_count, empty, st, ii, jj, post


def realign_mask_device(rect, corner_j0, tL, loF_c, hiF_c, loF_r, hiF_r,
                        loE_c, hiE_c, loE_r, hiE_r):
    """The realign cell-off corridor from its interval form
    (search/posterior.py:RealignMaskSpec), pointwise compares on the
    intervals' device.  rect (B, 4) = (i1, j1, i2, j2); corner_j0, tL
    (B,); F intervals (B, Wj) / (B, Li); E intervals (B, P, Wj) /
    (B, P, Li).  Returns (B, Li, Wj) bool (True = cell off)."""
    P = loE_c.shape[1]
    Li, Wj = loF_r.shape[1], loF_c.shape[1]
    dev = rect.device
    i = torch.arange(Li, dtype=torch.int32, device=dev)[None, :, None]
    j = torch.arange(Wj, dtype=torch.int32, device=dev)[None, None, :]
    r = rect.to(torch.int32)
    i1, j1, i2, j2 = (r[:, k, None, None] for k in range(4))

    def band(lo_c, hi_c, lo_r, hi_r):
        return (((i >= lo_c[:, None, :]) & (i <= hi_c[:, None, :]))
                | ((j >= lo_r[:, :, None]) & (j <= hi_r[:, :, None])))

    base = ~(((i < i1) & (j < j1)) | ((i > i2) & (j > j2)))
    co = base & ~band(loF_c, hiF_c, loF_r, hiF_r)
    for p in range(P):
        co = co | band(loE_c[:, p], hiE_c[:, p], loE_r[:, p], hiE_r[:, p])
    # column 0 open, row 0 the corner remnant, padding columns closed
    co[:, :, 0] = False
    co[:, 0, :] = j[:, 0, :] >= corner_j0.to(torch.int32)[:, None]
    return co | (j > tL.to(torch.int32)[:, None, None])


def forward_score(scales, pfwd, Lq: int, Lt: int, local: bool) -> np.ndarray:
    """The Forward score log2(Pforward) - 10 - sum log2(scale) (local:
    minus log(Lt * Lq) / lambda + 14) in numpy f32 on the host, the same
    code for both devices' R1 outputs."""
    sc = np.asarray(scales.cpu(), dtype=np.float32)[:, 3:]
    P = np.asarray(pfwd.cpu(), dtype=np.float32)
    acc = np.zeros(P.shape[0], np.float32)
    for r in range(sc.shape[1]):
        acc = acc + np.log2(sc[:, r])
    with np.errstate(divide="ignore"):    # Pforward 0: a padding lane
        score = np.log2(P) - np.float32(10.0) - acc
    if local:
        score = score - np.float32(float(np.log(Lt * Lq) / LAMDA + 14.0))
    return score.astype(np.float32)


# ---------------------------------------------------------- kernels ----

def bind(lib):
    """Set the C signatures of ``csrc/posterior.cu``'s entry points."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hh_post_forward.argtypes = [P, P, P, P, P, P, P, I, P, P, P, P, I,
                                    I, I, Fl, I, P, I, P, P, P, P]
    lib.hh_post_backward.argtypes = [P, P, P, P, P, P, P, I, P, P, P, P, P,
                                     P, I, I, I, Fl, I, P, I, P, P]
    lib.hh_post_mac.argtypes = [P, P, P, I, I, I, Fl, I, P, I, P, P, P, P]
    lib.hh_post_walk.argtypes = [P, P, P, P, P, I, I, I, I, P, P]
    for fn in ("hh_post_forward", "hh_post_backward", "hh_post_mac",
               "hh_post_walk"):
        getattr(lib, fn).restype = I
    lib.hh_post_lane_floats.argtypes = [I, I]
    lib.hh_post_lane_floats.restype = ctypes.c_longlong
    lib.hh_post_error_string.argtypes = [I]
    lib.hh_post_error_string.restype = ctypes.c_char_p
    return lib


def cuda_lib():
    """The built ``csrc/posterior.cu`` library with its C signatures."""
    from ..device import cuda_library

    lib, _info = cuda_library("posterior")
    if not _BOUND.get(id(lib)):
        bind(lib)
        _BOUND[id(lib)] = True
    return lib


def _require_cuda(x) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"posterior kernels take CPU or CUDA tensors, not "
                         f"{x.device}")
    return x.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{lib.hh_post_error_string(abs(rc)).decode()}")


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _f32(x, dev, shape, what):
    """A contiguous, 16-byte aligned f32 tensor on ``dev`` of ``shape``
    (the kernels read rows of 20 floats as float4), or raise."""
    if x.device != dev or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {tuple(shape)} on {dev}, got "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.to(torch.float32).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _lane_arrays(lib, kind: int, B: int, Wj: int, dev):
    """(dynamic shared bytes, scratch): a CTA's row arrays in shared
    memory when they fit :data:`SMEM_MAX`, else in a global scratch of
    B lanes."""
    n = int(lib.hh_post_lane_floats(kind, Wj))
    if n == 0:                         # R1-R3 in registers
        return 0, None
    if n * 4 <= SMEM_MAX:
        return n * 4, None
    return 0, torch.empty(B * n, dtype=torch.float32, device=dev)


def _int32_2d(x, dev, shape, what):
    if x.device != dev or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {tuple(shape)} on {dev}, got "
                         f"{tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def _table(ss_table, dev, B, Li, Wj):
    """The table form's (lut, n_lut, roff, coff) for the kernels, or
    Nones."""
    if ss_table is None:
        return None, 0, None, None
    lut, roff, coff = ss_table
    if lut.device != dev or lut.dim() != 1 or not 1 <= lut.numel() <= \
            SS_LUT_MAX:
        raise ValueError(f"SS table: 1 to {SS_LUT_MAX} entries on {dev}")
    return (lut.to(torch.float32).contiguous(), lut.numel(),
            _int32_2d(roff, dev, (B, Li), "roff"),
            _int32_2d(coff, dev, (B, Wj), "coff"))


def _common(qp, qtr, tp, ttr, co, ss_f, ss_table=None):
    dev = _require_cuda(tp)
    B, Li, Wj = co.shape
    Lq = Li - 1
    if Lq < 1 or Wj < 2:
        raise ValueError(f"realign batch needs Lq >= 1 and Lt >= 1, got "
                         f"co {tuple(co.shape)}")
    qp = _f32(qp, dev, (Lq + 2, 20), "qp")
    qtr = _f32(qtr, dev, (Lq + 2, 7), "qtr")
    tp = _f32(tp, dev, (B, Wj + 1, 20), "tp")
    ttr = _f32(ttr, dev, (B, Wj + 1, 7), "ttr")
    if co.device != dev or co.dtype != torch.bool:
        raise ValueError("co must be a bool tensor on the kernels' device")
    co = co.contiguous()
    if ss_f is not None:
        if ss_table is not None:
            raise ValueError("give the SS factors dense or as a table, "
                             "not both")
        ss_f = _f32(ss_f, dev, (B, Li, Wj), "ss_f")
    return (dev, B, Lq, Wj, qp, qtr, tp, ttr, co, ss_f,
            _table(ss_table, dev, B, Li, Wj))


def _int32(t_L, dev):
    return (None if t_L is None
            else torch.as_tensor(t_L).to(dev, torch.int32).contiguous())


def _launch_forward(qp, qtr, tp, ttr, co, cshift, ss_f, ss0, local, t_L,
                    ss_table=None):
    (dev, B, Lq, Wj, qp, qtr, tp, ttr, co, ss_f,
     (lut, n_lut, roff, coff)) = _common(qp, qtr, tp, ttr, co, ss_f,
                                         ss_table)
    if ss0 is not None:
        ss0 = _f32(ss0, dev, (B,), "ss0")
    tl = _int32(t_L, dev)
    lib = cuda_lib()
    fwd = torch.empty((B, Lq + 1, Wj), dtype=torch.float32, device=dev)
    scales = torch.empty((B, Lq + 2), dtype=torch.float32, device=dev)
    pfwd = torch.empty(B, dtype=torch.float32, device=dev)
    smem, scratch = _lane_arrays(lib, 0, B, Wj, dev)
    rc = lib.hh_post_forward(
        qp.data_ptr(), qtr.data_ptr(), tp.data_ptr(), ttr.data_ptr(),
        co.data_ptr(), _ptr(ss_f), _ptr(lut), n_lut, _ptr(roff),
        _ptr(coff), _ptr(ss0), _ptr(tl), B, Lq, Wj, float(cshift),
        int(bool(local)), _ptr(scratch), smem, fwd.data_ptr(),
        scales.data_ptr(), pfwd.data_ptr(), _stream(dev))
    _check(lib, rc, "R1 fb_forward")
    fb_forward.launches += 1
    return fwd, scales, pfwd


def _launch_backward(qp, qtr, tp, ttr, co, cshift, fwd, scales, pfwd, ss_f,
                     local, t_L, ss_table=None):
    (dev, B, Lq, Wj, qp, qtr, tp, ttr, co, ss_f,
     (lut, n_lut, roff, coff)) = _common(qp, qtr, tp, ttr, co, ss_f,
                                         ss_table)
    fwd = _f32(fwd, dev, (B, Lq + 1, Wj), "fwd")
    scales = _f32(scales, dev, (B, Lq + 2), "scales")
    pfwd = _f32(pfwd, dev, (B,), "pfwd")
    tl = _int32(t_L, dev)
    lib = cuda_lib()
    pmm = torch.empty((B, Lq + 1, Wj), dtype=torch.float32, device=dev)
    smem, scratch = _lane_arrays(lib, 1, B, Wj, dev)
    rc = lib.hh_post_backward(
        qp.data_ptr(), qtr.data_ptr(), tp.data_ptr(), ttr.data_ptr(),
        co.data_ptr(), _ptr(ss_f), _ptr(lut), n_lut, _ptr(roff),
        _ptr(coff), fwd.data_ptr(), scales.data_ptr(), pfwd.data_ptr(),
        _ptr(tl), B, Lq, Wj, float(cshift), int(bool(local)),
        _ptr(scratch), smem, pmm.data_ptr(), _stream(dev))
    _check(lib, rc, "R2 fb_backward")
    fb_backward.launches += 1
    return pmm


def _launch_mac(p_mm, co, mact, local, t_L):
    dev = _require_cuda(p_mm)
    B, Li, Wj = p_mm.shape
    p_mm = _f32(p_mm, dev, (B, Li, Wj), "p_mm")
    if co.device != dev or co.dtype != torch.bool or co.shape != p_mm.shape:
        raise ValueError("co must be a bool tensor shaped as p_mm on its "
                         "device")
    co = co.contiguous()
    tl = _int32(t_L, dev)
    lib = cuda_lib()
    b_mac = torch.empty((B, Li, Wj), dtype=torch.uint8, device=dev)
    i2 = torch.empty(B, dtype=torch.int32, device=dev)
    j2 = torch.empty(B, dtype=torch.int32, device=dev)
    smem, scratch = _lane_arrays(lib, 2, B, Wj, dev)
    rc = lib.hh_post_mac(
        p_mm.data_ptr(), co.data_ptr(), _ptr(tl), B, Li - 1, Wj,
        float(np.float32(mact)), int(bool(local)), _ptr(scratch), smem,
        b_mac.data_ptr(), i2.data_ptr(), j2.data_ptr(), _stream(dev))
    _check(lib, rc, "R3 mac_dp")
    mac_dp.launches += 1
    return b_mac, i2, j2


def _launch_walk(b_mac, p_mm, i2, j2, score, kmax):
    dev = _require_cuda(b_mac)
    B, Li, Wj = b_mac.shape
    if b_mac.dtype != torch.uint8 or kmax < 1:
        raise ValueError("b_mac must be uint8 and kmax >= 1")
    b_mac = b_mac.contiguous()
    p_mm = _f32(p_mm, dev, (B, Li, Wj), "p_mm")
    i2 = i2.to(dev, torch.int32).contiguous()
    j2 = j2.to(dev, torch.int32).contiguous()
    score = _f32(torch.as_tensor(score).to(dev), dev, (B,), "score")
    lib = cuda_lib()
    out = torch.empty((B, 12 + 5 * kmax), dtype=torch.int8, device=dev)
    rc = lib.hh_post_walk(b_mac.data_ptr(), p_mm.data_ptr(), i2.data_ptr(),
                          j2.data_ptr(), score.data_ptr(), B, Li - 1, Wj,
                          int(kmax), out.data_ptr(), _stream(dev))
    _check(lib, rc, "R4 mac_walk_packed8")
    mac_walk_packed8.launches += 1
    return out


# ---------------------------------------------------------- public ----

def fb_forward(qp, qtr, tp, ttr, co, cshift, ss_f=None, ss0=None,
               local=True, t_L=None, ss_table=None):
    """R1: (fwd MM (B, Lq+1, Lt+1), scales (B, Lq+2), Pforward (B,));
    see :func:`fb_forward_plain`."""
    if tp.device.type == "cpu":
        return fb_forward_plain(qp, qtr, tp, ttr, co, cshift, ss_f, ss0,
                                local, t_L, ss_table)
    return _launch_forward(qp, qtr, tp, ttr, co, cshift, ss_f, ss0, local,
                           t_L, ss_table)


fb_forward.launches = 0


def fb_backward(qp, qtr, tp, ttr, co, cshift, fwd, scales, pfwd, ss_f=None,
                local=True, t_L=None, ss_table=None):
    """R2: the posterior p_mm (B, Lq+1, Lt+1); see
    :func:`fb_backward_plain`."""
    if tp.device.type == "cpu":
        return fb_backward_plain(qp, qtr, tp, ttr, co, cshift, fwd, scales,
                                 pfwd, ss_f, local, t_L, ss_table)
    return _launch_backward(qp, qtr, tp, ttr, co, cshift, fwd, scales, pfwd,
                            ss_f, local, t_L, ss_table)


fb_backward.launches = 0


def mac_dp(p_mm, co, mact, local=True, t_L=None):
    """R3: (b_mac, i2, j2); see :func:`mac_dp_plain`."""
    if p_mm.device.type == "cpu":
        return mac_dp_plain(p_mm, co, mact, local, t_L)
    return _launch_mac(p_mm, co, mact, local, t_L)


mac_dp.launches = 0


def mac_walk_packed8(b_mac, p_mm, i2, j2, score, kmax):
    """R4: the packed walk payload (B, 12 + 5 * kmax) int8; see
    :func:`mac_walk_packed8_plain`."""
    if b_mac.device.type == "cpu":
        return mac_walk_packed8_plain(b_mac, p_mm, i2, j2, score, kmax)
    return _launch_walk(b_mac, p_mm, i2, j2, score, kmax)


mac_walk_packed8.launches = 0


def fb_mac_rows(qp, qtr_lin, tp, ttr_lin, co, shift, mact, ss_fpow2=None,
                ss0_fpow2=None, local=True, t_L=None, ss_table=None):
    """Forward + Backward + MAC for a batch of hits, without the score:
    R1, R2 and R3 (the realign path's form; it keeps the search scores).
    The SS factors come dense (``ss_fpow2``) or as ``ss_table``.
    Returns (b_mac (B, Lq+1, Lt+1) uint8, i2, j2 (B,) int32, p_mm (B,
    Lq+1, Lt+1) f32, R1's scales (B, Lq+2) and Pforward (B,)), all on the
    inputs' device."""
    cshift = float(np.exp2(np.float32(shift)))
    fwd, scales, pfwd = fb_forward(qp, qtr_lin, tp, ttr_lin, co, cshift,
                                   ss_fpow2, ss0_fpow2, local, t_L,
                                   ss_table)
    p_mm = fb_backward(qp, qtr_lin, tp, ttr_lin, co, cshift, fwd, scales,
                       pfwd, ss_fpow2, local, t_L, ss_table)
    del fwd
    b_mac, i2, j2 = mac_dp(p_mm, co, mact, local, t_L)
    return b_mac, i2, j2, p_mm, scales, pfwd


def fb_mac_batch(qp, qtr_lin, tp, ttr_lin, co, shift, mact, ss_fpow2=None,
                 ss0_fpow2=None, local=True, t_L=None, ss_table=None):
    """Forward + Backward + MAC for a batch of hits (the JAX
    ``fb_mac_batch`` signature, torch tensors on one device):
    :func:`fb_mac_rows` and the Forward score from R1's outputs on the
    host.  ``t_L`` (B,) gives each lane's true length: in global mode
    its exits (Forward, Backward and the argmax) are at that column, so
    a padded lane decodes as its unpadded template does; ``ss_table`` the
    table form of the SS factors.  Returns (score
    (B,) f32, b_mac (B, Lq+1, Lt+1) uint8, i2, j2 (B,) int32, p_mm (B,
    Lq+1, Lt+1) f32), all on the inputs' device."""
    b_mac, i2, j2, p_mm, scales, pfwd = fb_mac_rows(
        qp, qtr_lin, tp, ttr_lin, co, shift, mact, ss_fpow2, ss0_fpow2,
        local, t_L, ss_table)
    Lq, Lt = co.shape[1] - 1, co.shape[2] - 1
    score = torch.from_numpy(forward_score(scales, pfwd, Lq, Lt, local))
    return score.to(tp.device), b_mac, i2, j2, p_mm
