"""Batched 5-pair-state Viterbi HMM-HMM alignment: the plain PyTorch
version, the backtrace walk (W1) and the host decoders.

:func:`viterbi_batch` reimplements the recurrence of
src/hhviterbialgorithm.cpp:45-497 as an anti-diagonal wavefront over a
batch of templates: on diagonal d = i+j every state depends only on
diagonals d-1 and d-2, so one step computes a whole diagonal of every
template with elementwise tensor ops, and each cell evaluates the same
float expression as the reference's row loop.  It is the port's exact
CPU path and the plain version of the backtrace kernels (K2, K3 in
``ops/viterbi_lanes.py`` and ``ops/viterbi_rows.py``): the CUDA kernels
compute every cell with the same operations in the same order, so the
two agree bit for bit.

The match score ``Si = log2f4(dot20(q_i, t_j)) + shift`` uses the
reference's SSE summation tree for the 20-term dot
(:func:`fastmath.scalar_prod20_torch`); maxima are ``a > b ? a : b``.

Outputs per lane: best score / end cell (i2, j2) (ties: score desc,
then i asc, then j asc — the reference's strictly-greater row-major
update, src/hhviterbialgorithm.cpp:423-455) and the backtrace byte
matrix (bits 0-2: MM predecessor code, bit3/4/5/6: GD/IM/DG/MI opened
from MM; src/hhviterbimatrix.h:29-85).

W1 :func:`backtrace_walk_packed8` replaces the JAX package's compiled
walks (hhsuite_tpu/ops/viterbi.py:_backtrace_walk_packed8,
backtrace_walk_packed8_words): from each lane's best cell over its
backtrace bytes into a packed payload of state bytes, read by
:func:`backtrace_walk_unpack8` and the native decoder.  On a CPU tensor
it runs its plain version (:func:`backtrace_walk_packed8_plain`, a loop
of torch ops); on a CUDA tensor it launches ``csrc/viterbi.cu:
bt_walk_kernel`` (a team of lanes a walk, walking tiles of bt staged in
shared memory) or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fastmath import log2f4_torch, scalar_prod20_torch

FLT_MAX = float(np.finfo(np.float32).max)

M2M, M2I, M2D, I2M, I2I, D2M, D2D = range(7)
STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6


def fmax(a, b):
    """``a > b ? a : b`` elementwise, as the CUDA kernels compute it."""
    return torch.where(a > b, a, b)


def _up(x, neg):
    """Shift a (B, Wi) diagonal vector down one row (row i gets i-1)."""
    return torch.cat([neg[:, :1], x[:, :-1]], dim=1)


def _diag_index(d: int, Wi: int, Lt: int, device):
    """Row/column indices of diagonal ``d`` over rows 0..Wi-1, the
    on-grid mask (1 <= i, 1 <= j <= Lt) and clamped column indices for
    the columns j and j-1."""
    ii = torch.arange(Wi, device=device)
    jj = d - ii
    on = (ii >= 1) & (jj >= 1) & (jj <= Lt)
    return ii, jj, on, jj.clamp(0, Lt + 1), (jj - 1).clamp(0, Lt + 1)


def diag_si(qrow, tp, jc, shift, exact=True, sh_fast=None):
    """Match scores of one diagonal: (B, Wi) ``log2(dot20) + shift``
    (``exact``: log2f4) or the K1 ``fast`` quartic with its folded
    constant ``sh_fast`` = shift - 127."""
    from ..fastmath import log2_quartic_torch

    dot = scalar_prod20_torch(qrow[None], tp[:, jc])
    if exact:
        return log2f4_torch(dot) + shift
    return log2_quartic_torch(dot, sh_fast)


def viterbi_batch(qp, qtr, tp, ttr, cell_off, t_L, shift, smin_local=0.0,
                  penalty_gap_query=0.0, penalty_gap_template=0.0,
                  ss_score=None, local=True, Lq_true: Optional[int] = None,
                  ss_lut=None, ss_qidx=None, ss_tidx=None):
    """Align one query against a batch of templates (torch, any device).

    Args:
      qp:   (Lq+2, 20) f32 query odds profile (already divided by null)
      qtr:  (Lq+2, 7)  f32 query log2 transitions
      tp:   (B, Lt+2, 20) f32 template odds profiles (padded cols = 0)
      ttr:  (B, Lt+2, 7)  f32 template transitions (padded cols = -FLT_MAX)
      cell_off: (B, Lq+1, Lt+1) bool, True = forbidden cell, or None
      t_L:  (B,) int32 true template lengths
      shift: score offset per aligned pair (par.shift)
      ss_score: optional (B, Lq+1, Lt+1) f32 secondary-structure score
        added to the match score (already weighted by ssw)
      ss_lut, ss_qidx, ss_tidx: the same term as a table (the form of
        search/viterbi_search.py:build_ss_lut): ss(b, i, j) =
        ss_lut[ss_qidx[i-1] + ss_tidx[b, j-1]] for 1 <= j <= t_L[b],
        else 0 — the values build_ss_score writes; pass it or ss_score
      local: Smith-Waterman vs global
      Lq_true: rows above it are query-length padding and never win the
        best cell (default: every row is real)
    Returns (score (B,) f32, i2 (B,) i32, j2 (B,) i32,
    bt (B, Lq+1, Lt+1) u8).
    """
    dev = tp.device
    f32 = torch.float32
    qp = qp.to(dev, f32)
    qtr = qtr.to(dev, f32)
    tp = tp.to(f32)
    ttr = ttr.to(f32)
    Lq = qp.shape[0] - 2
    Lt = tp.shape[1] - 2
    B = tp.shape[0]
    Wi = Lq + 1
    lqt = Lq if Lq_true is None else int(Lq_true)
    NEG = -FLT_MAX
    sh = torch.tensor(np.float32(shift), device=dev)
    pq = torch.tensor(np.float32(penalty_gap_query), device=dev)
    pt = torch.tensor(np.float32(penalty_gap_template), device=dev)
    smin = torch.tensor(0.0 if local else NEG, dtype=f32, device=dev)
    negrow = torch.full((B, Wi), NEG, dtype=f32, device=dev)

    ii = torch.arange(Wi, device=dev)
    im1 = (ii - 1).clamp(min=0)
    qm2m_1 = qtr[im1, M2M][None]
    qd2m_1 = qtr[im1, D2M][None]
    qi2m_1 = qtr[im1, I2M][None]
    qm2d_1 = qtr[im1, M2D][None]
    qd2d_1 = qtr[im1, D2D][None]
    qm2i_0 = qtr[ii, M2I][None]
    qi2i_0 = qtr[ii, I2I][None]
    qrow = qp[:Wi]
    tL = t_L.to(dev, torch.int64)[:, None]
    iif = ii.to(f32)
    if ss_lut is not None:
        if ss_score is not None:
            raise ValueError("viterbi_batch: pass ss_score or ss_lut, "
                             "not both")
        # offset 0 at row 0 / column 0: off the grid, never read
        lut = ss_lut.to(dev, f32)
        qi = torch.cat([ss_qidx.new_zeros(1), ss_qidx]).to(dev, torch.int64)
        ti = torch.cat([ss_tidx.new_zeros((B, 1)), ss_tidx],
                       dim=1).to(dev, torch.int64)

    def boundary(d):
        j = d - ii
        mm = torch.where(ii == 0, (-j.to(f32)) * pt,
                         torch.where(j == 0, (-iif) * pq,
                                     torch.tensor(NEG, device=dev)))
        mm = torch.where((j < 0) | (j > Lt), torch.tensor(NEG, device=dev),
                         mm)
        return mm[None].expand(B, Wi)

    mm1, mm2 = boundary(1), boundary(0)
    dg1 = mi1 = gd1 = im1_ = negrow
    dg2 = mi2 = gd2 = im2 = negrow
    best = torch.full((B,), NEG, dtype=f32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int64, device=dev)
    best_j = torch.zeros(B, dtype=torch.int64, device=dev)
    bt = torch.zeros((B, Lq + 1, Lt + 1), dtype=torch.uint8, device=dev)
    u8 = torch.uint8

    for d in range(2, Lq + Lt + 1):
        _ii, jj, on, jc, jm1 = _diag_index(d, Wi, Lt, dev)
        si = diag_si(qrow, tp, jc, sh)
        if ss_score is not None:
            si = si + ss_score[:, ii, jj.clamp(0, Lt)].to(f32)
        elif ss_lut is not None:
            jcl = jj.clamp(0, Lt)
            ss_on = (jj[None] >= 1) & (jj[None] <= tL)
            si = si + torch.where(ss_on, lut[qi[ii][None] + ti[:, jcl]],
                                  0.0)
        tm2m1 = ttr[:, jm1, M2M]
        td2m1 = ttr[:, jm1, D2M]
        ti2m1 = ttr[:, jm1, I2M]
        tm2d1 = ttr[:, jm1, M2D]
        td2d1 = ttr[:, jm1, D2D]
        tm2i0 = ttr[:, jc, M2I]
        ti2i0 = ttr[:, jc, I2I]

        mm_d, gd_d, im_d = _up(mm2, negrow), _up(gd2, negrow), \
            _up(im2, negrow)
        dg_d, mi_d = _up(dg2, negrow), _up(mi2, negrow)
        c_mm = (mm_d + qm2m_1) + tm2m1
        best5 = fmax(smin, c_mm)
        code = torch.where(c_mm > smin, MM, STOP)
        c_gd = (gd_d + qm2m_1) + td2m1
        code = torch.where(c_gd > best5, GD, code)
        best5 = fmax(best5, c_gd)
        c_im = (im_d + qi2m_1) + tm2m1
        code = torch.where(c_im > best5, IM, code)
        best5 = fmax(best5, c_im)
        c_dg = (dg_d + qd2m_1) + tm2m1
        code = torch.where(c_dg > best5, DG, code)
        best5 = fmax(best5, c_dg)
        c_mi = (mi_d + qm2m_1) + ti2m1
        code = torch.where(c_mi > best5, MI, code)
        best5 = fmax(best5, c_mi)
        mm_new = best5 + si

        mm_u, dg_u, mi_u = _up(mm1, negrow), _up(dg1, negrow), \
            _up(mi1, negrow)
        a_dg = mm_u + qm2d_1
        b_dg = dg_u + qd2d_1
        dg_new = fmax(a_dg, b_dg)
        a_mi = (mm_u + qm2m_1) + tm2i0
        b_mi = (mi_u + qm2m_1) + ti2i0
        mi_new = fmax(a_mi, b_mi)
        a_gd = mm1 + tm2d1
        b_gd = gd1 + td2d1
        gd_new = fmax(a_gd, b_gd)
        a_im = (mm1 + qm2i_0) + tm2m1
        b_im = (im1_ + qi2i_0) + tm2m1
        im_new = fmax(a_im, b_im)
        if cell_off is not None:
            co = torch.where(cell_off[:, ii, jj.clamp(0, Lt)], NEG,
                             0.0).to(f32)
            mm_new = mm_new + co
            dg_new = dg_new + co
            mi_new = mi_new + co
            gd_new = gd_new + co
            im_new = im_new + co

        onb = on[None]
        mm_new = torch.where(onb, mm_new, boundary(d))
        dg_new = torch.where(onb, dg_new, negrow)
        mi_new = torch.where(onb, mi_new, negrow)
        gd_new = torch.where(onb, gd_new, negrow)
        im_new = torch.where(onb, im_new, negrow)

        i_on = ii[on]
        if i_on.numel():
            byte = (code | torch.where(a_gd > b_gd, 8, 0)
                    | torch.where(a_im > b_im, 16, 0)
                    | torch.where(a_dg > b_dg, 32, 0)
                    | torch.where(a_mi > b_mi, 64, 0)).to(u8)
            bt[:, i_on, jj[on]] = byte[:, on]

        cand_on = onb & (ii <= lqt)[None]
        if not local:
            cand_on = cand_on & ((jj[None] == tL) | (ii == lqt)[None])
        cand = torch.where(cand_on, mm_new, NEG)
        k = torch.argmax(cand, dim=1)
        cand_s = cand.gather(1, k[:, None])[:, 0]
        upd = (cand_s > best) | ((cand_s == best) & (k < best_i))
        best = torch.where(upd, cand_s, best)
        best_i = torch.where(upd, k, best_i)
        best_j = torch.where(upd, d - k, best_j)

        mm2, dg2, mi2, gd2, im2 = mm1, dg1, mi1, gd1, im1_
        mm1, dg1, mi1, gd1, im1_ = mm_new, dg_new, mi_new, gd_new, im_new

    return (best, best_i.to(torch.int32), best_j.to(torch.int32), bt)


# ---------------------------------------------------------------- device ----

# The backtrace kernels' byte layout (csrc/viterbi.cu): backtrace bytes and
# cell-off masks are stored [B][Lt+1][Wq], row i of column j at byte
# BT_ROW0 + i, so that each lane's 8 rows (1 + 8m .. 8 + 8m) form one
# aligned 8-byte word; Wq = bt_col_bytes(Lq).
BT_ROW0 = 7


def bt_col_bytes(Lq: int) -> int:
    """Bytes per stored column: rows 0..Lq from BT_ROW0 on, room for the
    last lane's whole word, rounded up to 16."""
    return -(-(Lq + 8) // 16) * 16


def bt_storage(B: int, Lq: int, Lt: int, dtype, device, zero=False):
    """(storage [B][Lt+1][Wq], its (B, Lq+1, Lt+1) view) in the kernels'
    layout."""
    alloc = torch.zeros if zero else torch.empty
    store = alloc((B, Lt + 1, bt_col_bytes(Lq)), dtype=dtype, device=device)
    return store, store[:, :, BT_ROW0: BT_ROW0 + Lq + 1].transpose(1, 2)


def bt_base(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The [B][Lt+1][Wq] storage of which ``x`` (B, Lq+1, Lt+1) is the
    :func:`bt_storage` view, or None when ``x`` is laid out otherwise."""
    B, Li, Wj = x.shape
    Wq = bt_col_bytes(Li - 1)
    if (x.stride() != (Wj * Wq, 1, Wq) or x.storage_offset() != BT_ROW0
            or x.untyped_storage().nbytes() < B * Wj * Wq * x.element_size()):
        return None
    return x.as_strided((B, Wj, Wq), (Wj * Wq, Wq, 1), 0)


# per-state walk tables (index = state code 0..7): the gap-state bit of
# the backtrace byte that re-opens MM, and whether the state moves i / j
# (every real state moves; STOP and the unused codes 1 and 7 stop)
_WALK_BIT = (0, 0, 0, 8, 16, 32, 64, 0)
_WALK_DI = (0, 0, 1, 0, 0, 1, 1, 0)
_WALK_DJ = (0, 0, 1, 1, 1, 0, 0, 0)


def backtrace_walk_packed8_plain(bt, i2, j2, score, kmax: int,
                                 chunk: int = 64):
    """The plain version of W1 (:func:`backtrace_walk_packed8`): the walk
    over the (B, Lq+1, Lt+1) backtrace bytes (any strides: the kernels'
    lanes-last bt is read in place) as a loop of torch ops, one step at
    a time: ONE int8 array of [score(4B) i2(2B) j2(2B) n(4B) st[kmax](1B
    each)] per lane, the ``_backtrace_walk_packed8`` format of the JAX
    package.

    Same step rules as the scalar :func:`backtrace`
    (src/hhviterbi.cpp:83-160).  The (ii, jj) step positions are not
    shipped: every recorded step's move is fixed by its state (MM:
    -1,-1; GD/IM: 0,-1; DG/MI: -1,0), so the host rebuilds them from
    (i2, j2) and the state bytes (:func:`backtrace_walk_unpack8`).
    Stops early once every lane has reached STOP (checked every
    ``chunk`` steps), leaving the unwritten tail zero — exactly what
    the full-length walk records for stopped lanes."""
    dev = bt.device
    B = bt.shape[0]
    lanes = torch.arange(B, device=dev)
    i = i2.to(torch.int64).clone()
    j = j2.to(torch.int64).clone()
    s = torch.full((B,), MM, dtype=torch.int64, device=dev)
    bit_t = torch.tensor(_WALK_BIT, dtype=torch.int64, device=dev)
    di_t = torch.tensor(_WALK_DI, dtype=torch.int64, device=dev)
    dj_t = torch.tensor(_WALK_DJ, dtype=torch.int64, device=dev)
    st = torch.zeros((B, kmax), dtype=torch.int8, device=dev)
    for k in range(kmax):
        if k % chunk == 0 and k and not bool((s != STOP).any()):
            break
        b = bt[lanes, i, j].to(torch.int64)
        need_i = di_t[s]
        need_j = dj_t[s]
        blocked = ((need_i | need_j) == 0) | ((need_i == 1) & (i <= 1)) \
            | ((need_j == 1) & (j <= 1))
        nxt = torch.where((b & bit_t[s]) != 0, MM, s)
        nxt = torch.where(s == MM, b & 7, nxt)
        st[:, k] = s.to(torch.int8)
        move = (~blocked).to(torch.int64)
        i = i - need_i * move
        j = j - need_j * move
        s = torch.where(blocked, STOP, nxt)
    n = (st != 0).sum(dim=1, dtype=torch.int32)

    def b8(x, dt):
        return x.to(dt).contiguous().view(torch.int8).reshape(B, -1)

    header = torch.cat([b8(score, torch.float32), b8(i2, torch.int16),
                        b8(j2, torch.int16), b8(n, torch.int32)], dim=1)
    return torch.cat([header, st], dim=1)


def backtrace_walk_packed8(bt, i2, j2, score, kmax: int):
    """W1: the walk payload (B, 12 + kmax) int8 of
    :func:`backtrace_walk_packed8_plain` — its plain version on a CPU
    ``bt``, the CUDA kernel (``csrc/viterbi.cu:bt_walk_kernel``: a team
    of lanes a walk, walking R x R tiles of bt staged in shared memory)
    on a card's, reading bt in place through its strides.
    ``backtrace_walk_packed8.launches`` counts kernel launches."""
    if bt.device.type == "cpu":
        return backtrace_walk_packed8_plain(bt, i2, j2, score, kmax)
    return launch_walk(bt, i2, j2, score, kmax)


backtrace_walk_packed8.launches = 0

# W1's tile side and lanes a walk, as csrc/viterbi.cu builds it
# (WALK_R, WALK_G)
WALK_R, WALK_G = 16, 16


def launch_walk(bt, i2, j2, score, kmax: int):
    """Launch W1 on the card: ``bt`` (B, Lq+1, Lt+1) uint8 of any strides
    (K2/K3's storage view or contiguous bytes, no copy), i2, j2, score
    (B,); raises ValueError for another type or shape, RuntimeError when
    the C entry refuses the launch (kmax < 1)."""
    from . import viterbi_lanes as VL

    dev = VL._require_cuda(bt)
    if bt.dtype != torch.uint8 or bt.dim() != 3:
        raise ValueError(f"W1 walk: bt must be (B, Lq+1, Lt+1) uint8, not "
                         f"{bt.dtype} {tuple(bt.shape)}")
    B = bt.shape[0]
    i2 = i2.to(dev, torch.int32).contiguous()
    j2 = j2.to(dev, torch.int32).contiguous()
    score = torch.as_tensor(score).to(dev, torch.float32).contiguous()
    if not (i2.shape == j2.shape == score.shape == (B,)):
        raise ValueError(f"W1 walk: i2, j2 and score must be ({B},)")
    out = torch.empty((B, 12 + max(int(kmax), 0)), dtype=torch.int8,
                      device=dev)
    if B == 0:
        return out
    lib = VL.cuda_lib()
    rc = lib.hh_vit_walk(bt.data_ptr(), *bt.stride(), i2.data_ptr(),
                         j2.data_ptr(), score.data_ptr(), B, int(kmax),
                         out.data_ptr(), VL._stream(dev))
    VL._check(lib, rc, "W1 backtrace walk")
    backtrace_walk_packed8.launches += 1
    return out


def backtrace_walk_unpack8(packed, kmax):
    """Fetch + unpack the int8 walk: positions rebuilt on host from
    the state bytes (see backtrace_walk_packed8_plain)."""
    packed = np.ascontiguousarray(np.asarray(packed))
    sc_v = packed[:, 0:4].copy().view(np.float32)[:, 0]
    i2_v = packed[:, 4:6].copy().view(np.int16)[:, 0].astype(np.int32)
    j2_v = packed[:, 6:8].copy().view(np.int16)[:, 0].astype(np.int32)
    n = packed[:, 8:12].copy().view(np.int32)[:, 0]
    nmax = int(n.max()) if n.size else 0
    st = packed[:, 12: 12 + max(nmax, 1)]
    di = ((st == MM) | (st == DG) | (st == MI)).astype(np.int32)
    dj = ((st == MM) | (st == GD) | (st == IM)).astype(np.int32)
    ii = i2_v[:, None] - np.cumsum(di, axis=1) + di
    jj = j2_v[:, None] - np.cumsum(dj, axis=1) + dj
    kidx = np.arange(st.shape[1])[None, :]
    matched = ((st == MM) & (kidx < n[:, None])).sum(axis=1)

    def unpack(b):
        nb = int(n[b])
        i_steps = np.zeros(nb + 1, dtype=np.int32)
        j_steps = np.zeros(nb + 1, dtype=np.int32)
        states = np.zeros(nb + 1, dtype=np.int8)
        i_steps[1:] = ii[b, :nb]
        j_steps[1:] = jj[b, :nb]
        states[1:] = st[b, :nb]
        if nb:
            states[nb] = MM
        return i_steps, j_steps, states, int(matched[b])

    unpack.score = sc_v
    unpack.i2 = i2_v
    unpack.j2 = j2_v
    return unpack


class DecodedBatch:
    """Arrays from the native batched walk decode (one per lane, with a
    leading zero column so per-hit slices [:n+1] match the step arrays
    backtrace_walk_unpack8's unpack(b) built)."""

    __slots__ = ("score", "sc_ss", "i2", "j2", "n", "matched",
                 "ii2", "jj2", "st2", "S2", "zss")


def decode_rescore_native(packed_np, kmax: int, q_p, t_ps, corr: float,
                          nat, pnul=None) -> DecodedBatch:
    """Run native vit_decode_rescore over a fetched walk payload.

    ``packed_np``: (B, 12+kmax) int8 host array; ``t_ps``: one (Lt+2, 20)
    float32 profile array per REAL lane.  Returns per-lane final scores
    (with the correlation term), matched counts and (B, nmax+1) path
    arrays whose per-lane slices are bit-identical to the Python
    decode loop's outputs (see the C source for the parity contract)."""
    from .. import fastmath as fm

    B = packed_np.shape[0]
    Breal = len(t_ps)
    n_hdr = packed_np[:Breal, 8:12].copy().view(np.int32)[:, 0]
    nmax = int(n_hdr.max()) if Breal else 0
    # clamp like the C side: a corrupt header must not size allocations
    K1 = min(max(nmax, 0), int(kmax)) + 1
    d = DecodedBatch()
    d.ii2 = np.zeros((B, K1), np.int32)
    d.jj2 = np.zeros((B, K1), np.int32)
    d.st2 = np.zeros((B, K1), np.int8)
    d.S2 = np.zeros((B, K1), np.float32)
    d.zss = np.zeros(K1, np.float32)
    d.score = np.zeros(B, np.float32)
    d.sc_ss = np.zeros(B, np.float32)
    d.n = np.zeros(B, np.int32)
    d.matched = np.zeros(B, np.int32)
    d.i2 = np.zeros(B, np.int32)
    d.j2 = np.zeros(B, np.int32)
    lg2, diff = fm._fast_log2_tables()
    qp32 = np.ascontiguousarray(q_p, dtype=np.float32)
    tps32 = [np.ascontiguousarray(t, dtype=np.float32) for t in t_ps]
    args = [packed_np, int(kmax), int(Breal), qp32, tps32,
            float(np.float32(corr)), lg2, diff,
            d.ii2, d.jj2, d.st2, d.S2, d.score, d.sc_ss,
            d.n, d.matched, d.i2, d.j2]
    if pnul is not None:
        args.append(np.ascontiguousarray(pnul, dtype=np.float32))
    nat.vit_decode_rescore(*args)
    return d


def band_intervals(pi, pj, W: int, Lq: int, Lt: int, n_i: int, n_j: int):
    """Per-column / per-row ±W band intervals around a monotone path —
    the compact form of :func:`exclude_alignment_mask`'s region.  A cell
    (i, j) is inside the band iff lo_c[j] <= i <= hi_c[j] or
    lo_r[i] <= j <= hi_r[i].  Empty intervals encode as (1, 0).
    Returns int32 arrays lo_c, hi_c (n_j,), lo_r, hi_r (n_i,)."""
    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    from ..native import load as _load_native

    nat = _load_native()
    if nat is not None and hasattr(nat, "band_intervals"):
        lo_c = np.empty(n_j, np.int32)
        hi_c = np.empty(n_j, np.int32)
        lo_r = np.empty(n_i, np.int32)
        hi_r = np.empty(n_i, np.int32)
        nat.band_intervals(np.ascontiguousarray(pi),
                           np.ascontiguousarray(pj), W, Lq, Lt,
                           lo_c, hi_c, n_j, lo_r, hi_r, n_i)
        return lo_c, hi_c, lo_r, hi_r
    BIG = np.int64(1 << 60)
    min_i = np.full(n_j, BIG, np.int64)
    max_i = np.full(n_j, -1, np.int64)
    np.minimum.at(min_i, pj, pi)
    np.maximum.at(max_i, pj, pi)
    valid = max_i >= 0
    lo_c = np.where(valid, np.maximum(1, min_i - W), 1).astype(np.int32)
    hi_c = np.where(valid, np.minimum(Lq, max_i + W), 0).astype(np.int32)
    min_j = np.full(n_i, BIG, np.int64)
    max_j = np.full(n_i, -1, np.int64)
    np.minimum.at(min_j, pi, pj)
    np.maximum.at(max_j, pi, pj)
    valid = max_j >= 0
    lo_r = np.where(valid, np.maximum(1, min_j - W), 1).astype(np.int32)
    hi_r = np.where(valid, np.minimum(Lt, max_j + W), 0).astype(np.int32)
    return lo_c, hi_c, lo_r, hi_r


def exclusion_mask_device(lo_c, hi_c, lo_r, hi_r):
    """Build the (B, Li, Wj) bool cell-off mask ON THE DEVICE of the
    interval tensors (lo_c/hi_c (B, P, Wj), lo_r/hi_r (B, P, Li)).

    The altali exclusion masks are O(B*Lq*Lt) bools but are fully
    determined by O(B*P*(Lq+Lt)) intervals, so only the intervals cross
    to the card.  The mask is built in the backtrace kernels' storage
    ([B][Wj][Wq], :func:`bt_storage`) and returned as its (B, Li, Wj)
    view, which the kernel reads without a copy."""
    B, P, Wj = lo_c.shape
    Li = lo_r.shape[2]
    dev = lo_c.device
    _store, view = bt_storage(B, Li - 1, Wj - 1, torch.bool, dev, zero=True)
    m = view.transpose(1, 2)                             # (B, Wj, Li)
    i_idx = torch.arange(Li, dtype=torch.int32, device=dev)[None, None]
    j_idx = torch.arange(Wj, dtype=torch.int32, device=dev)[None, :, None]
    for p in range(P):      # P <= altali-1 <= 3
        m |= ((i_idx >= lo_c[:, p, :, None])
              & (i_idx <= hi_c[:, p, :, None]))
        m |= ((j_idx >= lo_r[:, p, None, :])
              & (j_idx <= hi_r[:, p, None, :]))
    return view


# ------------------------------------------------------------------ host ----

def backtrace(bt: np.ndarray, start_i: int, start_j: int):
    """Scalar backtrace over one lane's byte matrix
    (src/hhviterbi.cpp:83-160).

    Returns (i_steps, j_steps, states, matched_cols); step arrays are
    1-based like the reference (index 0 unused), ordered end->start.
    """
    i, j = int(start_i), int(start_j)
    i_steps = [0]
    j_steps = [0]
    states = [0]
    state = MM
    matched_cols = 0
    while state != STOP:
        states.append(state)
        i_steps.append(i)
        j_steps.append(j)
        b = int(bt[i, j])
        if state == MM:
            matched_cols += 1
            if i <= 1 or j <= 1:
                state = STOP
            else:
                state = b & 0x07
                i -= 1
                j -= 1
        elif state == GD:
            if j <= 1:
                state = STOP
            else:
                if b & 8:
                    state = MM
                j -= 1
        elif state == IM:
            if j <= 1:
                state = STOP
            else:
                if b & 16:
                    state = MM
                j -= 1
        elif state == DG:
            if i <= 1:
                state = STOP
            else:
                if b & 32:
                    state = MM
                i -= 1
        elif state == MI:
            if i <= 1:
                state = STOP
            else:
                if b & 64:
                    state = MM
                i -= 1
        else:
            state = STOP
    states[len(states) - 1] = MM  # first state set to MM (reference quirk)
    return (np.array(i_steps, dtype=np.int32),
            np.array(j_steps, dtype=np.int32),
            np.array(states, dtype=np.int8),
            matched_cols)


def exclude_alignment_mask(cell_off: np.ndarray, i_steps, j_steps, Lq, Lt):
    """Cross out cells around a previous alignment path
    (src/hhviterbi.cpp:61-77, VITERBI_PATH_WIDTH=40); vectorized over
    the path (per column the step rows are contiguous, so the union of
    ±W windows is [min_i - W, max_i + W], and transposed for rows)."""
    from ..search.posterior import _band_set

    _band_set(cell_off, np.asarray(i_steps)[1:], np.asarray(j_steps)[1:],
              40, Lq, Lt, True)
    return cell_off
