"""Template-lanes Viterbi kernels: K1 and K6 (score-only sweeps) and K2
(full-backtrace pass), CUDA C++ in ``csrc/viterbi.cu``.

All three (and K3, in ``ops/viterbi_rows.py``) give each template a
group of G lanes that sweep an anti-diagonal wavefront: lane k holds 8
query rows and computes column s - k + 1 at step s, taking the row above
from lane k-1 by a warp shuffle; queries longer than G*8 rows run in
passes (see the kernel source for the design and the layouts).
:func:`score_geometry` (K1/K6) and :func:`bt_geometry` (K2/K3) pick the
launch's group width G; the C entries take G alone and derive the rest.
Each wrapper takes the JAX package's shapes — ``tp`` (B, Lt+2, 20),
``ttr`` (B, Lt+2, 7) — and reads them lanes-last: ``tp.permute(1, 2,
0).contiguous()`` is free when the caller's storage is already (Lt+2,
20, B), as the resident template pack hands it out.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches.

K1 ``viterbi_score_lanes_fused`` replaces the Pallas kernel of the same
name (hhsuite_tpu/ops/viterbi_lanes.py): best local score per template
(egq = egt = 0) with the 20-term profile dot and the log2 fused into the
DP.  ``si_mode="fast"`` uses the exponent-bit log2 with a quartic
mantissa correction (|err| <= 0.000146 bit/cell; ranking only, the
survivors are rescored exactly), ``"exact"`` the ``log2f4`` cubic.  The
dot is f32 in the reference's SSE summation order — the TPU kernel's
bf16 MXU operands have no counterpart here.

K6 ``viterbi_score_lanes`` replaces the Pallas kernel of the same name:
the same sweep with ``Si = log2f4(dot) + shift + ss``, the secondary-
structure term given densely (``ss_score`` (B, Lq+1, Lt+1)) or as a
lookup table (``ss_lut`` flat, ``ss_qidx`` (Lq,), ``ss_tidx`` (B, Lt):
ss(b, i, j) = lut[qidx[i-1] + tidx[b, j-1]]; the search passes this
form, ``build_ss_lut``'s).  It is K1 ``exact`` with one more add per
cell, in the same kernel (an SS-mode template parameter), so with no SS
term it is K1 ``exact`` bit for bit.  Si is
f32 only: the TPU kernel's bfloat16 Si stream saved HBM bandwidth on a
machine where Si lived in HBM; here Si never leaves the registers.

K2 ``viterbi_backtrace_lanes`` replaces
hhsuite_tpu/ops/viterbi_lanes.py:viterbi_backtrace_lanes: the full local
Viterbi (no cell-off, no SS) with score, best cell (score desc, i asc,
j asc) and the backtrace bytes, bit-identical to
:func:`ops.viterbi.viterbi_batch`.  The bytes come back as a (B, Lq+1,
Lt+1) view of [B][Lt+1][Wq] storage (:func:`ops.viterbi.bt_storage`),
which the walk W1 (:func:`ops.viterbi.backtrace_walk_packed8`) reads
in place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import launch_on
from .viterbi import (D2D, D2M, FLT_MAX, I2I, I2M, M2D, M2I, M2M, _diag_index,
                      _up, bt_base, bt_storage, diag_si, fmax, viterbi_batch)

_BOUND = {}


def bind(lib):
    """Set the C signatures of ``csrc/viterbi.cu``'s entry points on a
    loaded library."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hh_vit_score.argtypes = [P, P, P, P, P, P, I, P, P, I, I, I, F, I,
                                 I, P, P, P]
    lib.hh_vit_score.restype = I
    lib.hh_vit_bt.argtypes = [P, P, P, P, P, P, P, I, P, P, I, I, I, I, I,
                              F, F, F, I, P, P, P, P, P, P]
    lib.hh_vit_bt.restype = I
    lib.hh_bt_smem_bytes.argtypes = [I, I]
    lib.hh_bt_smem_bytes.restype = I
    lib.hh_bt_col_stride.argtypes = [I]
    lib.hh_bt_col_stride.restype = I
    L = ctypes.c_longlong
    lib.hh_vit_walk.argtypes = [P, L, L, L, P, P, P, I, I, P, P]
    lib.hh_vit_walk.restype = I
    lib.hh_error_string.argtypes = [I]
    lib.hh_error_string.restype = ctypes.c_char_p
    return lib


def cuda_lib():
    """The built ``csrc/viterbi.cu`` library with its C signatures."""
    from ..device import cuda_library

    lib, _info = cuda_library("viterbi")
    if not _BOUND.get(id(lib)):
        bind(lib)
        _BOUND[id(lib)] = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{lib.hh_error_string(rc).decode()}")


def _require_cuda(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"Viterbi kernels take CPU or CUDA tensors, "
                         f"not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
    return dev


def _lanes_last(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, ...) -> contiguous (..., B) storage; no copy when ``x`` is
    already a view of lanes-last storage."""
    return x.to(dtype).movedim(0, -1).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fast_shift(shift) -> np.float32:
    """K1 ``fast`` folds the -127 exponent bias into the shift (f32)."""
    return np.float32(shift) - np.float32(127.0)


# ------------------------------------------------------------------ K1 --

def launch_score(qp, qtr, tp, ttr, sh, fast, what, ss=None, lut=None,
                 qidx=None, tidxT=None):
    """Launch the score-sweep kernel (K1; K6 with ``ss`` (B, Lq+1, Lt+1)
    contiguous, or ``lut`` with ``qidx`` and ``tidxT`` [Lt][B], all on
    the card) at the group width :func:`score_geometry` picks.  ``sh`` is
    the shift the kernel adds (K1 fast: shift - 127)."""
    dev = _require_cuda(tp, ttr)
    lib = cuda_lib()
    f32 = torch.float32
    Lq = qp.shape[0] - 2
    B, Lt2, _ = tp.shape
    Lt = Lt2 - 2
    if ttr.shape != (B, Lt2, 7) or qtr.shape != (Lq + 2, 7):
        raise ValueError(f"{what}: inconsistent shapes")
    geo = score_geometry(B, Lq, Lt)
    qp_c = qp.to(dev, f32).contiguous()
    qtr_c = qtr.to(dev, f32).contiguous()
    tpT = _lanes_last(tp, f32)
    ttrT = _lanes_last(ttr, f32)
    scratch = (torch.empty((B, Lt + 1, 5), dtype=f32, device=dev)
               if geo.passes > 1 else None)
    out = torch.empty(B, dtype=f32, device=dev)
    n_lut = 0 if lut is None else int(lut.numel())
    rc = launch_on(dev, lib.hh_vit_score, _ptr(qp_c), _ptr(qtr_c), _ptr(tpT),
                   _ptr(ttrT), _ptr(ss), _ptr(lut), n_lut, _ptr(qidx),
                   _ptr(tidxT), B, Lq, Lt, float(np.float32(sh)), int(fast),
                   geo.G, _ptr(scratch), _ptr(out), _stream(dev))
    _check(lib, rc, what)
    return out


def viterbi_score_lanes_plain(qp, qtr, tp, ttr, t_L, shift,
                              si_mode="exact", ss_score=None, ss_lut=None,
                              ss_qidx=None, ss_tidx=None):
    """Plain PyTorch version of K1 and K6 (any device): an anti-diagonal
    sweep evaluating each cell with K1's own arithmetic — the five MM
    candidates factored into two max trees (the TPU kernel's
    viterbi_lanes.py:537-552), MM boundary 0 on row 0 and column 0.
    K6's SS term (dense ``ss_score`` or the ``ss_lut`` form) is added to
    Si after the log2 and the shift, as the kernel adds it."""
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
    NEG = -FLT_MAX
    exact = si_mode == "exact"
    sh = torch.tensor(np.float32(shift), device=dev)
    sh_fast = _fast_shift(shift)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
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
    if ss_lut is not None:
        # row 0 / column 0 offsets are never read (off the grid)
        lut = ss_lut.to(dev, f32)
        qi = torch.cat([ss_qidx.new_zeros(1), ss_qidx]).to(dev, torch.int64)
        ti = torch.cat([ss_tidx.new_zeros((B, 1)), ss_tidx],
                       dim=1).to(dev, torch.int64)

    def boundary(d):
        j = d - ii
        mm = torch.where(((ii == 0) | (j == 0)) & (j >= 0) & (j <= Lt),
                         0.0, NEG).to(f32)
        return mm[None].expand(B, Wi)

    mm1, mm2 = boundary(1), boundary(0)
    dg1 = mi1 = gd1 = imc1 = negrow
    dg2 = mi2 = gd2 = imc2 = negrow
    best = torch.full((B,), NEG, dtype=f32, device=dev)
    for d in range(2, Lq + Lt + 1):
        _ii, jj, on, jc, jm1 = _diag_index(d, Wi, Lt, dev)
        si = diag_si(qrow, tp, jc, sh, exact=exact, sh_fast=sh_fast)
        if ss_score is not None:
            si = si + ss_score[:, ii, jj.clamp(0, Lt)].to(f32)
        elif ss_lut is not None:
            si = si + lut[qi[ii][None] + ti[:, jj.clamp(0, Lt)]]
        tm2m1 = ttr[:, jm1, M2M]
        td2m1 = ttr[:, jm1, D2M]
        ti2m1 = ttr[:, jm1, I2M]
        tm2d1 = ttr[:, jm1, M2D]
        td2d1 = ttr[:, jm1, D2D]
        tm2i0 = ttr[:, jc, M2I]
        ti2i0 = ttr[:, jc, I2I]

        mm_d, gd_d, im_d = _up(mm2, negrow), _up(gd2, negrow), \
            _up(imc2, negrow)
        dg_d, mi_d = _up(dg2, negrow), _up(mi2, negrow)
        t_a = fmax(mm_d + qm2m_1, im_d + qi2m_1)
        t_a = fmax(t_a, dg_d + qd2m_1) + tm2m1
        t_b = fmax(gd_d + td2m1, mi_d + ti2m1) + qm2m_1
        mm_new = fmax(fmax(zero, t_a), t_b) + si

        mm_u, dg_u, mi_u = _up(mm1, negrow), _up(dg1, negrow), \
            _up(mi1, negrow)
        dg_new = fmax(mm_u + qm2d_1, dg_u + qd2d_1)
        mi_new = fmax(mm_u + tm2i0, mi_u + ti2i0) + qm2m_1
        gd_new = fmax(mm1 + tm2d1, gd1 + td2d1)
        im_new = fmax(mm1 + qm2i_0, imc1 + qi2i_0) + tm2m1

        onb = on[None]
        best = fmax(best, torch.where(onb, mm_new, NEG).amax(dim=1))
        mm_new = torch.where(onb, mm_new, boundary(d))
        dg_new = torch.where(onb, dg_new, negrow)
        mi_new = torch.where(onb, mi_new, negrow)
        gd_new = torch.where(onb, gd_new, negrow)
        im_new = torch.where(onb, im_new, negrow)
        mm2, dg2, mi2, gd2, imc2 = mm1, dg1, mi1, gd1, imc1
        mm1, dg1, mi1, gd1, imc1 = mm_new, dg_new, mi_new, gd_new, im_new
    return fmax(best, torch.tensor(NEG, dtype=f32, device=dev))


def viterbi_score_lanes_fused(qp, qtr, tp, ttr, t_L, shift,
                              si_mode="fast"):
    """K1: (B,) f32 best local score per template.  ``t_L`` is unused
    (padded columns carry -FLT_MAX transitions), kept for the JAX
    signature."""
    if si_mode not in ("fast", "exact"):
        raise ValueError(f"si_mode must be 'fast' or 'exact': {si_mode}")
    if tp.device.type == "cpu":
        return viterbi_score_lanes_plain(qp, qtr, tp, ttr, t_L, shift,
                                         si_mode=si_mode)
    fast = si_mode == "fast"
    sh = _fast_shift(shift) if fast else shift
    out = launch_score(qp, qtr, tp, ttr, sh, fast,
                       "K1 viterbi_score_lanes_fused")
    viterbi_score_lanes_fused.launches += 1
    return out


viterbi_score_lanes_fused.launches = 0


# ------------------------------------------------------------------ K6 --

# the largest SS table: S33, NSSPRED x MAXCF x NSSPRED x MAXCF floats
# (csrc/viterbi.cu keeps it in shared memory)
SS_LUT_MAX = 4 * 11 * 4 * 11


def ss_table_args(ss_lut, ss_qidx, ss_tidx, Lq, B, Lt, dev, what):
    """The SS table form checked and moved to the card as the kernels
    read it: lut f32, qidx (Lq,) i32, tidxT [Lt][B] i32."""
    if not 0 < ss_lut.numel() <= SS_LUT_MAX:
        raise ValueError(f"{what}: ss_lut has {ss_lut.numel()} entries "
                         f"(1..{SS_LUT_MAX})")
    if tuple(ss_qidx.shape) != (Lq,) or tuple(ss_tidx.shape) != (B, Lt):
        raise ValueError(f"{what}: ss_qidx must be (Lq,) and ss_tidx "
                         "(B, Lt)")
    return dict(lut=ss_lut.to(dev, torch.float32).contiguous(),
                qidx=ss_qidx.to(dev, torch.int32).contiguous(),
                tidxT=_lanes_last(ss_tidx.to(dev), torch.int32))


def viterbi_score_lanes(qp, qtr, tp, ttr, t_L, shift, ss_score=None,
                        ss_lut=None, ss_qidx=None, ss_tidx=None,
                        si_dtype="float32"):
    """K6: (B,) f32 best local score per template with an optional SS
    term — dense ``ss_score`` (B, Lq+1, Lt+1) f32, or ``ss_lut`` (n,) f32
    with ``ss_qidx`` (Lq,) and ``ss_tidx`` (B, Lt) int offsets into it
    (0 <= qidx + tidx < n, as ``build_ss_lut`` makes them; the kernel
    does not check, which would cost a device sync per launch).
    Equals ``viterbi_batch_rows(local=True)`` scores up to K1's factored
    max trees.  ``t_L`` is unused (padded columns carry -FLT_MAX
    transitions), kept for the JAX signature."""
    if si_dtype != "float32":
        raise ValueError(
            f"K6 computes Si in float32 only, not {si_dtype}: the TPU "
            "kernel's bfloat16 Si stream halved its HBM traffic, but here "
            "Si is computed in registers and never stored")
    if ss_score is not None and ss_lut is not None:
        raise ValueError("K6: pass ss_score or ss_lut, not both")
    if ss_lut is not None and (ss_qidx is None or ss_tidx is None):
        raise ValueError("K6: ss_lut needs ss_qidx and ss_tidx")
    if tp.device.type == "cpu":
        return viterbi_score_lanes_plain(
            qp, qtr, tp, ttr, t_L, shift, si_mode="exact",
            ss_score=ss_score, ss_lut=ss_lut, ss_qidx=ss_qidx,
            ss_tidx=ss_tidx)
    dev = _require_cuda(tp, ttr)
    f32 = torch.float32
    Lq = qp.shape[0] - 2
    B, Lt = tp.shape[0], tp.shape[1] - 2
    kw = {}
    if ss_score is not None:
        if tuple(ss_score.shape) != (B, Lq + 1, Lt + 1):
            raise ValueError(f"K6: ss_score shape {tuple(ss_score.shape)} "
                             f"!= {(B, Lq + 1, Lt + 1)}")
        kw["ss"] = ss_score.to(dev, f32).contiguous()
    elif ss_lut is not None:
        kw = ss_table_args(ss_lut, ss_qidx, ss_tidx, Lq, B, Lt, dev, "K6")
    out = launch_score(qp, qtr, tp, ttr, shift, False,
                       "K6 viterbi_score_lanes", **kw)
    viterbi_score_lanes.launches += 1
    return out


viterbi_score_lanes.launches = 0


# ------------------------------------------------------------------ K2 --

# csrc/viterbi.cu's wavefront constants: threads per block and query rows
# per lane (the kernel's shared-memory layout stays in the source:
# hh_bt_smem_bytes)
BT_THREADS, BT_R = 256, 8
# lanes that keep 8 warps on each of the H100's 132 SMs
_FULL_LANES = 132 * 8 * 32


class WaveGeometry(NamedTuple):
    """One launch of a wavefront kernel: G lanes a template, R query rows
    a lane, ``passes`` passes of G*R rows, ``groups`` templates a block
    of BT_THREADS."""
    G: int
    R: int
    passes: int
    groups: int

    def row(self, p: int, k: int, r: int) -> int:
        """The query row of pass ``p``, lane ``k``, register row ``r``
        (rows past Lq in the last pass are computed and dropped)."""
        return p * self.G * self.R + k * self.R + r + 1


def _wave_geometry(B: int, Lq: int, Lt: int, G: Optional[int], widths,
                   what: str) -> WaveGeometry:
    """The group width ``G`` when given (8, 16 or 32), else the one of
    ``widths`` with the least estimated time: passes x (Lt + G - 1)
    steps, scaled by how far B*G lanes exceed what keeps 8 warps on every
    SM (a wide group fills the card at small B, a narrow one wastes fewer
    rows on the last pass and fewer fill/drain steps)."""
    if B < 1 or Lq < 1 or Lt < 1:
        raise ValueError(f"{what}: B={B}, Lq={Lq}, Lt={Lt} must be >= 1")
    if G not in (None, 8, 16, 32):
        raise ValueError(f"{what}: G={G} is not 8, 16 or 32")

    def passes(G):
        return -(-Lq // (G * BT_R))

    def cost(G):
        return passes(G) * (Lt + G - 1) * max(1.0, B * G / _FULL_LANES)

    G = G or min(widths, key=cost)
    return WaveGeometry(G, BT_R, passes(G), BT_THREADS // G)


def bt_geometry(B: int, Lq: int, Lt: int,
                G: Optional[int] = None) -> WaveGeometry:
    """Launch geometry of the backtrace kernel (K2/K3) for B templates of
    Lt columns and a query of Lq rows: G = 8 or 32 by the cost model of
    :func:`_wave_geometry`; G = 16 is left to callers that ask for it (no
    timed shape favours it)."""
    return _wave_geometry(B, Lq, Lt, G, (8, 32), "backtrace kernel")


def score_geometry(B: int, Lq: int, Lt: int,
                   G: Optional[int] = None) -> WaveGeometry:
    """Launch geometry of the score-sweep kernel (K1/K6) for B templates
    of Lt columns and a query of Lq rows: G = 8, 16 or 32 by the cost
    model of :func:`_wave_geometry` (at Lq = 320, Lt = 384: 8 for a full
    sweep chunk of 8192 templates, 16 for 2048, as timed in
    ``chip_smoke.py`` phase 1)."""
    return _wave_geometry(B, Lq, Lt, G, (8, 16, 32), "score kernel")


def launch_bt(qp, qtr, tp, ttr, t_L, cell_off, shift, local, Lq_true,
              penalty_gap_query=0.0, penalty_gap_template=0.0, lut=None,
              qidx=None, tidxT=None):
    """Launch the backtrace kernel (K2: no cell-off, no SS, local; K3:
    any; the SS term as ``lut`` with ``qidx`` and ``tidxT`` [Lt][B] on
    the card).  ``cell_off`` (B, Lq+1, Lt+1) is read in place when it is
    a view of the kernel's storage (:func:`ops.viterbi.bt_storage`, as
    ``exclusion_mask_device`` builds it), else laid out so.  Returns
    (score, i2, j2, bt) with bt a (B, Lq+1, Lt+1) view of that storage."""
    dev = _require_cuda(tp, ttr)
    lib = cuda_lib()
    f32 = torch.float32
    Lq = qp.shape[0] - 2
    B, Lt2, _ = tp.shape
    Lt = Lt2 - 2
    if ttr.shape != (B, Lt2, 7) or qtr.shape != (Lq + 2, 7) \
            or tuple(t_L.shape) != (B,):
        raise ValueError("backtrace kernel: inconsistent shapes")
    geo = bt_geometry(B, Lq, Lt)
    co = None
    if cell_off is not None:
        if tuple(cell_off.shape) != (B, Lq + 1, Lt + 1) \
                or cell_off.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"backtrace kernel: cell_off must be bool "
                             f"{(B, Lq + 1, Lt + 1)}, not {cell_off.dtype} "
                             f"{tuple(cell_off.shape)}")
        cell_off = cell_off.to(dev)
        co = bt_base(cell_off)
        if co is None:
            co, view = bt_storage(B, Lq, Lt, cell_off.dtype, dev)
            view.copy_(cell_off)
    qp_c = qp.to(dev, f32).contiguous()
    qtr_c = qtr.to(dev, f32).contiguous()
    tpT = _lanes_last(tp, f32)
    ttrT = _lanes_last(ttr, f32)
    tL = t_L.to(dev, torch.int32).contiguous()
    scratch = (torch.empty((B, Lt + 1, 5), dtype=f32, device=dev)
               if geo.passes > 1 else None)
    score = torch.empty(B, dtype=f32, device=dev)
    i2 = torch.empty(B, dtype=torch.int32, device=dev)
    j2 = torch.empty(B, dtype=torch.int32, device=dev)
    bt_s, bt = bt_storage(B, Lq, Lt, torch.uint8, dev)
    lqt = Lq if Lq_true is None else int(Lq_true)
    n_lut = 0 if lut is None else int(lut.numel())
    rc = launch_on(dev, lib.hh_vit_bt, _ptr(qp_c), _ptr(qtr_c), _ptr(tpT),
                   _ptr(ttrT), _ptr(tL), _ptr(co), _ptr(lut), n_lut,
                   _ptr(qidx), _ptr(tidxT), B, Lq, Lt, lqt, int(bool(local)),
                   float(np.float32(shift)),
                   float(np.float32(penalty_gap_query)),
                   float(np.float32(penalty_gap_template)), geo.G,
                   _ptr(scratch), _ptr(score), _ptr(i2), _ptr(j2), _ptr(bt_s),
                   _stream(dev))
    _check(lib, rc, "Viterbi backtrace kernel")
    return score, i2, j2, bt


def viterbi_backtrace_lanes(qp, qtr, tp, ttr, t_L, shift, Lq_true=None):
    """K2: (score (B,) f32, i2 (B,) i32, j2 (B,) i32, bt (B, Lq+1, Lt+1)
    u8) of the full local Viterbi, egq = egt = 0, no cell-off, no SS."""
    if tp.device.type == "cpu":
        return viterbi_batch(qp, qtr, tp, ttr, None, t_L, shift, 0.0, 0.0,
                             0.0, local=True, Lq_true=Lq_true)
    out = launch_bt(qp, qtr, tp, ttr, t_L, None, shift, True, Lq_true)
    viterbi_backtrace_lanes.launches += 1
    return out


viterbi_backtrace_lanes.launches = 0
