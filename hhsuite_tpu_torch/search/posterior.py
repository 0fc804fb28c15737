"""MAC realignment: Forward/Backward posterior decoding + MAC backtrace.

Line-faithful reimplementation of PosteriorDecoder
(src/hhposteriordecoder.cpp:86-307, src/hhforwardalgorithm.cpp,
src/hhbackwardalgorithm.cpp, src/hhmacalgorithm.cpp,
src/hhbacktracemac.cpp): double-precision row-rescaled Forward/Backward
restricted to a cell-off corridor of ±40 cells around the Viterbi path
(FWD_BKW_PATHWIDTH), posterior matrix P_MM, MAC DP with mact gap penalty
and the MAC backtrace that replaces the hit's alignment.

This is the reference-exact host path; the banded corridor keeps it
O(width · L).  ``PosteriorDecoder.realign_batch_device`` is the bulk f32
path on the card: a batch of hits decoded by the kernels of
ops/posterior_batch.py (R1-R4), with the corridor built from its
interval form (:class:`RealignMaskSpec`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import fastmath as fm
from ..constants import (D2D, D2M, FWD_BKW_PATHWIDTH, I2I, I2M, M2D, M2I,
                         M2M, NTRANS)
from ..core.hit import Hit, log_pvalue, pvalue
from ..core.hmm import HMM

DBL_MIN = np.finfo(np.float64).tiny
FLT_MIN = float(np.finfo(np.float32).tiny)
FLT_MAX = float(np.finfo(np.float32).max)
STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6

LAMDA = 0.388

# hits a batched realign chunk decodes (the JAX package's staging, which
# defines the results: length-sorted chunks of this many hits, a level
# of several chunks padded to it with lanes of cells all off)
REALIGN_CHUNK = 256


@dataclass
class MACBacktraceResult:
    alt_i: List[int] = field(default_factory=list)
    alt_j: List[int] = field(default_factory=list)


def _score_ss_single(q, t, i, j, ssw, ssm, S73, S37, S33):
    """Viterbi::ScoreSS for one cell (hhviterbi.h:193-211)."""
    if ssm == 0 or S73 is None:
        return 0.0
    i = min(i, q.ss_pred.shape[0] - 1)
    j = min(j, t.ss_pred.shape[0] - 1)
    if ssm == 1:    # PRED_DSSP
        return ssw * float(S37[q.ss_pred[i], q.ss_conf[i], t.ss_dssp[j]])
    if ssm == 2:    # DSSP_PRED
        return ssw * float(S73[q.ss_dssp[i], t.ss_pred[j], t.ss_conf[j]])
    if ssm == 3:    # PRED_PRED
        return ssw * float(S33[q.ss_pred[i], q.ss_conf[i],
                               t.ss_pred[j], t.ss_conf[j]])
    return 0.0


def _parse_excl_pairs(exclstr: str):
    """strint pairs from '3-57,238-317' style strings (the reference
    uses strint, which skips any non-digit separators)."""
    import re

    nums = [abs(int(x)) for x in re.findall(r"-?\d+", exclstr)]
    return list(zip(nums[0::2], nums[1::2]))


def apply_exclstr(co: np.ndarray, exclstr: Optional[str],
                  template_exclstr: Optional[str], Lq: int, Lt: int):
    """PosteriorDecoder::exclude_regions / exclude_template_regions
    (hhposteriordecoder.cpp:122-152): mask query rows i0..i1 /
    template columns j0..j1 from the realignment."""
    if exclstr:
        for i0, i1 in _parse_excl_pairs(exclstr):
            co[i0: min(i1, Lq) + 1, 1: Lt + 1] = True
    if template_exclstr:
        for j0, j1 in _parse_excl_pairs(template_exclstr):
            co[1: Lq + 1, j0: min(j1, Lt) + 1] = True
    return co


class RealignMaskSpec:
    """Compact interval form of build_realign_cell_off's mask, for
    construction on the card (``ops.posterior_batch.
    realign_mask_device``): a few hundred KB of intervals a chunk
    instead of the (B, Lq+1, Lt+1) bool corridor.

    co(i>=1, j>=1) = (base & ~bandF) | bandE with
      base  = NOT((i < i1 & j < j1) | (i > i2 & j > j2)),
      bandF = the ±40 Viterbi-path band (column/row intervals),
      bandE = union of ±2 bands around previously excluded MAC paths;
    col 0 forced open(False), row 0 = the min-overlap corner remnant
    (j >= corner_j0), padding columns j > Lt closed."""

    __slots__ = ("i1", "j1", "i2", "j2", "corner_j0", "Lt",
                 "F", "E")

    def __init__(self, q: HMM, t: HMM, hit: Hit, par_min_overlap: int,
                 alignments_to_exclude: List[MACBacktraceResult]):
        from ..ops.viterbi import band_intervals

        Lq, Lt = q.L, t.L
        if par_min_overlap == 0:
            min_overlap = min(60, int(0.333 * min(Lq, Lt)) + 1)
        else:
            min_overlap = min(par_min_overlap, int(0.8 * min(Lq, Lt)))
        self.i1, self.j1 = int(hit.i1), int(hit.j1)
        self.i2, self.j2 = int(hit.i2), int(hit.j2)
        self.corner_j0 = max(Lt + 1 - min_overlap, 0)
        self.Lt = Lt
        self.F = band_intervals(hit.i[1: hit.nsteps + 1],
                                hit.j[1: hit.nsteps + 1], 40, Lq, Lt,
                                Lq + 1, Lt + 1)
        self.E = [band_intervals(np.asarray(al.alt_i),
                                 np.asarray(al.alt_j), 2, Lq, Lt,
                                 Lq + 1, Lt + 1)
                  for al in alignments_to_exclude]


def build_realign_cell_off(q: HMM, t: HMM, hit: Hit, par_min_overlap: int,
                           alignments_to_exclude: List[MACBacktraceResult],
                           exclstr: Optional[str] = None,
                           template_exclstr: Optional[str] = None
                           ) -> np.ndarray:
    """initializeForAlignment + maskViterbiAlignment + excludeMACAlignment
    (hhposteriordecoder.cpp:162-265, hhviterbi.cpp:322-357)."""
    Lq, Lt = q.L, t.L
    co = np.zeros((Lq + 1, Lt + 1), dtype=bool)

    # Viterbi::InitializeForAlignment (self == 0 path): min-overlap
    # corners.  maskViterbiAlignment then overwrites all of co[1:, 1:],
    # so only the i=0 row of the first corner loop survives — written
    # directly (differentially verified against the straight port).
    if par_min_overlap == 0:
        min_overlap = min(60, int(0.333 * min(Lq, Lt)) + 1)
    else:
        min_overlap = min(par_min_overlap, int(0.8 * min(Lq, Lt)))
    j0 = Lt + 1 - min_overlap
    if j0 <= Lt:
        co[0, max(j0, 0):] = True

    # maskViterbiAlignment: off everything except the upper-left /
    # lower-right rectangles around the Viterbi endpoints
    co[1:, 1:] = True
    co[1: hit.i1, 1: hit.j1] = False
    co[hit.i2 + 1:, hit.j2 + 1:] = False
    # ... then re-open a ±40 corridor around the Viterbi path.
    # The per-step loop opens rows [si-W, si+W] of column sj (and the
    # transpose); the path is monotone, so per column the step rows are
    # contiguous and the union is [min_i - W, max_i + W] — computed for
    # all columns at once with ufunc.at reductions.
    W = FWD_BKW_PATHWIDTH
    _band_set(co, hit.i[1: hit.nsteps + 1], hit.j[1: hit.nsteps + 1],
              W, Lq, Lt, False)

    # exclude previous alternative MAC alignments (±2 cells)
    for al in alignments_to_exclude:
        _band_set(co, np.asarray(al.alt_i), np.asarray(al.alt_j),
                  2, Lq, Lt, True)
    apply_exclstr(co, exclstr, template_exclstr, Lq, Lt)
    return co


def _band_set(co: np.ndarray, pi, pj, W: int, Lq: int, Lt: int,
              value: bool) -> None:
    """Set co[si-W .. si+W, sj] and co[si, sj-W .. sj+W] = value for
    every path step (si, sj), vectorized over the whole path."""
    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    if pi.size == 0:
        return
    from ..native import load as _load_native

    nat = _load_native()
    if nat is not None and hasattr(nat, "band_set") \
            and co.dtype == np.bool_ and co.flags["C_CONTIGUOUS"]:
        nat.band_set(co, co.shape[0], co.shape[1],
                     np.ascontiguousarray(pi), np.ascontiguousarray(pj),
                     W, Lq, Lt, 1 if value else 0)
        return
    # column pass: rows [min_i-W, max_i+W] per column (arrays sized to
    # co, which may be padded wider than Lq+1 x Lt+1)
    min_i = np.full(co.shape[1], np.iinfo(np.int64).max, np.int64)
    max_i = np.full(co.shape[1], -1, np.int64)
    np.minimum.at(min_i, pj, pi)
    np.maximum.at(max_i, pj, pi)
    valid = max_i >= 0
    lo = np.where(valid, np.maximum(1, min_i - W), 1)
    hi = np.where(valid, np.minimum(Lq, max_i + W), 0)
    rows = np.arange(co.shape[0])[:, None]
    co[(rows >= lo[None, :]) & (rows <= hi[None, :])] = value
    # row pass: columns [min_j-W, max_j+W] per row
    min_j = np.full(co.shape[0], np.iinfo(np.int64).max, np.int64)
    max_j = np.full(co.shape[0], -1, np.int64)
    np.minimum.at(min_j, pi, pj)
    np.maximum.at(max_j, pi, pj)
    valid = max_j >= 0
    lo = np.where(valid, np.maximum(1, min_j - W), 1)
    hi = np.where(valid, np.minimum(Lt, max_j + W), 0)
    cols = np.arange(co.shape[1])[None, :]
    co[(cols >= lo[:, None]) & (cols <= hi[:, None])] = value


def prepare_template_transitions(t: HMM):
    """Boundary transition init (hhposteriordecoder.cpp:168-177);
    t.tr must already be linear."""
    t.tr[0, M2M] = 1.0
    t.tr[0, M2D] = t.tr[0, M2I] = 0.0
    t.tr[0, I2M] = t.tr[0, I2I] = 0.0
    t.tr[0, D2M] = t.tr[0, D2D] = 0.0
    t.tr[t.L, M2M] = 1.0
    t.tr[t.L, M2D] = t.tr[t.L, M2I] = 0.0
    t.tr[t.L, I2M] = t.tr[t.L, I2I] = 0.0
    t.tr[t.L, D2M] = 1.0
    t.tr[t.L, D2D] = 0.0


def prepare_query_transitions(q: HMM):
    """initializeQueryHMMTransitions (hhposteriordecoderrunner.cpp:147-154);
    q.tr must already be linear."""
    q.tr[0, M2D] = q.tr[0, M2I] = 0.0
    q.tr[0, I2M] = q.tr[0, I2I] = 0.0
    q.tr[0, D2M] = q.tr[0, D2D] = 0.0
    q.tr[q.L, M2M] = 1.0
    q.tr[q.L, M2D] = q.tr[q.L, M2I] = 0.0
    q.tr[q.L, I2M] = q.tr[q.L, I2I] = 0.0
    q.tr[q.L, D2M] = 1.0


class PosteriorDecoder:
    """One realign() = forward + backward + MAC + backtrace."""

    def __init__(self, local: bool, ssw: float, S73=None, S37=None,
                 S33=None):
        self.local = local
        self.ssw = ssw
        self.S73, self.S37, self.S33 = S73, S37, S33

    def _ss_matrix(self, q: HMM, t: HMM, ssm: int) -> np.ndarray:
        """Dense (Lq+2, Lt+2) float32 grid of _score_ss_single values
        (same index clamping), for the native decoder."""
        Lq, Lt = q.L, t.L
        out = np.zeros((Lq + 2, Lt + 2), dtype=np.float32)
        if ssm == 0 or self.S73 is None:
            return out
        ii = np.arange(Lq + 2)
        jj = np.arange(Lt + 2)
        iq = np.minimum(ii, q.ss_pred.shape[0] - 1)
        jt = np.minimum(jj, t.ss_pred.shape[0] - 1)
        if ssm == 1:      # PRED_DSSP
            out[:] = (self.ssw * self.S37[q.ss_pred[iq][:, None],
                                          q.ss_conf[iq][:, None],
                                          t.ss_dssp[jt][None, :]]
                      ).astype(np.float32)
        elif ssm == 2:    # DSSP_PRED
            out[:] = (self.ssw * self.S73[q.ss_dssp[iq][:, None],
                                          t.ss_pred[jt][None, :],
                                          t.ss_conf[jt][None, :]]
                      ).astype(np.float32)
        elif ssm == 3:    # PRED_PRED
            out[:] = (self.ssw * self.S33[q.ss_pred[iq][:, None],
                                          q.ss_conf[iq][:, None],
                                          t.ss_pred[jt][None, :],
                                          t.ss_conf[jt][None, :]]
                      ).astype(np.float32)
        return out

    def _fb_mac_native(self, nat, q, t, hit, p_mm, co, shift, mact,
                       scale) -> Optional[np.ndarray]:
        """Run _forward/_backward/_mac through the C++ decoder
        (bit-identical hot loops); returns the MAC byte matrix."""
        Lq, Lt = q.L, t.L

        def prof(p, L):
            out = np.zeros((L + 2, 20), dtype=np.float32)
            rows = min(p.shape[0], L + 2)
            out[:rows] = p[:rows, :20]
            return out

        def trans(tr, L):
            out = np.zeros((L + 2, 7), dtype=np.float64)
            rows = min(tr.shape[0], L + 2)
            out[:rows] = tr[:rows, :7]
            return out

        qp32 = prof(q.p, Lq)
        tp32 = prof(t.p, Lt)
        qtr64 = trans(q.tr, Lq)
        ttr64 = trans(t.tr, Lt)
        co8 = np.ascontiguousarray(co, dtype=np.uint8)
        ss32 = self._ss_matrix(q, t, hit.ssm2)
        bmac = np.zeros((Lq + 1, Lt + 1), dtype=np.uint8)
        (pfwd, score, fwd, bwd, i2, j2) = nat.posterior_fb_mac(
            qp32, tp32, qtr64, ttr64, co8, ss32, p_mm, scale, bmac,
            float(np.float32(shift)), 1 if self.local else 0,
            float(mact))
        hit.Pforward = pfwd
        hit.score = score
        hit.i2, hit.j2 = int(i2), int(j2)
        self._forward_entries = [(i, j, v) for (i, j, v) in fwd]
        self._backward_entries = [(i, j, v) for (i, j, v) in bwd]
        return bmac

    # ------------------------------------------------------------ forward --
    def realign(self, q: HMM, t: HMM, hit: Hit, co: np.ndarray,
                shift: float, mact: float, corr: float):
        """hhposteriordecoder.cpp:86-122 (cell-off matrix passed in)."""
        from .. import native

        Lq, Lt = q.L, t.L
        p_mm = np.zeros((Lq + 1, Lt + 1), dtype=np.float64)
        scale = np.ones(Lq + 2, dtype=np.float64)

        saved = (hit.score, hit.score_ss, hit.score_aass, hit.Pval,
                 hit.Pvalt, hit.logPval, hit.logPvalt, hit.Eval,
                 hit.logEval, hit.Probab)

        nat = native.load()
        if nat is not None and hasattr(nat, "posterior_fb_mac"):
            bmac = self._fb_mac_native(nat, q, t, hit, p_mm, co, shift,
                                       mact, scale)
        else:
            self._forward(q, t, hit, p_mm, co, shift, scale)
            self._backward(q, t, hit, p_mm, co, shift, scale)
            bmac = self._mac(q, t, hit, p_mm, co, mact)
        self._backtrace_mac(q, t, hit, p_mm, co, bmac, corr)

        (hit.score, hit.score_ss, hit.score_aass, hit.Pval, hit.Pvalt,
         hit.logPval, hit.logPvalt, hit.Eval, hit.logEval,
         hit.Probab) = saved
        hit.P_MM = p_mm    # posterior matrix (for -omat output)

        # writeProfilesToHits (hhbacktracemac.cpp:14-109): sparse
        # forward/backward/posterior triples and per-row profiles
        hit.backward_matrix = self._backward_entries
        hit.forward_matrix = self._forward_entries
        fp = np.zeros(q.L + 1)
        bp = np.zeros(q.L + 1)
        for (i, j, v) in self._forward_entries:
            fp[i] += v
        for (i, j, v) in self._backward_entries:
            bp[i] += v
        hit.forward_profile = fp
        hit.backward_profile = bp
        post = []
        PT = 0.01          # POSTERIOR_PROBABILITY_THRESHOLD (hhdecl.h:49)
        for i in range(1, q.L + 1):
            row = p_mm[i]
            # cell_off now includes the MAC-backtrace path exclusions,
            # like the reference at writeProfilesToHits time
            mask = (row[1:] >= PT) & ~co[i, 1: t.L + 1]
            for j in np.nonzero(mask)[0]:
                v = row[int(j) + 1]
                if np.isfinite(v):
                    post.append((i, int(j) + 1, float(v)))
        hit.posterior_matrix = post
        return p_mm

    def realign_batch_device(self, q: HMM, items, shift: float,
                             mact: float, corr: float, device):
        """Realign a batch of hits on ``device`` with the batched
        F/B/MAC decoder (ops/posterior_batch.py: the kernels R1-R4 on
        the card, their plain versions on the CPU): per chunk one mask
        build, R1, R2, R3, R4 and one copy of the packed payload.

        ``items`` is a list of (hit, t, co) with templates already in
        linear-transition form and ``co`` a :class:`RealignMaskSpec` or
        a bool corridor.  Float32 bulk path: posteriors agree with the
        host decoder to ~5e-3 and MAC paths are identical away from
        numerical plateaus; the -omat sparse products are NOT produced
        (callers use the host path for -omat).  Saved-score semantics
        match ``realign``: the hits keep their search scores, so the
        Forward score is not computed (the payload's score field is 0).
        Stage timers: ``host_realign_assemble`` (staging, upload and
        launches),
        ``posterior_fetch_wait`` (the payload's copy and unpack),
        ``host_realign_write`` (the hits' fields).
        """
        import time

        import torch

        from ..ops.posterior_batch import (fb_mac_rows, mac_walk_packed8,
                                           mac_walk_unpack8,
                                           realign_mask_device)
        from ..profiling import stage_add

        if not items:
            return
        Lq = q.L
        qp = torch.from_numpy(q.p.astype(np.float32)).to(device)
        qtr = torch.from_numpy(q.tr.astype(np.float32)).to(device)

        def dev(x):
            return torch.from_numpy(x).to(device)

        # sort by template length so per-chunk padding stays tight (the
        # reference length-sorts for thread utilization,
        # hhviterbirunner.cpp:117); results go onto the hit objects, so
        # the order does not matter
        items = sorted(items, key=lambda it: -it[1].L)
        for s in range(0, len(items), REALIGN_CHUNK):
            t0 = time.perf_counter()
            part = items[s: s + REALIGN_CHUNK]
            # a level of several chunks pads each to the full chunk with
            # lanes of cells all off
            B = REALIGN_CHUNK if len(items) > REALIGN_CHUNK else len(part)
            Lt_max = max(t.L for _h, t, _c in part)
            Lt_pad = -(-max(Lt_max, 128) // 128) * 128
            Wj = Lt_pad + 1
            tp = np.zeros((B, Lt_pad + 2, 20), np.float32)
            ttr = np.zeros((B, Lt_pad + 2, NTRANS), np.float32)
            use_spec = isinstance(part[0][2], RealignMaskSpec)
            if use_spec:
                P = max((len(sp.E) for _h, _t, sp in part), default=0)
                rect = np.zeros((B, 4), np.int32)
                corner = np.zeros(B, np.int32)
                tLv = np.zeros(B, np.int32)
                loF_c = np.ones((B, Wj), np.int16)
                hiF_c = np.zeros((B, Wj), np.int16)
                loF_r = np.ones((B, Lq + 1), np.int16)
                hiF_r = np.zeros((B, Lq + 1), np.int16)
                loE_c = np.ones((B, P, Wj), np.int16)
                hiE_c = np.zeros((B, P, Wj), np.int16)
                loE_r = np.ones((B, P, Lq + 1), np.int16)
                hiE_r = np.zeros((B, P, Lq + 1), np.int16)
                for b, (_h, t, sp) in enumerate(part):
                    rect[b] = (sp.i1, sp.j1, sp.i2, sp.j2)
                    corner[b] = sp.corner_j0
                    tLv[b] = sp.Lt
                    lc, hc, lr, hr = sp.F
                    loF_c[b, : sp.Lt + 1] = lc
                    hiF_c[b, : sp.Lt + 1] = hc
                    loF_r[b] = lr
                    hiF_r[b] = hr
                    for p, (lc, hc, lr, hr) in enumerate(sp.E):
                        loE_c[b, p, : sp.Lt + 1] = lc
                        hiE_c[b, p, : sp.Lt + 1] = hc
                        loE_r[b, p] = lr
                        hiE_r[b, p] = hr
            else:
                co = np.ones((B, Lq + 1, Wj), bool)
            need_ss = any(h.ssm2 for h, _t, _c in part)
            if need_ss:
                # dense SS factors, filled on the host for each hit
                ss_f = np.ones((B, Lq + 1, Wj), np.float32)
                ss0 = np.ones(B, np.float32)
            for b, (hit, t, co_h) in enumerate(part):
                tp[b, : t.L + 2] = t.p.astype(np.float32)
                ttr[b, : t.L + 2] = t.tr.astype(np.float32)
                if not use_spec:
                    co[b, :, : t.L + 1] = co_h
                if need_ss and hit.ssm2:
                    m = self._ss_matrix(q, t, hit.ssm2)
                    ss_f[b, :, : t.L + 1] = fm.fpow2(
                        m[: Lq + 1, : t.L + 1].astype(np.float32))
                    ss0[b] = fm.fpow2(np.float32(_score_ss_single(
                        q, t, 1, t.L + 1, self.ssw, hit.ssm2,
                        self.S73, self.S37, self.S33)))
            t_Ls = np.zeros(B, np.int32)
            t_Ls[: len(part)] = [t.L for _h, t, _c in part]
            kmax = Lq + Lt_pad + 2
            if use_spec:
                co_d = realign_mask_device(*(dev(x) for x in (
                    rect, corner, tLv, loF_c, hiF_c, loF_r, hiF_r, loE_c,
                    hiE_c, loE_r, hiE_r)))
            else:
                co_d = dev(co)
            b_mac, i2_d, j2_d, p_mm_d, _sc, _pf = fb_mac_rows(
                qp, qtr, dev(tp), dev(ttr), co_d, shift, mact,
                dev(ss_f) if need_ss else None,
                dev(ss0) if need_ss else None, local=self.local,
                t_L=dev(t_Ls))
            packed_d = mac_walk_packed8(b_mac, p_mm_d, i2_d, j2_d,
                                        torch.zeros(B, device=device), kmax)
            del co_d, b_mac, p_mm_d, _sc, _pf
            stage_add("host_realign_assemble", time.perf_counter() - t0)

            t0 = time.perf_counter()
            (_score, i2, j2, n, mm_count, empty, st, ii,
             jj, post) = mac_walk_unpack8(packed_d.cpu().numpy(), kmax)
            stage_add("posterior_fetch_wait", time.perf_counter() - t0)

            t0 = time.perf_counter()
            for b, (hit, t, _co_h) in enumerate(part):
                saved = (hit.score, hit.score_ss, hit.score_aass,
                         hit.Pval, hit.Pvalt, hit.logPval, hit.logPvalt,
                         hit.Eval, hit.logEval, hit.Probab)
                hit.i2 = int(i2[b])
                hit.j2 = int(j2[b])
                if empty[b]:
                    hit.matched_cols = 1
                    hit.i = np.array([hit.i2], np.int32)
                    hit.j = np.array([hit.j2], np.int32)
                    hit.states = np.zeros(1, np.int8)
                    hit.nsteps = 0
                    hit.i1 = hit.i2
                    hit.j1 = hit.j2
                    hit.alt_i = [hit.i2]
                    hit.alt_j = [hit.j2]
                    P_post = np.zeros(1, np.float32)
                else:
                    nb = int(n[b])
                    hit.nsteps = nb
                    hit.i = np.zeros(nb + 1, np.int32)
                    hit.j = np.zeros(nb + 1, np.int32)
                    hit.states = np.zeros(nb + 1, np.int8)
                    hit.i[1:] = ii[b, :nb]
                    hit.j[1:] = jj[b, :nb]
                    hit.states[1:] = st[b, :nb]
                    hit.states[nb] = MM       # reference overwrite
                    hit.matched_cols = 1 + int(mm_count[b])
                    hit.i1 = int(hit.i[nb])
                    hit.j1 = int(hit.j[nb])
                    hit.alt_i = ii[b, :nb].astype(np.int64)
                    hit.alt_j = jj[b, :nb].astype(np.int64)
                    # posteriors only at MM steps (the host gathers
                    # AFTER the terminal-state MM overwrite, so the
                    # last step's posterior is included either way)
                    P_post = np.zeros(nb + 1, np.float32)
                    mm_mask = hit.states[1:] == MM
                    P_post[1:][mm_mask] = post[b, :nb][mm_mask]
                self._rescore_mac_path(q, t, hit, None, corr,
                                       P_post=P_post)
                (hit.score, hit.score_ss, hit.score_aass, hit.Pval,
                 hit.Pvalt, hit.logPval, hit.logPvalt, hit.Eval,
                 hit.logEval, hit.Probab) = saved
                hit.P_MM = None
            stage_add("host_realign_write", time.perf_counter() - t0)

    def _forward(self, q, t, hit, p_mm, co, shift, scale):
        """hhforwardalgorithm.cpp:10-220 (double precision, row scaled)."""
        Lq, Lt = q.L, t.L
        local = self.local
        pmin = 1.0 if local else 0.0
        Cshift = 2.0 ** float(np.float32(shift))
        qp = q.p.astype(np.float64)
        tp = t.p.astype(np.float64)
        qtr = q.tr.astype(np.float64)
        ttr = t.tr.astype(np.float64)
        ssm2 = hit.ssm2

        def probfwd(i, j):
            return float(fm.scalar_prod20(q.p[i], t.p[j]))

        # row i = 1
        curr = np.zeros((Lt + 1, 5))   # columns: mm, mi, dg, im, gd
        MMc, MIc, DGc, IMc, GDc = 0, 1, 2, 3, 4
        for j in range(1, Lt + 1):
            if co[1, j]:
                continue
            curr[j, MMc] = probfwd(1, j) * Cshift
            curr[j, IMc] = (curr[j - 1, MMc] * qtr[1, M2I] * ttr[j - 1, M2M]
                            + curr[j - 1, IMc] * qtr[1, I2I]
                            * ttr[j - 1, M2M])
            curr[j, GDc] = (curr[j - 1, MMc] * ttr[j - 1, M2D]
                            + curr[j - 1, GDc] * ttr[j - 1, D2D])
        p_mm[1, :] = curr[:, MMc]
        prev = curr.copy()
        scale[0] = scale[1] = scale[2] = 1.0
        scale_prod = 1.0

        for i in range(2, Lq + 1):
            jmin = 1
            if scale_prod < DBL_MIN * 100:
                scale_prod = 0.0
            else:
                scale_prod *= scale[i]
            curr = np.zeros((Lt + 1, 5))
            if not co[i, jmin]:
                # reference reads ScoreSS at (1, j=t.L+1): zero with no SS
                ss0 = _score_ss_single(q, t, 1, Lt + 1, self.ssw, ssm2,
                                       self.S73, self.S37, self.S33)
                curr[jmin, MMc] = (scale_prod * fm.fpow2(np.float32(ss0))
                                   * probfwd(i, jmin) * Cshift)
                curr[jmin, MIc] = scale[i] * (
                    prev[jmin, MMc] * qtr[i - 1, M2M] * ttr[jmin, M2I]
                    + prev[jmin, MIc] * qtr[i - 1, M2M] * ttr[jmin, I2I])
                curr[jmin, DGc] = scale[i] * (
                    prev[jmin, MMc] * qtr[i - 1, M2D]
                    + prev[jmin, DGc] * qtr[i - 1, D2D])
            p_mm[i, jmin] = curr[jmin, MMc]
            Pmax_i = 0.0
            row_co = co[i]
            for j in range(jmin + 1, Lt + 1):
                if row_co[j]:
                    continue
                ss = _score_ss_single(q, t, i, j, self.ssw, ssm2,
                                      self.S73, self.S37, self.S33)
                mm = (probfwd(i, j) * Cshift
                      * float(fm.fpow2(np.float32(ss))) * scale[i]
                      * (pmin
                         + prev[j - 1, MMc] * qtr[i - 1, M2M]
                         * ttr[j - 1, M2M]
                         + prev[j - 1, GDc] * qtr[i - 1, M2M]
                         * ttr[j - 1, D2M]
                         + prev[j - 1, IMc] * qtr[i - 1, I2M]
                         * ttr[j - 1, M2M]
                         + prev[j - 1, DGc] * qtr[i - 1, D2M]
                         * ttr[j - 1, M2M]
                         + prev[j - 1, MIc] * qtr[i - 1, M2M]
                         * ttr[j - 1, I2M]))
                curr[j, MMc] = mm
                curr[j, GDc] = (curr[j - 1, MMc] * ttr[j - 1, M2D]
                                + curr[j - 1, GDc] * ttr[j - 1, D2D])
                curr[j, IMc] = (curr[j - 1, MMc] * qtr[i, M2I]
                                * ttr[j - 1, M2M]
                                + curr[j - 1, IMc] * qtr[i, I2I]
                                * ttr[j - 1, M2M])
                curr[j, DGc] = scale[i] * (prev[j, MMc] * qtr[i - 1, M2D]
                                           + prev[j, DGc] * qtr[i - 1, D2D])
                curr[j, MIc] = scale[i] * (
                    prev[j, MMc] * qtr[i - 1, M2M] * ttr[j, M2I]
                    + prev[j, MIc] * qtr[i - 1, M2M] * ttr[j, I2I])
                if mm > Pmax_i:
                    Pmax_i = mm
            p_mm[i, :] = curr[:, MMc]
            prev = curr
            pmin *= scale[i]
            if pmin < DBL_MIN * 100:
                pmin = 0.0
            scale[i + 1] = 1.0 / (Pmax_i + 1.0)

        # total forward probability (hhforwardalgorithm.cpp:150-178)
        # sequential (left-to-right) row sums like the reference's C++
        # accumulation loop — numpy's pairwise .sum() rounds differently
        if local:
            Pforward = 1.0
            for i in range(1, Lq + 1):
                Pforward += float(np.cumsum(p_mm[i, 1:])[-1])
                Pforward *= scale[i + 1]
        else:
            Pforward = 0.0
            for i in range(1, Lq):
                Pforward = (Pforward + p_mm[i, Lt]) * scale[i + 1]
            Pforward += float(np.cumsum(p_mm[Lq, 1:])[-1])
            Pforward *= scale[Lq + 1]
        hit.Pforward = Pforward

        score = math.log2(Pforward) - 10.0
        for i in range(1, Lq + 2):
            score -= math.log2(scale[i])
        if local:
            score -= math.log(Lt * Lq) / LAMDA + 14.0
        hit.score = score

        # sparse forward triples for -omat (hhforwardalgorithm.cpp:
        # 185-220): rescale row-i forward values to final scaling
        THR = 1e-4
        fwd = []
        scale_prod_curr = 1.0
        for i in range(1, Lq + 1):
            if scale_prod_curr < DBL_MIN * 100:
                scale_prod_curr = 0.0
            else:
                scale_prod_curr *= scale[i]
            if scale_prod_curr == 0.0:
                continue
            scale_rate = (scale_prod * scale[Lq + 1]) / scale_prod_curr
            vals = p_mm[i, 1:] / Pforward * scale_rate
            for j in np.nonzero(vals > THR)[0]:
                fwd.append((i, int(j) + 1, float(vals[j])))
        self._forward_entries = fwd

    def _backward(self, q, t, hit, p_mm, co, shift, scale):
        """hhbackwardalgorithm.cpp (double precision)."""
        Lq, Lt = q.L, t.L
        Cshift = 2.0 ** float(np.float32(shift))
        qtr = q.tr.astype(np.float64)
        ttr = t.tr.astype(np.float64)
        ssm2 = hit.ssm2
        MMc, MIc, DGc, IMc, GDc = 0, 1, 2, 3, 4

        def probfwd(i, j):
            return float(fm.scalar_prod20(q.p[i], t.p[j]))

        prev = np.zeros((Lt + 2, 5))
        for j in range(Lt, 0, -1):
            if co[Lq, j]:
                p_mm[Lq, j] = 0.0
            else:
                prev[j, MMc] = scale[Lq + 1]
                p_mm[Lq, j] = p_mm[Lq, j] * scale[Lq + 1] / hit.Pforward

        pmin = scale[Lq + 1] if self.local else 0.0
        scale_prod = scale[Lq + 1]
        final_scale_prod = scale[Lq + 1]
        for i in range(Lq - 1, 0, -1):
            final_scale_prod *= scale[i + 1]
            if final_scale_prod < DBL_MIN * 100:
                final_scale_prod = 0.0
        bwd = []

        for i in range(Lq - 1, 0, -1):
            jmin = 1
            scale_prod *= scale[i + 1]
            if scale_prod < DBL_MIN * 100:
                scale_prod = 0.0
            curr = np.zeros((Lt + 2, 5))
            if co[i, Lt]:
                p_mm[i, Lt] = 0.0
            else:
                curr[Lt, MMc] = scale_prod
                p_mm[i, Lt] = p_mm[i, Lt] * scale_prod / hit.Pforward
            pmin *= scale[i + 1]
            if pmin < DBL_MIN * 100:
                pmin = 0.0
            row_co = co[i]
            for j in range(Lt - 1, jmin - 1, -1):
                if row_co[j]:
                    continue
                ss = _score_ss_single(q, t, i + 1, j + 1, self.ssw, ssm2,
                                      self.S73, self.S37, self.S33)
                pmatch = (prev[j + 1, MMc] * probfwd(i + 1, j + 1)
                          * float(fm.fpow2(np.float32(ss))) * Cshift
                          * scale[i + 1])
                curr[j, MMc] = (pmin
                                + pmatch * qtr[i, M2M] * ttr[j, M2M]
                                + curr[j + 1, GDc] * ttr[j, M2D]
                                + curr[j + 1, IMc] * qtr[i, M2I]
                                * ttr[j, M2M]
                                + prev[j, DGc] * qtr[i, M2D] * scale[i + 1]
                                + prev[j, MIc] * qtr[i, M2M] * ttr[j, M2I]
                                * scale[i + 1])
                curr[j, GDc] = (pmatch * qtr[i, M2M] * ttr[j, D2M]
                                + curr[j + 1, GDc] * ttr[j, D2D])
                curr[j, IMc] = (pmatch * qtr[i, I2M] * ttr[j, M2M]
                                + curr[j + 1, IMc] * qtr[i, I2I]
                                * ttr[j, M2M])
                curr[j, DGc] = (pmatch * qtr[i, D2M] * ttr[j, M2M]
                                + prev[j, DGc] * qtr[i, D2D]
                                * scale[i + 1])
                curr[j, MIc] = (pmatch * qtr[i, M2M] * ttr[j, I2M]
                                + prev[j, MIc] * qtr[i, M2M] * ttr[j, I2I]
                                * scale[i + 1])
            for jj in range(jmin, Lt):
                p_mm[i, jj] *= curr[jj, MMc] / hit.Pforward
            # sparse backward triples for -omat
            # (hhbackwardalgorithm.cpp:111-122)
            if final_scale_prod != 0.0 and scale_prod != 0.0:
                for j in range(jmin, Lt):
                    if row_co[j] or curr[j, MMc] == 0.0:
                        continue
                    val = (probfwd(i, j) * Cshift * curr[j, MMc]
                           / hit.Pforward * final_scale_prod / scale_prod)
                    if val > 1e-4:
                        bwd.append((i, j, float(val)))
            prev = curr
        self._backward_entries = sorted(bwd)

    def _mac(self, q, t, hit, p_mm, co, mact) -> np.ndarray:
        """hhmacalgorithm.cpp (float32 S values like the reference)."""
        Lq, Lt = q.L, t.L
        b = np.zeros((Lq + 1, Lt + 1), dtype=np.uint8)
        S_prev = np.zeros(Lt + 1, dtype=np.float32)
        score_MAC = -FLT_MAX
        hit.i2 = hit.j2 = 0
        mact32 = np.float32(mact)
        half = np.float32(0.5) * mact32
        for i in range(1, Lq + 1):
            S_curr = np.zeros(Lt + 1, dtype=np.float32)
            row_co = co[i]
            for j in range(1, Lt + 1):
                if row_co[j]:
                    S_curr[j] = -FLT_MIN
                    b[i, j] = STOP
                    continue
                post = np.float32(p_mm[i, j])
                term1 = post - mact32
                term2 = S_prev[j - 1] + post - mact32
                term3 = S_prev[j] - half
                term4 = S_curr[j - 1] - half
                if term1 > term2:
                    mx, val = term1, STOP
                else:
                    mx, val = term2, MM
                if term3 > mx:
                    mx, val = term3, MI
                if term4 > mx:
                    mx, val = term4, IM
                S_curr[j] = mx
                b[i, j] = val
                if mx > score_MAC and (self.local or i == Lq):
                    hit.i2, hit.j2 = i, j
                    score_MAC = mx
            if not self.local and S_curr[Lt] > score_MAC:
                hit.i2, hit.j2 = i, Lt
                score_MAC = S_curr[Lt]
            S_prev = S_curr
        return b

    def _backtrace_mac(self, q, t, hit, p_mm, co, b, corr):
        """hhbacktracemac.cpp:111-304."""
        Lq, Lt = q.L, t.L
        b = b.copy()
        b[:, 1] = STOP
        b[1, 1: Lt + 1] = STOP

        hit.matched_cols = 1
        state = MM
        i, j = hit.i2, hit.j2
        i_steps = [0]
        j_steps = [0]
        states = [0]
        alt_i: List[int] = []
        alt_j: List[int] = []
        if b[i, j] != MM:
            i_steps[0] = i
            j_steps[0] = j
            alt_i.append(i)
            alt_j.append(j)
            state = STOP
            nsteps = 0
        else:
            while state != STOP:
                state = int(b[i, j])
                states.append(state)
                i_steps.append(i)
                j_steps.append(j)
                alt_i.append(i)
                alt_j.append(j)
                co[max(i - 2, 1): min(i + 2, Lq) + 1, j] = True
                co[i, max(j - 2, 1): min(j + 2, Lt) + 1] = True
                if state == MM:
                    hit.matched_cols += 1
                    i -= 1
                    j -= 1
                elif state == IM:
                    j -= 1
                elif state == MI:
                    i -= 1
                elif state == STOP:
                    pass
                else:
                    state = STOP
            nsteps = len(states) - 1
            states[nsteps] = MM

        hit.i = np.array(i_steps, dtype=np.int32)
        hit.j = np.array(j_steps, dtype=np.int32)
        hit.states = np.array(states, dtype=np.int8)
        hit.nsteps = nsteps
        hit.i1 = int(hit.i[nsteps]) if nsteps else int(hit.i[0])
        hit.j1 = int(hit.j[nsteps]) if nsteps else int(hit.j[0])
        hit.alt_i = alt_i
        hit.alt_j = alt_j

        self._rescore_mac_path(q, t, hit, p_mm, corr)

    def _rescore_mac_path(self, q, t, hit, p_mm, corr, P_post=None):
        """Rescoring along the MAC path (hhbacktracemac.cpp:186-254);
        the per-MM-step dot/log2/table lookups are batched through
        the vectorized fastmath twins (bit-identical elementwise),
        only the reference's SEQUENTIAL f32/f64 accumulators stay as
        O(path) python loops to preserve its rounding order.

        ``P_post`` (len nsteps+1, step-indexed) replaces the p_mm
        gather when the posteriors were already collected on device.
        """
        nsteps = hit.nsteps
        S = np.zeros(nsteps + 1, dtype=np.float32)
        S_ss = np.zeros(nsteps + 1, dtype=np.float32)
        if P_post is None:
            P_post = np.zeros(nsteps + 1, dtype=np.float32)
            gather_post = True
        else:
            P_post = np.asarray(P_post, dtype=np.float32)
            gather_post = False
        ssm = hit.ssm1 + hit.ssm2
        mm_steps = np.nonzero(hit.states[1: nsteps + 1] == MM)[0] + 1
        if mm_steps.size:
            si = hit.i[mm_steps].astype(np.int64)
            sj = hit.j[mm_steps].astype(np.int64)
            S[mm_steps] = fm.fast_log2(
                fm.scalar_prod20(q.p[si], t.p[sj]))
            if ssm and self.S73 is not None:
                ic = np.minimum(si, q.ss_pred.shape[0] - 1)
                jc = np.minimum(sj, t.ss_pred.shape[0] - 1)
                if ssm == 1:      # PRED_DSSP
                    sv = self.S37[q.ss_pred[ic], q.ss_conf[ic],
                                  t.ss_dssp[jc]]
                elif ssm == 2:    # DSSP_PRED
                    sv = self.S73[q.ss_dssp[ic], t.ss_pred[jc],
                                  t.ss_conf[jc]]
                elif ssm == 3:    # PRED_PRED
                    sv = self.S33[q.ss_pred[ic], q.ss_conf[ic],
                                  t.ss_pred[jc], t.ss_conf[jc]]
                else:
                    sv = np.zeros(mm_steps.size, dtype=np.float32)
                # f64 product then one f32 rounding, like the scalar
                # ssw * float(table[...]) expression
                S_ss[mm_steps] = (np.float64(self.ssw)
                                  * sv.astype(np.float64)).astype(
                                      np.float32)
            if gather_post:
                P_post[mm_steps] = p_mm[si, sj]
        from ..native import load as _load_native

        nat = _load_native()
        if nat is not None:
            # identical f32 accumulation order: non-MM steps hold exact
            # +0.0 which is an identity under f32 addition, so summing
            # all steps equals summing the MM subset bit for bit
            score_ss_f, corr_term = nat.backtrace_score_terms(
                np.ascontiguousarray(S), np.ascontiguousarray(S_ss),
                int(nsteps), float(np.float32(corr)))
            score_ss = np.float32(score_ss_f)
        else:
            score_ss = np.float32(0.0)
            for v in S_ss[mm_steps]:
                score_ss = np.float32(score_ss + v)
            scorr = np.float32(0.0)
            if nsteps:
                for lag in (1, 2, 3, 4):
                    prods = np.float32(S[1: nsteps + 1 - lag]
                                       * S[1 + lag: nsteps + 1])
                    for v in prods:
                        scorr = np.float32(scorr + v)
            corr_term = float(np.float32(corr) * scorr) if nsteps else 0.0
        sum_of_probs = 0.0
        if mm_steps.size:
            keep = (np.ones(mm_steps.size, bool) if t.nss_dssp < 0
                    else t.ss_dssp[hit.j[mm_steps].astype(np.int64)] > 0)
            for v in P_post[mm_steps][keep]:
                sum_of_probs += float(v)
        hit.S = S
        hit.S_ss = S_ss
        hit.P_posterior = P_post
        hit.sum_of_probs = sum_of_probs
        hit.score_ss = float(score_ss)
        if hit.ssm2 >= 1:
            hit.score -= hit.score_ss
        if nsteps:
            hit.score += float(np.float32(corr_term))
        hit.score_aass = -hit.score
        hit.logPval = 0.0
        hit.Pval = 1.0
        if t.mu:
            hit.logPvalt = float(log_pvalue(hit.score, t.lamda, t.mu))
            hit.Pvalt = float(pvalue(hit.score, t.lamda, t.mu))
        else:
            hit.logPvalt = 0.0
            hit.Pvalt = 1.0
