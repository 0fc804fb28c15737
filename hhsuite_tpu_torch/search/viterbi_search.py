"""Viterbi search scheduling: template batches -> scored Hits.

Replacement for ViterbiRunner (src/hhviterbirunner.cpp:75-330):
templates are length-bucketed and held on the device in a resident pack
(the batch axis replaces the reference's VECSIZE_FLOAT SIMD lanes and
OpenMP threads), the Viterbi kernels score a whole batch per launch, the
backtrace is walked on the device and only a per-lane state string
reaches the host, where each path is rescored like ScoreForBacktrace
(src/hhviterbi.cpp:195-283).  The alternative-alignment loop with path
exclusion (par.altali, src/hhviterbirunner.cpp:104-194) builds its
cell-off masks on the device from band intervals.

Kernels on this path (``ops/``): K1 ``viterbi_score_lanes_fused`` (the
funnel's score-only sweep), K6 ``viterbi_score_lanes`` (the sweep when
secondary structure enters the DP), K2 ``viterbi_backtrace_lanes`` (the
hot backtrace pass), K3 ``viterbi_batch_rows`` (altali passes, SS in
the DP, global mode, long queries) and W1 ``backtrace_walk_packed8``
(the walk of each K2/K3 batch into its payload; a junk's payloads are
copied to the host after its last batch).  On the CPU every wrapper
runs its plain PyTorch version, so one code path serves both devices.
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fastmath as fm
from ..constants import MAXCF, NDSSP, NSSPRED, Parameters
from ..core.hit import Hit
from ..core.hmm import HMM
from ..device import resolve_device
from ..ops import viterbi as V
from ..ops.viterbi_lanes import (viterbi_backtrace_lanes,
                                 viterbi_score_lanes,
                                 viterbi_score_lanes_fused)
from ..ops.viterbi_rows import viterbi_batch_rows
from ..profiling import annotate, stage_add

FLT_MAX = float(np.finfo(np.float32).max)

# ss_hmm_mode bit flags (hhhmm.h computeScoreSSMode)
NO_SS_INFORMATION = 0
PRED_DSSP = 1
DSSP_PRED = 2
PRED_PRED = 4


def compute_ss_hmm_mode(q: HMM, templates: List[HMM]) -> int:
    """HMM::computeScoreSSMode consensus over a batch followed by the
    reference's exact (quirky) mode-selection cascade
    (hhviterbirunner.cpp:14-22): effectively only PRED_PRED survives."""
    consensus = 0xFF
    for t in templates:
        mode = 0
        mode |= PRED_DSSP if (q.nss_pred >= 0 and t.nss_dssp >= 0) else 0
        mode |= DSSP_PRED if (q.nss_dssp >= 0 and t.nss_pred >= 0) else 0
        mode |= PRED_PRED if (q.nss_pred >= 0 and t.nss_pred >= 0) else 0
        consensus &= mode
    ss = consensus & PRED_DSSP
    ss = (consensus & DSSP_PRED) if ss == 0 else 0
    ss = (consensus & PRED_PRED) if ss == 0 else 0
    return ss


def pack_templates(templates: List[HMM], Lt_max: int, B: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack template HMMs into padded arrays (HMMSimd::MapHMMVector
    semantics, hhhmmsimd.cpp:86-160: pad tr with -FLT_MAX, p with 0).

    ``B`` > len(templates) pads extra all-zero lanes."""
    B = max(B, len(templates))
    tp = np.zeros((B, Lt_max + 2, 20), dtype=np.float32)
    ttr = np.full((B, Lt_max + 2, 7), -FLT_MAX, dtype=np.float32)
    t_L = np.zeros(B, dtype=np.int32)
    for b, t in enumerate(templates):
        L = t.L
        t_L[b] = L
        tp[b, : L + 1] = _template_p(t)[: L + 1]
        ttr[b, : L + 1] = t.tr[: L + 1]
    return tp, ttr, t_L


def to_device_pack(tp: np.ndarray, ttr: np.ndarray, t_L: np.ndarray,
                   device) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Move packed template arrays (``pack_templates`` output, JAX
    shapes (B, Lt+2, 20/7)) to ``device`` in the kernels' lanes-last
    storage, returned as (B, Lt+2, 20/7) views that the kernel wrappers
    read without a copy."""
    dev = torch.device(device)
    tpT = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tp, np.float32).transpose(1, 2, 0))).to(dev)
    ttrT = torch.from_numpy(np.ascontiguousarray(
        np.asarray(ttr, np.float32).transpose(1, 2, 0))).to(dev)
    tL = torch.from_numpy(np.asarray(t_L, np.int32).copy()).to(dev)
    return tpT.permute(2, 0, 1), ttrT.permute(2, 0, 1), tL


def _template_p(t: HMM) -> np.ndarray:
    """Divided (odds-ratio) profile of a search handout.

    engine.get_template_hmm_search defers include_null_model's f32
    division (hhhmm.cpp:2139-2142) because the resident pack replays it
    on device and the native decode replays it on host; any host consumer goes
    through here, which materializes the division once and promotes
    the handout to the divided state (bit-identical to dividing
    eagerly).

    NOT thread-safe on a SHARED handout (two racing callers could
    double-divide).  Handouts are per-call shell copies and each query
    runs its search single-threaded, so no current caller shares one;
    keep it that way or guard the promotion."""
    if getattr(t, "p_divided", True):
        return t.p
    t.p = (t.p.astype(np.float32, copy=False)
           / t.pnul_used[None, :])
    t.p_divided = True
    return t.p


def build_ss_score(q: HMM, t: HMM, ss_hmm_mode: int, ssw: float,
                   S73, S37, S33) -> Optional[np.ndarray]:
    """Precompute the (Lq+1, Lt+1) SS score matrix for one template
    (Viterbi::ScoreSS, hhviterbi.h:193-211), already ssw-weighted."""
    if ss_hmm_mode == NO_SS_INFORMATION:
        return None
    Lq, Lt = q.L, t.L
    out = np.zeros((Lq + 1, Lt + 1), dtype=np.float32)
    qi = np.arange(1, Lq + 1)
    tj = np.arange(1, Lt + 1)
    if ss_hmm_mode == PRED_DSSP:
        out[1:, 1:] = ssw * S37[q.ss_pred[qi][:, None],
                                q.ss_conf[qi][:, None],
                                t.ss_dssp[tj][None, :]]
    elif ss_hmm_mode == DSSP_PRED:
        out[1:, 1:] = ssw * S73[q.ss_dssp[qi][:, None],
                                t.ss_pred[tj][None, :],
                                t.ss_conf[tj][None, :]]
    elif ss_hmm_mode == PRED_PRED:
        out[1:, 1:] = ssw * S33[q.ss_pred[qi][:, None],
                                q.ss_conf[qi][:, None],
                                t.ss_pred[tj][None, :],
                                t.ss_conf[tj][None, :]]
    return out


def build_ss_lut(q: HMM, templates: List[HMM], ss_hmm_mode: int,
                 ssw: float, S73, S37, S33, Lt_max: int):
    """Device-side form of Viterbi::ScoreSS (hhviterbi.h:193-211):
    a flat ssw-weighted table plus per-query-row / per-template-column
    offsets such that ss(b,i,j) = lut[qidx[i] + tidx[b,j]].

    The HMM's SS arrays are int8; the offsets are computed in int32 (the
    query offsets reach 43 * 44 = 1892, which int8 arithmetic wraps)."""
    Lq = q.L
    qi = np.arange(1, Lq + 1)
    i32 = np.int32
    tidx = np.zeros((len(templates), Lt_max), dtype=i32)
    if ss_hmm_mode == PRED_DSSP:
        lut = (ssw * S37).reshape(-1).astype(np.float32)
        qidx = ((q.ss_pred[qi].astype(i32) * MAXCF + q.ss_conf[qi])
                * NDSSP)
        for b, t in enumerate(templates):
            tidx[b, : t.L] = t.ss_dssp[1: t.L + 1]
    elif ss_hmm_mode == DSSP_PRED:
        lut = (ssw * S73).reshape(-1).astype(np.float32)
        qidx = q.ss_dssp[qi].astype(i32) * (NSSPRED * MAXCF)
        for b, t in enumerate(templates):
            tj = np.arange(1, t.L + 1)
            tidx[b, : t.L] = t.ss_pred[tj].astype(i32) * MAXCF \
                + t.ss_conf[tj]
    else:  # PRED_PRED
        lut = (ssw * S33).reshape(-1).astype(np.float32)
        qidx = ((q.ss_pred[qi].astype(i32) * MAXCF + q.ss_conf[qi])
                * (NSSPRED * MAXCF))
        for b, t in enumerate(templates):
            tj = np.arange(1, t.L + 1)
            tidx[b, : t.L] = t.ss_pred[tj].astype(i32) * MAXCF \
                + t.ss_conf[tj]
    qidx = qidx.astype(i32)
    # K6 and K3 index the table without a bound on the card:
    # check the offsets here, on the host, where it costs no sync
    if (qidx.min() < 0 or tidx.min(initial=0) < 0
            or int(qidx.max()) + int(tidx.max(initial=0)) >= len(lut)):
        raise ValueError("SS table offsets out of range")
    return lut, qidx, tidx


def score_for_backtrace(q: HMM, t: HMM, align_score: float,
                        i_steps, j_steps, states, ss_hmm_mode: int,
                        ssw: float, ss_mode: int, corr: float,
                        S73, S37, S33) -> Tuple[float, float, np.ndarray,
                                                np.ndarray]:
    """Viterbi::ScoreForBacktrace (hhviterbi.cpp:195-283).

    Returns (score, score_ss, S, S_ss) with S/S_ss 1-based step arrays.
    """
    nsteps = len(i_steps) - 1
    S = np.zeros(nsteps + 1, dtype=np.float32)
    S_ss = np.zeros(nsteps + 1, dtype=np.float32)
    mm = states[1:] == V.MM
    steps = np.arange(1, nsteps + 1)
    mi = np.asarray(i_steps)[1:][mm]
    mj = np.asarray(j_steps)[1:][mm]
    if len(mi):
        S[steps[mm]] = fm.fast_log2(fm.scalar_prod20(q.p[mi],
                                                     _template_p(t)[mj]))
        if ss_hmm_mode != NO_SS_INFORMATION:
            if ss_hmm_mode == PRED_DSSP:
                sv = ssw * S37[q.ss_pred[mi], q.ss_conf[mi], t.ss_dssp[mj]]
            elif ss_hmm_mode == DSSP_PRED:
                sv = ssw * S73[q.ss_dssp[mi], t.ss_pred[mj], t.ss_conf[mj]]
            else:
                sv = ssw * S33[q.ss_pred[mi], q.ss_conf[mi],
                               t.ss_pred[mj], t.ss_conf[mj]]
            S_ss[steps[mm]] = sv
    # sequential float32 accumulation of score_ss and the correlation
    # term (hhviterbi.cpp:224-252) — bit-exact order; the native twin
    # runs the same f32 loops in C (~1 ms/hit -> ~1 us/hit)
    from ..native import load as _load_native

    nat = _load_native()
    if nat is not None:
        score_ss, corr_term = nat.backtrace_score_terms(
            np.ascontiguousarray(S), np.ascontiguousarray(S_ss),
            int(nsteps), float(np.float32(corr)))
        score_ss = np.float32(score_ss)
        score = np.float32(align_score)
        if ss_mode == 2:   # Hit::SCORE_ALIGNMENT: subtract kernel SS
            score = np.float32(score - score_ss)
        if nsteps:
            score = np.float32(score + np.float32(corr_term))
        return float(score), float(score_ss), S, S_ss
    score_ss = np.float32(0.0)
    for v in S_ss[1:]:
        score_ss = np.float32(score_ss + v)
    score = np.float32(align_score)
    if ss_mode == 2:  # Hit::SCORE_ALIGNMENT: subtract SS added in kernel
        score = np.float32(score - score_ss)
    # correlation term (hhviterbi.cpp:243-252)
    scorr = np.float32(0.0)
    if nsteps:
        Sf = S
        for lag in (1, 2, 3, 4):
            for step in range(1 + lag, nsteps + 1):
                scorr = np.float32(scorr + np.float32(Sf[step]
                                                      * Sf[step - lag]))
        score = np.float32(score + np.float32(corr) * scorr)
    return float(score), float(score_ss), S, S_ss


def calculate_early_stop(par: Parameters, q: HMM,
                         junk_hits: List[Hit]) -> float:
    """ViterbiRunner::calculateEarlyStop (hhviterbirunner.cpp:213-247):
    sum of 1/(1+E) over a scored block; the block loop stops when this
    falls below block_size * par.filter_thresh."""
    import math

    from ..core.hit import lamda_nn, log_pvalue, mu_nn

    if not junk_hits:
        return 0.0
    LOG1000 = math.log(1000.0)
    log_dbsize = math.log(max(par.dbsize, 1))
    log_pcut = math.log(par.prefilter_evalue_thresh / max(par.dbsize, 1))
    q_len = math.log(q.L) / LOG1000
    q_neff = q.Neff_HMM / 10.0
    n = len(junk_hits)
    hit_len = np.array([math.log(max(h.L, 1)) for h in junk_hits],
                       np.float64) / LOG1000
    hit_neff = np.array([h.Neff_HMM for h in junk_hits],
                        np.float64) / 10.0
    scores = np.array([h.score for h in junk_hits], np.float64)
    qlv = np.full(n, q_len)
    qnv = np.full(n, q_neff)
    lam = lamda_nn(qlv, hit_len, qnv, hit_neff)
    mu = mu_nn(qlv, hit_len, qnv, hit_neff)
    logp = log_pvalue(scores, lam, mu)
    alpha = np.float64(0.0)
    if par.prefilter:
        alpha = par.alphaa + par.alphab * (hit_neff - 1) \
            * (1 - par.alphac * (q_neff - 1))
    eval_ = np.exp(logp + log_dbsize + alpha * log_pcut)
    return float(np.sum(1.0 / (1.0 + eval_)))


def _funnel_ok(device: torch.device) -> bool:
    """Hardware gate for the two-pass score-only funnel: on the card
    (tests force it on the CPU by patching this)."""
    return device.type == "cuda"


# backtrace-pass lanes per launch: on the card, batches wide enough to
# fill it (the K2 byte matrix is ~1 B/cell: 4096 x 513 x 513 = 1.1 GB at
# the widest bucket); on the CPU, wide enough to amortise the plain
# version's per-diagonal tensor ops
BT_BATCH = {"cuda": 4096, "cpu": 256}
# score-sweep lanes per K1/K6 launch (the JAX package's SB: the SS mode
# is decided per chunk, so both packages must cut the same chunks)
SWEEP_BATCH = 8192


def _lanes_impl() -> str:
    """Which kernel sweeps a chunk with no SS term (HHSUITE_TPU_SI_MODE,
    as in the JAX package): ``"fused"`` (default) K1 with the fast
    quartic log2, ``"exact"`` K1 with log2f4, ``"split"`` K6 with no SS
    term (bit-identical to ``"exact"`` here)."""
    v = os.environ.get("HHSUITE_TPU_SI_MODE", "fused").strip().lower()
    if v not in ("fused", "exact", "split"):
        raise ValueError(f"HHSUITE_TPU_SI_MODE must be fused, exact or "
                         f"split: {v!r}")
    return v


class _PackDisabled:
    """Sentinel: the resident pack was declined (device-memory budget)
    — callers must not build the local fallback pack either, or the
    budget check is defeated."""


PACK_DISABLED = _PackDisabled()


class ResidentTemplatePack:
    """Device-resident RAW template arrays, bucketed by padded length,
    incrementally grown and cached per database.

    The altali loop re-aligns the same templates up to ``par.altali``
    times and the funnel sweeps them once more; each template's arrays
    upload ONCE (length-bucketed so padding stays tight) and every batch
    is an on-device gather by row index plus a (B, 20) null-model
    vector.

    Storage is lanes-last — (Lt+2, 20, cap) profiles and (Lt+2, 7, cap)
    transitions — so a gathered batch is already in the kernels'
    layout.

    Query independence: rows hold the template profile BEFORE the
    null-model division (include_null_model, hhhmm.cpp:2059-2144 — the
    only query-dependent template stage).  The per-template pnul vectors
    are computed on host exactly like include_null_model and the
    division runs on the device per batch (f32 IEEE divide == numpy's,
    bit-exact), so the same resident rows serve every query.

    Capacity grows by doubling (one spare row past ``used`` is the
    all-padding row that fills partial batches).
    """

    def __init__(self, device, bucket: int = 128):
        self.device = torch.device(device)
        self.bucket_size = bucket
        self.row_of: Dict[str, Tuple[int, int]] = {}   # name -> (b,row)
        self.buckets: Dict[int, dict] = {}
        self.approx_bytes = 0      # device-resident footprint estimate

    def _bucket_for(self, L: int) -> int:
        b = self.bucket_size
        return max(b, -(-L // b) * b)

    def ensure(self, items: List[Tuple[str, HMM]]):
        """Upload any templates not yet resident.  ``items`` are
        (name, PRE-division HMM) — e.g. the parsed-HMM cache entries
        from get_template_hmm_prepared, read-only."""
        new_by_bucket: Dict[int, List[Tuple[str, HMM]]] = {}
        for name, t in items:
            if name not in self.row_of:
                new_by_bucket.setdefault(self._bucket_for(t.L),
                                         []).append((name, t))
        for Lt_pad, new in new_by_bucket.items():
            bk = self.buckets.get(Lt_pad)
            have = bk["used"] if bk else 0
            need = have + len(new)
            cap = bk["cap"] if bk else 0
            if need + 1 > cap:       # +1 for the null row
                new_cap = max(16, 1 << (need + 1).bit_length())
                tp = np.zeros((new_cap, Lt_pad + 2, 20), np.float32)
                ttr = np.full((new_cap, Lt_pad + 2, 7), -FLT_MAX,
                              np.float32)
                t_L = np.zeros(new_cap, np.int32)
                if bk is not None:
                    tp[:have] = bk["tp_h"][:have]
                    ttr[:have] = bk["ttr_h"][:have]
                    t_L[:have] = bk["t_L_h"][:have]
                self.approx_bytes += ((new_cap - cap)
                                      * (Lt_pad + 2) * 27 * 4)
                bk = self.buckets[Lt_pad] = {
                    "tp_h": tp, "ttr_h": ttr, "t_L_h": t_L,
                    "used": have, "cap": new_cap}
            for name, t in new:
                row = bk["used"]
                L = t.L
                bk["tp_h"][row, : L + 1] = _template_p(t)[: L + 1]
                bk["ttr_h"][row, : L + 1] = t.tr[: L + 1]
                bk["t_L_h"][row] = L
                bk["used"] = row + 1
                self.row_of[name] = (Lt_pad, row)
            bk["tp"], bk["ttr"], bk["t_L"] = to_device_pack(
                bk["tp_h"], bk["ttr_h"], bk["t_L_h"], self.device)

    def projected_bytes(self, items: List[Tuple[str, HMM]]) -> int:
        """Device footprint AFTER ensure(items) would run, mirroring
        its bucket/pow2-capacity allocation math."""
        new_per_bucket: Dict[int, int] = {}
        for name, t in items:
            if name not in self.row_of:
                b = self._bucket_for(t.L)
                new_per_bucket[b] = new_per_bucket.get(b, 0) + 1
        total = self.approx_bytes
        for Lt_pad, n_new in new_per_bucket.items():
            bk = self.buckets.get(Lt_pad)
            have = bk["used"] if bk else 0
            cap = bk["cap"] if bk else 0
            need = have + n_new
            if need + 1 > cap:
                new_cap = max(16, 1 << (need + 1).bit_length())
                total += (new_cap - cap) * (Lt_pad + 2) * 27 * 4
        return total

    def gather(self, Lt_pad: int, names: List[str], pnul: np.ndarray,
               Bp: int):
        """One batch of ``Bp`` lanes gathered on the device and divided
        by the per-lane null model ``pnul`` (Bp, 20): (tp, ttr, t_L) in
        the JAX shapes, tp/ttr as views of lanes-last storage.  Lanes
        past ``names`` read the null (all-padding) row."""
        bk = self.buckets[Lt_pad]
        idx = np.full(Bp, bk["cap"] - 1, dtype=np.int64)
        for k, name in enumerate(names):
            idx[k] = self.row_of[name][1]
        idx_d = torch.from_numpy(idx).to(self.device)
        pn = torch.from_numpy(np.ascontiguousarray(pnul.T)).to(self.device)
        tpT = bk["tp"].permute(1, 2, 0)[:, :, idx_d] / pn[None]
        ttrT = bk["ttr"].permute(1, 2, 0)[:, :, idx_d]
        return tpT.permute(2, 0, 1), ttrT.permute(2, 0, 1), bk["t_L"][idx_d]


def _payload(packed: torch.Tensor) -> np.ndarray:
    """Bring a walk payload to the host (the backtrace passes' only
    device->host transfer)."""
    return np.ascontiguousarray(packed.cpu().numpy())


def _host_to(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def viterbi_search(par: Parameters, q: HMM, templates: List[Tuple[str, HMM]],
                   ss_matrices=None, allow_funnel: bool = True,
                   resident_pack=None, device=None) -> List[Hit]:
    """Align query against prepared template HMMs, with the altali loop.

    ``templates``: list of (entry_name, prepared HMM).  Returns all hits
    (irep 1..altali) exactly like ViterbiRunner::alignment.

    On the card the first alignment pass runs a two-pass funnel: the
    score-only K1 sweep scores every template, then only candidates that
    can be displayed, realigned, or enter the altali loop — the running
    global top-2*max(Z,B,realign_max) by score plus everything above
    par.smin — go through the backtrace pass for full paths.  The rest
    become path-less "light" hits (hit.light=True) that carry the sweep
    score for E-values and early stopping but are never printed with
    alignments or realigned.  This mirrors the reference's display /
    realign caps (src/hhdecl.cpp:165-169); light hits lack the
    correlation-score term (src/hhviterbi.cpp:243-252), which only
    affects hits far outside the reporting caps.  When secondary
    structure enters the DP (``ssm`` 2 and SS on both sides) the sweep
    is K6 with the SS term; a light hit then carries the sweep score,
    SS included, where a full hit's score has ``score_ss`` subtracted
    (as in the JAX package).
    """
    dev = resolve_device(device if resident_pack is None
                         or resident_pack is PACK_DISABLED
                         else resident_pack.device)
    if ss_matrices is not None:
        S73, S37, S33 = (ss_matrices.S73, ss_matrices.S37, ss_matrices.S33)
    else:
        S73 = S37 = S33 = None

    batch_size = BT_BATCH[dev.type]
    smin = par.smin
    hits: List[Hit] = []
    # per-template accumulated exclusion paths
    exclude: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}

    alive = list(range(len(templates)))
    tmpl_list = [t for _, t in templates]
    shift = np.float32(par.shift)

    pack = None
    pack_names: List[str] = []
    pack_pnul: Optional[np.ndarray] = None
    # the pack path (K2 hot batches, Lq bucketing) assumes zero end-gap
    # penalties; with egq/egt the batches are packed per launch and go
    # to K3, which takes them
    if (resident_pack is not PACK_DISABLED and par.egq == 0.0
            and par.egt == 0.0):
        with annotate("template_pack_upload"):
            names = [str(n) for n, _t in templates]
            if resident_pack is not None and \
                    all(n in resident_pack.row_of for n in names):
                # engine-cached raw pack: rows are pre-division, the
                # per-template pnul vectors replay include_null_model
                # on the device
                pack = resident_pack
                pack_names = names
                pack_pnul = np.stack(
                    [np.asarray(t.pnul_used, np.float32)
                     for _n, t in templates])
            else:
                # local pack (hhalign, promote passes): rows are the
                # already-divided arrays, the division is by 1.0
                pack = ResidentTemplatePack(dev)
                pack_names = [f"\x00{i}" for i in range(len(tmpl_list))]
                pack.ensure(list(zip(pack_names, tmpl_list)))
                pack_pnul = np.ones((len(tmpl_list), 20), np.float32)

    def _pnul_lanes(idxs: List[int], Bp: int) -> np.ndarray:
        out = np.ones((Bp, 20), np.float32)
        out[: len(idxs)] = pack_pnul[idxs]
        return out

    # ---- query-length bucketing (pack path, local mode, no SS) ----
    # pad the kernels' view of the query to a 32-row bucket; padded rows
    # carry zero profiles / -inf transitions and are excluded from the
    # best cell via Lq_true.  Host-side rescoring always uses the REAL
    # q (paths never enter padded rows).
    Lq_real = q.L
    Lq_use = Lq_real
    qp_use = q.p.astype(np.float32)
    qtr_use = q.tr.astype(np.float32)
    if (pack is not None and bool(par.loc)
            and q.nss_pred < 0 and q.nss_dssp < 0):
        Lq_use = max(32, -(-Lq_real // 32) * 32)
        if Lq_use > Lq_real:
            qp_pad = np.zeros((Lq_use + 2, 20), np.float32)
            qp_pad[: Lq_real + 2] = qp_use
            qtr_pad = np.full((Lq_use + 2, 7), -FLT_MAX, np.float32)
            qtr_pad[: Lq_real + 2] = qtr_use
            qp_use, qtr_use = qp_pad, qtr_pad
    qp_d = _host_to(qp_use, dev)
    qtr_d = _host_to(qtr_use, dev)
    # the unbucketed query, for the per-batch packing path
    qp_real_d = _host_to(q.p.astype(np.float32), dev)
    qtr_real_d = _host_to(q.tr.astype(np.float32), dev)

    def _run_junk(junk):
        _t_p1 = _time.perf_counter()
        pending = []
        if pack is not None:
            # resident-pack path: group by length bucket, batches are
            # on-device gathers (no per-batch template upload)
            by_bucket: Dict[int, List[int]] = {}
            for i in junk:
                by_bucket.setdefault(pack.row_of[pack_names[i]][0],
                                     []).append(i)
            batches = [(lt, ids[s: s + batch_size])
                       for lt in sorted(by_bucket, reverse=True)
                       for ids in (by_bucket[lt],)
                       for s in range(0, len(ids), batch_size)]
        else:
            batches = [(None, junk[s: s + batch_size])
                       for s in range(0, len(junk), batch_size)]
        for bucket_lt, idxs in batches:
            batch = [tmpl_list[i] for i in idxs]
            # quantize the lane count: a power of two below 256, a
            # multiple of 256 above
            nb = len(batch)
            if nb <= 256:
                Bp = 1 << max(0, nb - 1).bit_length()
            else:
                Bp = -(-nb // 256) * 256
            Bp = min(batch_size, Bp)
            if bucket_lt is not None:
                Lt_max = bucket_lt
                tp, ttr, t_L = pack.gather(
                    bucket_lt, [pack_names[i] for i in idxs],
                    _pnul_lanes(idxs, Bp), Bp)
            else:
                Lt_max = -(-max(t.L for t in batch) // 64) * 64
                tp, ttr, t_L = to_device_pack(
                    *pack_templates(batch, Lt_max, B=Bp), dev)
            # ss_hmm_mode is derived from SS-data availability
            # UNCONDITIONALLY (the runner computes it regardless of
            # -ssm, hhviterbirunner.cpp:14-22, and ScoreForBacktrace
            # then reports a nonzero score_ss that feeds score_aass
            # even for -ssm 0); the DP itself adds SS only for ssm=2
            # (hhviterbi.cpp:175 gates on SCORE_ALIGNMENT)
            ss_hmm_mode = compute_ss_hmm_mode(q, batch)
            ss_in_dp = par.ssm == 2 and ss_hmm_mode != NO_SS_INFORMATION

            # the pack path's kernels see the Lq-bucketed query view
            Lq = Lq_use if bucket_lt is not None else q.L
            qp_k = qp_d if bucket_lt is not None else qp_real_d
            qtr_k = qtr_d if bucket_lt is not None else qtr_real_d
            kmax = Lq + Lt_max + 1
            has_excl = any(exclude.get(i) for i in idxs)
            has_str = bool(par.exclstr or par.template_exclstr)
            cell_off = None
            if has_excl and not has_str:
                # the altali exclusion mask is built on the device from
                # band intervals: O(B*P*(Lq+Lt)) int16 cross to the card
                # instead of the O(B*Lq*Lt) bool mask
                P = max(len(exclude.get(i, [])) for i in idxs)
                Wj = Lt_max + 1
                lo_c = np.ones((Bp, P, Wj), np.int16)
                hi_c = np.zeros((Bp, P, Wj), np.int16)
                lo_r = np.ones((Bp, P, Lq + 1), np.int16)
                hi_r = np.zeros((Bp, P, Lq + 1), np.int16)
                for b, i in enumerate(idxs):
                    for p, (pi, pj) in enumerate(exclude.get(i, [])):
                        lc, hc, lr, hr = V.band_intervals(
                            np.asarray(pi)[1:], np.asarray(pj)[1:], 40,
                            q.L, tmpl_list[i].L, Lq + 1, Wj)
                        lo_c[b, p] = lc
                        hi_c[b, p] = hc
                        lo_r[b, p] = lr
                        hi_r[b, p] = hr
                cell_off = V.exclusion_mask_device(
                    *(_host_to(x, dev) for x in (lo_c, hi_c, lo_r, hi_r)))
            elif has_excl or has_str:
                co = np.zeros((Bp, Lq + 1, Lt_max + 1), dtype=bool)
                for b, i in enumerate(idxs):
                    for (pi, pj) in exclude.get(i, []):
                        V.exclude_alignment_mask(co[b], pi, pj, Lq,
                                                 tmpl_list[i].L)
                if has_str:
                    # region masks also apply to the Viterbi stage
                    # (hhviterbirunner.cpp:156-165)
                    from .posterior import apply_exclstr

                    for b, i in enumerate(idxs):
                        apply_exclstr(co[b], par.exclstr,
                                      par.template_exclstr, Lq,
                                      tmpl_list[i].L)
                cell_off = _host_to(co, dev)

            ss_kw = {}
            if ss_in_dp:
                # K3's SS term as the table K6 reads (SS queries are
                # never Lq-bucketed: Lq == q.L); padded lanes have
                # t_L = 0, so their term is 0
                lut, qidx, tidx = build_ss_lut(q, batch, ss_hmm_mode,
                                               par.ssw, S73, S37, S33,
                                               Lt_max)
                tidx = np.pad(tidx, ((0, Bp - len(batch)), (0, 0)))
                ss_kw = dict(ss_lut=_host_to(lut, dev),
                             ss_qidx=_host_to(qidx, dev),
                             ss_tidx=_host_to(tidx, dev))

            with annotate("viterbi_backtrace_pass"):
                if (bucket_lt is not None and cell_off is None
                        and not ss_kw and bool(par.loc)
                        and Lq <= 512):
                    # hot path: K2 over the gathered batch
                    score, i2, j2, bt = viterbi_backtrace_lanes(
                        qp_k, qtr_k, tp, ttr, t_L, shift, Lq_true=q.L)
                else:
                    # K3: altali exclusion masks, SS in the DP, global
                    # mode, long queries, per-batch packing
                    score, i2, j2, bt = viterbi_batch_rows(
                        qp_k, qtr_k, tp, ttr, cell_off, t_L, shift,
                        local=bool(par.loc), Lq_true=q.L,
                        penalty_gap_query=par.egq,
                        penalty_gap_template=par.egt, **ss_kw)
                # walk the backtrace on the device (W1): only an int8
                # state string + header per lane reaches the host, after
                # the junk's last batch
                packed = V.backtrace_walk_packed8(bt, i2, j2, score,
                                                  kmax=kmax)
                del bt, cell_off
            pending.append((idxs, batch, ss_hmm_mode, packed, kmax))
        # one wait for the whole junk: the payloads come to the host once
        # every batch has been launched
        _t_f = _time.perf_counter()
        pending = [(idxs, batch, mode, _payload(packed), kmax)
                   for idxs, batch, mode, packed, kmax in pending]
        now = _time.perf_counter()
        stage_add("vit_payload_fetch", now - _t_f)
        stage_add("host_vit_dispatch", now - _t_p1)

        from ..native import load as _load_native

        nat = _load_native()
        q_p32 = np.ascontiguousarray(q.p, dtype=np.float32)
        for idxs, batch, ss_hmm_mode, packed_np, kmax in pending:
            # ---- native fast path: decode + walk + rescore +
            # correlation term in ONE C call per batch; bit-identical
            # to the loop below ----
            if (ss_hmm_mode == NO_SS_INFORMATION and nat is not None
                    and hasattr(nat, "vit_decode_rescore")):
                _t_hb = _time.perf_counter()
                # raw handouts ship their pnul for the in-C division;
                # divided lanes get an all-ones row (x / 1.0f == x)
                nb_real = len(idxs)
                t_ps = [batch[b].p for b in range(nb_real)]
                pn = None
                if any(not getattr(batch[b], "p_divided", True)
                       for b in range(nb_real)):
                    pn = np.ones((nb_real, 20), np.float32)
                    for b in range(nb_real):
                        if not getattr(batch[b], "p_divided", True):
                            pn[b] = batch[b].pnul_used
                dec = V.decode_rescore_native(
                    packed_np, kmax, q_p32, t_ps, par.corr, nat, pnul=pn)
                sc_l = dec.score.tolist()
                n_l = dec.n.tolist()
                m_l = dec.matched.tolist()
                i2_l = dec.i2.tolist()
                j2_l = dec.j2.tolist()
                for b, tid in enumerate(idxs):
                    t = batch[b]
                    nb = n_l[b]
                    sc = sc_l[b]
                    hit = Hit()
                    hit.init_from_hmm(q, t, par.nseqdis, par.ssm)
                    hit.entry = templates[tid][0]
                    hit.file = t.file
                    hit.lastrep = 1 if sc <= smin else 0
                    hit.score = sc
                    hit.score_ss = 0.0
                    hit.score_aass = -sc
                    # VIEWS into the batch decode arrays, not copies
                    # (nothing writes through them: realign reassigns
                    # fresh arrays)
                    hit.S = dec.S2[b, : nb + 1]
                    hit.S_ss = dec.zss[: nb + 1]
                    hit.i = dec.ii2[b, : nb + 1]
                    hit.j = dec.jj2[b, : nb + 1]
                    hit.states = dec.st2[b, : nb + 1]
                    hit.nsteps = nb
                    hit.matched_cols = m_l[b]
                    hit.i1 = int(dec.ii2[b, nb])
                    hit.j1 = int(dec.jj2[b, nb])
                    hit.i2 = i2_l[b]
                    hit.j2 = j2_l[b]
                    hit.irep = alignment + 1
                    hits.append(hit)
                    if sc > smin:
                        next_alive.append(tid)
                        exclude.setdefault(tid, []).append(
                            (hit.i.copy(), hit.j.copy()))
                stage_add("host_hitbuild", _time.perf_counter() - _t_hb)
                continue
            unpack = V.backtrace_walk_unpack8(packed_np, kmax)
            score, i2, j2 = unpack.score, unpack.i2, unpack.j2

            # batched rescoring (no-SS case): ONE scalar_prod20 +
            # fast_log2 over every hit's MM steps concatenated —
            # row-independent ops, bit-identical to the per-hit calls
            batch_rescore = (ss_hmm_mode == NO_SS_INFORMATION
                             and nat is not None)
            decoded = []
            if batch_rescore:
                with annotate("host_decode_rescore"):
                    cat_q, cat_t = [], []
                    for b, tid in enumerate(idxs):
                        t = batch[b]
                        i_steps, j_steps, states, matched_cols = unpack(b)
                        mm = states[1:] == V.MM
                        mi = i_steps[1:][mm]
                        mj = j_steps[1:][mm]
                        decoded.append((i_steps, j_steps, states,
                                        matched_cols, mm, len(mi)))
                        if len(mi):
                            cat_q.append(q.p[mi])
                            cat_t.append(_template_p(t)[mj])
                    if cat_q:
                        svals = fm.fast_log2(fm.scalar_prod20(
                            np.concatenate(cat_q), np.concatenate(cat_t)))
                    else:
                        svals = np.zeros(0, np.float32)
                    s_off = 0

            _t_hb = _time.perf_counter()
            for b, tid in enumerate(idxs):
                t = batch[b]
                if batch_rescore:
                    (i_steps, j_steps, states, matched_cols, mm,
                     nmi) = decoded[b]
                    nsteps = len(i_steps) - 1
                    S = np.zeros(nsteps + 1, dtype=np.float32)
                    S_ss = np.zeros(nsteps + 1, dtype=np.float32)
                    if nmi:
                        S[1:][mm] = svals[s_off: s_off + nmi]
                        s_off += nmi
                    sc_ss, corr_term = nat.backtrace_score_terms(
                        np.ascontiguousarray(S),
                        np.ascontiguousarray(S_ss), int(nsteps),
                        float(np.float32(par.corr)))
                    sc = np.float32(score[b])
                    if nsteps:
                        sc = np.float32(sc + np.float32(corr_term))
                    sc = float(sc)
                    sc_ss = float(np.float32(sc_ss))
                else:
                    i_steps, j_steps, states, matched_cols = unpack(b)
                    sc, sc_ss, S, S_ss = score_for_backtrace(
                        q, t, float(score[b]), i_steps, j_steps, states,
                        ss_hmm_mode, par.ssw, par.ssm, par.corr,
                        S73, S37, S33)
                hit = Hit()
                hit.init_from_hmm(q, t, par.nseqdis, par.ssm)
                hit.entry = templates[tid][0]
                hit.file = t.file
                hit.lastrep = 1 if sc <= smin else 0
                hit.score = sc
                hit.score_ss = sc_ss
                hit.score_aass = -sc
                hit.S = S
                hit.S_ss = S_ss
                hit.i = i_steps
                hit.j = j_steps
                hit.states = states
                hit.nsteps = len(i_steps) - 1
                hit.matched_cols = matched_cols
                hit.i1 = int(i_steps[-1])
                hit.j1 = int(j_steps[-1])
                hit.i2 = int(i2[b])
                hit.j2 = int(j2[b])
                hit.irep = alignment + 1
                hits.append(hit)

                if sc > smin:
                    next_alive.append(tid)
                    exclude.setdefault(tid, []).append(
                        (i_steps.copy(), j_steps.copy()))
            stage_add("host_hitbuild", _time.perf_counter() - _t_hb)

    def _lanes_scores(junk) -> np.ndarray:
        """Score-only sweep over one junk, per chunk K6 with the SS LUT
        when SS enters the DP, else the ``_lanes_impl`` kernel (K1
        ``fast`` by default); returns the scores in junk order."""
        impl = _lanes_impl()
        # chunking: plain SWEEP_BATCH slices, or (resident pack) per
        # length bucket so gathers draw from one bucket at a time;
        # `positions` maps each chunk back into the junk order
        if pack is not None:
            by_bucket: Dict[int, List[int]] = {}
            for posn, i in enumerate(junk):
                by_bucket.setdefault(pack.row_of[pack_names[i]][0],
                                     []).append(posn)
            chunks = [(lt, poss[s: s + SWEEP_BATCH])
                      for lt in sorted(by_bucket, reverse=True)
                      for poss in (by_bucket[lt],)
                      for s in range(0, len(poss), SWEEP_BATCH)]
        else:
            chunks = [(None, list(range(s, min(s + SWEEP_BATCH,
                                                len(junk)))))
                      for s in range(0, len(junk), SWEEP_BATCH)]
        scores = np.full(len(junk), -FLT_MAX, dtype=np.float32)
        for bucket_lt, positions in chunks:
            idxs = [junk[p] for p in positions]
            batch = [tmpl_list[i] for i in idxs]
            nb = len(batch)
            Bp = min(SWEEP_BATCH, 1 << max(0, nb - 1).bit_length())
            if bucket_lt is not None:
                Lt_max = bucket_lt
                tp, ttr, t_L = pack.gather(
                    bucket_lt, [pack_names[i] for i in idxs],
                    _pnul_lanes(idxs, Bp), Bp)
            else:
                Lt_max = max(128, -(-max(t.L for t in batch) // 128) * 128)
                tp, ttr, t_L = to_device_pack(
                    *pack_templates(batch, Lt_max, B=Bp), dev)
            ss_hmm_mode = compute_ss_hmm_mode(q, batch) \
                if par.ssm == 2 else NO_SS_INFORMATION
            with annotate("viterbi_lanes_sweep"):
                if ss_hmm_mode != NO_SS_INFORMATION or impl == "split":
                    ss = {}
                    if ss_hmm_mode != NO_SS_INFORMATION:
                        # SS queries are never Lq-bucketed (qp_d is q's
                        # own profile)
                        lut, qidx, tidx = build_ss_lut(
                            q, batch, ss_hmm_mode, par.ssw, S73, S37, S33,
                            Lt_max)
                        tidx = np.pad(tidx, ((0, Bp - nb), (0, 0)))
                        ss = dict(ss_lut=_host_to(lut, dev),
                                  ss_qidx=_host_to(qidx, dev),
                                  ss_tidx=_host_to(tidx, dev))
                    sc = viterbi_score_lanes(qp_d, qtr_d, tp, ttr, t_L,
                                             shift, **ss)
                else:
                    sc = viterbi_score_lanes_fused(
                        qp_d, qtr_d, tp, ttr, t_L, shift,
                        si_mode="fast" if impl == "fused" else "exact")
                scores[np.asarray(positions, dtype=np.int64)] = \
                    sc[:nb].cpu().numpy()
        return scores

    def _make_light_hit(tid: int, sc: float) -> Hit:
        t = tmpl_list[tid]
        hit = Hit()
        hit.init_from_hmm(q, t, par.nseqdis, par.ssm)
        hit.entry = templates[tid][0]
        hit.file = t.file
        hit.light = True
        hit.lastrep = 1
        hit.score = float(sc)
        hit.score_ss = 0.0
        hit.score_aass = -float(sc)
        hit.S = np.zeros(1, dtype=np.float32)
        hit.S_ss = np.zeros(1, dtype=np.float32)
        hit.i = np.zeros(1, dtype=np.int32)
        hit.j = np.zeros(1, dtype=np.int32)
        hit.states = np.zeros(1, dtype=np.int32)
        hit.nsteps = 0
        hit.matched_cols = 0
        hit.i1 = hit.i2 = hit.j1 = hit.j2 = 0
        hit.irep = 1
        return hit

    K_cap = 2 * max(par.Z, par.B, par.realign_max, par.z, par.b)
    use_funnel = (allow_funnel and _funnel_ok(dev) and par.egq == 0.0
                  and par.egt == 0.0
                  and bool(par.loc) and q.L <= 512
                  and not (par.exclstr or par.template_exclstr)
                  and len(templates) > K_cap)
    funnel_scores: List[float] = []   # all pass-1 scores so far (global)
    funnel_on = True                  # dropped when a block keeps >=90%

    for alignment in range(par.altali):
        if not alive:
            break
        next_alive: List[int] = []
        # early-stopping block scheduling (hhviterbirunner.cpp:109-192):
        # in the first alignment pass, score prefilter-ordered blocks of
        # 2000 and stop once a block's quality sum drops below cutoff
        n_all = len(alive)
        block = 2000 if (alignment == 0 and par.early_stopping_filter) \
            else max(n_all, 1)
        for jstart in range(0, n_all, block):
            junk = alive[jstart: jstart + block]
            # sort by length desc within the block (reference sorts for
            # thread utilization; here it makes padded batches tight)
            junk.sort(key=lambda idx: -tmpl_list[idx].L)
            junk_hit_start = len(hits)
            if alignment == 0 and use_funnel and funnel_on:
                scores = _lanes_scores(junk)
                funnel_scores.extend(scores.tolist())
                allsc = np.asarray(funnel_scores, dtype=np.float32)
                if len(allsc) > K_cap:
                    cutoff = float(np.partition(allsc, -K_cap)[-K_cap])
                else:
                    cutoff = -FLT_MAX
                # keep everything that can be displayed/realigned (the
                # running global top-K) or enter the altali loop (smin,
                # with margin for the missing corr/ss adjustments)
                keep = (scores >= cutoff) | (scores > par.smin - 2.0)
                full = [junk[k] for k in range(len(junk)) if keep[k]]
                _run_junk(full)
                for k in range(len(junk)):
                    if not keep[k]:
                        hits.append(_make_light_hit(junk[k],
                                                    float(scores[k])))
                stage_add("funnel_blocks", 1)
                if len(full) >= 0.9 * len(junk):
                    # funnel-degenerate workload (near-identical
                    # templates score above the keep thresholds): the
                    # sweep filters nothing, so drop it for the
                    # remaining blocks — identical output
                    funnel_on = False
                    stage_add("funnel_dropped", 1)
            else:
                _run_junk(junk)
            if alignment == 0 and par.early_stopping_filter:
                junk_hits = hits[junk_hit_start:]
                es = calculate_early_stop(par, q, junk_hits)
                if es < len(junk) * par.filter_thresh:
                    break
        alive = next_alive
    return hits


def promote_light_hits(par: Parameters, q: HMM, hitlist,
                       templates: List[Tuple[str, HMM]],
                       ss_matrices=None, merge_window: bool = True,
                       device=None) -> bool:
    """Exactness backstop for the two-pass funnel.

    The funnel's raw-score top-K keeps 2x the display/realign caps as
    full hits, so normally every hit the user can see has a backtrace.
    But a light hit can still matter downstream if its E-value lands
    inside the MSA-merge window (hhblits.cpp:832-838) or, for hhsearch,
    within the display rank.  After P/E-values are known, re-run the
    full Viterbi path (backtrace, rescoring, altali loop) for exactly
    those hits and splice the results in.

    Returns True if anything was promoted; the caller must then
    re-sort and recompute P-values, since promoted scores gain the
    correlation term (hhviterbi.cpp:243-252).
    """
    cap = max(par.Z, par.B)
    want = set()
    for rank, h in enumerate(hitlist):
        if getattr(h, "light", False) and (
                (merge_window and h.Eval <= 100.0 * par.e)
                or rank < cap):
            want.add(str(h.entry))
    if not want:
        return False
    sub = [(n, t) for (n, t) in templates if n in want]
    if not sub:
        return False
    hitlist.hits = [h for h in hitlist.hits
                    if not (getattr(h, "light", False)
                            and str(h.entry) in want)]
    hitlist.extend(viterbi_search(par, q, sub, ss_matrices=ss_matrices,
                                  allow_funnel=False, device=device))
    return True
