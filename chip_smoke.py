#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hhsuite_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit
and no result line:

0. setup: the card's name and power limit, the torch version, the builds
   of the CUDA kernels (``hhsuite_tpu_torch/csrc/viterbi.cu`` and
   ``csrc/prefilter.cu``, in parallel) and of the native host library,
   and (in a background process) the benchmark databases under
   ``chip_smoke_cache/``: the 512-, 128- and 8192-template families,
   two with decoys (128 + 16,384; 8192 + 1,040,384 = 2^20 entries) and
   two with secondary structure (``tools/benchdb.py:build_ss_db``: the
   128 and 8192 families with ``>ss_pred``/``>ss_conf`` rows); ptxas's
   registers and spill bytes of each wavefront kernel instantiation (the
   eight of ``vit_bt_kernel``, K2/K3, and the twelve of
   ``vit_score_kernel``, K1/K6: fast, exact, SS table and dense SS at G
   = 8, 16, 32) and of the prefilter kernels (the four instantiations of
   ``pf_wave_kernel``: K4 and K5, table in shared or global memory), of
   the realign kernels (R1-R4: the 64 instantiations) and of the walk
   (W1, ``bt_walk_kernel``), and the prefilter's integer add / min /
   max instructions (``cuobjdump -sass``);
1. each kernel against its plain PyTorch version on the card at the
   search path's shapes: the Viterbi kernels (K1 fast and exact, K2, K3
   with altali masks, global, and with the SS table, K6 with the SS
   table) bit-identical, with the launch geometry (group width G, rows a
   lane R); K1 fast timed at each group width G = 8, 16, 32 at a full
   sweep chunk (8192 templates) and a partial one (2048); K6's dense
   form and its table form bit-identical, K6 without SS equal to K1
   exact; K1/K6 and K2/K3 at their wavefronts' edge shapes; the walk W1
   byte-identical to its plain version on K2's bt (the kernel's storage
   view) and on the plain version's contiguous bt, timed on both
   layouts beside the plain walk on K2's bt in one call, with a model of
   the bt bytes and sectors its tiles load, and at every K2/K3 edge;
   R1-R4 at the realign chunk (R3 also at Lt_pad 512) and at their
   edges; the prefilter kernels (K4, K5) int-identical at the path's
   shape and at edge shapes, each timed at each group width G = 8, 16, 32 and held at
   its wavefront's edge shapes at each; times from CUDA events;
2. ``hhsearch`` and ``hhblits`` (``-n 1``, ``-n 2``) through the CLI
   entry on the golden single-entry database: outputs byte-identical to
   the reference's (tests/fixtures); ``hhsearch`` on the golden SS
   database (``-ssm 2``): the reference's scores within
   tests/test_ss_scoring.py's tolerances;
3. the 512-template database: ``hhsearch`` with the funnel on (``-Z 100
   -B 100 -realign_max 100``), the 128-template SS database with the
   SS funnel on (``-Z 30 -B 30 -realign_max 30``), and ``hhblits -n 2``
   on the first 128 templates plus 16,384 decoys, each on the card and
   on the CPU with the plain versions (the three CPU runs side by side in
   child processes): the ``.hhr`` files (and ``-oa3m``) must agree apart
   from Date/Command;
4. the 8192-template long-tail database, ``hhsearch`` with default
   parameters, cold and warm: wall and host-stage times, hit counts and
   the Viterbi kernels' launch counts on that run (each must be > 0); a
   profiled warm query;
5. ``hhblits -n 2`` with default parameters on the 2^20-entry database,
   cold and warm: per round the prefilter survivors, templates, hits,
   stage times and the launches of K1-K5 (each must be > 0 over the
   run); K4 and K5 over the whole resident cs219 pack against their
   plain versions; a profiled warm query, with K4's device time from CUDA
   events around its launches and K5's from the profiler;
6. ``hhsearch`` with default parameters (``-ssm 2``: SS in the DP) on the
   8192-template SS database with the family's SS-annotated query, cold
   and warm: as phase 4, with K1, K3 and K6 launched, and whether the
   funnel switched itself off; a profiled warm query, with K3's device
   time.

A profiled warm query (phases 4-6) traces the card's activity alone
(``torch.profiler``, CUDA activities): device time by kernel and the
device's busy share; on the same query CUDA events around each launch of
the sweep kernel (K1/K6), R1-R4, the walk W1, and in phase 5 of K4, give
its device time over exactly the launches that the counters count (the
phase fails when the two count different launches), beside the
profiler's reading of the same kernel.  In phases 3-6 W1 must launch,
and in phases 4-6 once for each K2/K3 launch (the phase fails
otherwise); phases 4-6 print the backtrace pass's launch time
(``viterbi_backtrace_pass``) beside its payload copy
(``vit_payload_fetch``).  Each phase prints its wall seconds.  The last
lines are the card (``nvidia-smi``), one JSON object with the per-kernel
numbers, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "chip_smoke_cache")
FIX = os.path.join(REPO, "tests", "fixtures")

# H100 SXM rates: f32 instructions outside the tensor cores, 132 SMs x
# 128 lanes x 1.98 GHz boost clock (the data sheet's 67 TFLOP/s counts
# an FMA as two operations; the Viterbi kernels are built with
# -fmad=false, so every operation is one instruction), and HBM3
# bandwidth (NVIDIA data sheet)
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12
# f32 operations per DP cell, counted in csrc/viterbi.cu: the 20-term
# dot (20 mul + 19 add), the log2 (fast quartic 12, exact cubic 10) and
# the recurrence (K1 28; K2/K3 45 incl. the backtrace-bit compares,
# K3 +5 with a cell-off mask, +1 with SS)
OPS_DOT = 39
OPS_K1 = {"fast": OPS_DOT + 12 + 28, "exact": OPS_DOT + 10 + 28}
OPS_BT = OPS_DOT + 10 + 45
# K6: K1 exact plus the SS add (the LUT form's shared-memory load is not
# an f32 operation)
OPS_K6 = OPS_K1["exact"] + 1

# INT32 rate of the H100 SXM: 132 SMs x 64 INT32 lanes (Hopper
# architecture white paper) x 1.98 GHz boost clock = 1.67e13 op/s
PEAK_INT32 = 132 * 64 * 1.98e9
# integer instructions per DP cell the prefilter's function needs on
# Hopper: an add followed by a min or max against a third operand (and a
# floor at 0) is one instruction (VIADDMNMX[.RELU]), and every value of
# both stages lies in [0, 255], so two cells go in one register as s16x2
# (VIADDMNMX.S16x2[.RELU], VIMNMX.S16x2.RELU: one instruction for two
# cells).  K4 min(hdiag + q, 255), max(t - off, 0), the running max: 3
# instructions for a pair of cells, 1.5 a cell; K5 min(hdiag + q, 255),
# max(t - off, E), max(H0, F), H - gi, max(E - ge, ., 0), H0 - gi,
# max(F - ge, ., 0), the running max: 8 for a pair, 4 a cell (byte
# extraction, addressing and loop control not counted).  The card's reading
# (hhsuite_tpu_torch/tools/int_rate.py, H100 80GB HBM3, 700.00 W): IADD3,
# VIADDMNMX and the three s16x2 forms each issue at 63.4-63.9 a SM and
# clock, 1.657e13-1.671e13/s, so PEAK_INT32 is the rate of all of them.  The kernels keep
# the 32-bit form (the s16x2 build was no faster: PERF.md).
OPS_K4, OPS_K5 = 1.5, 4

LQ, LT = 320, 384
B_K1, B_K2, B_K3, B_SMALL = 8192, 4096, 1024, 64
# prefilter: the hhblits path's query length and one 2^16 slice of the
# long-tail database
LQ_PF, B_PF = 300, 65536
# phase 3's hhblits database: the first 128 templates of the 512 family
# (the same entries) plus decoys; 128 keeps its CPU run near 40 s
N_FAMILY_SMALL, N_DECOYS_SMALL, N_ENTRIES_BIG = 128, 16384, 1 << 20
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ----------------------------------------------------------- inputs ----

def synth_inputs(Lq, Lt, B, seed, device, pad_last=False):
    """Seeded profile-like inputs in the search path's layout: query
    (Lq+2, 20)/(Lq+2, 7), templates as (B, Lt+2, 20/7) views of
    lanes-last storage, true lengths between Lt/2 and Lt; ``pad_last``:
    the last template is a lane of padding only (zero profile, -FLT_MAX
    transitions in every column), as pack_templates pads a batch."""
    from hhsuite_tpu_torch.search.viterbi_search import to_device_pack

    rng = np.random.default_rng(seed)
    fmax = np.finfo(np.float32).max

    def prof(n):
        p = rng.gamma(0.6, 1.0, (n, 20)).astype(np.float32) + 0.01
        return p / p.mean(axis=1, keepdims=True)

    def trans(n):
        t = rng.dirichlet([6.0, 1, 1], n)
        g = rng.dirichlet([3.0, 1], (n, 2))
        tr = np.stack([t[:, 0], t[:, 1], t[:, 2], g[:, 0, 0], g[:, 0, 1],
                       g[:, 1, 0], g[:, 1, 1]], axis=1)
        return np.log2(tr).astype(np.float32)

    qp, qtr = prof(Lq + 2), trans(Lq + 2)
    t_L = rng.integers(Lt // 2, Lt + 1, B).astype(np.int32)
    tp = np.zeros((B, Lt + 2, 20), np.float32)
    ttr = np.full((B, Lt + 2, 7), -fmax, np.float32)
    for b in range(B):
        L = int(t_L[b])
        tp[b, : L + 1] = prof(L + 1)
        ttr[b, : L + 1] = trans(L + 1)
    if pad_last:
        tp[-1], ttr[-1] = 0.0, -fmax
    import torch

    tp_d, ttr_d, tL_d = to_device_pack(tp, ttr, t_L, device)
    return (torch.from_numpy(qp).to(device), torch.from_numpy(qtr).to(device),
            tp_d, ttr_d, tL_d)


def exclusion_masks(Lq, Lt, t_L, P, seed, device):
    """Altali-style cell-off masks on the device: P diagonal paths per
    lane, each widened by the +-40 exclusion band."""
    import torch

    from hhsuite_tpu_torch.ops import viterbi as V

    rng = np.random.default_rng(seed)
    tl = t_L.cpu().numpy()
    B, Wj = len(tl), Lt + 1
    lo_c = np.ones((B, P, Wj), np.int16)
    hi_c = np.zeros((B, P, Wj), np.int16)
    lo_r = np.ones((B, P, Lq + 1), np.int16)
    hi_r = np.zeros((B, P, Lq + 1), np.int16)
    for b in range(B):
        for p in range(P):
            off = int(rng.integers(-Lq // 2, Lq // 2))
            j = np.arange(1, tl[b] + 1)
            i = j + off
            ok = (i >= 1) & (i <= Lq)
            if not ok.any():
                continue
            iv = V.band_intervals(i[ok][::-1], j[ok][::-1], 40, Lq,
                                  int(tl[b]), Lq + 1, Wj)
            lo_c[b, p], hi_c[b, p], lo_r[b, p], hi_r[b, p] = iv
    return V.exclusion_mask_device(*(torch.from_numpy(x).to(device)
                                     for x in (lo_c, hi_c, lo_r, hi_r)))


# ----------------------------------------------------------- timing ----

def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(ops: float, nbytes: float, peak_ops: float = PEAK_F32):
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def ptxas_usage(log_text: str) -> dict:
    """Registers and spill bytes per kernel instantiation from an
    ``nvcc -Xptxas -v`` log: {mangled name: (registers, spill stores,
    spill loads)}."""
    import re

    out, name, spill = {}, None, (0, 0)
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)),) + spill
            name = None
    return out


def wave_instantiations(usage: dict) -> dict:
    """The wavefront kernels' entries of :func:`ptxas_usage`:
    vit_bt_kernel<HAS_CO, HAS_SS, LOCAL> (K2/K3) keyed "bt<co,ss,local>"
    and vit_score_kernel<FAST, SS, G> (K1/K6; SS 0 none, 1 dense, 2
    table) keyed "score<fast,ss,G>"."""
    import re

    out = {}
    for name, u in usage.items():
        m = re.search(r"vit_bt_kernelILb([01])ELb([01])ELb([01])E", name)
        if m:
            out["bt<%s,%s,%s>" % m.groups()] = u
        m = re.search(r"vit_score_kernelILb([01])ELi([0-9])ELi(\d+)E", name)
        if m:
            out["score<%s,%s,%s>" % m.groups()] = u
    return dict(sorted(out.items()))


def realign_instantiations(usage: dict) -> dict:
    """The realign kernels' entries of :func:`ptxas_usage`: R1/R2 as
    fb_forward_kernel<C,SS> / fb_backward_kernel<C,SS> (C = 1-8 columns
    a thread; SS 0 none, 1 dense, 2 table) and fb_forward_wide<SS> /
    fb_backward_wide<SS>, R3 as mac_dp_kernel<C> and mac_dp_wide, R4
    mac_walk_kernel."""
    import re

    out = {}
    for name, u in usage.items():
        m = re.search(r"(fb_forward_kernel|fb_backward_kernel)ILi(\d)ELi(\d)E",
                      name)
        if m:
            out["%s<%s,%s>" % m.groups()] = u
        m = re.search(r"(fb_forward_wide|fb_backward_wide)ILi(\d)E", name)
        if m:
            out["%s<%s>" % m.groups()] = u
        m = re.search(r"mac_dp_kernelILi(\d)E", name)
        if m:
            out["mac_dp_kernel<%s>" % m.group(1)] = u
        for k in ("mac_dp_wide", "mac_walk_kernel"):
            if k in name:
                out[k] = u
    return dict(sorted(out.items()))


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(a, b) -> float:
    d = (a.double() - b.double()).abs()
    d = d[~(a.isinf() & b.isinf() & (a == b))] if d.numel() else d
    return float(d.max()) if d.numel() else 0.0


# ----------------------------------------------------------- phases ----

def phase1_kernels(dev, usage):
    """Kernel vs plain version at the path shapes; returns the per-kernel
    records (without launch counts).  ``usage``: ptxas registers and
    spills of each wavefront kernel instantiation
    (:func:`wave_instantiations`)."""
    import functools

    import torch

    from hhsuite_tpu_torch.ops import viterbi_lanes as VL
    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        bt_geometry, cuda_lib, score_geometry, viterbi_backtrace_lanes,
        viterbi_score_lanes_fused, viterbi_score_lanes_plain)
    from hhsuite_tpu_torch.ops.viterbi import viterbi_batch
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    shift = -0.03
    recs = {}
    f32b, u8b = 4, 1

    def in_bytes(qp, tp, B):
        return (qp.shape[0] * 27 + B * (tp.shape[1]) * 27) * f32b + B * 4

    # ---- K1 ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K1, SEED, dev)
    needed = LQ * int(tL.sum())
    geo = score_geometry(B_K1, LQ, LT)
    k1, plain_out = {}, {}
    for mode in ("fast", "exact"):
        out_k = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tL, shift,
                                          si_mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tL, shift,
                                          si_mode=mode)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not bits_equal(out_k, out_p):
            raise AssertionError(f"K1 {mode}: kernel != plain version "
                                 f"(max |d| {max_abs(out_k, out_p)})")
        if not torch.isfinite(out_k).all():
            raise AssertionError(f"K1 {mode}: non-finite scores")
        n0 = viterbi_score_lanes_fused.launches
        ms = cuda_ms(lambda: viterbi_score_lanes_fused(
            qp, qtr, tp, ttr, tL, shift, si_mode=mode), 3)
        k1[mode] = (ms, plain_ms, max_abs(out_k, out_p))
        plain_out[mode] = out_p
        log(f"phase1 K1 {mode}: B={B_K1} Lq={LQ} Lt={LT} {ms:.3f} ms "
            f"({LQ * LT * B_K1 / ms / 1e6:.1f} GCUPS, "
            f"{viterbi_score_lanes_fused.launches - n0} launches), plain "
            f"{plain_ms:.1f} ms, bit-identical; G={geo.G} R={geo.R} "
            f"passes={geo.passes} smem="
            f"{cuda_lib().hh_bt_smem_bytes(geo.G, 0)} B")
    bms, bby = bound_ms(needed * OPS_K1["fast"],
                        in_bytes(qp, tp, B_K1) + B_K1 * f32b)
    # the group widths, each timed at a full SWEEP_BATCH chunk and a
    # partial one, bit-identical to the plain version at each
    orig, g_ms = VL.score_geometry, {}
    try:
        for B in (B_K1, B_K1 // 4):
            if B != B_K1:
                del qp, qtr, tp, ttr, tL
                qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B, SEED + 6, dev)
                plain_out["fast"] = viterbi_score_lanes_plain(
                    qp, qtr, tp, ttr, tL, shift, si_mode="fast")
            for G in (8, 16, 32):
                VL.score_geometry = functools.partial(orig, G=G)
                got = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tL, shift)
                if not bits_equal(got, plain_out["fast"]):
                    raise AssertionError(f"K1 fast G={G} B={B}: kernel != "
                                         "plain version")
                g_ms[f"B={B} G={G}"] = cuda_ms(
                    lambda: viterbi_score_lanes_fused(qp, qtr, tp, ttr, tL,
                                                      shift), 3)
            VL.score_geometry = orig
            log(f"phase1 K1 fast group widths, B={B} Lq={LQ} Lt={LT}: "
                + ", ".join(f"G={G} {g_ms[f'B={B} G={G}']:.3f} ms"
                            for G in (8, 16, 32))
                + f"; bit-identical; chosen G={score_geometry(B, LQ, LT).G}")
    finally:
        VL.score_geometry = orig
    recs["K1"] = dict(
        name="K1 viterbi_score_lanes_fused (si_mode=fast)",
        route="cuda", source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_lanes.py:355",
        max_abs_err=k1["fast"][2], ms=k1["fast"][0],
        plain_ms=k1["fast"][1], bound_ms=bms, bound_by=bby,
        library_ms=None, exact_ms=k1["exact"][0],
        exact_plain_ms=k1["exact"][1], exact_max_abs_err=k1["exact"][2],
        G=geo.G, R=geo.R, G_ms=g_ms,
        ptxas={k: v for k, v in usage.items()
               if k.startswith(("score<1,0,", "score<0,0,"))})
    del qp, qtr, tp, ttr, tL, plain_out

    def bt_check(tag, kern, plain, B, extra_bytes, ops_cell, tL, reps,
                 after=None):
        counters = (viterbi_backtrace_lanes, viterbi_batch_rows)
        n0 = sum(c.launches for c in counters)
        out_k = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        names = ("score", "i2", "j2", "bt")
        for nm, a, b in zip(names, out_k, out_p):
            if not bits_equal(a, b):
                raise AssertionError(f"{tag}: {nm} of kernel != plain")
        if not torch.isfinite(out_k[0]).all():
            raise AssertionError(f"{tag}: non-finite scores")
        err = max_abs(out_k[0], out_p[0])
        if after is not None:
            after(out_k, out_p)
        del out_k, out_p
        ms = cuda_ms(kern, reps)
        launches = sum(c.launches for c in counters) - n0
        needed = LQ * int(tL.sum())
        nbytes = extra_bytes + B * (LQ + 1) * (LT + 1) * u8b + B * 12
        bms, bby = bound_ms(needed * ops_cell, nbytes)
        geo = bt_geometry(B, LQ, LT)
        smem = cuda_lib().hh_bt_smem_bytes(geo.G, int("SS" in tag))
        log(f"phase1 {tag}: B={B} Lq={LQ} Lt={LT} {ms:.3f} ms "
            f"({LQ * LT * B / ms / 1e6:.1f} GCUPS, {launches} launches), "
            f"plain {plain_ms:.1f} ms, bit-identical (score, i2, j2, bt); "
            f"G={geo.G} R={geo.R} passes={geo.passes} "
            f"smem={smem} B; bound {bms:.3f} ms ({bby})")
        return ms, plain_ms, err, bms, bby, geo

    # ---- K2, and W1 on its bt ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K2, SEED + 1, dev)
    ms, plain_ms, err, bms, bby, geo = bt_check(
        "K2",
        lambda: viterbi_backtrace_lanes(qp, qtr, tp, ttr, tL, shift,
                                        Lq_true=LQ),
        lambda: viterbi_batch(qp, qtr, tp, ttr, None, tL, shift,
                              Lq_true=LQ),
        B_K2, in_bytes(qp, tp, B_K2), OPS_BT, tL, 2,
        after=lambda k, p: recs.update(W1=phase1_walk(k, p, usage)))
    recs["K2"] = dict(
        name="K2 viterbi_backtrace_lanes", route="cuda",
        source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_lanes.py:646",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=None, G=geo.G, R=geo.R,
        ptxas=usage.get("bt<0,0,1>"))
    del qp, qtr, tp, ttr, tL

    # ---- K3: altali masks at the path's batch; global and SS cases ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K3, SEED + 2, dev)
    co = exclusion_masks(LQ, LT, tL, 3, SEED + 3, dev)
    ms, plain_ms, err, bms, bby, geo = bt_check(
        "K3 (altali masks)",
        lambda: viterbi_batch_rows(qp, qtr, tp, ttr, co, tL, shift,
                                   Lq_true=LQ),
        lambda: viterbi_batch(qp, qtr, tp, ttr, co, tL, shift, Lq_true=LQ),
        B_K3, in_bytes(qp, tp, B_K3) + B_K3 * (LQ + 1) * (LT + 1),
        OPS_BT + 5, tL, 3)
    del qp, qtr, tp, ttr, tL, co
    # global mode, and SS in the DP (the table form, as the search
    # passes it) at the SS query's batch of 4096 lanes
    for tag, B, local, ss in (("K3 global", B_SMALL, False, False),
                              ("K3 SS", B_K2, True, True)):
        qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B, SEED + 4, dev)
        lut, qidx, tidx = ss_lut_inputs(LQ, LT, B, SEED + 5, dev)
        kw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx) if ss else {}
        _ms, _pms, e, _b, _bb, _g = bt_check(
            tag,
            lambda: viterbi_batch_rows(qp, qtr, tp, ttr, None, tL, shift,
                                       local=local, **kw),
            lambda: viterbi_batch(qp, qtr, tp, ttr, None, tL, shift,
                                  local=local, **kw),
            B, in_bytes(qp, tp, B) + (B * LT + LQ + 1936) * 4 * ss,
            OPS_BT + ss, tL, 1 + ss)
        err = max(err, e)
        del qp, qtr, tp, ttr, tL, lut, qidx, tidx, kw
    recs["K3"] = dict(
        name="K3 viterbi_batch_rows", route="cuda",
        source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_rows.py:59",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=None, G=geo.G, R=geo.R,
        ptxas={k: v for k, v in usage.items()
               if k.startswith("bt<") and k != "bt<0,0,1>"})
    edge_err = phase1_bt_edges(dev)
    recs["W1"]["max_abs_err"] = max(recs["W1"]["max_abs_err"], edge_err)
    torch.cuda.empty_cache()
    return recs


def walk_tile_model(payload, bt, R):
    """A model, not a measurement, of the bt that W1's tiles of side R
    load for the walks of a payload (the plain walk's, (B, 12 + kmax)
    int8 on any device) on ``bt`` (the card's tensor; only its address
    and strides are used, and its smaller stride must be 1): each walk's
    reads replayed on the host (a recorded step reads the byte at its
    cell unless it is blocked), a tile of rows max(1, i-R+1)..i and
    columns max(1, j-R+1)..j loaded at the first read outside the tile
    before.  Returns (the bytes of those squares, the 32-byte sectors the
    squares' byte runs along the unit stride touch, each tile on its
    own).  The sectors are what the tiles would draw from device memory
    if L2 kept nothing between tiles; the kernel's clamped duplicate
    loads fall inside the square and add none."""
    from hhsuite_tpu_torch.ops import viterbi as V

    sb, si, sj = bt.stride()
    if min(si, sj) != 1:
        raise ValueError("walk_tile_model: bt has no unit stride")
    along_i = si == 1
    pk = np.ascontiguousarray(payload.cpu().numpy())
    i2 = pk[:, 4:6].copy().view(np.int16)[:, 0].astype(np.int64)
    j2 = pk[:, 6:8].copy().view(np.int16)[:, 0].astype(np.int64)
    n = pk[:, 8:12].copy().view(np.int32)[:, 0]
    st = pk[:, 12:].astype(np.int64)
    di = (st == V.MM) | (st == V.DG) | (st == V.MI)
    dj = (st == V.MM) | (st == V.GD) | (st == V.IM)
    ii = i2[:, None] - np.cumsum(di, axis=1) + di
    jj = j2[:, None] - np.cumsum(dj, axis=1) + dj
    reads = ~((~di & ~dj) | (di & (ii <= 1)) | (dj & (jj <= 1)))
    reads &= np.arange(st.shape[1])[None, :] < n[:, None]
    nbytes = sectors = 0
    for b in range(pk.shape[0]):
        ri, rj = ii[b][reads[b]], jj[b][reads[b]]
        k = 0
        while k < ri.size:
            i, j = int(ri[k]), int(rj[k])
            ilo, jlo = max(1, i - R + 1), max(1, j - R + 1)
            nbytes += (i - ilo + 1) * (j - jlo + 1)
            # one run of nf bytes along the unit stride for each of ng
            # rows or columns
            nf, ng = (i - ilo + 1, j - jlo + 1) if along_i else (
                j - jlo + 1, i - ilo + 1)
            a0 = (bt.data_ptr() + b * sb + ilo * si + jlo * sj
                  + np.arange(ng) * (sj if along_i else si))
            sectors += int(((a0 + nf - 1) // 32 - a0 // 32 + 1).sum())
            # positions only fall: the first read below or left of it
            k = min(np.searchsorted(-ri, -ilo, side="right"),
                    np.searchsorted(-rj, -jlo, side="right"))
    return nbytes, sectors


def phase1_walk(out_k, out_p, usage):
    """W1 on K2's outputs at the path shape: its payload on the kernel's
    bt (the [B][Lt+1][Wq] storage view) and on the plain version's
    contiguous bt, each byte-identical to the plain walk on the kernel's
    bt; W1 on both layouts and the plain walk timed on that bt in one
    call, with :func:`walk_tile_model`'s bytes and sectors of its tiles
    on the storage view.  Bound: the bytes W1 must move (the payload
    written once, i2/j2/score read once, one bt byte a recorded step), at
    3.35 TB/s.  Returns W1's record (``max_abs_err``: payload bytes that
    differ)."""
    import torch

    from hhsuite_tpu_torch.ops import viterbi as V

    kmax = LQ + LT + 1
    args = (out_k[3], out_k[1], out_k[2], out_k[0], kmax)
    args_c = (out_p[3], out_p[1], out_p[2], out_p[0], kmax)
    n0 = V.backtrace_walk_packed8.launches
    got = V.backtrace_walk_packed8(*args)
    got_c = V.backtrace_walk_packed8(*args_c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = V.backtrace_walk_packed8_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if V.backtrace_walk_packed8.launches != n0 + 2:
        raise AssertionError("W1: the wrapper did not launch the kernel")
    err = int((got != want).sum()) + int((got_c != want).sum())
    if err:
        raise AssertionError(f"W1: {err} payload bytes differ from the "
                             "plain walk")
    ms = cuda_ms(lambda: V.backtrace_walk_packed8(*args), 5)
    ms_c = cuda_ms(lambda: V.backtrace_walk_packed8(*args_c), 5)
    tile_bytes, tile_sectors = walk_tile_model(want, args[0], V.WALK_R)
    B = out_k[0].shape[0]
    n = want[:, 8:12].cpu().numpy().copy().view(np.int32)[:, 0]
    steps = int(n.sum())
    bms, bby = bound_ms(0, B * (12 + kmax) + 12 * B + steps)
    regs = usage.get("bt_walk_kernel")
    log(f"phase1 W1 (on K2's bt): B={B} Lq={LQ} Lt={LT} kmax={kmax} "
        f"R={V.WALK_R} G={V.WALK_G}: {ms:.3f} ms on the storage view, "
        f"{ms_c:.3f} ms on contiguous bytes; plain walk {plain_ms:.1f} ms, "
        f"bound {bms:.4f} ms ({bby}); walks of {int(n.min())}-"
        f"{int(n.max())} steps (mean {n.mean():.1f}, {steps} in all); "
        "byte-identical on both layouts; ptxas "
        f"{regs} (registers, spill stores, spill loads)")
    log(f"phase1 W1 tiles on the storage view (modelled, not measured): "
        f"{tile_bytes} bt bytes in the squares ({tile_bytes / steps:.1f} a "
        f"step), {tile_sectors} 32-byte sectors touched "
        f"({32 * tile_sectors / steps:.1f} bytes a step)")
    return dict(
        name="W1 backtrace_walk_packed8 (the Viterbi path walk into the "
        "payload)", route="cuda", source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi.py:495", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
        ptxas=regs, kmax=kmax, steps=steps, contiguous_ms=ms_c,
        tile=[V.WALK_R, V.WALK_G], tile_bytes_model=tile_bytes,
        tile_sectors_model=tile_sectors)


def bt_edge_shapes():
    """(G, Lq, Lt, B) at the K2/K3 wavefront's edges, at each group width
    G (8 rows a lane): one query row, a pass of G*8 rows less one,
    exactly, plus one (a second pass of one row); one template column;
    one template; a block of 256/G templates left partly empty; and
    (G chosen by the kernel's geometry) a query longer than K2 takes."""
    shapes = [(None, 513, 60, 12)]
    for G in (8, 16, 32):
        shapes += [(G, 1, 30, 7), (G, 8 * G - 1, 30, 7), (G, 8 * G, 25, 7),
                   (G, 8 * G + 1, 20, 7), (G, 40, 1, 9), (G, 40, 33, 1),
                   (G, 40, 24, 256 // G + 3)]
    return shapes


def score_edge_shapes():
    """(G, Lq, Lt, B, padded lane) at the K1/K6 wavefront's edges, at
    each group width G (8 rows a lane): one query row, one pass of G*8
    rows exactly, a second pass of one row, three passes (2*G*8 + 1
    rows); one template column; fewer columns than lanes; one template;
    a block of 256/G templates left partly empty, its last lane padding
    only; and (G chosen by the kernel's geometry) the funnel's longest
    query, 512 rows."""
    shapes = [(None, 512, 60, 12, True)]
    for G in (8, 16, 32):
        shapes += [(G, 1, 30, 7, False), (G, 8 * G, 25, 7, True),
                   (G, 8 * G + 1, 20, 7, False), (G, 16 * G + 1, 20, 5, False),
                   (G, 40, 1, 9, False), (G, 40, G - 3, 5, False),
                   (G, 40, 33, 1, False), (G, 37, 24, 256 // G + 3, True)]
    return shapes


def phase1_bt_edges(dev):
    """K2 and K3 (global, cell-off, SS table) against the plain version
    at the wavefront's edges, at each group width G: one query row, a
    pass of G*R rows less one, exactly, plus one; one template column;
    one template; a block left partly empty; and K3 at Lq = 513.  At
    each, W1 on the kernel's bt and on the plain version's against the
    plain walk on the plain version's bt; returns the payload bytes that
    differ (0, or the phase fails)."""
    import functools

    import torch

    from hhsuite_tpu_torch.ops import viterbi_lanes as VL
    from hhsuite_tpu_torch.ops.viterbi import (
        backtrace_walk_packed8, backtrace_walk_packed8_plain, viterbi_batch)
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    shift, n, worst, t0 = -0.03, 0, 0, time.perf_counter()
    orig = VL.bt_geometry
    try:
        for k, (G, Lq, Lt, B) in enumerate(bt_edge_shapes()):
            VL.bt_geometry = functools.partial(orig, G=G)
            qp, qtr, tp, ttr, tL = synth_inputs(Lq, Lt, B, SEED + 40 + k,
                                                dev)
            co = exclusion_masks(Lq, Lt, tL, 1, SEED + 41 + k, dev)
            lut, qidx, tidx = ss_lut_inputs(Lq, Lt, B, SEED + 42 + k, dev)
            ss = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
            runs = [("K3", lambda f, c: f(qp, qtr, tp, ttr, c, tL, shift,
                                          local=False, **ss),
                     viterbi_batch_rows)]
            if G is not None:
                runs.append(("K2", lambda f, c: f(
                    qp, qtr, tp, ttr, tL, shift, Lq_true=max(1, Lq - 2)),
                    VL.viterbi_backtrace_lanes))
            for tag, call, kern in runs:
                if tag == "K2":
                    got = call(kern, None)
                    want = viterbi_batch(qp, qtr, tp, ttr, None, tL, shift,
                                         Lq_true=max(1, Lq - 2))
                else:
                    got = call(kern, co)
                    want = call(viterbi_batch, co)
                kmax = Lq + Lt + 1
                same = all(bits_equal(a, b) for a, b in zip(got, want))
                plain = backtrace_walk_packed8_plain(want[3], *want[1:3],
                                                     want[0], kmax)
                walk = [int((backtrace_walk_packed8(
                    x[3], *x[1:3], x[0], kmax) != plain).sum())
                    for x in (got, want)]
                if not same or any(walk):
                    raise AssertionError(f"{tag} edge G={G} Lq={Lq} Lt={Lt}"
                                         f" B={B}: kernel != plain version"
                                         f" (W1: {walk} bytes differ)")
                worst = max(worst, *walk)
                n += 1
    finally:
        VL.bt_geometry = orig
    log(f"phase1 K2/K3 wavefront edges: {n} cases bit-identical (score, "
        "i2, j2, bt), W1's payload byte-identical to the plain walk's on "
        "the kernel's and the plain version's bt, at G = 8, 16, 32 and Lq "
        f"= 513 ({time.perf_counter() - t0:.1f} s)")
    return worst


def ss_lut_inputs(Lq, Lt, B, seed, device):
    """A seeded S33-shaped SS table (NSSPRED x MAXCF x NSSPRED x MAXCF =
    1936 floats, in the range of ssw * S33) and query / template offsets
    into it, the form search/viterbi_search.py:build_ss_lut gives; the
    offsets reach both ends of the table."""
    import torch

    rng = np.random.default_rng(seed)
    lut = (rng.random(1936) * 0.6 - 0.3).astype(np.float32)
    qidx = (rng.integers(0, 44, Lq) * 44).astype(np.int32)
    tidx = rng.integers(0, 44, (B, Lt)).astype(np.int32)
    qidx[0], tidx[0, 0] = 0, 0
    qidx[-1], tidx[-1, -1] = 43 * 44, 43
    return tuple(torch.from_numpy(x).to(device) for x in (lut, qidx, tidx))


def ss_dense(lut, qidx, tidx):
    """The dense (B, Lq+1, Lt+1) SS matrix of the table form, row 0 and
    column 0 zero, contiguous (the layout K6 reads it in), filled one
    query row at a time."""
    import torch

    B, Lt = tidx.shape
    Lq = qidx.shape[0]
    out = torch.zeros((B, Lq + 1, Lt + 1), dtype=torch.float32,
                      device=lut.device)
    t = tidx.long()
    for i in range(Lq):
        out[:, i + 1, 1:] = lut[qidx[i].long() + t]
    return out


def phase1_k6(dev, usage):
    """K6 against its plain version at the SS sweep's path shape (the
    table form), its dense form against the table form, and K6 without
    SS against K1 exact; then the K1/K6 wavefront edges.  Returns its
    record (without launch counts)."""
    import torch

    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        score_geometry, viterbi_score_lanes, viterbi_score_lanes_fused,
        viterbi_score_lanes_plain)

    shift = -0.03
    Lq, Lt, B = LQ, LT, B_K1
    qp, qtr, tp, ttr, tL = synth_inputs(Lq, Lt, B, SEED + 20, dev)
    lut, qidx, tidx = ss_lut_inputs(Lq, Lt, B, SEED + 21, dev)
    kw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    out_k = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tL, shift, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not bits_equal(out_k, out_p):
        raise AssertionError(f"K6: kernel != plain version "
                             f"(max |d| {max_abs(out_k, out_p)})")
    if not torch.isfinite(out_k).all():
        raise AssertionError("K6: non-finite scores")
    dense = ss_dense(lut, qidx, tidx)
    out_d = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift, ss_score=dense)
    if not bits_equal(out_d, out_k):
        raise AssertionError("K6: dense form != table form")
    out_n = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift)
    out_e = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tL, shift,
                                      si_mode="exact")
    if not bits_equal(out_n, out_e):
        raise AssertionError("K6: no SS != K1 exact")
    n0 = viterbi_score_lanes.launches
    ms = cuda_ms(lambda: viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift,
                                             **kw), 3)
    launches = viterbi_score_lanes.launches - n0
    dense_ms = cuda_ms(lambda: viterbi_score_lanes(
        qp, qtr, tp, ttr, tL, shift, ss_score=dense), 2)
    del dense, out_d
    needed = Lq * int(tL.sum())
    nbytes = ((Lq * 27 + B * (Lt + 2) * 27) * 4 + B * 4      # profiles
              + (lut.numel() + Lq + B * Lt) * 4 + B * 4)     # SS, out
    bms, bby = bound_ms(needed * OPS_K6, nbytes)
    geo = score_geometry(B, Lq, Lt)
    log(f"phase1 K6 table: B={B} Lq={Lq} Lt={Lt} {ms:.3f} ms "
        f"({Lq * Lt * B / ms / 1e6:.1f} GCUPS, {launches} launches), "
        f"dense {dense_ms:.3f} ms, plain {plain_ms:.1f} ms; bit-identical, "
        f"dense == table, no SS == K1 exact; G={geo.G} "
        f"passes={geo.passes}; bound {bms:.3f} ms ({bby})")
    rec = dict(
        name="K6 viterbi_score_lanes (SS lookup table)", route="cuda",
        source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_lanes.py:62",
        max_abs_err=max_abs(out_k, out_p), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=bby, library_ms=None, dense_ms=dense_ms,
        G=geo.G, R=geo.R,
        ptxas={k: v for k, v in usage.items()
               if k.startswith(("score<0,1,", "score<0,2,"))})
    del qp, qtr, tp, ttr, tL, lut, qidx, tidx
    phase1_score_edges(dev)
    torch.cuda.empty_cache()
    return rec


def phase1_score_edges(dev):
    """K1 (fast, exact) and K6 (SS table, dense SS; without SS == K1
    exact) against the plain version at the score wavefront's edges
    (:func:`score_edge_shapes`), bit for bit: the dense form against the
    table's plain result on the matrix the table defines."""
    import functools

    from hhsuite_tpu_torch.ops import viterbi_lanes as VL

    shift, n, t0 = -0.03, 0, time.perf_counter()
    orig = VL.score_geometry
    try:
        for k, (G, Lq, Lt, B, pad) in enumerate(score_edge_shapes()):
            VL.score_geometry = functools.partial(orig, G=G)
            qp, qtr, tp, ttr, tL = synth_inputs(Lq, Lt, B, SEED + 80 + k,
                                                dev, pad_last=pad)
            lut, qidx, tidx = ss_lut_inputs(Lq, Lt, B, SEED + 81 + k, dev)
            table = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
            args = (qp, qtr, tp, ttr, tL, shift)
            want = {mode: VL.viterbi_score_lanes_plain(*args, si_mode=mode)
                    for mode in ("fast", "exact")}
            want["table"] = VL.viterbi_score_lanes_plain(*args, **table)
            got = {mode: VL.viterbi_score_lanes_fused(*args, si_mode=mode)
                   for mode in ("fast", "exact")}
            got["table"] = VL.viterbi_score_lanes(*args, **table)
            got["dense"] = VL.viterbi_score_lanes(
                *args, ss_score=ss_dense(lut, qidx, tidx))
            want["dense"] = want["table"]
            got["no SS"] = VL.viterbi_score_lanes(*args)
            want["no SS"] = got["exact"]
            for tag in got:
                if not bits_equal(got[tag], want[tag]):
                    raise AssertionError(f"K1/K6 {tag} edge G={G} Lq={Lq} "
                                         f"Lt={Lt} B={B}: kernel != plain "
                                         "version")
                n += 1
    finally:
        VL.score_geometry = orig
    log(f"phase1 K1/K6 wavefront edges: {n} cases bit-identical (K1 fast, "
        "K1 exact, K6 table, K6 dense; K6 without SS == K1 exact) at G = "
        f"8, 16, 32 and Lq = 512 ({time.perf_counter() - t0:.1f} s)")


def long_tail_lengths(rng, n, L0=300):
    """Lengths of the benchmark databases' long-tail mix
    (tools/benchdb.py, length_mix=True): 70% ~L0, 20% half-length
    fragments, 10% 1.5x duplications, with an indel spread."""
    u = rng.random(n)
    base = np.where(u < 0.2, L0 // 2, np.where(u > 0.9, L0 * 3 // 2, L0))
    return np.maximum(1, base + rng.integers(-15, 16, n))


def prefilter_table(rng, Lq, offset=50):
    """A seeded (220, Lq) query table in the range the tests use, where
    ungapped and gapped scores spread."""
    qc = (rng.integers(0, 80, (220, Lq))
          * (rng.random((220, Lq)) < 0.5)).astype(np.int32)
    qc[219] = offset - 1
    return qc


# K5's gap settings on the hhblits path: gap_init, gap_extend, offset
K5_GAPS = (24, 4, 50)

# realign (R1-R4): the search's shift and mact, the path's chunk of 256
# hits at Lq = 300 and the padded template width of the 8192 family
REALIGN_SHIFT, REALIGN_MACT = -0.03, 0.3501
B_RE, LQ_RE, LT_RE = 256, 300, 384


def realign_edge_shapes():
    """Edges of R1-R4: (tag, Lq, Lt_pad, B, exclusion bands, SS, local,
    extras); SS False, True (seeded dense factors) or an SS table kind
    of :func:`realign_inputs` ("m1", "m2", "m3": every lane of that
    mode; "mix": modes 1, 0, 2, 3 in turn); extras "pad" makes the last
    lane a padding lane (no template, every cell but column 0 off, as a
    chunk is padded), "empty" closes every row of lane 1 below row 1
    (its MAC cell lies in row 1, which the walk's pre-masking stops: an
    empty walk).  R1/R2 keep rows of up to 8 columns a thread in
    registers (the profile of more than 4 in shared memory); 9 columns
    take the wide kernels' shared memory, 47 their global scratch."""
    return [("Wj < T", 12, 20, 3, 0, False, True, ""),
            ("Wj % T != 0, padded lane", 9, 140, 3, 2, True, True, "pad"),
            ("Lq = 1", 1, 30, 2, 0, False, True, ""),
            ("global, ragged t_L", 15, 40, 4, 3, True, False, "pad"),
            ("3 columns a thread, global", 10, 300, 2, 1, False, False, ""),
            ("empty walk", 7, 128, 3, 0, True, True, "empty,pad"),
            ("SS and non-SS lanes", 20, 200, 5, 1, "mix", True, "pad"),
            ("SS mode 1, global", 17, 90, 3, 0, "m1", False, ""),
            ("SS mode 2", 13, 130, 3, 2, "m2", True, "pad"),
            ("SS mode 3, 4 columns a thread", 11, 500, 2, 1, "m3", True,
             ""),
            ("5 columns a thread, SS table", 8, 600, 3, 1, "mix", True,
             "pad"),
            ("9 columns a thread, global", 7, 1100, 2, 1, "m3", False,
             "pad"),
            ("global scratch row, SS table", 6, 5888, 2, 0, "m2", False,
             "pad")]


# the table kinds' SS modes a lane, in turn
SS_KINDS = {"m1": (1,), "m2": (2,), "m3": (3,), "mix": (1, 0, 2, 3)}


def realign_ss_table(rng, Lq, t_L, kind, Wj):
    """Seeded SS states of a query and of each lane's template, seeded
    S37/S73/S33 matrices, and the realign path's table of them
    (``PosteriorDecoder.ss_table``): (lut, roff, coff) numpy arrays.
    Lanes of t_L 0 (padding) are of mode 0."""
    from types import SimpleNamespace

    from hhsuite_tpu_torch.constants import MAXCF, NDSSP, NSSPRED
    from hhsuite_tpu_torch.search.posterior import PosteriorDecoder

    def states(n):
        return SimpleNamespace(
            L=n, ss_pred=rng.integers(0, NSSPRED, n + 1).astype(np.int8),
            ss_conf=rng.integers(0, MAXCF, n + 1).astype(np.int8),
            ss_dssp=rng.integers(0, NDSSP, n + 1).astype(np.int8))

    S = {k: rng.uniform(-1.5, 1.5, sh).astype(np.float32) for k, sh in (
        ("S73", (NDSSP, NSSPRED, MAXCF)), ("S37", (NSSPRED, MAXCF, NDSSP)),
        ("S33", (NSSPRED, MAXCF, NSSPRED, MAXCF)))}
    dec = PosteriorDecoder(True, 0.11, **S)
    modes = SS_KINDS[kind]
    lanes = [(states(int(L)), modes[b % len(modes)] if L > 0 else 0)
             for b, L in enumerate(t_L)]
    return dec.ss_table(states(Lq), lanes, len(t_L), Wj)


def realign_inputs(Lq, Lt_pad, B, P, ss, seed, device, extras=""):
    """Seeded inputs of one realign chunk in the search path's staging:
    query profile and linear transitions; templates as noisy copies of
    query stretches (true lengths between Lt_pad/2 and Lt_pad, zeros
    past them); the cell-off corridor built by ``realign_mask_device``
    from RealignMaskSpec-style intervals of a seeded Viterbi path (the
    +-40 band, its rectangle and the min-overlap corner) and of P seeded
    exclusion paths (+-2 bands); with ``ss`` the boundary SS factors and
    the SS factors: seeded dense ones (``ss`` True), or a table kind of
    :data:`SS_KINDS`, as ``ss_table`` (:func:`realign_ss_table`) and
    ``ss_f`` its dense expansion.  Returns a dict of tensors on
    ``device`` and kmax."""
    import torch

    from hhsuite_tpu_torch.ops.posterior_batch import (realign_mask_device,
                                                       ss_expand)
    from hhsuite_tpu_torch.ops.viterbi import band_intervals

    rng = np.random.default_rng(seed)
    f32 = np.float32
    Wj = Lt_pad + 1

    def trans(n):
        t = rng.dirichlet([6.0, 1, 1], n)
        g = rng.dirichlet([3.0, 1], (n, 2))
        return np.stack([t[:, 0], t[:, 1], t[:, 2], g[:, 0, 0], g[:, 0, 1],
                         g[:, 1, 0], g[:, 1, 1]], axis=1).astype(f32)

    qp = rng.dirichlet(np.full(20, 0.4), Lq + 2).astype(f32)
    qtr = trans(Lq + 2)
    t_L = rng.integers(max(1, Lt_pad // 2), Lt_pad + 1, B).astype(np.int32)
    t_L[0] = Lt_pad
    tp = np.zeros((B, Lt_pad + 2, 20), f32)
    ttr = np.zeros((B, Lt_pad + 2, 7), f32)
    rect = np.zeros((B, 4), np.int32)
    corner = np.zeros(B, np.int32)
    lo_fc = np.ones((B, Wj), np.int16)
    hi_fc = np.zeros((B, Wj), np.int16)
    lo_fr = np.ones((B, Lq + 1), np.int16)
    hi_fr = np.zeros((B, Lq + 1), np.int16)
    lo_ec = np.ones((B, P, Wj), np.int16)
    hi_ec = np.zeros((B, P, Wj), np.int16)
    lo_er = np.ones((B, P, Lq + 1), np.int16)
    hi_er = np.zeros((B, P, Lq + 1), np.int16)
    n_real = B - 1 if "pad" in extras else B

    def path(L, off):
        j = np.arange(1, L + 1)
        i = j + off
        keep = (i >= 1) & (i <= Lq)
        if not keep.any():
            i, j = np.array([1]), np.array([1])
        else:
            i, j = i[keep], j[keep]
        return i[::-1], j[::-1]          # backtrace order, as hit.i/j

    for b in range(n_real):
        L = int(t_L[b])
        # the template's diagonal overlaps at least half the shorter
        h = min(L, Lq) // 2
        off = int(rng.integers(1 - L + h, max(Lq - h, 1 - L + h) + 1))
        rows = np.clip(np.arange(L + 2) + off, 0, Lq + 1)
        noise = rng.dirichlet(np.full(20, 0.4), L + 2)
        tp[b, : L + 2] = (0.9 * qp[rows] + 0.1 * noise) / 0.05
        ttr[b, : L + 2] = trans(L + 2)
        pi, pj = path(L, off)
        rect[b] = (pi[-1], pj[-1], pi[0], pj[0])
        min_overlap = min(60, int(0.333 * min(Lq, L)) + 1)
        corner[b] = max(L + 1 - min_overlap, 0)
        iv = band_intervals(pi, pj, 40, Lq, L, Lq + 1, L + 1)
        lo_fc[b, : L + 1], hi_fc[b, : L + 1], lo_fr[b], hi_fr[b] = iv
        for p in range(P):
            ei, ej = path(L, off + int(rng.integers(-30, 31)))
            iv = band_intervals(ei, ej, 2, Lq, L, Lq + 1, L + 1)
            lo_ec[b, p, : L + 1], hi_ec[b, p, : L + 1] = iv[:2]
            lo_er[b, p], hi_er[b, p] = iv[2:]
    if "pad" in extras:
        t_L[-1] = 0

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    co = realign_mask_device(*(dev(x) for x in (
        rect, corner, t_L, lo_fc, hi_fc, lo_fr, hi_fr, lo_ec, hi_ec, lo_er,
        hi_er)))
    if "empty" in extras:
        co[1, 2:] = True
    out = dict(qp=dev(qp), qtr=dev(qtr), tp=dev(tp), ttr=dev(ttr), co=co,
               t_L=dev(t_L), ss_f=None, ss0=None, ss_table=None,
               kmax=Lq + Lt_pad + 2)
    if ss in SS_KINDS:
        out["ss_table"] = tuple(dev(a) for a in realign_ss_table(
            rng, Lq, t_L, ss, Wj))
        out["ss_f"] = ss_expand(*out["ss_table"])
    elif ss:
        out["ss_f"] = dev(np.exp2(rng.uniform(-1, 1, (B, Lq + 1, Wj))
                                  ).astype(f32))
    if ss:
        out["ss0"] = dev(np.exp2(rng.uniform(-1, 1, B)).astype(f32))
    return out


def finite_err(a, b) -> float:
    """max |a - b| over the cells finite on both sides; inf where one side
    is finite and the other is not (NaN and inf cells the two share are
    left to the bit comparison)."""
    import torch

    fa, fb = a.isfinite(), b.isfinite()
    if not torch.equal(fa, fb):
        return float("inf")
    d = (a[fa].double() - b[fb].double()).abs()
    return float(d.max()) if d.numel() else 0.0


def realign_check(x, local, tag):
    """R1-R4 on the card against their plain versions on the same inputs
    (R1-R3 bit for bit, R4 byte for byte), each fed the plain version's
    outputs of the pass before; with an SS table, R1 and R2 in both SS
    forms (the table and its dense expansion), each bit-identical to the
    plain version.  Returns the plain outputs (fwd, scales,
    pfwd, p_mm, b_mac, i2, j2, score, payload) and each kernel's measured
    difference from its plain version: R1 and R2 :func:`finite_err` over
    their f32 outputs, R3 the count of b_mac, i2 and j2 entries that
    differ, R4 the count of payload bytes that differ."""
    import torch

    from hhsuite_tpu_torch.ops import posterior_batch as PB

    cs = float(np.exp2(np.float32(REALIGN_SHIFT)))
    args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
    err = {"R1": 0.0, "R2": 0.0}
    # the SS forms: the dense factors, and the table where there is one
    forms = [("dense", dict(ss_f=x["ss_f"]))]
    if x.get("ss_table") is not None:
        forms.append(("table", dict(ss_table=x["ss_table"])))
    want = PB.fb_forward_plain(*args, x["ss_f"], x["ss0"], local, x["t_L"])
    for form, ss in forms:
        got = PB.fb_forward(*args, ss0=x["ss0"], local=local, t_L=x["t_L"],
                            **ss)
        e = max(finite_err(a, b) for a, b in zip(got, want))
        err["R1"] = max(err["R1"], e)
        for nm, a, b in zip(("fwd", "scales", "Pforward"), got, want):
            if not bits_equal(a, b):
                raise AssertionError(f"R1 {tag} ({form} SS): {nm} of "
                                     f"kernel != plain (max |err| {e})")
    fwd, scales, pfwd = want
    pmm = PB.fb_backward_plain(*args, fwd, scales, pfwd, x["ss_f"], local,
                               x["t_L"])
    for form, ss in forms:
        got = PB.fb_backward(*args, fwd, scales, pfwd, local=local,
                             t_L=x["t_L"], **ss)
        e = finite_err(got, pmm)
        err["R2"] = max(err["R2"], e)
        if not bits_equal(got, pmm):
            raise AssertionError(f"R2 {tag} ({form} SS): p_mm of kernel != "
                                 f"plain (max |err| {e})")
    want = PB.mac_dp_plain(pmm, x["co"], REALIGN_MACT, local, x["t_L"])
    got = PB.mac_dp(pmm, x["co"], REALIGN_MACT, local, x["t_L"])
    err["R3"] = float(sum(int((a != b).sum()) for a, b in zip(got, want)))
    for nm, a, b in zip(("b_mac", "i2", "j2"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"R3 {tag}: {nm} of kernel != plain")
    bmac, i2, j2 = want
    Lq, Lt = x["co"].shape[1] - 1, x["co"].shape[2] - 1
    score = torch.from_numpy(PB.forward_score(scales, pfwd, Lq, Lt,
                                              local)).to(pmm.device)
    payload = PB.mac_walk_packed8_plain(bmac, pmm, i2, j2, score, x["kmax"])
    got = PB.mac_walk_packed8(bmac, pmm, i2, j2, score, x["kmax"])
    err["R4"] = float(int((got != payload).sum()))
    if not torch.equal(got, payload):
        raise AssertionError(f"R4 {tag}: payload of kernel != plain "
                             f"({int(err['R4'])} bytes differ)")
    torch.cuda.synchronize()
    return (fwd, scales, pfwd, pmm, bmac, i2, j2, score, payload), err


# f32 operations a cell that each realign pass needs, counted in the
# expressions of csrc/posterior.cu (the segment scans' prefix products
# and carries, which the parallel form adds, not counted): R1 the dot
# 39, Cshift 1, MM 18, DG 5, MI 7, the GD and IM chains 12, the row sum
# and max 2; R2 the dot 39, Cshift 1, the match term 2, the chains 13, MM
# 16, DG 6, MI 7, the posterior 2; SS one more multiply each; R3 the
# three terms 4, their max and code compares 4, the chain 2, the IM
# compare 2, the argmax compare 1
OPS_R = {"R1": 84, "R2": 86, "R3": 13}


def realign_bound(key, x, ss, n_steps=None):
    """The bound of R1-R4 on chunk ``x``: f32 operations (every cell of
    every row, as the function computes them) and bytes (each input read
    once, each output written once; R4 the cells its walks visit)."""
    B, Li, Wj = x["co"].shape
    cells = B * (Li - 1) * Wj
    prof = (Li + 1) * 27 * 4 + B * (Wj + 1) * 27 * 4
    mat = B * Li * Wj
    if key == "R4":
        nbytes = B * (12 + 5 * x["kmax"]) + 12 * B + 5 * int(n_steps)
        return bound_ms(0, nbytes)
    if key == "R3":
        return bound_ms(cells * OPS_R["R3"], mat * (4 + 1 + 1) + 12 * B)
    ss_bytes = (mat * 4 + 4 * B) if ss else 0
    nbytes = prof + mat + ss_bytes + mat * 4 + B * (Li + 2) * 4
    if key == "R2":
        nbytes += mat * 4 + 4 * B
    return bound_ms(cells * (OPS_R[key] + int(ss)), nbytes)


# key -> (kernel in csrc/posterior.cu, record name, the JAX code it
# replaces, its C entry)
REALIGN_KERNELS = {
    "R1": ("fb_forward_kernel", "R1 fb_forward (fb_mac_batch's Forward "
           "rows)", "hhsuite_tpu/ops/posterior_batch.py:139",
           "hh_post_forward"),
    "R2": ("fb_backward_kernel", "R2 fb_backward (Backward rows, "
           "posterior)", "hhsuite_tpu/ops/posterior_batch.py:226",
           "hh_post_backward"),
    "R3": ("mac_dp_kernel", "R3 mac_dp (MAC rows, codes, argmax)",
           "hhsuite_tpu/ops/posterior_batch.py:281", "hh_post_mac"),
    "R4": ("mac_walk_kernel", "R4 mac_walk_packed8 (MAC walk into the "
           "payload)", "hhsuite_tpu/ops/posterior_batch.py:470",
           "hh_post_walk")}
REALIGN_KEYS = tuple(REALIGN_KERNELS)


def phase1_realign(dev, usage):
    """R1-R4 against their plain versions on the card at the realign
    path's chunk (B = 256 hits, Lq = 300, Lt_pad = 384; corridors from
    the interval form of seeded paths with 3 exclusion bands; a padding
    lane), SS off and on (an SS table of mixed modes and non-SS lanes,
    R1/R2 in both SS forms), local and global; then at
    :func:`realign_edge_shapes`.  Each timed with CUDA events beside its
    bound and its plain version's time (R1/R2 with SS in the dense and
    the table form too); its ``max_abs_err`` is the largest
    difference from its plain version that :func:`realign_check` measured
    over all of these cases.  Returns the records (without launch
    counts)."""
    import torch

    from hhsuite_tpu_torch.ops import posterior_batch as PB

    cs = float(np.exp2(np.float32(REALIGN_SHIFT)))
    recs, t_all = {}, time.perf_counter()
    errs = dict.fromkeys(REALIGN_KEYS, 0.0)

    def check(x, local, tag):
        out, err = realign_check(x, local, tag)
        for k, v in err.items():
            errs[k] = max(errs[k], v)
        return out

    for ss in (False, "mix"):
        for local in (True, False):
            tag = (f"SS {'on' if ss else 'off'}, "
                   f"{'local' if local else 'global'}")
            x = realign_inputs(LQ_RE, LT_RE, B_RE, 3, ss,
                               SEED + 40 + bool(ss), dev, extras="pad")
            out = check(x, local, tag)
            fwd, scales, pfwd, pmm, bmac, i2, j2, score, payload = out
            n_steps = int(PB.mac_walk_unpack8(payload.cpu().numpy(),
                                              x["kmax"])[3].sum()) + B_RE
            # (global mode: a lane whose corridor reaches neither row Lq
            # nor its own last column has Pforward 0, a score of -inf)
            if local and not torch.isfinite(score[:-1]).all():
                raise AssertionError(f"realign {tag}: non-finite scores")
            if not ss and local:
                # the path's form: time each kernel and its plain version
                args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
                calls = {
                    "R1": lambda p: (PB.fb_forward_plain if p else
                                     PB.fb_forward)(*args, None, None, True,
                                                    x["t_L"]),
                    "R2": lambda p: (PB.fb_backward_plain if p else
                                     PB.fb_backward)(*args, fwd, scales,
                                                     pfwd, None, True,
                                                     x["t_L"]),
                    "R3": lambda p: (PB.mac_dp_plain if p else PB.mac_dp)(
                        pmm, x["co"], REALIGN_MACT, True, x["t_L"]),
                    "R4": lambda p: (PB.mac_walk_packed8_plain if p else
                                     PB.mac_walk_packed8)(
                        bmac, pmm, i2, j2, score, x["kmax"])}
                for key, call in calls.items():
                    t0 = time.perf_counter()
                    call(True)
                    torch.cuda.synchronize()
                    plain_ms = (time.perf_counter() - t0) * 1e3
                    ms = cuda_ms(lambda: call(False), 3)
                    bms, bby = realign_bound(key, x, ss, n_steps)
                    kname, name, replaces, _entry = REALIGN_KERNELS[key]
                    recs[key] = dict(
                        name=name, route="cuda",
                        source="hhsuite_tpu_torch/csrc/posterior.cu",
                        replaces=replaces, max_abs_err=None, ms=ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                        library_ms=None,
                        ptxas=usage.get(kname))
                    log(f"phase1 {key} ({tag}): B={B_RE} Lq={LQ_RE} "
                        f"Lt_pad={LT_RE} {ms:.3f} ms, plain {plain_ms:.1f} "
                        f"ms, bound {bms:.4f} ms ({bby}); "
                        + ("byte-identical" if key == "R4"
                           else "bit-identical")
                        + f"; ptxas {usage.get(kname)}")
            else:
                # the other forms: kernel time only (R1/R2 with SS in
                # both SS forms)
                times = {}
                args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
                forms = [("", dict(ss_f=x["ss_f"]))]
                if ss:
                    forms = [(" dense", dict(ss_f=x["ss_f"])),
                             (" table", dict(ss_table=x["ss_table"]))]
                for form, fss in forms:
                    times["R1" + form] = cuda_ms(lambda: PB.fb_forward(
                        *args, ss0=x["ss0"], local=local, t_L=x["t_L"],
                        **fss), 2)
                    times["R2" + form] = cuda_ms(lambda: PB.fb_backward(
                        *args, fwd, scales, pfwd, local=local, t_L=x["t_L"],
                        **fss), 2)
                times["R3"] = cuda_ms(lambda: PB.mac_dp(
                    pmm, x["co"], REALIGN_MACT, local, x["t_L"]), 2)
                for key, ms in times.items():
                    recs.setdefault(key[:2], {}).setdefault("other_ms", {})[
                        tag + key[2:]] = ms
                log(f"phase1 R1-R3 ({tag}): " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in times.items())
                    + "; bit-identical, R4 byte-identical")
            walks = PB.mac_walk_unpack8(payload.cpu().numpy(), x["kmax"])[3]
            log(f"phase1 realign ({tag}): walks of {int(walks.min())}-"
                f"{int(walks.max())} steps, {int((walks == 0).sum())} empty"
                f" of {B_RE}; i2 max {int(i2.max())}, finite scores "
                f"{int(torch.isfinite(score).sum())} of {B_RE}, range "
                f"{float(score[torch.isfinite(score)].min()):.2f}.."
                f"{float(score[torch.isfinite(score)].max()):.2f}")
            del x, out, fwd, scales, pfwd, pmm, bmac, i2, j2, score, payload
            torch.cuda.empty_cache()
    # rows of 5 columns a thread (Lt_pad 512: the 8192 query's longest
    # chunk), R1/R2 with the profile in shared memory
    tag = "Lt_pad 512, SS off, local"
    x = realign_inputs(LQ_RE, 512, B_RE, 3, False, SEED + 50, dev,
                       extras="pad")
    fwd, scales, pfwd, pmm = check(x, True, tag)[:4]
    args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
    times = {"R1": cuda_ms(lambda: PB.fb_forward(
        *args, local=True, t_L=x["t_L"]), 3),
             "R2": cuda_ms(lambda: PB.fb_backward(
        *args, fwd, scales, pfwd, local=True, t_L=x["t_L"]), 3),
             "R3": cuda_ms(lambda: PB.mac_dp(
        pmm, x["co"], REALIGN_MACT, True, x["t_L"]), 3)}
    for key, ms in times.items():
        recs[key]["other_ms"][tag] = ms
    r3_bound = realign_bound("R3", x, False)
    log(f"phase1 R1-R3 ({tag}): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()) + "; bit-identical; "
        f"R3 bound {r3_bound[0]:.4f} ms ({r3_bound[1]}), ptxas "
        f"mac_dp_kernel<5> {usage.get('mac_dp_kernel<5>')}")
    del x, fwd, scales, pfwd, pmm
    t0 = time.perf_counter()
    for k, (tag, Lq, Lt_pad, B, P, ss, local, extras) in enumerate(
            realign_edge_shapes()):
        x = realign_inputs(Lq, Lt_pad, B, P, ss, SEED + 60 + k, dev, extras)
        check(x, local, tag)
    log(f"phase1 R1-R4 edges: {len(realign_edge_shapes())} cases "
        f"bit-identical (R4 byte-identical): "
        + "; ".join(e[0] for e in realign_edge_shapes())
        + f" ({time.perf_counter() - t0:.1f} s)")
    for k in REALIGN_KEYS:
        recs[k]["max_abs_err"] = errs[k]
    log("phase1 R1-R4 measured kernel - plain: " + ", ".join(
        f"{k} {errs[k]}" for k in REALIGN_KEYS) + " (R1/R2 max |err| over "
        "finite cells, R3 entries and R4 bytes that differ)")
    log(f"phase1 R1-R4: {time.perf_counter() - t_all:.1f} s")
    return recs


def k5_edge_shapes():
    """K5's wavefront edges at each forced group width G (also the card
    tests' and the CPU emulation's cases): (tag, G, Lq, Ld, B, lengths or
    None for seeded ones, (gap_init, gap_extend, offset)).  One query
    row; one pass of 8G rows exactly, plus one row, three passes; lengths
    0, 1, G-1 and 3 beside 300 in one warp; a row of 255s across a pass
    boundary; the gap settings (0, 0, 50) and (40, 12, 50); Lq = 1025,
    the table read from global memory."""
    out = []
    for G in (8, 16, 32):
        R = 8 * G
        out += [("Lq=1", G, 1, 40, 6, None, K5_GAPS),
                ("Lq=8G", G, R, 30, 5, None, K5_GAPS),
                ("Lq=8G+1", G, R + 1, 30, 5, None, K5_GAPS),
                ("3 passes", G, 2 * R + 1, 20, 3, None, K5_GAPS),
                ("lengths 0/1/G-1/3 beside 300", G, R + 5, 300, 8,
                 [0, 300, 1, 300, G - 1, 300, 3, 300], K5_GAPS),
                ("row at 255 across passes", G, R + 20, 40, 6, None,
                 K5_GAPS),
                ("gaps 0/0/50", G, R + 3, 50, 7, None, (0, 0, 50)),
                ("gaps 40/12/50", G, R + 3, 50, 7, None, (40, 12, 50)),
                ("Lq=1025 global table", G, 1025, 24, 3, None, K5_GAPS)]
    return out


def k4_edge_shapes():
    """K4's wavefront edges at each forced group width G: K5's cases
    (:func:`k5_edge_shapes`) but the gap settings, with K4's offset alone
    as the stage's arguments: one query row; 8G rows, 8G+1, three passes;
    lengths 0, 1, G-1 and 3 beside 300 in one warp; a row of 255s across
    a pass boundary (S saturates at 255 - off); Lq = 1025 from global
    memory."""
    return [(tag, G, Lq, Ld, B, lens, gaps[2:])
            for tag, G, Lq, Ld, B, lens, gaps in k5_edge_shapes()
            if not tag.startswith("gaps")]


def k5_edge_inputs(case, seed):
    """Seeded (table, states padded with 219, lengths) numpy inputs of a
    :func:`k5_edge_shapes` or :func:`k4_edge_shapes` case; the "row at
    255" case puts a table row of 255s at every fourth position."""
    tag, _G, Lq, Ld, B, lens, _gaps = case
    rng = np.random.default_rng(seed)
    tab = prefilter_table(rng, Lq)
    db = rng.integers(0, 219, (B, Ld)).astype(np.int32)
    dl = np.asarray(lens if lens is not None
                    else rng.integers(Ld // 2, Ld + 1, B), np.int32)
    if tag.startswith("row at 255"):
        tab[7] = 255
        db[:, ::4] = 7
    for b in range(B):
        db[b, dl[b]:] = 219
    return tab, db, dl


@contextlib.contextmanager
def forced_pf_width(G):
    """K4 and K5 launched at group width G (None: the one pf_geometry
    picks)."""
    from hhsuite_tpu_torch.ops import prefilter as P

    geometry = P.pf_geometry
    P.pf_geometry = lambda *a, **kw: geometry(*a, **kw, G=G)
    try:
        yield
    finally:
        P.pf_geometry = geometry


def phase1_prefilter(dev):
    """K4 and K5 against their plain versions on the card, over the
    resident layout at the path's shape (B_PF long-tail sequences,
    Lq = LQ_PF; both also timed at each group width) and through the
    public wrappers at edge shapes, both also at their wavefront's edges
    at each group width (:func:`k4_edge_shapes`,
    :func:`k5_edge_shapes`); returns the per-kernel records (without
    launch counts)."""
    import torch

    from hhsuite_tpu_torch.ops import prefilter as P
    from hhsuite_tpu_torch.search.prefilter import to_device_cs219

    rng = np.random.default_rng(SEED + 10)
    lens = long_tail_lengths(rng, B_PF)
    seqs = [rng.integers(0, 219, n, dtype=np.uint8).tobytes() for n in lens]
    pack = to_device_cs219(seqs, dev)
    qc = torch.from_numpy(prefilter_table(rng, LQ_PF)).to(dev)
    rows = (pack.states, pack.offsets, pack.row_lengths)
    cells = LQ_PF * int(lens.sum())
    nbytes = 220 * LQ_PF + int(lens.sum()) + B_PF * (8 + 4 + 4)
    recs = {}
    for key, kern, plain, args, ops, src in (
            ("K4", P.ungapped_scores_packed, P.ungapped_scores_plain, (50,),
             OPS_K4, "hhsuite_tpu/ops/prefilter_pallas.py:32"),
            ("K5", P.gapped_scores_packed, P.gapped_scores_plain,
             K5_GAPS, OPS_K5, "hhsuite_tpu/ops/prefilter_pallas2.py:37")):
        counter = P.ungapped_scores if key == "K4" else P.gapped_scores
        n0 = counter.launches
        out_k = kern(qc, *rows, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = P.packed_plain(plain, qc, *rows, *args, chunk=B_PF)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{key}: kernel != plain version at "
                                 f"B={B_PF} Lq={LQ_PF}")
        if int(out_k.max()) <= 0:
            raise AssertionError(f"{key}: all scores 0")
        ms = cuda_ms(lambda: kern(qc, *rows, *args), 3)
        bms, bby = bound_ms(cells * ops, nbytes, PEAK_INT32)
        log(f"phase1 {key}: B={B_PF} Lq={LQ_PF} sum(len)={int(lens.sum())} "
            f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS, "
            f"{counter.launches - n0} launches), plain {plain_ms:.1f} ms, "
            f"int-identical; bound {bms:.3f} ms ({bby})")
        name = ("K4 ungapped_scores (stage 1)" if key == "K4"
                else "K5 gapped_scores (stage 2)")
        recs[key] = dict(
            name=name, route="cuda",
            source="hhsuite_tpu_torch/csrc/prefilter.cu", replaces=src,
            max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None)
    geo = P.pf_geometry(B_PF, LQ_PF, float(lens.mean()))
    scratch = P.cuda_lib().hh_pf_scratch_bytes(
        LQ_PF, geo.G, pack.states.numel())
    for key, kern, args in (("K4", P.ungapped_scores_packed, (50,)),
                            ("K5", P.gapped_scores_packed, K5_GAPS)):
        widths = {}
        for G in (8, 16, 32):
            with forced_pf_width(G):
                widths[G] = cuda_ms(lambda: kern(qc, *rows, *args), 3)
        log(f"phase1 {key} geometry: G={geo.G} (chosen), {geo.passes} "
            f"passes of {geo.G * geo.R} rows, {geo.groups} sequences a "
            f"block, scratch {scratch} bytes; at G = 8/16/32: "
            + " / ".join(f"{widths[G]:.3f}" for G in (8, 16, 32)) + " ms")
        recs[key].update(G=geo.G, R=geo.R, passes=geo.passes,
                         G_ms={f"G={G}": ms for G, ms in widths.items()})
    del pack, rows

    # edge shapes through the public (B, Ld) wrappers; 1024 is the
    # longest query whose table the kernels keep in shared memory, 2000
    # reads it from global memory
    edges = [("Lq=1", 1, 60, 257), ("Lq=33", 33, 50, 300),
             ("Lq=1024", 1024, 120, 96), ("Lq=2000", 2000, 150, 64),
             ("B=1", LQ_PF, 320, 1), ("all-padding rows", 64, 40, 40),
             ("row at 255", 128, 90, 80)]
    for tag, Lq, Ld, B in edges:
        tab = prefilter_table(rng, Lq)
        db = rng.integers(0, 219, (B, Ld)).astype(np.int32)
        dl = rng.integers(Ld // 2, Ld + 1, B).astype(np.int32)
        if tag == "all-padding rows":
            dl[::3] = 0
        if tag == "row at 255":
            tab[7] = 255
            db[:, ::4] = 7
        for b in range(B):
            db[b, dl[b]:] = 219
        tab_d, db_d, dl_d = (torch.from_numpy(x).to(dev)
                             for x in (tab, db, dl))
        for key, kern, plain, args in (
                ("K4", P.ungapped_scores, P.ungapped_scores_plain, (50,)),
                ("K5", P.gapped_scores, P.gapped_scores_plain, K5_GAPS)):
            got = kern(tab_d, db_d, dl_d, *args)
            want = plain(tab_d, db_d, dl_d, *args)
            streamed = kern(tab_d, db_d, torch.full_like(dl_d, Ld), *args)
            if not (torch.equal(got, want) and torch.equal(got, streamed)):
                raise AssertionError(f"{key} {tag}: kernel != plain version")
            if tag == "row at 255" and int(got.max()) != 255 - 50:
                raise AssertionError(f"{key} {tag}: no saturation")
            if tag == "all-padding rows" and int(got[::3].max()) != 0:
                raise AssertionError(f"{key} {tag}: empty rows score")
        log(f"phase1 K4/K5 edge {tag} (Lq={Lq} Ld={Ld} B={B}): "
            f"int-identical, padding streamed == stopped at db_len")
    for key, kern, plain, cases, what in (
            ("K4", P.ungapped_scores, P.ungapped_scores_plain,
             k4_edge_shapes(), ""),
            ("K5", P.gapped_scores, P.gapped_scores_plain, k5_edge_shapes(),
             "; gaps 0/0/50 and 40/12/50")):
        t0 = time.perf_counter()
        for case in cases:
            tag, G, Lq, Ld, B, _lens, args = case
            tab_d, db_d, dl_d = (torch.from_numpy(x).to(dev)
                                 for x in k5_edge_inputs(case, seed=Lq + G))
            with forced_pf_width(G):
                got = kern(tab_d, db_d, dl_d, *args)
                streamed = kern(tab_d, db_d, torch.full_like(dl_d, Ld),
                                *args)
            want = plain(tab_d, db_d, dl_d, *args)
            if not (torch.equal(got, want) and torch.equal(got, streamed)):
                raise AssertionError(f"{key} wavefront edge G={G} {tag} "
                                     f"(Lq={Lq} Ld={Ld} B={B}): kernel != "
                                     "plain version")
            if tag.startswith("row at 255") and \
                    int(got.max()) != 255 - args[-1]:
                raise AssertionError(f"{key} wavefront edge G={G} {tag}: "
                                     "no saturation")
        log(f"phase1 {key} wavefront edges: {len(cases)} cases "
            "int-identical (Lq 1, 8G, 8G+1, 16G+1, 1025 from global memory; "
            "lengths 0/1/G-1/3 beside 300 in a warp; a row of 255s across "
            f"passes{what}) at G = 8, 16, 32 "
            f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    return recs


def phase2_golden(work):
    from hhsuite_tpu_torch.cli import main as cli_main

    d = os.path.join(work, "golden")
    os.makedirs(d, exist_ok=True)
    for src, dst in (("single_a3m", "single_a3m"), ("single_hhm", "single_hhm"),
                     ("golden_single_cs219", "single_cs219")):
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(os.path.join(FIX, src + ext),
                        os.path.join(d, dst + ext))
    out = os.path.join(work, "golden.m8")
    rc = cli_main(["hhsearch", "-i", os.path.join(FIX, "query.a3m"),
                   "-d", os.path.join(d, "single"), "-blasttab", out,
                   "-o", os.path.join(work, "golden.hhr")])
    if rc != 0:
        raise AssertionError(f"phase2: hhsearch exit {rc}")
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(FIX, "golden_hhsearch.blasttab"), "rb") as f:
        want = f.read()
    if got != want:
        raise AssertionError("phase2: blasttab differs from the golden "
                             f"file:\n{got.decode()}")
    log("phase2 golden: blasttab byte-identical "
        f"({len(got.splitlines())} lines)")
    base = os.path.join(d, "single")
    for rounds, outs in (("1", {"-blasttab": "golden_hhblits_n1.blasttab"}),
                         ("2", {"-oa3m": "blits_n2.a3m",
                                "-blasttab": "blits_n2.m8"})):
        args = ["hhblits", "-i", os.path.join(FIX, "query.a3m"), "-d", base,
                "-nocontxt", "-n", rounds,
                "-o", os.path.join(work, f"blits{rounds}.hhr")]
        for flag, golden in outs.items():
            args += [flag, os.path.join(work, golden)]
        rc = cli_main(args)
        if rc != 0:
            raise AssertionError(f"phase2: hhblits -n {rounds} exit {rc}")
        for golden in outs.values():
            with open(os.path.join(work, golden), "rb") as f:
                got = f.read()
            with open(os.path.join(FIX, golden), "rb") as f:
                if got != f.read():
                    raise AssertionError(f"phase2: hhblits -n {rounds} "
                                         f"differs from {golden}")
        log(f"phase2 golden: hhblits -n {rounds} "
            f"{' '.join(outs.values())} byte-identical")


def phase2_golden_ss(work):
    """hhsearch (-ssm 2, the default) through the CLI on the golden SS
    database: tests/test_ss_scoring.py's checks."""
    from hhsuite_tpu_torch.cli import main as cli_main

    d = os.path.join(work, "golden_ss")
    os.makedirs(d, exist_ok=True)
    for f in ("a3m", "cs219"):
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(os.path.join(FIX, f"ss_db_{f}{ext}"),
                        os.path.join(d, f"db_{f}{ext}"))
    hhr, m8 = os.path.join(work, "ss.hhr"), os.path.join(work, "ss.m8")
    rc = cli_main(["hhsearch", "-i", os.path.join(FIX, "query_ss.a3m"),
                   "-d", os.path.join(d, "db"), "-nocontxt", "-o", hhr,
                   "-blasttab", m8])
    if rc != 0:
        raise AssertionError(f"phase2: SS hhsearch exit {rc}")
    with open(hhr) as f:
        lines = f.read().splitlines()
    top = lines.index(next(ln for ln in lines if ln.startswith(" No Hit")))
    rows = [ln.split() for ln in lines[top + 1: top + 3]]
    # Score, SS, Cols, query range, template range from the right
    (s1, ss1, c1, q1, t1), (s2, ss2) = rows[0][-6:-1], rows[1][-6:-4]
    if not (abs(float(s1) - 1376.0) < 0.2 and abs(float(ss1) - 34.6) < 0.05
            and int(c1) == 431 and (q1, t1) == ("1-431", "1-431")
            and abs(float(s2) - 14.4) < 0.2
            and abs(float(ss2) - 0.5) < 0.05):
        raise AssertionError(f"phase2: SS hits differ from golden_ss: "
                             f"{rows}")
    with open(m8) as f:
        got = f.read().splitlines()
    with open(os.path.join(FIX, "golden_ss.m8")) as f:
        want = f.read().splitlines()
    if len(got) != len(want):
        raise AssertionError("phase2: SS blasttab line count differs")
    for g, w in zip(got, want):
        gt, wt = g.split("\t"), w.split("\t")
        if (gt[:10] != wt[:10]
                or abs(float(gt[10]) - float(wt[10]))
                > 0.02 * max(float(wt[10]), 1e-300)
                or abs(float(gt[11]) - float(wt[11])) > 0.15):
            raise AssertionError(f"phase2: SS blasttab {g!r} vs {w!r}")
    with open(os.path.join(FIX, "golden_ss.hhr")) as f:
        want_ss = [ln for ln in f.read().splitlines()
                   if ln.startswith("Q ss_pred")]
    if [ln for ln in lines if ln.startswith("Q ss_pred")] != want_ss:
        raise AssertionError("phase2: Q ss_pred rows differ from golden")
    log(f"phase2 golden SS: top hit {s1} SS {ss1} {c1} cols {q1}/{t1}, "
        f"second {s2} SS {ss2}; blasttab within tolerance, Q ss_pred rows "
        "identical")


def _hhr_body(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("Date", "Command"))]


CPU_RUN = """
import sys, time
sys.path.insert(0, {repo!r})
from hhsuite_tpu_torch.cli import main
from hhsuite_tpu_torch.search import engine
# the card's realign rule without its card test: the CPU run takes the
# batched realign path (the plain versions of R1-R4) as the card does
engine._use_device_realign = (
    lambda par, selected, device: not par.matrices_output_file
    and len(selected) >= 4)
t0 = time.perf_counter()
rc = main(sys.argv[1:])
print(f"CPU_SECONDS {{time.perf_counter() - t0:.2f}}", flush=True)
sys.exit(rc)
"""


def start_cpu_run(args):
    """One CLI run on the CPU (the plain versions) in a child process,
    with a third of the host's cores for its torch threads, so that
    phase 3's three CPU runs go side by side; its realign takes the
    card's path (:data:`CPU_RUN`)."""
    from hhsuite_tpu_torch.device import DEVICE_ENV

    threads = str(max(1, (os.cpu_count() or 3) // 3))
    env = dict(os.environ, **{DEVICE_ENV: "cpu", "OMP_NUM_THREADS": threads})
    return subprocess.Popen(
        [sys.executable, "-c", CPU_RUN.format(repo=REPO)] + args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_cpu_run(proc, tag) -> float:
    """Wait for :func:`start_cpu_run`'s child; returns its seconds."""
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase3 {tag}: CPU run exit {proc.returncode}"
                             f":\n{out[-3000:]}")
    return float(out.rsplit("CPU_SECONDS ", 1)[1].split()[0])


def phase3_card_vs_cpu(work, runs, counters):
    """Each of ``runs`` — (tag, CLI arguments, kernel that must launch,
    output flags) — through the CLI on the card and on the CPU (the
    plain versions; the CPU runs side by side in child processes,
    started first): the .hhr files (and -oa3m) must agree apart from
    Date/Command."""
    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.cli import main as cli_main

    def outs(tag, flags, side):
        name = f"p3_{[r[0] for r in runs].index(tag)}_{side}"
        return [x for f in flags for x in
                (f, os.path.join(work, name + (".a3m" if f == "-oa3m"
                                               else ".hhr")))]

    procs = {tag: start_cpu_run(args + outs(tag, flags, "cpu"))
             for tag, args, _kern, flags in runs}
    card = {}
    for tag, args, kern, flags in runs:
        timers = profiling.enable_stage_timers()
        reset(counters)
        t0 = time.perf_counter()
        try:
            if cli_main(args + outs(tag, flags, "card")) != 0:
                raise AssertionError(f"phase3 {tag}: card run failed")
        finally:
            profiling.disable_stage_timers()
        n = read(counters)
        if any(n[k] == 0 for k in kern):
            raise AssertionError(f"phase3 {tag}: {kern} did not launch ({n})")
        card[tag] = (time.perf_counter() - t0, n,
                     int(timers.get("funnel_blocks", 0)),
                     int(timers.get("funnel_dropped", 0)))
    for tag, _args, _kern, flags in runs:
        t_cpu = finish_cpu_run(procs[tag], tag)
        got = dict(zip(flags, outs(tag, flags, "card")[1::2]))
        want = dict(zip(flags, outs(tag, flags, "cpu")[1::2]))
        a, b = _hhr_body(got["-o"]), _hhr_body(want["-o"])
        if a != b:
            diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
            raise AssertionError(f"phase3 {tag}: card and CPU .hhr differ: "
                                 f"{diff}")
        same = f".hhr identical ({len(a)} lines)"
        if "-oa3m" in flags:
            with open(got["-oa3m"]) as f:
                a3m = f.read()
            with open(want["-oa3m"]) as f:
                if a3m != f.read():
                    raise AssertionError(f"phase3 {tag}: card and CPU -oa3m "
                                         "differ")
            same += f", -oa3m identical ({a3m.count(chr(62))} sequences)"
        t_card, n, blocks, dropped = card[tag]
        log(f"phase3 {tag}: card (funnel blocks {blocks}, switched off "
            f"{dropped}; launches {n}) {t_card:.2f} s, CPU (plain versions) "
            f"{t_cpu:.2f} s, {same}")


def phase4_full(base, query_text, counters):
    import math

    import torch

    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.search import engine

    db = engine.HHDatabase(base)
    last = None
    for tag in ("cold", "warm"):
        par = Parameters.hhsearch_defaults()
        timers = profiling.enable_stage_timers()
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, hitlist = engine.run_hhsearch(par, query_text, db, "bench_query")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read(counters)
        profiling.disable_stage_timers()
        hits = hitlist.hits
        light = sum(1 for h in hits if h.light)
        log(f"phase4 {tag}: {wall:.3f} s, templates searched "
            f"{hitlist.N_searched}, hits {len(hits)} (full "
            f"{len(hits) - light}, light {light}), launches {n}, "
            f"{_funnel_counts(timers)}, realign: "
            + ("device" if engine._use_device_realign(
                par, hits, torch.device("cuda")) else "host"))
        log("phase4 " + tag + " stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        log(f"phase4 {tag} {_realign_split(timers)}")
        log(f"phase4 {tag} {_backtrace_split(timers)}")
        if any(n[k] == 0 for k in ("K1", "K2", "K3", "W1") + REALIGN_KEYS):
            raise AssertionError(f"phase4: a kernel of the path was not "
                                 f"launched: {n}")
        check_walks(f"phase4 {tag}", n)
        if hitlist.N_searched != db.size() or not hits:
            raise AssertionError("phase4: wrong number of templates/hits")
        if not all(math.isfinite(h.score) for h in hits):
            raise AssertionError("phase4: non-finite scores")
        if hits[0].Probab < 99.0:
            raise AssertionError(f"phase4: top hit Probab {hits[0].Probab}")
        if last is not None and [
                (h.entry, h.irep, h.score) for h in hits] != last:
            raise AssertionError("phase4: warm run differs from cold run")
        last = [(h.entry, h.irep, h.score) for h in hits]
    # the same query with the host decoder: .hhr lines that differ
    # (a printed count, not a gate: f32 on the card against doubles)
    card_hhr = _hhr_lines(par, q, hitlist)
    orig = engine._use_device_realign
    engine._use_device_realign = lambda *_a: False
    try:
        t0 = time.perf_counter()
        par_h = Parameters.hhsearch_defaults()
        q_h, hl_h = engine.run_hhsearch(par_h, query_text, db, "bench_query")
        host_s = time.perf_counter() - t0
    finally:
        engine._use_device_realign = orig
    host_hhr = _hhr_lines(par_h, q_h, hl_h)
    ndiff = (sum(a != b for a, b in zip(card_hhr, host_hhr))
             + abs(len(card_hhr) - len(host_hhr)))
    log(f"phase4 realign on the card against the host decoder (same query, "
        f"host run {host_s:.3f} s): {ndiff} of {len(host_hhr)} .hhr lines "
        f"differ ({len(card_hhr)} lines on the card)")
    profile_query("phase4", lambda: engine.run_hhsearch(
        Parameters.hhsearch_defaults(), query_text, db, "bench_query"),
        counters, timed=("sweep (K1/K6)",) + REALIGN_KEYS + ("W1",))
    return n


def _hhr_lines(par, q, hitlist):
    """The .hhr text of a search (hit list and alignments, no Date or
    Command lines), as lines."""
    from hhsuite_tpu_torch.io.alignments import print_alignments
    from hhsuite_tpu_torch.io.results import print_hit_list
    from hhsuite_tpu_torch.matrices import get_substitution_matrix

    text = (print_hit_list(q, hitlist, par.maxdbstrlen, par.z, par.Z, par.p,
                           par.E, [], datestr="-")
            + print_alignments(q, hitlist, par,
                               get_substitution_matrix(par.matrix).S))
    return text.splitlines()


def _realign_split(timers: dict) -> str:
    """host_realign and its split timers, in seconds."""
    keys = ("host_realign", "host_realign_assemble", "posterior_fetch_wait",
            "host_realign_write")
    return "realign (s): " + ", ".join(
        f"{k} {timers.get(k, 0.0):.4f}" for k in keys)


def _backtrace_split(timers: dict) -> str:
    """The backtrace pass's timers, in seconds: the launches of K2/K3
    and W1 (``viterbi_backtrace_pass``), the payloads' copy to the host
    after each junk's last batch (``vit_payload_fetch``), their sum, and
    the dispatch stage that holds both (``host_vit_dispatch``)."""
    bt = timers.get("viterbi_backtrace_pass", 0.0)
    fetch = timers.get("vit_payload_fetch", 0.0)
    return (f"backtrace (s): viterbi_backtrace_pass {bt:.4f}, "
            f"vit_payload_fetch {fetch:.4f}, sum {bt + fetch:.4f}, "
            f"host_vit_dispatch {timers.get('host_vit_dispatch', 0.0):.4f}")


def _funnel_counts(timers: dict) -> str:
    """Take the search's funnel counts out of a stage-timer dict (which
    then holds seconds only) and say them."""
    blocks = int(timers.pop("funnel_blocks", 0))
    dropped = int(timers.pop("funnel_dropped", 0))
    return (f"funnel blocks {blocks}, switched itself off "
            f"{'yes' if dropped else 'no'}")


def _delta(now: dict, before: dict) -> dict:
    return {k: round(v - before.get(k, 0), 4) for k, v in sorted(now.items())
            if v - before.get(k, 0) and not k.startswith("funnel_")}


def phase5_hhblits(base, query_text, counters, dev):
    """hhblits -n 2 with default parameters on the 2^20-entry database,
    cold then warm; per-round survivors, stages and launches; K4/K5 over
    the whole resident pack against their plain versions."""
    import copy
    import math

    import torch

    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.cs.context_lib import ContextLibrary
    from hhsuite_tpu_torch.matrices import get_substitution_matrix
    from hhsuite_tpu_torch.ops import prefilter as P
    from hhsuite_tpu_torch.search import engine
    from hhsuite_tpu_torch.search.hhblits import (prefilter_pseudocounts,
                                                  run_hhblits)
    from hhsuite_tpu_torch.search.prefilter import (build_query_profile,
                                                    database_cs219)
    from hhsuite_tpu_torch.search.query import read_query_text

    t0 = time.perf_counter()
    db = engine.HHDatabase(base)
    log(f"phase5 database: {db.size()} entries opened in "
        f"{time.perf_counter() - t0:.2f} s")
    if db.size() != N_ENTRIES_BIG:
        raise AssertionError(f"phase5: {db.size()} entries")
    last = None
    for tag in ("cold", "warm"):
        par = Parameters.hhblits_defaults()
        timers = profiling.enable_stage_timers()
        rounds = []

        def on_round(info):
            rounds.append(dict(info, launches=read(counters),
                               stages=dict(timers)))

        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, hitlist, _qali = run_hhblits(par, query_text, db, "bench_query",
                                        on_round=on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read(counters)
        profiling.disable_stage_timers()
        hits = hitlist.hits
        log(f"phase5 {tag}: {wall:.3f} s, {len(rounds)} rounds, final hits "
            f"{len(hits)}, top hit {hits[0].entry if hits else None} "
            f"Probab {hits[0].Probab if hits else None}, launches {n}, "
            f"{_funnel_counts(timers)}")
        prev_n, prev_t = {k: 0 for k in n}, {}
        for r in rounds:
            log(f"phase5 {tag} round {r['round']}: prefilter stage 1 "
                f"{r.get('stage1')} / {db.size()}, stage 2 {r.get('stage2')}, "
                f"new {r['new']}, old {r['old']}, templates searched "
                f"{r['searched']}, hits {r['hits']}, launches "
                f"{ {k: v - prev_n[k] for k, v in r['launches'].items()} }")
            log(f"phase5 {tag} round {r['round']} stages (s): "
                + json.dumps(_delta(r["stages"], prev_t)))
            log(f"phase5 {tag} round {r['round']} " + _realign_split(
                _delta(r["stages"], prev_t)))
            log(f"phase5 {tag} round {r['round']} " + _backtrace_split(
                _delta(r["stages"], prev_t)))
            prev_n, prev_t = r["launches"], r["stages"]
        log(f"phase5 {tag} stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        if any(n[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5", "W1")
               + REALIGN_KEYS):
            raise AssertionError(f"phase5: a kernel of the path was not "
                                 f"launched: {n}")
        check_walks(f"phase5 {tag}", n)
        if not hits or not all(math.isfinite(h.score) for h in hits):
            raise AssertionError("phase5: no hits or non-finite scores")
        if hits[0].Probab < 99.0:
            raise AssertionError(f"phase5: top hit Probab {hits[0].Probab}")
        now = [(h.entry, h.irep, h.score) for h in hits]
        if last is not None and now != last:
            raise AssertionError("phase5: warm run differs from cold run")
        last = now
    launches = n

    # K4 / K5 over the whole resident pack with round 1's query table
    _names, _seqs, pack = database_cs219(db, dev)
    log(f"phase5 resident cs219 pack: {len(pack)} rows, {pack.nbytes} bytes "
        f"on the card ({int(pack.row_lengths.sum())} states)")
    par = Parameters.hhblits_defaults()
    mats = get_substitution_matrix(par.matrix)
    q, _qali, _fmt = read_query_text(par, query_text, "bench_query", mats)
    if par.notags:
        engine.neutralize_tags(q, mats.pb)
    q_tmp = copy.deepcopy(q)
    prefilter_pseudocounts(par, q_tmp, mats)
    qc = torch.from_numpy(build_query_profile(
        q_tmp, ContextLibrary.default_cs219(), par.prefilter_score_offset,
        par.prefilter_bit_factor)).to(dev)
    rows = (pack.states, pack.offsets, pack.row_lengths)
    gi = par.prefilter_gap_open + par.prefilter_gap_extend
    for key, kern, plain, args in (
            ("K4", P.ungapped_scores_packed, P.ungapped_scores_plain,
             (par.prefilter_score_offset,)),
            ("K5", P.gapped_scores_packed, P.gapped_scores_plain,
             (gi, par.prefilter_gap_extend, par.prefilter_score_offset))):
        got = kern(qc, *rows, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = P.packed_plain(plain, qc, *rows, *args, chunk=1 << 16)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not torch.equal(got, want):
            raise AssertionError(f"phase5: {key} over the whole pack != "
                                 "plain version")
        ms = cuda_ms(lambda: kern(qc, *rows, *args), 2)
        cells = q_tmp.L * int(pack.row_lengths.sum())
        log(f"phase5 {key} whole pack (Lq={q_tmp.L}, {len(pack)} rows): "
            f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), plain "
            f"{plain_s:.2f} s, int-identical")
    del rows
    torch.cuda.empty_cache()
    by_name = profile_query("phase5", lambda: run_hhblits(
        Parameters.hhblits_defaults(), query_text, db, "bench_query"),
        counters, timed=("sweep (K1/K6)", "K4") + REALIGN_KEYS + ("W1",))
    k5 = [v for name, v in by_name.items() if "pf_wave_kernel<true" in name]
    log(f"phase5 K5 device time: {sum(us for us, _n in k5) / 1e3:.3f} ms "
        f"over {sum(n for _us, n in k5)} launches (profiled warm query; "
        f"counter K5 {read(counters)['K5']})")
    return launches


def phase6_ss(base, query_text, counters):
    """hhsearch defaults (-ssm 2) on the 8192-template SS database with
    the SS-annotated query, cold then warm; K6 (the SS sweep) and K3 (the
    SS backtrace pass) must launch."""
    import math

    import torch

    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.search import engine

    db = engine.HHDatabase(base)
    last = None
    for tag in ("cold", "warm"):
        par = Parameters.hhsearch_defaults()
        timers = profiling.enable_stage_timers()
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, hitlist = engine.run_hhsearch(par, query_text, db,
                                         "bench_query_ss")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read(counters)
        profiling.disable_stage_timers()
        hits = hitlist.hits
        light = sum(1 for h in hits if h.light)
        log(f"phase6 {tag}: {wall:.3f} s, ssm {par.ssm}, templates "
            f"searched {hitlist.N_searched}, hits {len(hits)} (full "
            f"{len(hits) - light}, light {light}), top hit "
            f"{hits[0].entry if hits else None} Probab "
            f"{hits[0].Probab if hits else None} SS "
            f"{hits[0].score_ss if hits else None}, launches {n}, "
            f"{_funnel_counts(timers)}")
        log("phase6 " + tag + " stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        log(f"phase6 {tag} {_realign_split(timers)}")
        log(f"phase6 {tag} {_backtrace_split(timers)}")
        if q.nss_pred < 0:
            raise AssertionError("phase6: the query carries no SS")
        if any(n[k] == 0 for k in ("K6", "K3", "W1") + REALIGN_KEYS):
            raise AssertionError(f"phase6: K6, K3, W1 and R1-R4 must "
                                 f"launch: {n}")
        check_walks(f"phase6 {tag}", n)
        if hitlist.N_searched != db.size() or not hits:
            raise AssertionError("phase6: wrong number of templates/hits")
        if not all(math.isfinite(h.score) for h in hits):
            raise AssertionError("phase6: non-finite scores")
        if hits[0].Probab < 99.0 or hits[0].score_ss <= 0.0:
            raise AssertionError(f"phase6: top hit Probab {hits[0].Probab}"
                                 f" SS {hits[0].score_ss}")
        now = [(h.entry, h.irep, h.score, h.score_ss) for h in hits]
        if last is not None and now != last:
            raise AssertionError("phase6: warm run differs from cold run")
        last = now
    by_name = profile_query("phase6", lambda: engine.run_hhsearch(
        Parameters.hhsearch_defaults(), query_text, db, "bench_query_ss"),
        counters, timed=("sweep (K1/K6)",) + REALIGN_KEYS + ("W1",))
    k3 = [v for name, v in by_name.items() if "vit_bt_kernel" in name]
    log(f"phase6 K3 device time: {sum(us for us, _n in k3) / 1e3:.2f} ms "
        f"over {sum(n for _us, n in k3)} launches (profiled warm query)")
    return n


# kernels timed by CUDA events around each launch on a profiled query:
# label -> (ops module, library entry, counters, profiler name)
TIMED = {"sweep (K1/K6)": ("viterbi_lanes", "hh_vit_score", ("K1", "K6"),
                           "vit_score_kernel"),
         "K4": ("prefilter", "hh_pf_ungapped", ("K4",),
                "pf_wave_kernel<false")}
TIMED.update({key: ("posterior_batch", entry, (key,), kname)
              for key, (kname, _n, _r, entry) in REALIGN_KERNELS.items()})
TIMED["W1"] = ("viterbi_lanes", "hh_vit_walk", ("W1",), "bt_walk_kernel")


@contextlib.contextmanager
def launch_events(label):
    """CUDA events around each launch of a :data:`TIMED` kernel, by its
    launch code's library with the kernel's entry wrapped; yields the
    list of (host seconds, start event, end event), one a launch."""
    import importlib

    import torch

    module, entry, _keys, _name = TIMED[label]
    ops = importlib.import_module(f"hhsuite_tpu_torch.ops.{module}")
    lib, launches = ops.cuda_lib(), []

    def timed(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = getattr(lib, entry)(*args)
        e1.record()
        launches.append((time.perf_counter(), e0, e1))
        return rc

    class Timed:
        def __getattr__(self, name):
            return timed if name == entry else getattr(lib, name)

    orig, ops.cuda_lib = ops.cuda_lib, Timed
    try:
        yield launches
    finally:
        ops.cuda_lib = orig


def profile_query(tag, run, counters, timed=("sweep (K1/K6)",)):
    """One more warm query under torch.profiler, tracing the card's
    activity alone: device time by kernel and the device's busy share,
    read from the raw trace (torch's event tree over ~10^5 kernels took
    tens of seconds to build).  On the same query the launch counters,
    and CUDA events around each launch of the ``timed`` kernels
    (:func:`launch_events`; the sweep, K1 + K6, by default): their
    device time over exactly the launches the counters count, beside the
    profiler's reading of the same kernel; fails when the events' count
    and the counters' disagree.  Returns {kernel name: (microseconds,
    launches)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reset(counters)
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        events = {label: stack.enter_context(launch_events(label))
                  for label in timed}
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = read(counters)
    trace = prof.profiler.kineto_results
    by_name, first = {}, {}
    for ev in trace.events():
        if (ev.device_type() != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", lambda: False)()):
            continue
        us, k = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (us + ev.duration_ns() / 1e3, k + 1)
        t = ev.start_ns()
        first["any"] = min(first.get("any", t), t)
        for label in timed:
            if TIMED[label][3] in ev.name():
                first[label] = min(first.get(label, t), t)
    busy = sum(us for us, _n in by_name.values()) / 1e6
    log(f"{tag} profiled: {wall:.3f} s wall (profiler on), device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{sum(k for _us, k in by_name.values())} device activities, "
        f"launches {n}")
    for name, (us, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        log(f"{tag} device: {us / 1e3:10.2f} ms {k:7d} x {name[:70]}")
    into = {k: f"{(v - trace.trace_start_ns()) / 1e9:.3f} s"
            for k, v in first.items()}
    for label, launches in events.items():
        _module, _entry, keys, kname = TIMED[label]
        ev_ms = [e0.elapsed_time(e1) for _t, e0, e1 in launches]
        seen = [v for name, v in by_name.items() if kname in name]
        p_us, p_n = sum(us for us, _k in seen), sum(k for _us, k in seen)
        log(f"{tag} {label} device time: {sum(ev_ms):.3f} ms over "
            f"{len(ev_ms)} launches (CUDA events; counters "
            + ", ".join(f"{k} {n[k]}" for k in keys) + "): "
            + " ".join(f"{ms:.3f}" for ms in ev_ms)
            + f"; profiler {p_us / 1e3:.3f} ms over {p_n} launches")
        if len(ev_ms) != sum(n[k] for k in keys):
            raise AssertionError(f"{tag}: {len(ev_ms)} timed {label} "
                                 f"launches, counters {n}")
        if label == "W1":
            check_walks(tag, n)
        if p_n != len(ev_ms):
            log(f"{tag} the profiler recorded {p_n} of {len(ev_ms)} {label} "
                "launches: they left the host at "
                + ", ".join(f"{t - t0:.3f}" for t, _e0, _e1 in launches)
                + " s into the query; the trace's first device activity "
                f"{into.get('any', 'none')}, its first {label} kernel "
                f"{into.get(label, 'none')} into it")
    return by_name


# --------------------------------------------------------- counters ----

def kernel_counters():
    from hhsuite_tpu_torch.ops.prefilter import gapped_scores, ungapped_scores
    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        viterbi_backtrace_lanes, viterbi_score_lanes,
        viterbi_score_lanes_fused)
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    from hhsuite_tpu_torch.ops import posterior_batch as PB
    from hhsuite_tpu_torch.ops.viterbi import backtrace_walk_packed8

    return {"K1": viterbi_score_lanes_fused, "K2": viterbi_backtrace_lanes,
            "K3": viterbi_batch_rows, "K4": ungapped_scores,
            "K5": gapped_scores, "K6": viterbi_score_lanes,
            "R1": PB.fb_forward, "R2": PB.fb_backward, "R3": PB.mac_dp,
            "R4": PB.mac_walk_packed8, "W1": backtrace_walk_packed8}


def check_walks(tag, n):
    """Each K2/K3 launch of the backtrace pass is walked by one W1
    launch: fail otherwise."""
    if n["W1"] != n["K2"] + n["K3"]:
        raise AssertionError(f"{tag}: {n['W1']} W1 launches, K2 + K3 "
                             f"{n['K2'] + n['K3']}")


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


# ------------------------------------------------------------- main ----

def phase0_builds() -> dict:
    """Build the CUDA kernels (in parallel) and the native host library;
    print ptxas's registers and spills of every wavefront kernel
    instantiation: the eight of vit_bt_kernel (K2/K3) and the twelve of
    vit_score_kernel (K1/K6: fast, exact, dense SS, SS table at G = 8,
    16, 32), of the four realign kernels (R1-R4) and of the walk (W1).
    Returns :func:`wave_instantiations` of the viterbi build and the
    realign kernels' and the walk's usage under their names."""
    from concurrent.futures import ThreadPoolExecutor

    from hhsuite_tpu_torch import native
    from hhsuite_tpu_torch.device import cuda_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        f_cu = {name: ex.submit(cuda_library, name)
                for name in ("viterbi", "prefilter", "posterior")}
        f_nat = ex.submit(native.require)
        infos = {name: f.result()[1] for name, f in f_cu.items()}
        f_nat.result()
    log(f"phase0 build: {time.perf_counter() - t0:.1f} s (nvcc "
        + ", ".join(f"{n}.cu {i.seconds:.1f} s cached={i.cached}"
                    for n, i in infos.items())
        + "); native host library loaded")
    for ln in infos["prefilter"].log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            log("phase0 ptxas prefilter: " + ln.strip())
    for name, mix in sass_minmax(infos["prefilter"].path).items():
        log(f"phase0 SASS {name}: " + ", ".join(
            f"{op} {n}" for op, n in sorted(mix.items())))
    usage = wave_instantiations(ptxas_usage(infos["viterbi"].log))
    for key, (regs, st, ld) in usage.items():
        log(f"phase0 {key}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    n_bt = sum(k.startswith("bt<") for k in usage)
    n_score = sum(k.startswith("score<") for k in usage)
    if (n_bt, n_score) != (8, 12):
        raise AssertionError(f"phase0: ptxas reported {n_bt} vit_bt_kernel "
                             f"and {n_score} vit_score_kernel "
                             "instantiations, not 8 and 12")
    post = realign_instantiations(ptxas_usage(infos["posterior"].log))
    for key, (regs, st, ld) in post.items():
        log(f"phase0 {key}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    if len(post) != 64:
        raise AssertionError(f"phase0: ptxas reported {len(post)} realign "
                             "kernel instantiations, not 64")
    usage.update(post)
    # the path's: R1-R3 at 4 columns a thread without SS
    for kname, *_rest in REALIGN_KERNELS.values():
        usage[kname] = post.get(kname + "<4,0>",
                                post.get(kname + "<4>", post.get(kname)))
    for name, u in ptxas_usage(infos["viterbi"].log).items():
        if "bt_walk_kernel" in name:
            usage["bt_walk_kernel"] = u
    for key, (kname, *_rest) in list(REALIGN_KERNELS.items()) + [
            ("W1", ("bt_walk_kernel",))]:
        if usage.get(kname) is None:
            raise AssertionError(f"phase0: ptxas reported no {kname}")
        regs, st, ld = usage[kname]
        log(f"phase0 {key} {kname}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    return usage


def sass_minmax(so_path: str) -> dict:
    """The integer add / min / max and byte-permute instructions of each
    prefilter kernel in a built library, from ``cuobjdump -sass``:
    {kernel: {opcode: count}} (opcodes IADD3, VIADD, IMNMX, VIMNMX,
    VIADDMNMX, PRMT and their variants)."""
    import collections
    import re

    from hhsuite_tpu_torch.device import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"pf_wave_kernelILb([01])ELb([01])E",
                      body.split("\n", 1)[0])
        if not m:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"((?:IADD3|VIADD|IMNMX|VIMNMX|VIADDMNMX|PRMT)"
                         r"[A-Za-z0-9_.]*)", body)
        stage = "K5" if m.group(1) == "1" else "K4"
        out[f"{stage} pf_wave_kernel<{m.group(1)}, {m.group(2)}>"] = dict(
            collections.Counter(ops))
    if not out:
        raise AssertionError(f"phase0: no prefilter kernel in {so_path}")
    return out


def phase_ok(n: int, t0: float) -> float:
    """Say that phase ``n`` passed and its wall seconds since ``t0``;
    returns the time now."""
    now = time.perf_counter()
    log(f"phase{n} ok ({now - t0:.1f} s)")
    return now


DB_BUILD = """
import sys, time
sys.path.insert(0, {repo!r})
from hhsuite_tpu_torch.tools.benchdb import (build_bench_db, build_decoy_db,
                                             build_ss_db, ss_composition)
fam512, fam8k, fam_small, dec_small, big, ss_small, ss8k = sys.argv[1:8]
queries = {{}}
for base, n, mix in ((fam512, 512, False), (fam_small, {nfam}, False),
                     (fam8k, 8192, True)):
    t0 = time.perf_counter()
    q = queries[base] = build_bench_db(base, n_templates=n, length_mix=mix)
    with open(base + ".query.a3m", "w") as f:
        f.write(q)
    print(f"{{base}}: {{n}} templates in {{time.perf_counter() - t0:.1f}} s")
for base, fam in ((ss_small, fam_small), (ss8k, fam8k)):
    t0 = time.perf_counter()
    q = build_ss_db(base, fam, queries[fam])
    with open(base + ".query.a3m", "w") as f:
        f.write(q)
    comp = " ".join(f"{{k}} {{v:.3f}}" for k, v in ss_composition(base).items())
    print(f"{{base}}: SS rows in {{time.perf_counter() - t0:.1f}} s, "
          f"composition {{comp}}")
for base, fam, n in ((dec_small, fam_small, {ndec}),
                     (big, fam8k, {nbig} - 8192)):
    t0 = time.perf_counter()
    total = build_decoy_db(base, fam, n)
    print(f"{{base}}: {{total}} entries in {{time.perf_counter() - t0:.1f}} s")
"""


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "hhsuite_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(hhsuite_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.environ.pop("HHSUITE_TPU_TORCH_DEVICE", None)

    os.makedirs(CACHE, exist_ok=True)
    work = os.path.join(CACHE, f"run-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    base512 = os.path.join(CACHE, "bench512")
    base8k = os.path.join(CACHE, "bench8192mix")
    base_small = os.path.join(CACHE, f"bench{N_FAMILY_SMALL}")
    base_small_d = os.path.join(
        CACHE, f"bench{N_FAMILY_SMALL}_decoys{N_DECOYS_SMALL}")
    base_big = os.path.join(CACHE, f"bench8192mix_decoys_{N_ENTRIES_BIG}")
    base_ss_small = os.path.join(CACHE, f"bench{N_FAMILY_SMALL}_ss")
    base_ss8k = os.path.join(CACHE, "bench8192mix_ss")
    t_db = t_start = time.perf_counter()
    db_proc = subprocess.Popen(
        [sys.executable, "-c", DB_BUILD.format(
            repo=REPO, nfam=N_FAMILY_SMALL, ndec=N_DECOYS_SMALL,
            nbig=N_ENTRIES_BIG),
         base512, base8k, base_small, base_small_d, base_big, base_ss_small,
         base_ss8k],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

        from hhsuite_tpu_torch.device import resolve_device

        t_phase = time.perf_counter()
        usage = phase0_builds()
        t_phase = phase_ok(0, t_phase)
        dev = resolve_device("cuda")

        recs = phase1_kernels(dev, usage)
        recs["K6"] = phase1_k6(dev, usage)
        t_pf = time.perf_counter()
        recs.update(phase1_prefilter(dev))
        log(f"phase1 K4/K5: {time.perf_counter() - t_pf:.1f} s")
        recs.update(phase1_realign(dev, usage))
        t_phase = phase_ok(1, t_phase)
        phase2_golden(work)
        phase2_golden_ss(work)
        t_phase = phase_ok(2, t_phase)

        out, _ = db_proc.communicate(timeout=900)
        if db_proc.returncode != 0:
            raise AssertionError(f"database build failed:\n{out}")
        for ln in out.splitlines():
            log("database build: " + ln)
        log(f"databases ready after {time.perf_counter() - t_db:.1f} s")
        t_phase = time.perf_counter()
        counters = kernel_counters()

        def hhsearch(base, cap):
            return ["hhsearch", "-i", base + ".query.a3m", "-d", base, "-Z",
                    cap, "-B", cap, "-realign_max", cap]

        phase3_card_vs_cpu(work, [
            ("512 templates", hhsearch(base512, "100"),
             ("K1", "W1") + REALIGN_KEYS, ("-o",)),
            (f"{N_FAMILY_SMALL} SS templates", hhsearch(base_ss_small, "30"),
             ("K6", "W1") + REALIGN_KEYS, ("-o",)),
            (f"hhblits -n 2, {N_FAMILY_SMALL} templates + {N_DECOYS_SMALL} "
             "decoys", ["hhblits", "-i", base_small + ".query.a3m", "-d",
                        base_small_d, "-n", "2"],
             ("K4", "K5", "W1") + REALIGN_KEYS, ("-o", "-oa3m"))], counters)
        t_phase = phase_ok(3, t_phase)
        with open(base8k + ".query.a3m") as f:
            q8k = f.read()
        launches = phase4_full(base8k, q8k, counters)
        t_phase = phase_ok(4, t_phase)
        launches_blits = phase5_hhblits(base_big, q8k, counters, dev)
        t_phase = phase_ok(5, t_phase)
        with open(base_ss8k + ".query.a3m") as f:
            launches_ss = phase6_ss(base_ss8k, f.read(), counters)
        phase_ok(6, t_phase)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if db_proc.poll() is None:
            db_proc.kill()
            db_proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    # launches: K1-K3, R1-R4 and W1 on the hhsearch path (phase 4), K4/K5
    # on the hhblits path (phase 5), K6 on the SS hhsearch path (phase 6);
    # each also with its hhblits and SS counts
    main_path = {"K1": launches, "K2": launches, "K3": launches,
                 "K4": launches_blits, "K5": launches_blits,
                 "K6": launches_ss, "W1": launches}
    main_path.update({key: launches for key in REALIGN_KEYS})
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6") + REALIGN_KEYS + ("W1",):
        r = dict(recs[key])
        r["launches"] = main_path[key][key]
        r["launches_hhblits"] = launches_blits[key]
        r["launches_ss"] = launches_ss[key]
        kernels.append(r)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
