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
   registers and spill bytes of each of the eight ``vit_bt_kernel``
   (K2/K3) instantiations;
1. each kernel against its plain PyTorch version on the card at the
   search path's shapes: the Viterbi kernels (K1 fast and exact, K2, K3
   with altali masks, global, and with the SS table, K6 with the SS
   lookup table) bit-identical, with K2/K3's launch geometry (group
   width G, rows a lane R); K2 and K3 at the wavefront's edge shapes;
   K6's dense form and its LUT form bit-identical, K6 without SS equal
   to K1 exact, K6 at edge shapes; the prefilter kernels (K4, K5)
   int-identical at the path's shape and at edge shapes; times from
   CUDA events;
2. ``hhsearch`` and ``hhblits`` (``-n 1``, ``-n 2``) through the CLI
   entry on the golden single-entry database: outputs byte-identical to
   the reference's (tests/fixtures); ``hhsearch`` on the golden SS
   database (``-ssm 2``): the reference's scores within
   tests/test_ss_scoring.py's tolerances;
3. the 512-template database: ``hhsearch`` with the funnel on (``-Z 100
   -B 100 -realign_max 100``), the 128-template SS database with the
   SS funnel on (``-Z 30 -B 30 -realign_max 30``), and ``hhblits -n 2``
   on the first 128 templates plus 16,384 decoys, each on the card and
   on the CPU with the plain versions: the ``.hhr`` files (and
   ``-oa3m``) must agree apart from Date/Command;
4. the 8192-template long-tail database, ``hhsearch`` with default
   parameters, cold and warm: wall and host-stage times, hit counts and
   the Viterbi kernels' launch counts on that run (each must be > 0);
5. ``hhblits -n 2`` with default parameters on the 2^20-entry database,
   cold and warm: per round the prefilter survivors, templates, hits,
   stage times and the launches of K1-K5 (each must be > 0 over the
   run); K4 and K5 over the whole resident cs219 pack against their
   plain versions; a profiled warm query;
6. ``hhsearch`` with default parameters (``-ssm 2``: SS in the DP) on the
   8192-template SS database with the family's SS-annotated query, cold
   and warm: as phase 4, with K1, K3 and K6 launched, and whether the
   funnel switched itself off; a profiled warm query, with K3's device
   time.

The last lines are the card (``nvidia-smi``), one JSON object with the
per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# integer operations per DP cell, counted in csrc/prefilter.cu: K4 add,
# min, subtract, max, running max; K5 vH 4, H0 1, G 3, F 1, H 1, E 5,
# running max 1 (addressing and loop control not counted)
OPS_K4, OPS_K5 = 5, 16

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

def synth_inputs(Lq, Lt, B, seed, device):
    """Seeded profile-like inputs in the search path's layout: query
    (Lq+2, 20)/(Lq+2, 7), templates as (B, Lt+2, 20/7) views of
    lanes-last storage, true lengths between Lt/2 and Lt."""
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


def bt_instantiations(usage: dict) -> dict:
    """The vit_bt_kernel<HAS_CO, HAS_SS, LOCAL> entries of
    :func:`ptxas_usage`, keyed "<co,ss,local>"."""
    import re

    out = {}
    for name, u in usage.items():
        m = re.search(r"vit_bt_kernelILb([01])ELb([01])ELb([01])E", name)
        if m:
            out["<%s,%s,%s>" % m.groups()] = u
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

def phase1_kernels(dev, bt_usage):
    """Kernel vs plain version at the path shapes; returns the per-kernel
    records (without launch counts).  ``bt_usage``: ptxas registers and
    spills of each vit_bt_kernel instantiation."""
    import torch

    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        bt_geometry, cuda_lib, viterbi_backtrace_lanes,
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
    k1 = {}
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
        log(f"phase1 K1 {mode}: B={B_K1} Lq={LQ} Lt={LT} {ms:.3f} ms "
            f"({LQ * LT * B_K1 / ms / 1e6:.1f} GCUPS, "
            f"{viterbi_score_lanes_fused.launches - n0} launches), plain "
            f"{plain_ms:.1f} ms, bit-identical")
    bms, bby = bound_ms(needed * OPS_K1["fast"],
                        in_bytes(qp, tp, B_K1) + B_K1 * f32b)
    recs["K1"] = dict(
        name="K1 viterbi_score_lanes_fused (si_mode=fast)",
        route="cuda", source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_lanes.py:355",
        max_abs_err=k1["fast"][2], ms=k1["fast"][0],
        plain_ms=k1["fast"][1], bound_ms=bms, bound_by=bby,
        library_ms=None, exact_ms=k1["exact"][0],
        exact_plain_ms=k1["exact"][1], exact_max_abs_err=k1["exact"][2])
    del qp, qtr, tp, ttr, tL

    def bt_check(tag, kern, plain, B, extra_bytes, ops_cell, tL, reps):
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

    # ---- K2 ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K2, SEED + 1, dev)
    ms, plain_ms, err, bms, bby, geo = bt_check(
        "K2",
        lambda: viterbi_backtrace_lanes(qp, qtr, tp, ttr, tL, shift,
                                        Lq_true=LQ),
        lambda: viterbi_batch(qp, qtr, tp, ttr, None, tL, shift,
                              Lq_true=LQ),
        B_K2, in_bytes(qp, tp, B_K2), OPS_BT, tL, 2)
    recs["K2"] = dict(
        name="K2 viterbi_backtrace_lanes", route="cuda",
        source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_lanes.py:646",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=None, G=geo.G, R=geo.R,
        ptxas=bt_usage.get("<0,0,1>"))
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
        ptxas={k: v for k, v in bt_usage.items() if k != "<0,0,1>"})
    phase1_bt_edges(dev)
    torch.cuda.empty_cache()
    return recs


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


def phase1_bt_edges(dev):
    """K2 and K3 (global, cell-off, SS table) against the plain version
    at the wavefront's edges, at each group width G: one query row, a
    pass of G*R rows less one, exactly, plus one; one template column;
    one template; a block left partly empty; and K3 at Lq = 513."""
    import functools

    import torch

    from hhsuite_tpu_torch.ops import viterbi_lanes as VL
    from hhsuite_tpu_torch.ops.viterbi import (backtrace_walk_packed8,
                                               viterbi_batch)
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    shift, n = -0.03, 0
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
                walk = torch.equal(
                    backtrace_walk_packed8(got[3], *got[1:3], got[0], kmax),
                    backtrace_walk_packed8(want[3], *want[1:3], want[0],
                                           kmax))
                if not (same and walk):
                    raise AssertionError(f"{tag} edge G={G} Lq={Lq} Lt={Lt}"
                                         f" B={B}: kernel != plain version")
                n += 1
    finally:
        VL.bt_geometry = orig
    log(f"phase1 K2/K3 wavefront edges: {n} cases bit-identical (score, "
        "i2, j2, bt, walk payload) at G = 8, 16, 32 and Lq = 513")


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
    """The dense (B, Lq+1, Lt+1) SS matrix of the LUT form, row 0 and
    column 0 zero, as a view of lanes-last storage (K6's dense layout),
    filled one query row at a time."""
    import torch

    B, Lt = tidx.shape
    Lq = qidx.shape[0]
    out = torch.zeros((Lq + 1, Lt + 1, B), dtype=torch.float32,
                      device=lut.device)
    tT = tidx.T.long()
    for i in range(Lq):
        out[i + 1, 1:] = lut[qidx[i].long() + tT]
    return out.permute(2, 0, 1)


def phase1_k6(dev):
    """K6 against its plain version at the SS sweep's path shape (LUT
    form), its dense form, K1 exact, and edge shapes; returns its record
    (without launch counts)."""
    import torch

    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        viterbi_score_lanes, viterbi_score_lanes_fused,
        viterbi_score_lanes_plain)

    shift = -0.03

    def check(tag, Lq, Lt, B, seed, timed=False):
        qp, qtr, tp, ttr, tL = synth_inputs(Lq, Lt, B, seed, dev)
        lut, qidx, tidx = ss_lut_inputs(Lq, Lt, B, seed + 1, dev)
        kw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
        out_k = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tL, shift, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not bits_equal(out_k, out_p):
            raise AssertionError(f"K6 {tag}: kernel != plain version "
                                 f"(max |d| {max_abs(out_k, out_p)})")
        if not torch.isfinite(out_k).all():
            raise AssertionError(f"K6 {tag}: non-finite scores")
        dense = ss_dense(lut, qidx, tidx)
        out_d = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift,
                                    ss_score=dense)
        if not bits_equal(out_d, out_k):
            raise AssertionError(f"K6 {tag}: dense form != LUT form")
        out_n = viterbi_score_lanes(qp, qtr, tp, ttr, tL, shift)
        out_e = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tL, shift,
                                          si_mode="exact")
        if not bits_equal(out_n, out_e):
            raise AssertionError(f"K6 {tag}: no SS != K1 exact")
        if not timed:
            log(f"phase1 K6 edge {tag} (Lq={Lq} Lt={Lt} B={B}): "
                "bit-identical; dense == LUT; no SS == K1 exact")
            return None
        n0 = viterbi_score_lanes.launches
        ms = cuda_ms(lambda: viterbi_score_lanes(qp, qtr, tp, ttr, tL,
                                                 shift, **kw), 3)
        dense_ms = cuda_ms(lambda: viterbi_score_lanes(
            qp, qtr, tp, ttr, tL, shift, ss_score=dense), 2)
        launches = viterbi_score_lanes.launches - n0
        needed = Lq * int(tL.sum())
        nbytes = ((Lq * 27 + B * (Lt + 2) * 27) * 4 + B * 4      # profiles
                  + (lut.numel() + Lq + B * Lt) * 4 + B * 4)     # SS, out
        bms, bby = bound_ms(needed * OPS_K6, nbytes)
        log(f"phase1 K6 LUT: B={B} Lq={Lq} Lt={Lt} {ms:.3f} ms "
            f"({Lq * Lt * B / ms / 1e6:.1f} GCUPS, {launches} launches), "
            f"dense {dense_ms:.3f} ms, plain {plain_ms:.1f} ms; "
            f"bit-identical, dense == LUT, no SS == K1 exact; bound "
            f"{bms:.3f} ms ({bby})")
        return dict(
            name="K6 viterbi_score_lanes (SS lookup table)", route="cuda",
            source="hhsuite_tpu_torch/csrc/viterbi.cu",
            replaces="hhsuite_tpu/ops/viterbi_lanes.py:62",
            max_abs_err=max_abs(out_k, out_p), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=None, dense_ms=dense_ms)

    rec = check("path shape", LQ, LT, B_K1, SEED + 20, timed=True)
    # one partial ROWS strip, a full strip plus one row, two strips plus
    # one row; one template; one template column
    for k, (tag, Lq, Lt, B) in enumerate((
            ("Lq=1", 1, 40, 33), ("Lq=9", 9, 40, 33), ("Lq=17", 17, 50, 65),
            ("B=1", LQ, LT, 1), ("Lt=1", 25, 1, 40))):
        check(tag, Lq, Lt, B, SEED + 30 + 2 * k)
    torch.cuda.empty_cache()
    return rec


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


def phase1_prefilter(dev):
    """K4 and K5 against their plain versions on the card, over the
    resident layout at the path's shape (B_PF long-tail sequences,
    Lq = LQ_PF) and through the public wrappers at edge shapes; returns
    the per-kernel records (without launch counts)."""
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
             (24, 4, 50), OPS_K5, "hhsuite_tpu/ops/prefilter_pallas2.py:37")):
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
                ("K5", P.gapped_scores, P.gapped_scores_plain, (24, 4, 50))):
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


def phase3_card_vs_cpu(work, tag, base, query, counters, cap, sweep):
    """hhsearch -Z/-B/-realign_max ``cap`` through the CLI on the card
    (the funnel on: ``sweep``, the sweep kernel, must launch) and on the
    CPU: the .hhr files must agree apart from Date/Command."""
    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.cli import main as cli_main
    from hhsuite_tpu_torch.device import DEVICE_ENV

    args = ["hhsearch", "-i", query, "-d", base, "-Z", cap, "-B", cap,
            "-realign_max", cap]
    out = {k: os.path.join(work, f"p3_{tag.split()[0]}_{k}.hhr")
           for k in ("card", "cpu")}
    timers = profiling.enable_stage_timers()
    reset(counters)
    t0 = time.perf_counter()
    try:
        if cli_main(args + ["-o", out["card"]]) != 0:
            raise AssertionError(f"phase3 {tag}: card run failed")
    finally:
        profiling.disable_stage_timers()
    t_card = time.perf_counter() - t0
    n = read(counters)
    funnel = (int(timers.get("funnel_blocks", 0)),
              int(timers.get("funnel_dropped", 0)))
    if n[sweep] == 0:
        raise AssertionError(f"phase3 {tag}: the funnel did not run ({n})")
    os.environ[DEVICE_ENV] = "cpu"
    try:
        t0 = time.perf_counter()
        if cli_main(args + ["-o", out["cpu"]]) != 0:
            raise AssertionError(f"phase3 {tag}: CPU run failed")
        t_cpu = time.perf_counter() - t0
    finally:
        os.environ.pop(DEVICE_ENV, None)
    a, b = _hhr_body(out["card"]), _hhr_body(out["cpu"])
    if a != b:
        diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
        raise AssertionError(f"phase3 {tag}: card and CPU .hhr differ: "
                             f"{diff}")
    log(f"phase3 {tag}: card (funnel blocks {funnel[0]}, switched off "
        f"{funnel[1]}; launches {n}) {t_card:.2f} s, CPU (plain versions) "
        f"{t_cpu:.2f} s, .hhr identical ({len(a)} lines)")


def phase3_hhblits(work, base, query, counters):
    """hhblits -n 2 through the CLI on the card and on the CPU: .hhr and
    -oa3m identical; K4 and K5 launched on the card run."""
    from hhsuite_tpu_torch.cli import main as cli_main
    from hhsuite_tpu_torch.device import DEVICE_ENV

    def run(tag):
        t0 = time.perf_counter()
        rc = cli_main(["hhblits", "-i", query, "-d", base, "-n", "2",
                       "-o", os.path.join(work, f"p3b_{tag}.hhr"),
                       "-oa3m", os.path.join(work, f"p3b_{tag}.a3m")])
        if rc != 0:
            raise AssertionError(f"phase3: hhblits {tag} run exit {rc}")
        return time.perf_counter() - t0

    reset(counters)
    t_card = run("card")
    n = read(counters)
    if n["K4"] == 0 or n["K5"] == 0:
        raise AssertionError(f"phase3: the prefilter kernels did not run "
                             f"({n})")
    os.environ[DEVICE_ENV] = "cpu"
    try:
        t_cpu = run("cpu")
    finally:
        os.environ.pop(DEVICE_ENV, None)
    a = _hhr_body(os.path.join(work, "p3b_card.hhr"))
    b = _hhr_body(os.path.join(work, "p3b_cpu.hhr"))
    if a != b:
        diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
        raise AssertionError(f"phase3: hhblits card and CPU .hhr differ: "
                             f"{diff}")
    with open(os.path.join(work, "p3b_card.a3m")) as f:
        a3m = f.read()
    with open(os.path.join(work, "p3b_cpu.a3m")) as f:
        if a3m != f.read():
            raise AssertionError("phase3: hhblits card and CPU -oa3m differ")
    log(f"phase3 hhblits -n 2, {N_FAMILY_SMALL} templates + "
        f"{N_DECOYS_SMALL} decoys: card "
        f"(launches {n}) {t_card:.2f} s, CPU (plain versions) {t_cpu:.2f} s, "
        f".hhr identical ({len(a)} lines), -oa3m identical "
        f"({a3m.count(chr(62))} sequences)")


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
            f"{'device' if engine._use_device_realign(par, hits) else 'host'}")
        log("phase4 " + tag + " stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        if any(n[k] == 0 for k in ("K1", "K2", "K3")):
            raise AssertionError(f"phase4: a kernel of the path was not "
                                 f"launched: {n}")
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
    profile_query("phase4", lambda: engine.run_hhsearch(
        Parameters.hhsearch_defaults(), query_text, db, "bench_query"),
        set(timers))
    return n


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
            prev_n, prev_t = r["launches"], r["stages"]
        log(f"phase5 {tag} stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        if any(n[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5")):
            raise AssertionError(f"phase5: a kernel of the path was not "
                                 f"launched: {n}")
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
    profile_query("phase5", lambda: run_hhblits(
        Parameters.hhblits_defaults(), query_text, db, "bench_query"),
        set(timers))
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
        if q.nss_pred < 0:
            raise AssertionError("phase6: the query carries no SS")
        if n["K6"] == 0 or n["K3"] == 0:
            raise AssertionError(f"phase6: K6 and K3 must launch: {n}")
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
        set(timers))
    k3 = [v for name, v in by_name.items() if "vit_bt_kernel" in name]
    log(f"phase6 K3 device time: {sum(us for us, _n in k3) / 1e3:.2f} ms "
        f"over {sum(n for _us, n in k3)} launches (profiled warm query)")
    return n


def profile_query(tag, run, spans):
    """One more warm query under torch.profiler: device time by kernel
    (device activities only; the ``spans`` annotation ranges are left
    out) and the device's busy share of the profiled wall time.  Returns
    {kernel name: (microseconds, launches)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.name in spans
                or getattr(e, "is_user_annotation", False)):
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _n in by_name.values()) / 1e6
    log(f"{tag} profiled: {wall:.3f} s wall (profiler on), device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{sum(n for _us, n in by_name.values())} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        log(f"{tag} device: {us / 1e3:10.2f} ms {n:7d} x {name[:70]}")
    return by_name


# --------------------------------------------------------- counters ----

def kernel_counters():
    from hhsuite_tpu_torch.ops.prefilter import gapped_scores, ungapped_scores
    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        viterbi_backtrace_lanes, viterbi_score_lanes,
        viterbi_score_lanes_fused)
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    return {"K1": viterbi_score_lanes_fused, "K2": viterbi_backtrace_lanes,
            "K3": viterbi_batch_rows, "K4": ungapped_scores,
            "K5": gapped_scores, "K6": viterbi_score_lanes}


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


# ------------------------------------------------------------- main ----

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
    t_db = time.perf_counter()
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

        # ---- phase 0: builds ----
        from concurrent.futures import ThreadPoolExecutor

        from hhsuite_tpu_torch import native
        from hhsuite_tpu_torch.device import cuda_library, resolve_device

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as ex:
            f_cu = {name: ex.submit(cuda_library, name)
                    for name in ("viterbi", "prefilter")}
            f_nat = ex.submit(native.require)
            infos = {name: f.result()[1] for name, f in f_cu.items()}
            f_nat.result()
        log(f"phase0 build: {time.perf_counter() - t0:.1f} s (nvcc "
            + ", ".join(f"{n}.cu {i.seconds:.1f} s cached={i.cached}"
                        for n, i in infos.items())
            + "); native host library loaded")
        for name, info in infos.items():
            for ln in info.log.splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    log(f"phase0 ptxas {name}: " + ln.strip())
        bt_usage = bt_instantiations(ptxas_usage(infos["viterbi"].log))
        for key, (regs, st, ld) in bt_usage.items():
            log(f"phase0 vit_bt_kernel{key} (co, ss, local): {regs} "
                f"registers, {st} bytes spill stores, {ld} bytes spill "
                "loads")
        if len(bt_usage) != 8:
            raise AssertionError(f"phase0: ptxas reported {len(bt_usage)} "
                                 "vit_bt_kernel instantiations, not 8")
        dev = resolve_device("cuda")

        recs = phase1_kernels(dev, bt_usage)
        recs["K6"] = phase1_k6(dev)
        recs.update(phase1_prefilter(dev))
        log("phase1 ok")
        phase2_golden(work)
        phase2_golden_ss(work)
        log("phase2 ok")

        out, _ = db_proc.communicate(timeout=900)
        if db_proc.returncode != 0:
            raise AssertionError(f"database build failed:\n{out}")
        for ln in out.splitlines():
            log("database build: " + ln)
        log(f"databases ready after {time.perf_counter() - t_db:.1f} s")
        counters = kernel_counters()
        phase3_card_vs_cpu(work, "512 templates", base512,
                           base512 + ".query.a3m", counters, "100", "K1")
        phase3_card_vs_cpu(work, f"{N_FAMILY_SMALL} SS templates",
                           base_ss_small, base_ss_small + ".query.a3m",
                           counters, "30", "K6")
        phase3_hhblits(work, base_small_d, base_small + ".query.a3m",
                       counters)
        log("phase3 ok")
        with open(base8k + ".query.a3m") as f:
            q8k = f.read()
        launches = phase4_full(base8k, q8k, counters)
        log("phase4 ok")
        launches_blits = phase5_hhblits(base_big, q8k, counters, dev)
        log("phase5 ok")
        with open(base_ss8k + ".query.a3m") as f:
            launches_ss = phase6_ss(base_ss8k, f.read(), counters)
        log("phase6 ok")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if db_proc.poll() is None:
            db_proc.kill()
            db_proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    # launches: K1-K3 on the hhsearch path (phase 4), K4/K5 on the
    # hhblits path (phase 5), K6 on the SS hhsearch path (phase 6); each
    # also with its hhblits and SS counts
    main_path = {"K1": launches, "K2": launches, "K3": launches,
                 "K4": launches_blits, "K5": launches_blits,
                 "K6": launches_ss}
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6"):
        r = dict(recs[key])
        r["launches"] = main_path[key][key]
        r["launches_hhblits"] = launches_blits[key]
        r["launches_ss"] = launches_ss[key]
        kernels.append(r)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
