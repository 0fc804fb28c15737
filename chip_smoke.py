#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hhsuite_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit
and no result line:

0. setup: the card's name and power limit, the torch version, the build
   of the CUDA kernels (``hhsuite_tpu_torch/csrc/viterbi.cu``) and of the
   native host library, and (in a background process) the two benchmark
   databases under ``chip_smoke_cache/``;
1. each Viterbi kernel (K1 fast and exact, K2, K3) against its plain
   PyTorch version on the card at the search path's shapes: results
   must be bit-identical; times from CUDA events;
2. ``hhsearch`` through the CLI entry on the golden single-entry
   database: ``-blasttab`` must equal tests/fixtures/golden_hhsearch.blasttab
   byte for byte;
3. the 512-template benchmark database searched on the card with the
   funnel on (``-Z 100 -B 100 -realign_max 100``) and on the CPU with
   the plain versions: the two ``.hhr`` files must agree apart from
   their Date/Command lines;
4. the 8192-template long-tail database with default parameters, cold
   and warm: wall and host-stage times, hit counts and the kernels'
   launch counts on that run (each must be > 0).

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

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "chip_smoke_cache")
FIX = os.path.join(REPO, "tests", "fixtures")

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per DP cell, counted in csrc/viterbi.cu: the 20-term
# dot (20 mul + 19 add), the log2 (fast quartic 12, exact cubic 10) and
# the recurrence (K1 28; K2/K3 45 incl. the backtrace-bit compares,
# K3 +5 with a cell-off mask, +1 with SS)
OPS_DOT = 39
OPS_K1 = {"fast": OPS_DOT + 12 + 28, "exact": OPS_DOT + 10 + 28}
OPS_BT = OPS_DOT + 10 + 45

LQ, LT = 320, 384
B_K1, B_K2, B_K3, B_SMALL = 8192, 4096, 1024, 64
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
    import numpy as np

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
    import numpy as np
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


def bound_ms(ops: float, nbytes: float):
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


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

def phase1_kernels(dev):
    """Kernel vs plain version at the path shapes; returns the per-kernel
    records (without launch counts)."""
    import torch

    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        viterbi_backtrace_lanes, viterbi_score_lanes_fused,
        viterbi_score_lanes_plain)
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
        log(f"phase1 {tag}: B={B} Lq={LQ} Lt={LT} {ms:.3f} ms "
            f"({LQ * LT * B / ms / 1e6:.1f} GCUPS, {launches} launches), "
            f"plain {plain_ms:.1f} ms, bit-identical (score, i2, j2, bt)")
        return ms, plain_ms, err, bms, bby

    # ---- K2 ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K2, SEED + 1, dev)
    ms, plain_ms, err, bms, bby = bt_check(
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
        bound_by=bby, library_ms=None)
    del qp, qtr, tp, ttr, tL

    # ---- K3: altali masks at the path's batch; global and SS cases ----
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_K3, SEED + 2, dev)
    co = exclusion_masks(LQ, LT, tL, 3, SEED + 3, dev)
    ms, plain_ms, err, bms, bby = bt_check(
        "K3 (altali masks)",
        lambda: viterbi_batch_rows(qp, qtr, tp, ttr, co, tL, shift,
                                   Lq_true=LQ),
        lambda: viterbi_batch(qp, qtr, tp, ttr, co, tL, shift, Lq_true=LQ),
        B_K3, in_bytes(qp, tp, B_K3) + B_K3 * (LQ + 1) * (LT + 1),
        OPS_BT + 5, tL, 3)
    del qp, qtr, tp, ttr, tL, co
    qp, qtr, tp, ttr, tL = synth_inputs(LQ, LT, B_SMALL, SEED + 4, dev)
    gen = torch.Generator().manual_seed(SEED)
    ss = (torch.rand((B_SMALL, LQ + 1, LT + 1), generator=gen) - 0.5).to(dev)
    for tag, local, s in (("K3 global", False, None), ("K3 SS", True, ss)):
        _ms, _pms, e, _b, _bb = bt_check(
            tag,
            lambda: viterbi_batch_rows(qp, qtr, tp, ttr, None, tL, shift,
                                       ss_score=s, local=local),
            lambda: viterbi_batch(qp, qtr, tp, ttr, None, tL, shift,
                                  ss_score=s, local=local),
            B_SMALL, in_bytes(qp, tp, B_SMALL), OPS_BT, tL, 1)
        err = max(err, e)
    recs["K3"] = dict(
        name="K3 viterbi_batch_rows", route="cuda",
        source="hhsuite_tpu_torch/csrc/viterbi.cu",
        replaces="hhsuite_tpu/ops/viterbi_rows.py:59",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=None)
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


def _hhr_body(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("Date", "Command"))]


def phase3_card_vs_cpu(work, base, query, counters):
    from hhsuite_tpu_torch.cli import main as cli_main
    from hhsuite_tpu_torch.device import DEVICE_ENV

    args = ["hhsearch", "-i", query, "-d", base, "-Z", "100", "-B", "100",
            "-realign_max", "100"]
    reset(counters)
    t0 = time.perf_counter()
    if cli_main(args + ["-o", os.path.join(work, "p3_card.hhr")]) != 0:
        raise AssertionError("phase3: card run failed")
    t_card = time.perf_counter() - t0
    n = read(counters)
    if n["K1"] == 0:
        raise AssertionError(f"phase3: the funnel did not run ({n})")
    os.environ[DEVICE_ENV] = "cpu"
    try:
        t0 = time.perf_counter()
        if cli_main(args + ["-o", os.path.join(work, "p3_cpu.hhr")]) != 0:
            raise AssertionError("phase3: CPU run failed")
        t_cpu = time.perf_counter() - t0
    finally:
        os.environ.pop(DEVICE_ENV, None)
    a = _hhr_body(os.path.join(work, "p3_card.hhr"))
    b = _hhr_body(os.path.join(work, "p3_cpu.hhr"))
    if a != b:
        diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
        raise AssertionError(f"phase3: card and CPU .hhr differ: {diff}")
    log(f"phase3 512 templates: card (funnel, launches {n}) {t_card:.2f} s, "
        f"CPU (plain versions) {t_cpu:.2f} s, .hhr identical "
        f"({len(a)} lines)")


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
            f"realign: {'device' if engine._use_device_realign(par, hits) else 'host'}")
        log("phase4 " + tag + " stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(timers.items())}))
        if any(v == 0 for v in n.values()):
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
    profile_query(lambda: engine.run_hhsearch(
        Parameters.hhsearch_defaults(), query_text, db, "bench_query"),
        set(timers))
    return n


def profile_query(run, spans):
    """One more warm query under torch.profiler: device time by kernel
    (device activities only; the ``spans`` annotation ranges are left
    out) and the device's busy share of the profiled wall time."""
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
    log(f"phase4 profiled: {wall:.3f} s wall (profiler on), device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{sum(n for _us, n in by_name.values())} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        log(f"phase4 device: {us / 1e3:10.2f} ms {n:7d} x {name[:70]}")


# --------------------------------------------------------- counters ----

def kernel_counters():
    from hhsuite_tpu_torch.ops.viterbi_lanes import (
        viterbi_backtrace_lanes, viterbi_score_lanes_fused)
    from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows

    return {"K1": viterbi_score_lanes_fused, "K2": viterbi_backtrace_lanes,
            "K3": viterbi_batch_rows}


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


# ------------------------------------------------------------- main ----

DB_BUILD = """
import sys
sys.path.insert(0, {repo!r})
from hhsuite_tpu_torch.tools.benchdb import build_bench_db
for base, n, mix in ((sys.argv[1], 512, False), (sys.argv[2], 8192, True)):
    q = build_bench_db(base, n_templates=n, length_mix=mix)
    with open(base + ".query.a3m", "w") as f:
        f.write(q)
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
    t_db = time.perf_counter()
    db_proc = subprocess.Popen(
        [sys.executable, "-c", DB_BUILD.format(repo=REPO), base512, base8k],
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
        with ThreadPoolExecutor(2) as ex:
            f_cu = ex.submit(cuda_library, "viterbi")
            f_nat = ex.submit(native.require)
            _lib, info = f_cu.result()
            f_nat.result()
        log(f"phase0 build: {time.perf_counter() - t0:.1f} s (nvcc "
            f"{info.seconds:.1f} s, cached={info.cached}); native host "
            f"library loaded")
        for ln in info.log.splitlines():
            if "registers" in ln or "spill" in ln:
                log("phase0 ptxas: " + ln.strip())
        dev = resolve_device("cuda")

        recs = phase1_kernels(dev)
        log("phase1 ok")
        phase2_golden(work)
        log("phase2 ok")

        out, _ = db_proc.communicate(timeout=900)
        if db_proc.returncode != 0:
            raise AssertionError(f"database build failed:\n{out}")
        log(f"databases ready after {time.perf_counter() - t_db:.1f} s")
        counters = kernel_counters()
        phase3_card_vs_cpu(work, base512, base512 + ".query.a3m", counters)
        log("phase3 ok")
        with open(base8k + ".query.a3m") as f:
            q8k = f.read()
        launches = phase4_full(base8k, q8k, counters)
        log("phase4 ok")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if db_proc.poll() is None:
            db_proc.kill()
            db_proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for key in ("K1", "K2", "K3"):
        r = dict(recs[key])
        r["launches"] = launches[key]
        kernels.append(r)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
