"""What bounds the Viterbi path walk (W1, ``bt_walk_kernel``) and the MAC
DP (R3, ``mac_dp_kernel``): each kernel timed as the sources have it
and in variants that each change one thing, at ``chip_smoke.py``
phase 1's shapes (W1 on K2's bt at B = 4096, Lq = 320, Lt = 384, kmax =
705; R3 at the realign chunk, B = 256, Lq = 300, Lt_pad = 384).

Variants (text edits of the given sources, built by :mod:`.ablation`
into ``build/ablation/<variant>/``; the repository's sources are not
touched):

* W1 ``R<R>_G<G>``: the tile side ``WALK_R`` and the lanes a walk
  ``WALK_G`` set to R and G, for R in 16, 32, 64 and G in 8, 16, 32
  (not R 64 at G 8: a block's tiles pass the 48 KB of static shared
  memory); each held byte for byte against the plain walk, and shown
  with ``chip_smoke.walk_tile_model``'s bytes and sectors for its R;
* W1 ``l2_bt`` (at each R and G): the same build with every walk on
  lane 0's bt (a zero lane stride: ~130 KB, resident in L2): the walks
  differ, the instruction stream does not, so the difference is what
  reading bt from device memory costs;
* W1 ``no_payload``: the source's R and G, no payload stores but the
  header (what writing the payload costs);
* R3 ``base``: the source as it is;
* R3 ``inputs_cached``: every row's p_mm and cell-off bytes fetched
  from rows 1 to 4 (cached): what the rows' input loads cost (wrong
  codes, timing only);
* R3 ``no_codes``: no b_mac stores (timing only);
* R3 ``no_scan``: the 128-aggregate scan left out (wrong values, timing
  only).

Needs a CUDA card and ``nvcc``.  Run from the repository's root::

    python -m hhsuite_tpu_torch.tools.walk_mac_ablation \\
        [--viterbi <tree>/hhsuite_tpu_torch/csrc/viterbi.cu] \\
        [--posterior <tree>/hhsuite_tpu_torch/csrc/posterior.cu]

Prints one line a variant (ms a launch, CUDA events over ``--reps``
launches after one warm-up; ptxas registers and spills) and, as the last
line, one JSON object ``{"card": ..., "W1": {...}, "R3": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

from ..device import CSRC_DIR
from .ablation import build, card_line, edit, ptxas, timed

_W1_R = "constexpr int WALK_R = 16;"
_W1_G = "constexpr int WALK_G = 16;"
_W1_PAYLOAD = ("      for (int e = tl; e < k - k0; e += G) "
               "o[12 + k0 + e] = stage[e];")
_W1_TAIL = "  for (int e = k + tl; e < kmax; e += G) o[12 + e] = 0;"
_R3_NEXT = "    fetch(i + MAC_PD);"
_R3_CODES = "      if (j < Wj) brow[j] = (uint8_t)v;"
_R3_SCAN = "    ks_maxplus_warp(Vv, Dd);"

# (R, G) of the W1 builds
W1_SIDES = ((16, 8), (32, 8), (16, 16), (32, 16), (64, 16), (16, 32),
            (32, 32), (64, 32))


def variants(viterbi: str, posterior: str) -> dict:
    """{variant: (library name, source)}."""
    out = {f"W1_R{R}_G{G}": ("viterbi", edit(edit(
        viterbi, _W1_R, f"constexpr int WALK_R = {R};"), _W1_G,
        f"constexpr int WALK_G = {G};")) for R, G in W1_SIDES}
    out["W1_no_payload"] = ("viterbi", edit(edit(viterbi, _W1_PAYLOAD, ""),
                                            _W1_TAIL, ""))
    out["R3_base"] = ("posterior", posterior)
    out["R3_inputs_cached"] = ("posterior", edit(
        posterior, _R3_NEXT, "    fetch((i - 1) % MAC_PD + 1);"))
    out["R3_no_codes"] = ("posterior", edit(posterior, _R3_CODES, ""))
    out["R3_no_scan"] = ("posterior", edit(posterior, _R3_SCAN, ""))
    return out


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    from ..ops import posterior_batch as PB
    from ..ops import viterbi as V
    from ..ops import viterbi_lanes as VL

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--viterbi", default=os.path.join(CSRC_DIR,
                                                      "viterbi.cu"))
    ap.add_argument("--posterior", default=os.path.join(CSRC_DIR,
                                                        "posterior.cu"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_mac_ablation: no CUDA card", file=sys.stderr)
        return 2
    with open(args.viterbi) as f:
        vit = f.read()
    with open(args.posterior) as f:
        post = f.read()
    infos = build(variants(vit, post))
    dev = torch.device("cuda")
    out = {"W1": {}, "R3": {}}
    # ---- W1 on K2's bt at phase 1's shape ----
    qp, qtr, tp, ttr, tL = C.synth_inputs(C.LQ, C.LT, C.B_K2, C.SEED + 1, dev)
    sc, i2, j2, bt = VL.viterbi_backtrace_lanes(qp, qtr, tp, ttr, tL, -0.03,
                                                Lq_true=C.LQ)
    del qp, qtr, tp, ttr, tL
    B, kmax = bt.shape[0], C.LQ + C.LT + 1
    want = V.backtrace_walk_packed8_plain(bt, i2, j2, sc, kmax)
    n = want[:, 8:12].cpu().numpy().copy().view(np.int32)[:, 0]
    steps = int(n.sum())
    models = {R: C.walk_tile_model(want, bt, R)
              for R in sorted({R for R, _G in W1_SIDES})}
    pay = torch.empty((B, 12 + kmax), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, info in infos.items():
        if not name.startswith("W1_"):
            continue
        lib = VL.bind(ctypes.CDLL(info.path))
        runs = [(name[3:], bt.stride()[0])]
        if name != "W1_no_payload":
            runs.append(("l2_bt " + name[3:], 0))

        def launch(sb=bt.stride()[0]):
            rc = lib.hh_vit_walk(bt.data_ptr(), sb, *bt.stride()[1:],
                                 i2.data_ptr(), j2.data_ptr(), sc.data_ptr(),
                                 B, kmax, pay.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"W1 {name}: launch failed ({rc})")

        ptx = ptxas(info.log, "bt_walk_kernel")
        rec = {}
        if name != "W1_no_payload":
            launch()
            torch.cuda.synchronize()
            if not torch.equal(pay, want):
                raise AssertionError(f"W1 {name}: the payload differs from "
                                     "the plain walk")
            R = int(name[4:].split("_")[0])
            nbytes, sectors = models[R]
            rec = dict(tile_bytes_model=nbytes, tile_sectors_model=sectors)
        for label, sb in runs:
            ms = timed(lambda: launch(sb), args.reps)
            out["W1"][label] = dict(ms=ms, ptxas=ptx, **rec)
            extra = (f"; tiles (model): {rec['tile_bytes_model'] / steps:.1f}"
                     f" bytes, {32 * rec['tile_sectors_model'] / steps:.1f}"
                     " bytes of sectors a step" if rec else "")
            print(f"walk_mac_ablation W1 {label}: {ms:.4f} ms a launch; "
                  f"{ptx}{extra}", flush=True)
    del sc, i2, j2, bt, pay, want
    # ---- R3 at the realign chunk ----
    x = C.realign_inputs(C.LQ_RE, C.LT_RE, C.B_RE, 3, False, C.SEED + 40,
                         dev, extras="pad")
    cs = float(np.exp2(np.float32(C.REALIGN_SHIFT)))
    a = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
    fwd, scales, pfwd = PB.fb_forward(*a, local=True, t_L=x["t_L"])
    pmm = PB.fb_backward(*a, fwd, scales, pfwd, local=True, t_L=x["t_L"])
    B, Li, Wj = pmm.shape
    bmac = torch.empty((B, Li, Wj), dtype=torch.uint8, device=dev)
    ij = torch.empty((2, B), dtype=torch.int32, device=dev)
    tl = x["t_L"].to(torch.int32).contiguous()
    for name, info in infos.items():
        if not name.startswith("R3_"):
            continue
        lib = PB.bind(ctypes.CDLL(info.path))

        def launch():
            rc = lib.hh_post_mac(
                pmm.data_ptr(), x["co"].data_ptr(), tl.data_ptr(), B, Li - 1,
                Wj, float(np.float32(C.REALIGN_MACT)), 1, None, 0,
                bmac.data_ptr(), ij[0].data_ptr(), ij[1].data_ptr(), stream)
            if rc:
                raise RuntimeError(f"R3 {name}: launch failed ({rc})")
        ms = timed(launch, args.reps)
        ptx = ptxas(info.log, "mac_dp_kernelILi4E")
        out["R3"][name[3:]] = dict(ms=ms, us_a_row=ms * 1e3 / (Li - 1),
                                   ptxas=ptx)
        print(f"walk_mac_ablation R3 {name[3:]}: {ms:.4f} ms a launch, "
              f"{ms * 1e3 / (Li - 1):.2f} us a row; {ptx}", flush=True)
    card = card_line()
    print(card)
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
