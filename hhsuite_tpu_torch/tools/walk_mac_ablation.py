"""What bounds the Viterbi path walk (W1, ``bt_walk_kernel``), the MAC
DP (R3, ``mac_dp_kernel``) and the MAC walk (R4, ``mac_walk_kernel``):
each kernel timed as the sources have it and in variants that each
change one thing, at ``chip_smoke.py`` phase 1's shapes (W1 on K2's bt
at B = 4096, Lq = 320, Lt = 384, kmax = 705; R3 and R4 at the realign
chunk, B = 256, Lq = 300, Lt_pad = 384, R4's kmax 686).

Variants (text edits of the given sources, built by :mod:`.ablation`
into ``build/ablation/<variant>/``; the repository's sources are not
touched):

* W1 ``R<R>_G<G>``: the tile side ``WALK_R`` and the lanes a walk
  ``WALK_G`` set to R and G, for R in 16, 32, 64 and G in 8, 16, 32
  (not R 64 at G 8: a block's tiles pass the 48 KB of static shared
  memory); each held byte for byte against the plain walk, and shown
  with ``chip_smoke.walk_tile_model``'s bytes and sectors for its R;
  the source's own R and G timed ``--repeats`` times in a row;
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
  only);
* R4 ``R<R>_G<G>``: the tile side ``MAC_WALK_R`` set to R and, for G
  below 32, teams of G lanes a walk in place of the source's warp a
  walk (:data:`R4_SIDES`; each team walks on its own, its lanes' mask
  in ``__syncwarp``), and ``warps2`` two warps a block, each held byte
  for byte against the plain walk, with
  ``chip_smoke.mac_walk_rounds``'s longest chain for its R;
* R4 ``l2_R<R>_G<G>``: the same with every walk on lane 0's b_mac and
  p_mm planes (their squares stay in L2; the walks differ: timing
  only);
* R4 ``no_payload``: the source's R, no payload stores but the header;
  ``post_bytes``: the staged posteriors written a byte a store
  (consecutive lanes on consecutive bytes) in place of aligned words;
* R4 ``post_tiled_R<R>_G<G>`` (R = G = 32 and R = G = 16; at R = 64 a
  lane's 128 floats of a tile do not fit its registers): the path's
  posteriors read from an R x R tile of p_mm loaded beside the codes,
  in place of the gather of the staged cells (held byte for byte).

The R4 variants edit ``mac_walk_kernel`` at its ``// ablation:<name>``
marks (:func:`at_mark`), and its signature, launch and ``__syncwarp``
calls for teams (:func:`r4_teams`).

``latency``: one thread chasing a random cycle of 4-byte indices in
shared memory (4096 entries), in L2 (4 MB) and in device memory (256
MB, L1 bypassed), ns a hop; with it R4's modelled latency floor: its
longest chain's steps at a shared-memory hop and its round trips at a
device-memory (and an L2) hop.

Needs a CUDA card and ``nvcc``.  Run from the repository's root::

    python -m hhsuite_tpu_torch.tools.walk_mac_ablation \\
        [--viterbi <tree>/hhsuite_tpu_torch/csrc/viterbi.cu] \\
        [--posterior <tree>/hhsuite_tpu_torch/csrc/posterior.cu] \\
        [--only W1_R16_G16,R4_,latency]

``--only`` keeps the variants whose names start with one of its
prefixes.  Prints one line a variant (ms a launch,
CUDA events over ``--reps`` launches after one warm-up; ptxas registers
and spills) and, as the last line, one JSON object ``{"card": ...,
"W1": {...}, "R3": {...}, "R4": {...}, "latency": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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

# (R, G) of the R4 builds
R4_SIDES = ((16, 16), (32, 8), (32, 16), (32, 32), (64, 16), (64, 32))

# the latency probe: one thread chases a cycle of indices
LATENCY_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const unsigned* __restrict__ next, unsigned p,
                      int hops, int smem, unsigned* out) {
  __shared__ unsigned s[4096];
  if (smem) {
    for (int e = threadIdx.x; e < 4096; e += blockDim.x) s[e] = next[e];
    __syncthreads();
    if (threadIdx.x) return;
    for (int h = 0; h < hops; ++h) p = s[p];
  } else {
    if (threadIdx.x) return;
    for (int h = 0; h < hops; ++h) p = __ldcg(next + p);
  }
  out[0] = p;
}
extern "C" int hh_chase(const unsigned* next, unsigned start, int hops,
                        int smem, unsigned* out, void* stream) {
  chase<<<1, smem ? 128 : 1, 0, (cudaStream_t)stream>>>(next, start, hops,
                                                       smem, out);
  return (int)cudaGetLastError();
}
"""


def at_mark(src: str, name: str, new) -> str:
    """``src`` with the code that the mark ``// ablation:<name>`` names
    replaced by ``new`` (a string, or a function of the code): the line
    the mark ends, or the lines between the mark, alone on its line, and
    the next ``// ablation:end``; ValueError when the mark is not there
    exactly once."""
    lines = src.split("\n")
    hits = [k for k, ln in enumerate(lines)
            if re.search(rf"// ablation:{name}$", ln)]
    if len(hits) != 1:
        raise ValueError(f"not the source this variant edits: the mark "
                         f"ablation:{name} is not there once")
    k = hits[0]
    if lines[k].strip() == f"// ablation:{name}":
        e = next(m for m in range(k + 1, len(lines))
                 if lines[m].strip() == "// ablation:end")
        old, span = "\n".join(lines[k + 1:e]), slice(k + 1, e)
    else:
        old, span = lines[k], slice(k, k + 1)
    lines[span] = [new(old) if callable(new) else new]
    return "\n".join(lines)


def in_kernel(src: str, kernel: str, old: str, new: str) -> str:
    """``src`` with every ``old`` in the body of ``kernel`` (from its
    name to the first line that is ``}``) replaced by ``new``."""
    a = src.index(f" {kernel}(")
    b = src.index("\n}\n", a)
    if old not in src[a:b]:
        raise ValueError(f"not the source this variant edits: {old!r} is "
                         f"not in {kernel}")
    return src[:a] + src[a:b].replace(old, new) + src[b:]


def r4_sides(posterior: str, R: int) -> str:
    """R4 with the tile side ``MAC_WALK_R`` set to R."""
    return re.sub(r"constexpr int MAC_WALK_R = \d+;",
                  f"constexpr int MAC_WALK_R = {R};", posterior, count=1)


def r4_teams(posterior: str, G: int, warps: int = 1) -> str:
    """R4 with a team of G lanes a walk, ``warps`` warps a block: each
    team walks on its own (its lanes' mask in ``__syncwarp``), a team
    past the batch returns."""
    nt = warps * 32 // G
    s = at_mark(posterior, "lanes",
                f"  constexpr int R = MAC_WALK_R, G = {G}, NT = {nt};")
    s = at_mark(s, "walker", """\
  __shared__ uint32_t tiles[NT][R * NW];
  __shared__ uint8_t st_code[NT][S];
  __shared__ int st_off[NT][S];
  __shared__ float st_post[NT][S];
  const int tl = threadIdx.x % G, team = threadIdx.x / G;
  const int b = blockIdx.x * NT + team;
  if (b >= B) return;
  const unsigned tmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  uint32_t* tw = tiles[team];
  uint8_t* code_s = st_code[team];
  int* off_s = st_off[team];
  float* post_s = st_post[team];""")
    s = in_kernel(s, "mac_walk_kernel", "__syncwarp()", "__syncwarp(tmask)")
    s = in_kernel(s, "mac_walk_kernel", "int Lq, int Wj, int kmax",
                  "int B, int Lq, int Wj, int kmax")
    s = edit(s, "__launch_bounds__(32) mac_walk_kernel(",
             f"__launch_bounds__({32 * warps}) mac_walk_kernel(")
    s, n = re.subn(r"mac_walk_kernel<<<B, 32, (.*?)score, Lq,",
                   rf"mac_walk_kernel<<<(B + {nt - 1}) / {nt}, {32 * warps},"
                   r" \1score, B, Lq,", s, flags=re.S)
    if n != 1:
        raise ValueError("not the source this variant edits: R4's launch")
    return s


def r4_build(posterior: str, R: int, G: int, warps: int = 1) -> str:
    s = r4_sides(posterior, R)
    return s if (G, warps) == (32, 1) else r4_teams(s, G, warps)


def r4_post_tiled(posterior: str, R: int, G: int) -> str:
    """R4 with the path's posteriors from an R x R tile of p_mm loaded
    with the codes, each step's read from it during the walk, no
    gather."""
    s = r4_teams(r4_sides(posterior, R), G)
    s = at_mark(s, "gather", "    float pf[RL][R];")
    s = at_mark(s, "row", lambda ln: ln + """
#pragma unroll
        for (int c = 0; c < R; ++c)
          pf[r][c] = pb[(ilo + a) * Wj + jlo + min(c, nc - 1)];""")
    s = at_mark(s, "post_store", """\
    if (need) {
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int a = tl + G * r;
        if (R % G != 0 && a >= R) break;
#pragma unroll
        for (int c = 0; c < R; ++c) pt[a * R + c] = pf[r][c];
      }
    }""")
    s = edit(s, "  float* post_s = st_post[team];",
             "  float* post_s = st_post[team];\n"
             "  __shared__ float ptiles[NT][R * R];\n"
             "  float* pt = ptiles[team];")
    return at_mark(s, "record", lambda ln: ln + "\n        post_s[k - k0] = "
                   "pt[(i - ilo) * R + (j - jlo)];")


def variants(viterbi: str, posterior: str) -> dict:
    """{variant: (library name, source)}."""
    import chip_smoke as C

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
    for R, G in R4_SIDES:
        s = r4_build(posterior, R, G)
        out[f"R4_R{R}_G{G}"] = ("posterior", s)
        out[f"R4_l2_R{R}_G{G}"] = ("posterior", in_kernel(
            s, "mac_walk_kernel", "(long long)b * plane", "0"))
    R = C.mac_walk_side(posterior)
    out["R4_warps2"] = ("posterior", r4_build(posterior, R, 32, 2))
    out["R4_no_payload"] = ("posterior", at_mark(at_mark(at_mark(
        posterior, "codes", ""), "posts", ""), "tail", ""))
    out["R4_post_bytes"] = ("posterior", at_mark(posterior, "posts", """\
    for (int e = tl; e < 4 * ns; e += G)
      pd[e] = reinterpret_cast<const uint8_t*>(post_s)[e];"""))
    for R, G in ((32, 32), (16, 16)):
        out[f"R4_post_tiled_R{R}_G{G}"] = ("posterior",
                                            r4_post_tiled(posterior, R, G))
    out["latency"] = ("latency", LATENCY_SRC)
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
    ap.add_argument("--repeats", type=int, default=5,
                    help="timings of the source's own W1 in a row")
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the variants to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_mac_ablation: no CUDA card", file=sys.stderr)
        return 2
    with open(args.viterbi) as f:
        vit = f.read()
    with open(args.posterior) as f:
        post = f.read()
    todo = variants(vit, post)
    if args.only:
        keep = tuple(args.only.split(","))
        todo = {k: v for k, v in todo.items() if k.startswith(keep)}
    infos = build(todo)
    dev = torch.device("cuda")
    out = {"W1": {}, "R3": {}, "R4": {}, "latency": {}}
    # the source's own W1 side and width (timed --repeats times)
    w1_own = "W1_R%s_G%s" % tuple(
        re.search(rf"constexpr int {k} = (\d+);", vit).group(1)
        for k in ("WALK_R", "WALK_G"))
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
            if name == w1_own and sb:
                again = [timed(lambda: launch(sb), args.reps)
                         for _ in range(args.repeats)]
                out["W1"][label]["repeats_ms"] = again
                print(f"walk_mac_ablation W1 {label} (as built) timed "
                      f"again: " + ", ".join(f"{t:.4f}" for t in again)
                      + " ms", flush=True)
            extra = (f"; tiles (model): {rec['tile_bytes_model'] / steps:.1f}"
                     f" bytes, {32 * rec['tile_sectors_model'] / steps:.1f}"
                     " bytes of sectors a step" if rec else "")
            print(f"walk_mac_ablation W1 {label}: {ms:.4f} ms a launch; "
                  f"{ptx}{extra}", flush=True)
    del sc, i2, j2, bt, pay, want
    # ---- R3 and R4 at the realign chunk ----
    x = C.realign_inputs(C.LQ_RE, C.LT_RE, C.B_RE, 3, False, C.SEED + 40,
                         dev, extras="pad")
    cs = float(np.exp2(np.float32(C.REALIGN_SHIFT)))
    a = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
    fwd, scales, pfwd = PB.fb_forward(*a, local=True, t_L=x["t_L"])
    pmm = PB.fb_backward(*a, fwd, scales, pfwd, local=True, t_L=x["t_L"])
    del fwd
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
    out["latency"] = latency(infos, dev, stream)
    walk_r4(infos, post, x, pmm, scales, pfwd, dev, stream, args.reps, out)
    card = card_line()
    print(card)
    print(json.dumps({"card": card, **out}))
    return 0


def latency(infos, dev, stream) -> dict:
    """ns a hop of one thread's dependent loads (``LATENCY_SRC``) in
    shared memory, in L2 and in device memory; {} without the probe."""
    import torch

    if "latency" not in infos:
        return {}
    lib = ctypes.CDLL(infos["latency"].path)
    P = ctypes.c_void_p
    lib.hh_chase.argtypes = [P, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                             P, P]
    rng = np.random.default_rng(1)
    res = torch.empty(1, dtype=torch.int32, device=dev)
    out = {}
    for label, n, hops, smem in (("shared", 4096, 200000, 1),
                                 ("L2", 1 << 20, 20000, 0),
                                 ("device", 1 << 26, 20000, 0)):
        order = rng.permutation(n)      # one cycle through every entry
        nxt = np.empty(n, np.uint32)
        nxt[order] = np.roll(order, -1)
        t = torch.from_numpy(nxt.view(np.int32)).to(dev)

        starts = iter(rng.integers(0, n, 8).tolist())

        def run():
            # each run from another entry: hops the runs before did not
            # bring into L2
            rc = lib.hh_chase(t.data_ptr(), next(starts), hops, smem,
                              res.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"latency probe: launch failed ({rc})")
        out[label] = timed(run, 2) * 1e6 / hops
        print(f"walk_mac_ablation latency {label} ({4 * n} bytes): "
              f"{out[label]:.2f} ns a hop", flush=True)
        del t
    return out


def walk_r4(infos, posterior, x, pmm, scales, pfwd, dev, stream, reps,
            out) -> None:
    """R4's variants at the realign chunk: each that keeps the walk held
    byte for byte against the plain walk, with its modelled latency
    floor from ``out["latency"]``."""
    import torch

    import chip_smoke as C
    from ..ops import posterior_batch as PB

    if not any(k.startswith("R4_") for k in infos):
        return
    bmac, i2, j2 = PB.mac_dp(pmm, x["co"], C.REALIGN_MACT, True, x["t_L"])
    B, Li, Wj = pmm.shape
    kmax = x["kmax"]
    score = torch.from_numpy(PB.forward_score(scales, pfwd, Li - 1, Wj - 1,
                                              True)).to(dev)
    want = PB.mac_walk_packed8_plain(bmac, pmm, i2, j2, score, kmax)
    pay = torch.empty_like(want)
    lat = out["latency"]
    for name, info in infos.items():
        if not name.startswith("R4_"):
            continue
        lib = PB.bind(ctypes.CDLL(info.path))

        def launch():
            rc = lib.hh_post_walk(bmac.data_ptr(), pmm.data_ptr(),
                                  i2.data_ptr(), j2.data_ptr(),
                                  score.data_ptr(), B, Li - 1, Wj, kmax,
                                  pay.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"R4 {name}: launch failed ({rc})")
        rec = dict(ptxas=ptxas(info.log, "mac_walk_kernel"))
        launch()
        torch.cuda.synchronize()
        if "l2" not in name and "no_payload" not in name:
            if not torch.equal(pay, want):
                raise AssertionError(f"R4 {name}: the payload differs from "
                                     "the plain walk")
            m = re.search(r"_R(\d+)_G", name)
            R = int(m.group(1)) if m else C.mac_walk_side(posterior)
            steps, rounds = C.mac_walk_rounds(want, kmax, R)
            rec.update(R=R, chain_steps=int(steps.max()),
                       chain_rounds=int(rounds.max()))
            if lat:
                rec["floor_ms"] = float(np.max(
                    steps * lat["shared"] + rounds * lat["device"])) * 1e-6
                rec["floor_l2_ms"] = float(np.max(
                    steps * lat["shared"] + rounds * lat["L2"])) * 1e-6
        rec["ms"] = timed(launch, reps)
        out["R4"][name[3:]] = rec
        print(f"walk_mac_ablation R4 {name[3:]}: {rec['ms']:.4f} ms a "
              "launch; " + ", ".join(f"{k} {v}" for k, v in rec.items()
                                     if k != "ms"), flush=True)


if __name__ == "__main__":
    sys.exit(main())
