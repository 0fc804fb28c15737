"""What a row of the block-scan Forward kernel (R1 as the first port
wrote it: one ``fb_forward_kernel`` with its row arrays in shared
memory, template operands read from global memory per cell, a
Kogge-Stone scan and a pairwise tree over the block, 20 block barriers a
row) costs: that kernel timed as it is and in variants that each take
one cost away, at the realign path's chunk (B = 256 hits, Lq = 300, Wj
= 385, SS off, local).

Variants (text edits of the given source, built by
:mod:`.ablation` into ``build/ablation/<variant>/``; the repository's
sources are not touched):

* ``base``: the source as it is;
* ``tmpl_smem``: the template's profile and transition columns staged
  once per hit in shared memory and read from there;
* ``merged_bar``: the row sum and max tree run in the Kogge-Stone scan's
  barrier phases (18 barriers a row become 9; the same association);
* ``no_global``: every per-cell global read (template profile and
  transitions, the cell-off byte) replaced by a constant (wrong numbers,
  timing only);
* ``no_global_merged``: both of the last two.

Needs a CUDA card and ``nvcc``; run it on a ``csrc/posterior.cu`` of
that design (before the kernels kept their rows in registers), e.g. a
``git archive`` of such a commit::

    python -m hhsuite_tpu_torch.tools.realign_ablation \\
        --src <tree>/hhsuite_tpu_torch/csrc/posterior.cu

Prints one line a variant (ms a launch, CUDA events over ``--reps``
launches after one warm-up; ptxas registers and spills) and, as the last
line, one JSON object ``{"card": ..., "variants": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np

from .ablation import build, card_line, edit, ptxas, timed

T = 128

# the block-scan R1's row loop: the chain scan, its carry, the tree
_SCAN_AND_TREE = """    float cg, ci;
    ks_lin2<false>(pg, yg, pi, yi, ks, cg, ci);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      GDa[j] = GDa[j] + PG[j] * cg;
      IMa[j] = IMa[j] + PI[j] * ci;
    }
    tree_sum_max(lsum, lmax, red);
"""

_MERGED = """    float cg, ci;
    ks_lin2_tree(pg, yg, pi, yi, ks, cg, ci, lsum, lmax, red);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      GDa[j] = GDa[j] + PG[j] * cg;
      IMa[j] = IMa[j] + PI[j] * ci;
    }
"""

# ks_lin2 and tree_sum_max in one set of barrier phases
_MERGED_FN = """
__device__ void ks_lin2_tree(float a0, float u0, float a1, float u1,
                             float* buf, float& c0, float& c1, float& sum,
                             float& m, float* red) {
  const int t = threadIdx.x;
  float* in = buf;
  float* out = buf + 4 * T;
  in[t] = a0;
  in[T + t] = u0;
  in[2 * T + t] = a1;
  in[3 * T + t] = u1;
  red[t] = sum;
  red[T + t] = m;
  __syncthreads();
  int h = T / 2;
  for (int d = 1; d < T; d <<= 1, h >>= 1) {
    const int s = t - d;
    float A0 = in[t], U0 = in[T + t], A1 = in[2 * T + t], U1 = in[3 * T + t];
    if (s >= 0) {
      U0 = U0 + A0 * in[T + s];
      A0 = in[s] * A0;
      U1 = U1 + A1 * in[3 * T + s];
      A1 = in[2 * T + s] * A1;
    }
    out[t] = A0;
    out[T + t] = U0;
    out[2 * T + t] = A1;
    out[3 * T + t] = U1;
    if (t < h) {
      red[t] = red[t] + red[t + h];
      red[T + t] = mx(red[T + t], red[T + t + h]);
    }
    float* tmp = in;
    in = out;
    out = tmp;
    __syncthreads();
  }
  c0 = t > 0 ? in[T + t - 1] : 0.0f;
  c1 = t > 0 ? in[3 * T + t - 1] : 0.0f;
  sum = red[0];
  m = red[T];
  __syncthreads();
}
"""

_TMPL_R1 = """  const Tmpl tm{tp + (long long)b * (Wj + 1) * 20,
                ttr + (long long)b * (Wj + 1) * 7, Wj};
  const uint8_t* cob = co + b * plane;
  const float* ssb = ssf ? ssf + b * plane : nullptr;
  float* fw = fwd + b * plane;"""

_TMPL_R1_SMEM = """  float* tps = smem + (scratch ? 0 : 7 * W);
  float* ttrs = tps + (Wj + 1) * 20;
  for (int e = t; e < (Wj + 1) * 20; e += T)
    tps[e] = tp[(long long)b * (Wj + 1) * 20 + e];
  for (int e = t; e < (Wj + 1) * 7; e += T)
    ttrs[e] = ttr[(long long)b * (Wj + 1) * 7 + e];
  __syncthreads();
  const Tmpl tm{tps, ttrs, Wj};
  const uint8_t* cob = co + b * plane;
  const float* ssb = ssf ? ssf + b * plane : nullptr;
  float* fw = fwd + b * plane;"""

_TMPL_FNS = """  __device__ __forceinline__ float t(int j, int k) const {
    return (j >= 0 && j < Wj) ? tr[j * 7 + k] : 0.0f;
  }
  __device__ __forceinline__ float pf(const float* qrow, int j) const {
    return j < Wj ? dot20(qrow, p + j * 20) : 0.0f;
  }"""

_TMPL_FNS_CONST = """  __device__ __forceinline__ float t(int j, int k) const {
    return (j >= 0 && j < Wj) ? 0.125f + 0.0625f * (float)k : 0.0f;
  }
  __device__ __forceinline__ float pf(const float*, int j) const {
    return j < Wj ? 1.0f + 0.001f * (float)j : 0.0f;
  }"""

_OKF = "  return (j >= 1 && j < Wj && !co_row[j]) ? 1.0f : 0.0f;"
_OKF_CONST = "  return (j >= 1 && j < Wj) ? 1.0f : 0.0f;"


def variants(src: str) -> dict:
    """{variant: its source}."""
    merged = edit(edit(src, _SCAN_AND_TREE, _MERGED),
                  "// The row arrays of hit b", _MERGED_FN
                  + "\n// The row arrays of hit b")
    no_global = edit(edit(src, _TMPL_FNS, _TMPL_FNS_CONST), _OKF,
                     _OKF_CONST)
    return {"base": src,
            "tmpl_smem": edit(src, _TMPL_R1, _TMPL_R1_SMEM),
            "merged_bar": merged,
            "no_global": no_global,
            "no_global_merged": edit(edit(merged, _TMPL_FNS,
                                          _TMPL_FNS_CONST), _OKF,
                                     _OKF_CONST)}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="a csrc/posterior.cu of the block-scan design")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("realign_ablation: no CUDA card", file=sys.stderr)
        return 2
    with open(args.src) as f:
        infos = build({name: ("posterior", src)
                       for name, src in variants(f.read()).items()})

    B, Lq, Wj = 256, 300, 385
    c = -(-Wj // T)
    W = T * c
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def trans(n):
        t = rng.dirichlet([6.0, 1, 1], n)
        g = rng.dirichlet([3.0, 1], (n, 2))
        return np.stack([t[:, 0], t[:, 1], t[:, 2], g[:, 0, 0], g[:, 0, 1],
                         g[:, 1, 0], g[:, 1, 1]], axis=-1).astype(np.float32)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    qp = up(rng.dirichlet(np.full(20, 0.4), Lq + 2).astype(np.float32))
    qtr = up(trans(Lq + 2))
    tp = up(rng.dirichlet(np.full(20, 0.4), (B, Wj + 1)).astype(np.float32)
            / 0.05)
    ttr = up(trans(B * (Wj + 1)).reshape(B, Wj + 1, 7))
    co = torch.zeros((B, Lq + 1, Wj), dtype=torch.bool, device=dev)
    fwd = torch.empty((B, Lq + 1, Wj), dtype=torch.float32, device=dev)
    scales = torch.empty((B, Lq + 2), dtype=torch.float32, device=dev)
    pfwd = torch.empty(B, dtype=torch.float32, device=dev)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    cs = float(np.exp2(np.float32(-0.03)))
    out = {}
    for name, info in infos.items():
        lib = ctypes.CDLL(info.path)
        lib.hh_post_forward.argtypes = [P, P, P, P, P, P, P, P, I, I, I, Fl,
                                        I, P, I, P, P, P, P]
        lib.hh_post_forward.restype = I
        smem = 4 * 7 * W + (4 * (Wj + 1) * 27 if name == "tmpl_smem" else 0)

        def launch():
            rc = lib.hh_post_forward(
                qp.data_ptr(), qtr.data_ptr(), tp.data_ptr(), ttr.data_ptr(),
                co.data_ptr(), None, None, None, B, Lq, Wj, cs, 1, None,
                smem, fwd.data_ptr(), scales.data_ptr(), pfwd.data_ptr(),
                stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        ms = timed(launch, args.reps)
        out[name] = dict(ms=ms, us_a_row=ms * 1e3 / (Lq - 1),
                         ptxas=ptxas(info.log, "fb_forward_kernel"))
        print(f"realign_ablation {name}: R1 {ms:.3f} ms a launch, "
              f"{ms * 1e3 / (Lq - 1):.2f} us a row; {out[name]['ptxas']}",
              flush=True)
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "B": B, "Lq": Lq, "Wj": Wj,
                      "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
