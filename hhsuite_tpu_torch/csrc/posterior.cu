// Hand-written Hopper (sm_90a) kernels for the batched MAC realignment.
//
// Replace the JAX package's device realign decoder, which is plain jnp
// compiled into one dispatch (hhsuite_tpu/ops/posterior_batch.py):
//   R1  fb_mac_batch's Forward rows (:139-224)
//       -> fb_forward_kernel / hh_post_forward
//   R2  fb_mac_batch's Backward rows (:226-279), fused into the
//       posterior p_mm = fwd * bwd / Pforward
//       -> fb_backward_kernel / hh_post_backward
//   R3  fb_mac_batch's MAC rows, backtrace codes and argmax (:281-351)
//       -> mac_dp_kernel / hh_post_mac
//   R4  mac_walk (:470) + mac_walk_packed8 (:418): the MAC backtrace
//       with the path posteriors, into the packed payload
//       -> mac_walk_kernel / hh_post_walk
//
// Exactness.  Every cell evaluates the f32 expressions of the plain
// PyTorch versions beside the wrappers (ops/posterior_batch.py), in the
// same order and association: the 20-term profile dot summed in order,
// max as "a > b ? a : b", the same-row chains in three steps (below),
// row sums in the same pairwise tree.  Built with -fmad=false and IEEE
// division (nvcc's default -prec-div=true), never --use_fast_math, so
// kernels and plain versions are bit-identical; exp2(shift) and the
// score's log2 are computed on the host.
//
// Design: one CTA of T = 128 threads per hit, query rows in order inside
// the kernel.  A row of Wj = Lt + 1 cells is cut into T segments of
// c = ceil(Wj / T) contiguous columns (padded to W = T * c with cells
// that are off and hold zeros).  The row arrays of a hit (R1: MM, MI,
// DG, IM, GD and the two chains' segment products; R2: the same with
// the match term; R3: S, the decay sums, the partial max and code) live
// in dynamic shared memory, or, for rows too wide for it, in a global
// scratch of the same layout (the wrapper picks).  A cell's left (R1,
// R3) or right (R2) neighbour is read across the segment edge through
// those arrays; values a row overwrites in place are taken into
// registers before a barrier.  A same-row chain (R1/R2's GD and IM
// affine recurrences y[j] = u[j] + a[j] * y[j -+ 1], R3's max-plus
// S[j] = max(m[j], S[j-1] - d[j])) runs as a sequential pass inside the
// segment, a Kogge-Stone scan over the T segment aggregates in shared
// memory (ping-pong buffers, one barrier a step) with the JAX
// package's combine rules (_lin_scan :43, _maxplus_scan :58), and the
// carry applied back into the segment.  Row sums and maxima: sequential
// in the segment, then a pairwise tree over T.  R3 keeps each thread's
// best cell (strict ">" in row-major order) and reduces them by (score
// desc, flat index asc).  R4 runs one thread per hit over at most kmax
// steps, reading b_mac with the pre-masking (column 1 and row 1 STOP)
// applied on the fly, and writes the payload bytes directly.
//
// What bounds them on the card.  R1/R2 do 39 f32 operations a cell for
// the profile dot and ~45 for the recurrences and chains (R2 computes
// the dot of the neighbour column), R3 13; every one is a separate
// instruction (no FMA; chip_smoke.py:OPS_R counts them).  B = 256 hits of Lq = 300 rows and Wj = 385
// columns are ~30 M cells a pass, ~2 G instructions against 33.5e12/s:
// tens of microseconds.  The bytes are the (B, Lq+1, Wj) matrices (the
// cell-off mask, fwd, p_mm, b_mac, the optional SS factors): ~0.1-0.3 GB
// a pass against 3.35 TB/s.  The kernels are far from either: each row
// costs ~20 block barriers and a serial segment pass, so the time is the
// latency of Lq rows of barrier-separated steps.  Making them fast
// (warp-level scans, several rows in flight, the dot shared between
// passes) is later work.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstring>

namespace {

constexpr int T = 128;
constexpr float FLUSH = FLT_MIN * 100.0f;
constexpr float DECAY_OFF = 1e30f;
enum { M2M = 0, M2I = 1, M2D = 2, I2M = 3, I2I = 4, D2M = 5, D2D = 6 };
enum { STOP = 0, MM = 2, IM = 4, MI = 6 };

__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }

// the 20-term profile dot, summed in order (the plain _profile_dot)
__device__ __forceinline__ float dot20(const float* q, const float* t) {
  float acc = q[0] * t[0];
  for (int a = 1; a < 20; ++a) acc = acc + q[a] * t[a];
  return acc;
}

// A hit's template: profile rows (Wj + 1) x 20, transitions (Wj + 1) x 7;
// column j outside [0, Wj) reads as zeros (shift_r / shift_l's fill and
// the padding columns).
struct Tmpl {
  const float* p;
  const float* tr;
  int Wj;
  __device__ __forceinline__ float t(int j, int k) const {
    return (j >= 0 && j < Wj) ? tr[j * 7 + k] : 0.0f;
  }
  __device__ __forceinline__ float pf(const float* qrow, int j) const {
    return j < Wj ? dot20(qrow, p + j * 20) : 0.0f;
  }
};

// okf: 1.0 for an open cell with j >= 1, else 0 (column 0 and padding
// closed)
__device__ __forceinline__ float okf_at(const uint8_t* co_row, int j,
                                        int Wj) {
  return (j >= 1 && j < Wj && !co_row[j]) ? 1.0f : 0.0f;
}

// Kogge-Stone inclusive scan over the T segment aggregates of two affine
// chains at once, (a, u) pairs combined as (a_x * a_y, u_y + a_y * u_x)
// with x the earlier segment (REV: the one to the right).  buf holds 8T
// floats.  Returns each chain's exclusive carry for this thread (0 for
// the first segment).
template <bool REV>
__device__ void ks_lin2(float a0, float u0, float a1, float u1, float* buf,
                        float& c0, float& c1) {
  const int t = threadIdx.x;
  float* in = buf;
  float* out = buf + 4 * T;
  in[t] = a0;
  in[T + t] = u0;
  in[2 * T + t] = a1;
  in[3 * T + t] = u1;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    const int s = REV ? t + d : t - d;
    float A0 = in[t], U0 = in[T + t], A1 = in[2 * T + t], U1 = in[3 * T + t];
    if (REV ? s < T : s >= 0) {
      U0 = U0 + A0 * in[T + s];
      A0 = in[s] * A0;
      U1 = U1 + A1 * in[3 * T + s];
      A1 = in[2 * T + s] * A1;
    }
    out[t] = A0;
    out[T + t] = U0;
    out[2 * T + t] = A1;
    out[3 * T + t] = U1;
    float* tmp = in;
    in = out;
    out = tmp;
    __syncthreads();
  }
  const int s = REV ? t + 1 : t - 1;
  const bool has = REV ? s < T : s >= 0;
  c0 = has ? in[T + s] : 0.0f;
  c1 = has ? in[3 * T + s] : 0.0f;
  __syncthreads();
}

// Kogge-Stone inclusive scan of the max-plus chain's (v, d) aggregates,
// combined as (max(v_y, v_x - d_y), d_x + d_y).  buf holds 4T floats.
// Returns the inclusive v of the segment to the left (thread 0: unused).
__device__ float ks_maxplus(float v, float dd, float* buf) {
  const int t = threadIdx.x;
  float* in = buf;
  float* out = buf + 2 * T;
  in[t] = v;
  in[T + t] = dd;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    float V = in[t], D = in[T + t];
    if (t >= d) {
      V = mx(V, in[t - d] - D);
      D = in[T + t - d] + D;
    }
    out[t] = V;
    out[T + t] = D;
    float* tmp = in;
    in = out;
    out = tmp;
    __syncthreads();
  }
  const float carry = t > 0 ? in[t - 1] : 0.0f;
  __syncthreads();
  return carry;
}

// Pairwise trees over T of a sum and a max; buf holds 2T floats.
__device__ void tree_sum_max(float& sum, float& m, float* buf) {
  const int t = threadIdx.x;
  buf[t] = sum;
  buf[T + t] = m;
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (t < h) {
      buf[t] = buf[t] + buf[t + h];
      buf[T + t] = mx(buf[T + t], buf[T + t + h]);
    }
    __syncthreads();
  }
  sum = buf[0];
  m = buf[T];
  __syncthreads();
}

// The row arrays of hit b: dynamic shared memory, or its slice of the
// global scratch.
__device__ __forceinline__ float* lane_arrays(float* smem, float* scratch,
                                              long long lane_floats) {
  return scratch ? scratch + (long long)blockIdx.x * lane_floats : smem;
}

// ------------------------------------------------------------------ R1 --
// Forward rows.  fwd (B, Lq+1, Wj); scales (B, Lq+2): 1, 1, 1, then
// scale[i+1] of rows i = 2..Lq; pfwd (B,) Pforward.
__global__ void __launch_bounds__(T) fb_forward_kernel(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ ss0, const int* __restrict__ tL, int Lq,
    int Wj, int c, float cs, int local, float* scratch,
    float* __restrict__ fwd, float* __restrict__ scales,
    float* __restrict__ pfwd_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ks[8 * T];
  __shared__ float red[2 * T];
  const int b = blockIdx.x, t = threadIdx.x;
  const int W = T * c, j0 = t * c;
  float* st = lane_arrays(smem, scratch, 7LL * W);
  float* MMa = st;
  float* MIa = st + W;
  float* DGa = st + 2 * W;
  float* IMa = st + 3 * W;
  float* GDa = st + 4 * W;
  float* PG = st + 5 * W;
  float* PI = st + 6 * W;
  const long long plane = (long long)(Lq + 1) * Wj;
  const Tmpl tm{tp + (long long)b * (Wj + 1) * 20,
                ttr + (long long)b * (Wj + 1) * 7, Wj};
  const uint8_t* cob = co + b * plane;
  const float* ssb = ssf ? ssf + b * plane : nullptr;
  float* fw = fwd + b * plane;
  float* scb = scales + (long long)b * (Lq + 2);
  const float s0 = ss0 ? ss0[b] : 1.0f;
  // global mode: the hit's last column, where rows above Lq exit
  const int lc = tL ? tL[b] : Wj - 1;
  if (t < 3) scb[t] = 1.0f;

  // row 0 and row 1: MM = PF * Cshift (no SS factor); the IM and GD
  // prefix chains without the cell-off factor
  float lsum = 0.0f;
  for (int k = 0; k < c; ++k) {
    const int j = j0 + k;
    const float mm = (tm.pf(qp + 20, j) * cs) * okf_at(cob + Wj, j, Wj);
    MMa[j] = mm;
    MIa[j] = 0.0f;
    DGa[j] = 0.0f;
    if (j < Wj) {
      fw[j] = 0.0f;
      fw[Wj + j] = mm;
    }
    lsum = k ? lsum + mm : mm;
  }
  __syncthreads();
  {
    const float qmi = qtr[7 + M2I], qii = qtr[7 + I2I];
    float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const float mL = j > 0 ? MMa[j - 1] : 0.0f;
      const float tmm = tm.t(j - 1, M2M);
      const float ui = (mL * qmi) * tmm, ai = qii * tmm;
      const float ug = mL * tm.t(j - 1, M2D), ag = tm.t(j - 1, D2D);
      yg = k ? ug + ag * yg : ug;
      pg = k ? ag * pg : ag;
      yi = k ? ui + ai * yi : ui;
      pi = k ? ai * pi : ai;
      GDa[j] = yg;
      PG[j] = pg;
      IMa[j] = yi;
      PI[j] = pi;
    }
    float cg, ci;
    ks_lin2<false>(pg, yg, pi, yi, ks, cg, ci);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      GDa[j] = GDa[j] + PG[j] * cg;
      IMa[j] = IMa[j] + PI[j] * ci;
    }
  }
  float lmax = 0.0f;
  tree_sum_max(lsum, lmax, red);
  float pfwd = local ? 1.0f + lsum : MMa[lc];
  float pmin = local ? 1.0f : 0.0f;
  float scale_i = 1.0f, scale_prod = 1.0f;

  for (int i = 2; i <= Lq; ++i) {
    scale_prod = scale_prod < FLUSH ? 0.0f : scale_prod * scale_i;
    const float* qa = qtr + (i - 1) * 7;
    const float qmm = qa[M2M], qim = qa[I2M], qdm = qa[D2M], qmd = qa[M2D],
                qdd = qa[D2D];
    const float qmi = qtr[i * 7 + M2I], qii = qtr[i * 7 + I2I];
    const float* qrow = qp + i * 20;
    const uint8_t* corow = cob + (long long)i * Wj;
    const float si = scale_i;
    // the left neighbour's old MM, DG, MI, taken before anyone writes
    float bm = j0 > 0 ? MMa[j0 - 1] : 0.0f;
    float bd = j0 > 0 ? DGa[j0 - 1] : 0.0f;
    float bi = j0 > 0 ? MIa[j0 - 1] : 0.0f;
    __syncthreads();
    lsum = 0.0f;
    lmax = 0.0f;
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const float ok = okf_at(corow, j, Wj);
      const float pf1 = tm.pf(qrow, j) * cs;
      const float pfc =
          ssb ? pf1 * (j < Wj ? ssb[(long long)i * Wj + j] : 0.0f) : pf1;
      const float tmmL = tm.t(j - 1, M2M);
      const float gL = j > 0 ? GDa[j - 1] : 0.0f;
      const float iL = j > 0 ? IMa[j - 1] : 0.0f;
      const float om = MMa[j], od = DGa[j], oi = MIa[j];
      float acc = pmin + (bm * qmm) * tmmL;
      acc = acc + (gL * qmm) * tm.t(j - 1, D2M);
      acc = acc + (iL * qim) * tmmL;
      acc = acc + (bd * qdm) * tmmL;
      acc = acc + (bi * qmm) * tm.t(j - 1, I2M);
      float mm = (pfc * si) * acc;
      if (j == 1) mm = (scale_prod * s0) * pf1;
      mm = mm * ok;
      const float dg = (si * ((om * qmd) + (od * qdd))) * ok;
      const float mi =
          (si * (((om * qmm) * tm.t(j, M2I)) + ((oi * qmm) * tm.t(j, I2I)))) *
          ok;
      MMa[j] = mm;
      DGa[j] = dg;
      MIa[j] = mi;
      if (j < Wj) fw[(long long)i * Wj + j] = mm;
      const float v = j == 1 ? 0.0f : mm;
      lmax = k ? mx(lmax, v) : v;
      lsum = k ? lsum + mm : mm;
      bm = om;
      bd = od;
      bi = oi;
    }
    __syncthreads();
    float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const float ok = okf_at(corow, j, Wj);
      const float mL = j > 0 ? MMa[j - 1] : 0.0f;
      const float tmmL = tm.t(j - 1, M2M);
      const float ug = (mL * tm.t(j - 1, M2D)) * ok;
      const float ag = tm.t(j - 1, D2D) * ok;
      const float ui = ((mL * qmi) * tmmL) * ok;
      const float ai = (qii * tmmL) * ok;
      yg = k ? ug + ag * yg : ug;
      pg = k ? ag * pg : ag;
      yi = k ? ui + ai * yi : ui;
      pi = k ? ai * pi : ai;
      GDa[j] = yg;
      PG[j] = pg;
      IMa[j] = yi;
      PI[j] = pi;
    }
    float cg, ci;
    ks_lin2<false>(pg, yg, pi, yi, ks, cg, ci);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      GDa[j] = GDa[j] + PG[j] * cg;
      IMa[j] = IMa[j] + PI[j] * ci;
    }
    tree_sum_max(lsum, lmax, red);
    // Pmax over j >= 2 only (hhforwardalgorithm.cpp:139-143)
    const float scale_next = 1.0f / (mx(lmax, 0.0f) + 1.0f);
    if (local || i == Lq)
      pfwd = (pfwd + lsum) * scale_next;
    else
      pfwd = (pfwd + MMa[lc]) * scale_next;
    pmin = pmin * scale_i;
    pmin = pmin < FLUSH ? 0.0f : pmin;
    if (t == 0) scb[i + 1] = scale_next;
    scale_i = scale_next;
  }
  if (t == 0) pfwd_out[b] = pfwd;
}

// ------------------------------------------------------------------ R2 --
// Backward rows from Lq up to 1, each row's posterior written as it is
// done: pmm (B, Lq+1, Wj), p = fwd * bwd / Pforward on open cells, else 0.
__global__ void __launch_bounds__(T) fb_backward_kernel(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ fwd, const float* __restrict__ scales,
    const float* __restrict__ pfwd, const int* __restrict__ tL, int Lq,
    int Wj, int c, float cs, int local, float* scratch,
    float* __restrict__ pmm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ks[8 * T];
  const int b = blockIdx.x, t = threadIdx.x;
  const int W = T * c, j0 = t * c;
  float* st = lane_arrays(smem, scratch, 8LL * W);
  float* NM = st;
  float* ND = st + W;
  float* NI = st + 2 * W;
  float* GDa = st + 3 * W;
  float* IMa = st + 4 * W;
  float* PG = st + 5 * W;
  float* PI = st + 6 * W;
  float* PM = st + 7 * W;
  const long long plane = (long long)(Lq + 1) * Wj;
  const Tmpl tm{tp + (long long)b * (Wj + 1) * 20,
                ttr + (long long)b * (Wj + 1) * 7, Wj};
  const uint8_t* cob = co + b * plane;
  const float* ssb = ssf ? ssf + b * plane : nullptr;
  const float* fw = fwd + b * plane;
  float* pb = pmm + b * plane;
  const float* scb = scales + (long long)b * (Lq + 2);
  const float P = pfwd[b];
  const float sLq1 = scb[Lq + 1];
  // column Lt's reset: the hit's last column in global mode (local mode
  // keeps the padded row's, as the JAX package; the columns past the
  // hit's are off, so its own would give the same rows)
  const int lc = tL && !local ? tL[b] : Wj - 1;
  const uint8_t* coLq = cob + (long long)Lq * Wj;
  for (int k = 0; k < c; ++k) {
    const int j = j0 + k;
    const float ok = okf_at(coLq, j, Wj);
    const float nm = sLq1 * ok;
    NM[j] = nm;
    ND[j] = 0.0f;
    NI[j] = 0.0f;
    if (j < Wj) {
      pb[j] = 0.0f;
      pb[(long long)Lq * Wj + j] =
          ok != 0.0f ? (fw[(long long)Lq * Wj + j] * nm) / P : 0.0f;
    }
  }
  float scale_prod = sLq1;
  float pmin = local ? sLq1 : 0.0f;
  __syncthreads();
  for (int i = Lq - 1; i >= 1; --i) {
    const float si1 = scb[i + 1];
    scale_prod = scale_prod * si1;
    scale_prod = scale_prod < FLUSH ? 0.0f : scale_prod;
    pmin = pmin * si1;
    pmin = pmin < FLUSH ? 0.0f : pmin;
    const float* qa = qtr + i * 7;
    const float qmm = qa[M2M], qim = qa[I2M], qii = qa[I2I], qmi = qa[M2I],
                qmd = qa[M2D], qdd = qa[D2D], qdm = qa[D2M];
    const uint8_t* corow = cob + (long long)i * Wj;
    const float* qnext = qp + (i + 1) * 20;
    // the match term from the row below, then the reverse chains
    float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
    for (int k = c - 1; k >= 0; --k) {
      const int j = j0 + k;
      const float ok = okf_at(corow, j, Wj);
      float pm = 0.0f;
      if (j + 1 < W) {
        const float pf1 = tm.pf(qnext, j + 1) * cs;
        const float pfc =
            ssb ? pf1 * (j + 1 < Wj ? ssb[(long long)(i + 1) * Wj + j + 1]
                                    : 0.0f)
                : pf1;
        pm = (NM[j + 1] * pfc) * si1;
      }
      PM[j] = pm;
      const float tmm = tm.t(j, M2M);
      const float ug = ((pm * qmm) * tm.t(j, D2M)) * ok;
      const float ag = tm.t(j, D2D) * ok;
      const float ui = ((pm * qim) * tmm) * ok;
      const float ai = (qii * tmm) * ok;
      const bool first = k == c - 1;
      yg = first ? ug : ug + ag * yg;
      pg = first ? ag : ag * pg;
      yi = first ? ui : ui + ai * yi;
      pi = first ? ai : ai * pi;
      GDa[j] = yg;
      PG[j] = pg;
      IMa[j] = yi;
      PI[j] = pi;
    }
    float cg, ci;
    ks_lin2<true>(pg, yg, pi, yi, ks, cg, ci);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      GDa[j] = GDa[j] + PG[j] * cg;
      IMa[j] = IMa[j] + PI[j] * ci;
    }
    __syncthreads();
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const float ok = okf_at(corow, j, Wj);
      const float pm = PM[j];
      const float gR = j + 1 < W ? GDa[j + 1] : 0.0f;
      const float iR = j + 1 < W ? IMa[j + 1] : 0.0f;
      const float nd = ND[j], ni = NI[j];
      const float tmm = tm.t(j, M2M);
      float acc = pmin + (pm * qmm) * tmm;
      acc = acc + gR * tm.t(j, M2D);
      acc = acc + (iR * qmi) * tmm;
      acc = acc + (nd * qmd) * si1;
      acc = acc + ((ni * qmm) * tm.t(j, M2I)) * si1;
      float mm = acc * ok;
      const float dg = (((pm * qdm) * tmm) + ((nd * qdd) * si1)) * ok;
      const float mi =
          (((pm * qmm) * tm.t(j, I2M)) + (((ni * qmm) * tm.t(j, I2I)) * si1)) *
          ok;
      // column Lt: the suffix starts here with the cumulative scale
      if (j == lc) mm = scale_prod * ok;
      NM[j] = mm;
      ND[j] = dg;
      NI[j] = mi;
      if (j < Wj)
        pb[(long long)i * Wj + j] =
            ok != 0.0f ? (fw[(long long)i * Wj + j] * mm) / P : 0.0f;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ R3 --
// MAC rows, backtrace codes and the argmax.  bmac (B, Lq+1, Wj) uint8;
// i2, j2 (B,) int32.
__global__ void __launch_bounds__(T) mac_dp_kernel(
    const float* __restrict__ pmm, const uint8_t* __restrict__ co,
    const int* __restrict__ tL, int Lq, int Wj, int c, float mact, int local,
    float* scratch, uint8_t* __restrict__ bmac, int* __restrict__ i2,
    int* __restrict__ j2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ks[4 * T];
  __shared__ float red_v[T];
  __shared__ long long red_k[T];
  const int b = blockIdx.x, t = threadIdx.x;
  const int W = T * c, j0 = t * c;
  float* st = lane_arrays(smem, scratch, 3LL * W + (W + 3) / 4);
  float* S = st;
  float* DL = st + W;
  float* MX = st + 2 * W;
  uint8_t* V = reinterpret_cast<uint8_t*>(st + 3 * W);
  const long long plane = (long long)(Lq + 1) * Wj;
  const float* pb = pmm + b * plane;
  const uint8_t* cob = co + b * plane;
  uint8_t* bb = bmac + b * plane;
  const int lastcol = tL ? tL[b] : Wj - 1;
  const float half = 0.5f * mact;
  float best = -FLT_MAX;
  long long bestk = 0;
  for (int k = 0; k < c; ++k) {
    const int j = j0 + k;
    S[j] = 0.0f;
    if (j < Wj) bb[j] = 0;
  }
  __syncthreads();
  for (int i = 1; i <= Lq; ++i) {
    const float* prow = pb + (long long)i * Wj;
    const uint8_t* corow = cob + (long long)i * Wj;
    // the left neighbour's S of the row above, taken before anyone writes
    float bS = j0 > 0 ? S[j0 - 1] : 0.0f;
    __syncthreads();
    float s = 0.0f, D = 0.0f;
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const bool ok = j < Wj && !corow[j];
      const float po = j < Wj ? prow[j] : 0.0f;
      const float old = S[j];
      const float t1 = po - mact;
      const float t2 = (bS + po) - mact;
      const float t3 = old - half;
      uint8_t v = t1 > t2 ? STOP : MM;
      float m = mx(t1, t2);
      v = t3 > m ? MI : v;
      m = mx(m, t3);
      MX[j] = m;
      V[j] = v;
      float mm = ok ? m : -FLT_MIN;
      if (j == 0) mm = 0.0f;
      const float dec = ok ? half : DECAY_OFF;
      s = k ? mx(mm, s - dec) : mm;
      D = k ? D + dec : dec;
      S[j] = s;
      DL[j] = D;
      bS = old;
    }
    const float carry = ks_maxplus(s, D, ks);
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const bool ok = j < Wj && !corow[j];
      float sv = S[j];
      if (t > 0) sv = mx(sv, carry - DL[j]);
      sv = ok ? sv : -FLT_MIN;
      if (j == 0) sv = 0.0f;
      S[j] = sv;
    }
    __syncthreads();
    for (int k = 0; k < c; ++k) {
      const int j = j0 + k;
      const bool ok = j < Wj && !corow[j];
      const float t4 = (j > 0 ? S[j - 1] : 0.0f) - half;
      uint8_t v = t4 > MX[j] ? IM : V[j];
      if (!ok || j == 0) v = STOP;
      if (j < Wj) bb[(long long)i * Wj + j] = v;
      if (ok && j >= 1 && (local || i == Lq || j == lastcol) && S[j] > best) {
        best = S[j];
        bestk = (long long)i * Wj + j;
      }
    }
  }
  // the first row-major maximum: (score desc, flat index asc)
  red_v[t] = best;
  red_k[t] = bestk;
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (t < h) {
      const float ov = red_v[t + h];
      const long long okk = red_k[t + h];
      if (ov > red_v[t] || (ov == red_v[t] && okk < red_k[t])) {
        red_v[t] = ov;
        red_k[t] = okk;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const bool none = red_v[0] <= -FLT_MAX;
    i2[b] = none ? 0 : (int)(red_k[0] / Wj);
    j2[b] = none ? 0 : (int)(red_k[0] % Wj);
  }
}

// ------------------------------------------------------------------ R4 --
// One thread per hit: the MAC backtrace from (i2, j2) over kmax steps,
// each step's code and posterior recorded (after the terminal code, the
// stop cell repeats), into out (B, 12 + 5 kmax) bytes: score f32, i2
// int16, j2 int16, n int32, st[kmax], post[kmax] f32, little-endian.
__global__ void __launch_bounds__(T) mac_walk_kernel(
    const uint8_t* __restrict__ bmac, const float* __restrict__ pmm,
    const int* __restrict__ i2, const int* __restrict__ j2,
    const float* __restrict__ score, int B, int Lq, int Wj, int kmax,
    uint8_t* __restrict__ out) {
  const int b = blockIdx.x * T + threadIdx.x;
  if (b >= B) return;
  const long long plane = (long long)(Lq + 1) * Wj;
  const uint8_t* bb = bmac + b * plane;
  const float* pb = pmm + b * plane;
  uint8_t* o = out + (long long)b * (12 + 5LL * kmax);
  int i = i2[b], j = j2[b];
  // the reference's pre-masking: column 1 and row 1 stop
  auto code_at = [&](int ii, int jj) -> int {
    return (jj == 1 || (ii == 1 && jj >= 1)) ? STOP
                                             : bb[(long long)ii * Wj + jj];
  };
  bool alive = code_at(i, j) == MM;
  int n = 0;
  int code = 0;
  float post = 0.0f;
  for (int k = 0; k < kmax; ++k) {
    code = code_at(i, j);
    post = pb[(long long)i * Wj + j];
    o[12 + k] = (uint8_t)code;
    memcpy(o + 12 + kmax + 4LL * k, &post, 4);
    if (!alive) {
      // the cell stays: the rest of the steps repeat it
      for (int r = k + 1; r < kmax; ++r) {
        o[12 + r] = (uint8_t)code;
        memcpy(o + 12 + kmax + 4LL * r, &post, 4);
      }
      break;
    }
    ++n;
    const bool go = code == MM || code == IM || code == MI;
    if (go) {
      i -= (code == MM || code == MI);
      j -= (code == MM || code == IM);
    }
    alive = go;
  }
  const float sc = score[b];
  const int16_t hi = (int16_t)i2[b], hj = (int16_t)j2[b];
  memcpy(o, &sc, 4);
  memcpy(o + 4, &hi, 2);
  memcpy(o + 6, &hj, 2);
  memcpy(o + 8, &n, 4);
}

long long lane_floats(int kind, int Wj) {
  if (Wj < 1) return -1;
  const long long W = (long long)T * ((Wj + T - 1) / T);
  switch (kind) {
    case 0: return 7 * W;
    case 1: return 8 * W;
    case 2: return 3 * W + (W + 3) / 4;
    default: return -1;
  }
}

template <class K>
cudaError_t prepare(K kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* hh_post_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of a CTA's row arrays for kernel kind 0 (R1), 1 (R2), 2 (R3) at
// a row of Wj cells: the dynamic shared bytes / 4, or a lane's share of
// the global scratch; -1 for arguments the kernels do not take.
long long hh_post_lane_floats(int kind, int Wj) { return lane_floats(kind, Wj); }

// R1.  qp (Lq+2, 20), qtr (Lq+2, 7); tp (B, Wj+1, 20), ttr (B, Wj+1, 7);
// co (B, Lq+1, Wj) bytes (nonzero = cell off); ssf (B, Lq+1, Wj) and ss0
// (B,) or null; tL (B,) each hit's last column (global mode's exits;
// null for Wj - 1); cs = 2^shift; scratch: null with smem_bytes =
// 4 * hh_post_lane_floats(0, Wj), or B such slices with smem_bytes = 0.
int hh_post_forward(const float* qp, const float* qtr, const float* tp,
                    const float* ttr, const uint8_t* co, const float* ssf,
                    const float* ss0, const int* tL, int B, int Lq, int Wj,
                    float cs, int local, float* scratch, int smem_bytes,
                    float* fwd,
                    float* scales, float* pfwd, void* stream) {
  if (B < 0 || Lq < 1 || Wj < 2 || (!scratch && smem_bytes <= 0))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int c = (Wj + T - 1) / T;
  cudaError_t e = prepare(fb_forward_kernel, smem_bytes);
  if (e != cudaSuccess) return e;
  fb_forward_kernel<<<B, T, smem_bytes, (cudaStream_t)stream>>>(
      qp, qtr, tp, ttr, co, ssf, ss0, tL, Lq, Wj, c, cs, local, scratch,
      fwd, scales, pfwd);
  return cudaGetLastError();
}

// R2.  As R1, with R1's fwd, scales and pfwd; pmm (B, Lq+1, Wj); tL as
// R1 (the global mode's column-Lt reset).
int hh_post_backward(const float* qp, const float* qtr, const float* tp,
                     const float* ttr, const uint8_t* co, const float* ssf,
                     const float* fwd, const float* scales,
                     const float* pfwd, const int* tL, int B, int Lq,
                     int Wj, float cs, int local, float* scratch,
                     int smem_bytes, float* pmm, void* stream) {
  if (B < 0 || Lq < 1 || Wj < 2 || (!scratch && smem_bytes <= 0))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int c = (Wj + T - 1) / T;
  cudaError_t e = prepare(fb_backward_kernel, smem_bytes);
  if (e != cudaSuccess) return e;
  fb_backward_kernel<<<B, T, smem_bytes, (cudaStream_t)stream>>>(
      qp, qtr, tp, ttr, co, ssf, fwd, scales, pfwd, tL, Lq, Wj, c, cs,
      local, scratch, pmm);
  return cudaGetLastError();
}

// R3.  pmm (B, Lq+1, Wj), co as R1; tL (B,) the global mode's last
// column per hit, or null for Wj - 1.
int hh_post_mac(const float* pmm, const uint8_t* co, const int* tL, int B,
                int Lq, int Wj, float mact, int local, float* scratch,
                int smem_bytes, uint8_t* bmac, int* i2, int* j2,
                void* stream) {
  if (B < 0 || Lq < 1 || Wj < 2 || (!scratch && smem_bytes <= 0))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int c = (Wj + T - 1) / T;
  cudaError_t e = prepare(mac_dp_kernel, smem_bytes);
  if (e != cudaSuccess) return e;
  mac_dp_kernel<<<B, T, smem_bytes, (cudaStream_t)stream>>>(
      pmm, co, tL, Lq, Wj, c, mact, local, scratch, bmac, i2, j2);
  return cudaGetLastError();
}

// R4.  bmac, pmm (B, Lq+1, Wj); i2, j2 (B,) int32 in range; score (B,);
// out (B, 12 + 5 kmax) bytes.
int hh_post_walk(const uint8_t* bmac, const float* pmm, const int* i2,
                 const int* j2, const float* score, int B, int Lq, int Wj,
                 int kmax, uint8_t* out, void* stream) {
  if (B < 0 || Lq < 1 || Wj < 2 || kmax < 1) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  mac_walk_kernel<<<(B + T - 1) / T, T, 0, (cudaStream_t)stream>>>(
      bmac, pmm, i2, j2, score, B, Lq, Wj, kmax, out);
  return cudaGetLastError();
}

}  // extern "C"
