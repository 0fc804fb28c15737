// Hand-written Hopper (sm_90a) kernels for the HMM-HMM Viterbi search.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   K1  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_score_lanes_fused
//       (score-only sweep, profile dot and log2 fused; si_mode fast|exact)
//       -> vit_score_kernel / hh_vit_score
//   K2  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_backtrace_lanes
//       (full local Viterbi with backtrace bytes, no cell-off, no SS)
//       -> vit_bt_kernel<false, false, true> / hh_vit_bt
//   K3  hhsuite_tpu/ops/viterbi_rows.py  : viterbi_batch_rows
//       (cell-off mask, optional SS score, local or global, backtrace)
//       -> vit_bt_kernel<HAS_CO, HAS_SS, LOCAL> / hh_vit_bt
//   K6  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_score_lanes
//       (score-only sweep, Si = log2f4(dot) + shift + a secondary-
//       structure term, dense or through a lookup table; f32 Si only)
//       -> vit_score_kernel<false, SS_DENSE | SS_LUT> / hh_vit_score
//
// Design.  One template per thread, as the reference maps templates to
// SIMD lanes (hhviterbialgorithm.cpp:45-497).  A thread walks the query in
// strips of ROWS rows; inside a strip it walks template columns j = 1..Lt
// and keeps the strip's five DP states of column j-1 in registers.  The
// last row of a strip is handed to the next strip through a per-lane
// scratch row laid out [Lt+1][5][B], so neighbouring threads touch
// neighbouring addresses.  The query rows of a strip (20 profile floats
// and 7 transitions each) sit in shared memory; template profiles and
// transitions are read as [Lt+2][20][B] and [Lt+2][7][B], backtrace bytes
// (and the K3 cell-off / SS inputs) are [Lq+1][Lt+1][B]: every global
// access of a warp is one contiguous segment.
//
// Exactness.  Every cell evaluates the same f32 expressions, in the same
// order, as the plain PyTorch versions beside the wrappers
// (ops/viterbi.py:viterbi_batch for K2/K3, ops/viterbi_lanes.py for K1):
// the 20-term profile dot in the reference's SSE summation tree
// (hhhit-inl.h:62-120), the log2 polynomials bit for bit, max as
// "a > b ? a : b", strict ">" updates in row-major tie order.  Built with
// -fmad=false (no FMA contraction) and never with --use_fast_math.
//
// What bounds it on the card.  Per cell: 39 FP32 operations for the dot
// (20 mul + 19 add), 10-12 for the log2 and 28 (K1) or ~45 (K2/K3, with
// the backtrace-bit compares; K3 +5 with a cell-off mask) for the DP,
// K6 one more add for the SS term (plus, in the LUT form, one shared-
// memory load: the table, <= 1936 floats, sits in shared memory beside
// the strip's query rows and their table offsets; the template's offset
// of column j is one coalesced int32 load per column, like its
// transitions), all on CUDA cores: 77 (K1 exact; K6 78, K1 fast 79) to
// ~100 (K3) operations per cell
// against the card's 67 TFLOP/s FP32 peak, which counts an FMA as two —
// with FMA contraction off (exactness) the reachable rate is half of it.
// K2/K3 also write one backtrace byte per cell (K3 reads one cell-off
// byte and, with SS, four SS bytes; K6's dense form reads four SS
// bytes): ~1-6 B/cell against 3.35 TB/s, so
// the work is operations-bound, not bytes-bound.
//
// What the simple design leaves on the table.  One thread per template
// gives B threads: at B = 4096..8192 that is 1-2 warps per SM (K3's
// altali batches of ~1000 lanes leave most SMs idle), so the kernel is
// latency-bound; the ROWS strip's 5 states x 8 rows, the 20-float
// template column and the dot's products need more than the 255
// registers a thread may hold, and ptxas spills.  Splitting a template's
// rows over the lanes of a warp (a wavefront passing strip boundaries
// through shuffles), fewer live registers per strip, the tensor cores
// for the profile dot (which exactness rules out unless the dot order is
// kept), and TMA staging of the template columns are the next steps.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int M2M = 0, M2I = 1, M2D = 2, I2M = 3, I2I = 4, D2M = 5, D2D = 6;
constexpr int STOP = 0, MM = 2, GD = 3, IM = 4, DG = 5, MI = 6;
constexpr int ROWS = 8;      // query rows per strip, register-resident
constexpr int THREADS = 32;  // templates per block: spread over all SMs
constexpr float NEG = -FLT_MAX;
// K6's SS term: none, dense [Lq+1][Lt+1][B], or lut[qidx[i-1] + tidx[j-1]]
constexpr int SS_NONE = 0, SS_DENSE = 1, SS_LUT = 2;
constexpr int SS_LUT_MAX = 4 * 11 * 4 * 11;  // S33: NSSPRED x MAXCF squared

__device__ __forceinline__ float fmax_(float a, float b) {
  return a > b ? a : b;
}

// 20-term profile dot in the reference's SSE tree:
// lane_l = ((p_l + p_{l+4}) + (p_{l+8} + p_{l+12})) + p_{l+16},
// total = (lane3 + lane2) + (lane1 + lane0)
__device__ __forceinline__ float dot20(const float* q, const float* t) {
  float p[20];
#pragma unroll
  for (int k = 0; k < 20; ++k) p[k] = __fmul_rn(q[k], t[k]);
  float l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    l[k] = __fadd_rn(__fadd_rn(__fadd_rn(p[k], p[k + 4]),
                               __fadd_rn(p[k + 8], p[k + 12])),
                     p[k + 16]);
  return __fadd_rn(__fadd_rn(l[3], l[2]), __fadd_rn(l[1], l[0]));
}

// log2f4 (hhutil-inl.h:509-545), the exact Si log2
__device__ __forceinline__ float log2f4(float x) {
  const int bits = __float_as_int(x);
  const float e = (float)(((bits & 0x7F800000) >> 23) - 127);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  float p = -0.107254423828329604454f;
  p = __fadd_rn(__fmul_rn(p, m), 0.688243882994381274313f);
  p = __fadd_rn(__fmul_rn(p, m), -1.75647175389045657003f);
  p = __fadd_rn(__fmul_rn(p, m), 2.61761038894603480148f);
  p = __fmul_rn(p, __fsub_rn(m, 1.0f));
  return __fadd_rn(p, e);
}

// K1 "fast" log2 + offset: exponent bits plus a quartic mantissa
// correction, log2(x) + 127 + sh (the caller passes sh = shift - 127)
__device__ __forceinline__ float log2_quartic(float x, float sh) {
  const float y0 = __fmul_rn(__int2float_rn(__float_as_int(x)),
                             1.1920929e-7f);
  const float frac = __fsub_rn(y0, floorf(y0));
  float p = __fsub_rn(__fmul_rn(frac, 0.0803073f), 0.23669342f);
  p = __fadd_rn(__fmul_rn(p, frac), 0.43807325f);
  return __fadd_rn(__fmul_rn(__fmul_rn(p, frac), __fsub_rn(1.0f, frac)),
                   __fadd_rn(y0, sh));
}

// Stage the query rows i0..i0+ROWS-1 (profile, and K6's SS table
// offsets when qidx is given) and i0-1..i0+ROWS-1 (transitions) of a
// strip in shared memory.
__device__ __forceinline__ void load_strip(const float* __restrict__ qp,
                                           const float* __restrict__ qtr,
                                           int i0, int nr,
                                           float (*s_qp)[20],
                                           float (*s_qtr)[7],
                                           const int* __restrict__ qidx =
                                               nullptr,
                                           int* s_qidx = nullptr) {
  __syncthreads();
  for (int k = threadIdx.x; k < ROWS * 20; k += blockDim.x) {
    const int r = k / 20, a = k % 20;
    s_qp[r][a] = r < nr ? qp[(size_t)(i0 + r) * 20 + a] : 0.0f;
  }
  for (int k = threadIdx.x; k < (ROWS + 1) * 7; k += blockDim.x) {
    const int r = k / 7, c = k % 7;
    s_qtr[r][c] = r <= nr ? qtr[(size_t)(i0 - 1 + r) * 7 + c] : 0.0f;
  }
  if (qidx)
    for (int r = threadIdx.x; r < ROWS; r += blockDim.x)
      s_qidx[r] = r < nr ? qidx[i0 - 1 + r] : 0;
  __syncthreads();
}

// -------------------------------------------------------------- K1/K6 --
// Best local score per template, egq = egt = 0: MM is 0 on row 0 and
// column 0, the other states -FLT_MAX.  The arithmetic is K1's own
// (viterbi_lanes.py:537-552): the five MM candidates are factored into
// two max trees.  K6 (SS != SS_NONE, exact log2 only) adds the SS term
// to Si after the log2 and the shift: ss [Lq+1][Lt+1][B] (SS_DENSE), or
// lut[qidx[i-1] + tidx[(j-1)*B + b]] (SS_LUT).  Padded template columns
// (zero profile, zero table offset) score like K1's: their -FLT_MAX
// transitions keep them from extending a real path.
template <bool FAST, int SS>
__global__ void __launch_bounds__(THREADS)
vit_score_kernel(const float* __restrict__ qp, const float* __restrict__ qtr,
                 const float* __restrict__ tp, const float* __restrict__ ttr,
                 int B, int Lq, int Lt, float sh,
                 const float* __restrict__ ss, const float* __restrict__ lut,
                 int n_lut, const int* __restrict__ qidx,
                 const int* __restrict__ tidx,
                 float* __restrict__ scratch, float* __restrict__ out) {
  static_assert(!(FAST && SS != SS_NONE), "K6 uses the exact log2");
  __shared__ float s_qp[ROWS][20];
  __shared__ float s_qtr[ROWS + 1][7];
  __shared__ float s_lut[SS == SS_LUT ? SS_LUT_MAX : 1];
  __shared__ int s_qidx[ROWS];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const size_t SB = (size_t)B;
  // the table is visible after the first strip's __syncthreads
  if constexpr (SS == SS_LUT)
    for (int k = threadIdx.x; k < n_lut; k += blockDim.x) s_lut[k] = lut[k];
  // scratch[(j*5 + s)*B + b]: state s of the row above the strip
  if (live) {
    for (int j = 0; j <= Lt; ++j) {
      float* sc = scratch + (size_t)j * 5 * SB + b;
      sc[0] = 0.0f;
      sc[SB] = NEG;
      sc[2 * SB] = NEG;
      sc[3 * SB] = NEG;
      sc[4 * SB] = NEG;
    }
  }
  float best = NEG;
  for (int i0 = 1; i0 <= Lq; i0 += ROWS) {
    const int nr = min(ROWS, Lq - i0 + 1);
    load_strip(qp, qtr, i0, nr, s_qp, s_qtr,
               SS == SS_LUT ? qidx : nullptr, s_qidx);
    if (!live) continue;
    float cmm[ROWS], cgd[ROWS], cim[ROWS], cdg[ROWS], cmi[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      cmm[r] = 0.0f;
      cgd[r] = cim[r] = cdg[r] = cmi[r] = NEG;
    }
    // diagonal predecessor of the strip's first row at column 1: the
    // column-0 boundary of row i0-1
    float pmm = 0.0f, pgd = NEG, pim = NEG, pdg = NEG, pmi = NEG;
    for (int j = 1; j <= Lt; ++j) {
      float tcol[20];
      const float* tpj = tp + (size_t)j * 20 * SB + b;
#pragma unroll
      for (int a = 0; a < 20; ++a) tcol[a] = tpj[a * SB];
      const float* tr1 = ttr + (size_t)(j - 1) * 7 * SB + b;
      const float* tr0 = ttr + (size_t)j * 7 * SB + b;
      const float tm2m = tr1[M2M * SB], td2m = tr1[D2M * SB];
      const float ti2m = tr1[I2M * SB], tm2d = tr1[M2D * SB];
      const float td2d = tr1[D2D * SB];
      const float tm2i = tr0[M2I * SB], ti2i = tr0[I2I * SB];
      const int tj = SS == SS_LUT ? tidx[(size_t)(j - 1) * SB + b] : 0;
      float* sc = scratch + (size_t)j * 5 * SB + b;
      float umm = sc[0], ugd = sc[SB], uim = sc[2 * SB], udg = sc[3 * SB],
            umi = sc[4 * SB];
      float dmm = pmm, dgd = pgd, dim = pim, ddg = pdg, dmi = pmi;
      pmm = umm; pgd = ugd; pim = uim; pdg = udg; pmi = umi;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          const float qm2m = s_qtr[r][M2M], qi2m = s_qtr[r][I2M];
          const float qd2m = s_qtr[r][D2M], qm2d = s_qtr[r][M2D];
          const float qd2d = s_qtr[r][D2D];
          const float qm2i = s_qtr[r + 1][M2I], qi2i = s_qtr[r + 1][I2I];
          const float dot = dot20(s_qp[r], tcol);
          float si = FAST ? log2_quartic(dot, sh)
                          : __fadd_rn(log2f4(dot), sh);
          if constexpr (SS == SS_DENSE)
            si = __fadd_rn(si, ss[((size_t)(i0 + r) * (Lt + 1) + j) * SB
                                  + b]);
          if constexpr (SS == SS_LUT)
            si = __fadd_rn(si, s_lut[s_qidx[r] + tj]);
          float t_a = fmax_(dmm + qm2m, dim + qi2m);
          t_a = fmax_(t_a, ddg + qd2m) + tm2m;
          const float t_b = fmax_(dgd + td2m, dmi + ti2m) + qm2m;
          const float mm = fmax_(fmax_(0.0f, t_a), t_b) + si;
          const float dg = fmax_(umm + qm2d, udg + qd2d);
          const float mi = fmax_(umm + tm2i, umi + ti2i) + qm2m;
          const float lmm = cmm[r], lgd = cgd[r], lim = cim[r];
          const float ldg = cdg[r], lmi = cmi[r];
          const float gd = fmax_(lmm + tm2d, lgd + td2d);
          const float im = fmax_(lmm + qm2i, lim + qi2i) + tm2m;
          best = fmax_(best, mm);
          dmm = lmm; dgd = lgd; dim = lim; ddg = ldg; dmi = lmi;
          umm = mm; ugd = gd; uim = im; udg = dg; umi = mi;
          cmm[r] = mm; cgd[r] = gd; cim[r] = im; cdg[r] = dg; cmi[r] = mi;
        }
      }
      sc[0] = umm; sc[SB] = ugd; sc[2 * SB] = uim; sc[3 * SB] = udg;
      sc[4 * SB] = umi;
    }
  }
  if (live) out[b] = fmax_(best, NEG);
}

// --------------------------------------------------------------- K2/K3 --
// The contract of ops/viterbi.py:viterbi_batch (hhviterbialgorithm.cpp
// :45-497): MM is -j*pt on row 0 and -i*pq on column 0; each cell adds
// the cell-off term (0 or -FLT_MAX) after the max when HAS_CO; SS is
// added to Si when HAS_SS; backtrace byte = MM predecessor code (bits
// 0-2) | GD/IM/DG/MI opened from MM (bits 3-6).  The best cell is
// tracked over rows i <= Lq_true (global mode: last row Lq_true or the
// template's true last column) with ties broken by i, then j, ascending.
template <bool HAS_CO, bool HAS_SS, bool LOCAL>
__global__ void __launch_bounds__(THREADS)
vit_bt_kernel(const float* __restrict__ qp, const float* __restrict__ qtr,
              const float* __restrict__ tp, const float* __restrict__ ttr,
              const int* __restrict__ t_L,
              const uint8_t* __restrict__ co, const float* __restrict__ ss,
              int B, int Lq, int Lt, int Lq_true, float shift, float pq,
              float pt, float* __restrict__ scratch,
              float* __restrict__ score, int* __restrict__ i2,
              int* __restrict__ j2, uint8_t* __restrict__ bt) {
  __shared__ float s_qp[ROWS][20];
  __shared__ float s_qtr[ROWS + 1][7];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const size_t SB = (size_t)B;
  const size_t W = (size_t)(Lt + 1);
  const float smin = LOCAL ? 0.0f : NEG;
  const int tL = live ? t_L[b] : 0;
  if (live) {
    for (int j = 0; j <= Lt; ++j) {
      float* sc = scratch + (size_t)j * 5 * SB + b;
      sc[0] = __fmul_rn(-(float)j, pt);
      sc[SB] = NEG;
      sc[2 * SB] = NEG;
      sc[3 * SB] = NEG;
      sc[4 * SB] = NEG;
      bt[(size_t)j * SB + b] = 0;
    }
  }
  float best = NEG;
  int bi = 0, bj = 0;
  for (int i0 = 1; i0 <= Lq; i0 += ROWS) {
    const int nr = min(ROWS, Lq - i0 + 1);
    load_strip(qp, qtr, i0, nr, s_qp, s_qtr);
    if (!live) continue;
    float cmm[ROWS], cgd[ROWS], cim[ROWS], cdg[ROWS], cmi[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      cmm[r] = __fmul_rn(-(float)(i0 + r), pq);
      cgd[r] = cim[r] = cdg[r] = cmi[r] = NEG;
      if (r < nr) bt[(size_t)(i0 + r) * W * SB + b] = 0;
    }
    float pmm = i0 == 1 ? __fmul_rn(-0.0f, pt)
                        : __fmul_rn(-(float)(i0 - 1), pq);
    float pgd = NEG, pim = NEG, pdg = NEG, pmi = NEG;
    for (int j = 1; j <= Lt; ++j) {
      float tcol[20];
      const float* tpj = tp + (size_t)j * 20 * SB + b;
#pragma unroll
      for (int a = 0; a < 20; ++a) tcol[a] = tpj[a * SB];
      const float* tr1 = ttr + (size_t)(j - 1) * 7 * SB + b;
      const float* tr0 = ttr + (size_t)j * 7 * SB + b;
      const float tm2m = tr1[M2M * SB], td2m = tr1[D2M * SB];
      const float ti2m = tr1[I2M * SB], tm2d = tr1[M2D * SB];
      const float td2d = tr1[D2D * SB];
      const float tm2i = tr0[M2I * SB], ti2i = tr0[I2I * SB];
      float* sc = scratch + (size_t)j * 5 * SB + b;
      float umm = sc[0], ugd = sc[SB], uim = sc[2 * SB], udg = sc[3 * SB],
            umi = sc[4 * SB];
      float dmm = pmm, dgd = pgd, dim = pim, ddg = pdg, dmi = pmi;
      pmm = umm; pgd = ugd; pim = uim; pdg = udg; pmi = umi;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          const int i = i0 + r;
          const size_t cell = ((size_t)i * W + j) * SB + b;
          const float qm2m = s_qtr[r][M2M], qi2m = s_qtr[r][I2M];
          const float qd2m = s_qtr[r][D2M], qm2d = s_qtr[r][M2D];
          const float qd2d = s_qtr[r][D2D];
          const float qm2i = s_qtr[r + 1][M2I], qi2i = s_qtr[r + 1][I2I];
          float si = __fadd_rn(log2f4(dot20(s_qp[r], tcol)), shift);
          if (HAS_SS) si = si + ss[cell];
          const float cof = HAS_CO ? (co[cell] ? NEG : 0.0f) : 0.0f;
          // MM: five predecessors at (i-1, j-1), strict ">" code chain
          const float c_mm = (dmm + qm2m) + tm2m;
          float best5 = fmax_(smin, c_mm);
          int code = c_mm > smin ? MM : STOP;
          const float c_gd = (dgd + qm2m) + td2m;
          if (c_gd > best5) code = GD;
          best5 = fmax_(best5, c_gd);
          const float c_im = (dim + qi2m) + tm2m;
          if (c_im > best5) code = IM;
          best5 = fmax_(best5, c_im);
          const float c_dg = (ddg + qd2m) + tm2m;
          if (c_dg > best5) code = DG;
          best5 = fmax_(best5, c_dg);
          const float c_mi = (dmi + qm2m) + ti2m;
          if (c_mi > best5) code = MI;
          best5 = fmax_(best5, c_mi);
          float mm = best5 + si;
          // DG/MI: predecessors at (i-1, j)
          const float a_dg = umm + qm2d, b_dg = udg + qd2d;
          float dg = fmax_(a_dg, b_dg);
          const float a_mi = (umm + qm2m) + tm2i;
          const float b_mi = (umi + qm2m) + ti2i;
          float mi = fmax_(a_mi, b_mi);
          // GD/IM: predecessors at (i, j-1)
          const float lmm = cmm[r], lgd = cgd[r], lim = cim[r];
          const float ldg = cdg[r], lmi = cmi[r];
          const float a_gd = lmm + tm2d, b_gd = lgd + td2d;
          float gd = fmax_(a_gd, b_gd);
          const float a_im = (lmm + qm2i) + tm2m;
          const float b_im = (lim + qi2i) + tm2m;
          float im = fmax_(a_im, b_im);
          if (HAS_CO) {
            mm = mm + cof;
            dg = dg + cof;
            mi = mi + cof;
            gd = gd + cof;
            im = im + cof;
          }
          bt[cell] = (uint8_t)(code | (a_gd > b_gd ? 8 : 0)
                               | (a_im > b_im ? 16 : 0)
                               | (a_dg > b_dg ? 32 : 0)
                               | (a_mi > b_mi ? 64 : 0));
          if (i <= Lq_true && (LOCAL || j == tL || i == Lq_true)) {
            if (mm > best || (mm == best && i < bi)) {
              best = mm;
              bi = i;
              bj = j;
            }
          }
          dmm = lmm; dgd = lgd; dim = lim; ddg = ldg; dmi = lmi;
          umm = mm; ugd = gd; uim = im; udg = dg; umi = mi;
          cmm[r] = mm; cgd[r] = gd; cim[r] = im; cdg[r] = dg; cmi[r] = mi;
        }
      }
      sc[0] = umm; sc[SB] = ugd; sc[2 * SB] = uim; sc[3 * SB] = udg;
      sc[4 * SB] = umi;
    }
  }
  if (live) {
    score[b] = best;
    i2[b] = bi;
    j2[b] = bj;
  }
}

template <bool FAST, int SS>
int launch_score(dim3 grid, cudaStream_t stream, const float* qp,
                 const float* qtr, const float* tp, const float* ttr, int B,
                 int Lq, int Lt, float sh, const float* ss, const float* lut,
                 int n_lut, const int* qidx, const int* tidx, float* scratch,
                 float* out) {
  vit_score_kernel<FAST, SS><<<grid, THREADS, 0, stream>>>(
      qp, qtr, tp, ttr, B, Lq, Lt, sh, ss, lut, n_lut, qidx, tidx, scratch,
      out);
  return (int)cudaGetLastError();
}

template <bool HAS_CO, bool HAS_SS, bool LOCAL>
int launch_bt(dim3 grid, cudaStream_t stream, const float* qp,
              const float* qtr, const float* tp, const float* ttr,
              const int* t_L, const uint8_t* co, const float* ss, int B,
              int Lq, int Lt, int Lq_true, float shift, float pq, float pt,
              float* scratch, float* score, int* i2, int* j2, uint8_t* bt) {
  vit_bt_kernel<HAS_CO, HAS_SS, LOCAL><<<grid, THREADS, 0, stream>>>(
      qp, qtr, tp, ttr, t_L, co, ss, B, Lq, Lt, Lq_true, shift, pq, pt,
      scratch, score, i2, j2, bt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1 and K6.  qp (Lq+2, 20), qtr (Lq+2, 7), tp [Lt+2][20][B], ttr
// [Lt+2][7][B], scratch [Lt+1][5][B] f32, out (B,) f32.  sh = shift
// (exact) or shift - 127 (fast).  K6's SS term (exact only): ss
// [Lq+1][Lt+1][B] f32, or lut (n_lut <= 1936) f32 with qidx (Lq,) i32
// and tidx [Lt][B] i32 (0 <= qidx[i] + tidx[j][b] < n_lut, not
// checked); both NULL for K1.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int hh_vit_score(const float* qp, const float* qtr, const float* tp,
                 const float* ttr, int B, int Lq, int Lt, float sh, int fast,
                 const float* ss, const float* lut, int n_lut,
                 const int* qidx, const int* tidx, float* scratch,
                 float* out, void* stream) {
  if (B <= 0) return 0;
  if ((fast && (ss || lut)) || (lut && (n_lut <= 0 || n_lut > SS_LUT_MAX)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define HH_SCORE(F, S)                                                     \
  return launch_score<F, S>(grid, s, qp, qtr, tp, ttr, B, Lq, Lt, sh, ss, \
                            lut, n_lut, qidx, tidx, scratch, out)
  if (fast) HH_SCORE(true, SS_NONE);
  if (ss) HH_SCORE(false, SS_DENSE);
  if (lut) HH_SCORE(false, SS_LUT);
  HH_SCORE(false, SS_NONE);
#undef HH_SCORE
}

// K2 (co = ss = NULL, local = 1) and K3.  t_L (B,) i32; co
// [Lq+1][Lt+1][B] u8 or NULL; ss [Lq+1][Lt+1][B] f32 or NULL; score (B,)
// f32, i2/j2 (B,) i32, bt [Lq+1][Lt+1][B] u8 (fully written).
int hh_vit_bt(const float* qp, const float* qtr, const float* tp,
              const float* ttr, const int* t_L, const uint8_t* co,
              const float* ss, int B, int Lq, int Lt, int Lq_true, int local,
              float shift, float pq, float pt, float* scratch, float* score,
              int* i2, int* j2, uint8_t* bt, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const int sel = (co ? 4 : 0) | (ss ? 2 : 0) | (local ? 1 : 0);
#define HH_BT(C, S, L)                                                     \
  return launch_bt<C, S, L>(grid, s, qp, qtr, tp, ttr, t_L, co, ss, B, Lq,  \
                            Lt, Lq_true, shift, pq, pt, scratch, score, i2, \
                            j2, bt)
  switch (sel) {
    case 0: HH_BT(false, false, false);
    case 1: HH_BT(false, false, true);
    case 2: HH_BT(false, true, false);
    case 3: HH_BT(false, true, true);
    case 4: HH_BT(true, false, false);
    case 5: HH_BT(true, false, true);
    case 6: HH_BT(true, true, false);
    default: HH_BT(true, true, true);
  }
#undef HH_BT
}

}  // extern "C"
