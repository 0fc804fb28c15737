// Hand-written Hopper (sm_90a) kernels for the batched MAC realignment.
//
// Replace the JAX package's device realign decoder, which is plain jnp
// compiled into one dispatch (hhsuite_tpu/ops/posterior_batch.py):
//   R1  fb_mac_batch's Forward rows (:139-224)
//       -> fb_forward_kernel<C, SS> (fb_forward_wide<SS>) / hh_post_forward
//   R2  fb_mac_batch's Backward rows (:226-279), fused into the
//       posterior p_mm = fwd * bwd / Pforward
//       -> fb_backward_kernel<C, SS> (fb_backward_wide<SS>) /
//          hh_post_backward
//   R3  fb_mac_batch's MAC rows, backtrace codes and argmax (:281-351)
//       -> mac_dp_kernel<C> (mac_dp_wide) / hh_post_mac
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
// The association: one hit to a CTA of T = 128 threads, query rows in
// order.  A row of Wj = Lt + 1 cells is cut into T segments of c =
// ceil(Wj / T) contiguous columns (padded to W = T * c with cells that
// are off and hold zeros).  A same-row chain (R1/R2's GD and IM affine
// recurrences y[j] = u[j] + a[j] * y[j -+ 1], R3's max-plus S[j] =
// max(m[j], S[j-1] - d[j])) runs as a sequential pass inside the
// segment, a Kogge-Stone scan over the T segment aggregates with the JAX
// package's combine rules (_lin_scan :43, _maxplus_scan :58), and the
// carry applied back into the segment.  Row sums and maxima: sequential
// in the segment, then a pairwise tree over T.
//
// R1/R2 for rows of c <= CROW = 8 columns a thread (Wj <= 1024, the
// search's templates): fb_forward_kernel / fb_backward_kernel<C, SS>.
// What bounds them: a row of B = 256 hits at Wj = 385 is ~0.1 M cells,
// ~84 f32 operations each (no FMA), against 33.5e12/s: ~0.25 us; the
// row's work is a chain of dependent steps, so its latency sets the
// pace (the block-scan design below: ~10.9 us a row on an H100 80GB
// HBM3 at a 700 W power limit).
// What the design does about it:
//   - the row state (MM, DG, MI, GD, IM; R2 the next row's), the
//     template's transition columns of the thread's c columns, its
//     profile columns (up to CREG = 4 columns; beyond, in the thread's
//     own shared-memory slots) and each row's inputs (query row,
//     cell-off bytes, SS factors, R2's fwd row) live in registers; the
//     next row's inputs are loaded, and its profile dot computed, during
//     this row's scans;
//   - a row's neighbours meet in shared-memory slots of two parities,
//     and every warp scans the T chain aggregates (and R1's row sum and
//     max) itself, four elements a lane with shuffles, in the
//     association of the block-wide scan: 2 block barriers a row (the
//     block-scan design: 20 in R1, 11 in R2);
//   - the SS factors come as a table (SS_TABLE: the factors of the three
//     modes, ~10 KB, staged in shared memory; a row offset a row and a
//     column offset a column, -1 for a factor of 1) or as the dense
//     (B, Lq+1, Wj) matrix (SS_DENSE), the JAX layout.
// Wider rows keep the block-scan design (fb_forward_wide /
// fb_backward_wide: the row arrays in dynamic shared memory, or, too
// wide for it, in a global scratch of the same layout; the row's
// operands and the SS table read from global memory; 20 barriers a
// row).
//
// R3 for rows of c <= CROW columns a thread: mac_dp_kernel<C>.  What
// bounds it: 13 f32 operations a cell and 6 bytes (p_mm, the cell-off
// byte, the code), so at B = 256 hits and Wj = 385 a row moves ~0.6
// MB, ~0.18 us at 3.35 TB/s; the row is a dependent chain (the
// three-way max, the max-plus chain, the IM code), and the block-scan
// design paid ~2 us a row for its 11 barriers, its row arrays in shared
// memory and its global reads inside the row.  Now S, the three-way
// maxima, the codes and the chain's running values live in registers;
// the row's p_mm and cell-off bytes come by cp.async MAC_PD rows ahead
// into the thread's own shared-memory slots (a load issued one row
// ahead was moved by the compiler to the row's end, and its latency
// showed); a row meets one block barrier: the segment aggregates in
// two-parity shared slots, scanned by every warp itself
// (ks_maxplus_warp); a thread rebuilds its left neighbour's final S,
// which the IM code and the next row's diagonal need, from that
// neighbour's aggregate, and writes a row's codes during the next row's
// scan.  Wider rows keep the block-scan design (mac_dp_wide: the row
// arrays in shared memory or the global scratch).  Each thread keeps
// its best cell (strict ">" in row-major order), reduced by (score
// desc, flat index asc).  R4 runs one thread per hit over at most kmax
// steps, reading b_mac with the pre-masking (column 1 and row 1 STOP)
// applied on the fly, and writes the payload bytes directly.
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

// ------------------------------------------------------ SS factors --
enum { SS_NONE = 0, SS_DENSE = 1, SS_TABLE = 2 };
// the table's entries: 1 + |S37| + |S73| + |S33| = 1 + 352 + 352 + 1936
constexpr int SS_LUT_MAX = 4096;

// A hit's SS factor at (i, j) in the wide kernels: the dense (Lq+1, Wj)
// plane or the table (entry 0 where the column offset is negative); 0
// in the padding columns, as the plain versions pad.
template <int SS>
struct SsAt {
  const float* dense;
  const float* lut;
  const int* roff;
  const int* coff;
  int Wj;
  __device__ __forceinline__ float at(int i, int j) const {
    if (j >= Wj) return 0.0f;
    if constexpr (SS == SS_DENSE) {
      return dense[(long long)i * Wj + j];
    } else {
      const int cj = coff[j];
      return lut[cj < 0 ? 0 : roff[i] + cj];
    }
  }
};

template <int SS>
__device__ __forceinline__ SsAt<SS> ss_at(const float* ssf, const float* lut,
                                          const int* roff, const int* coff,
                                          int b, int Lq, int Wj) {
  const long long plane = (long long)(Lq + 1) * Wj;
  return SsAt<SS>{ssf ? ssf + b * plane : nullptr, lut,
                  roff ? roff + (long long)b * (Lq + 1) : nullptr,
                  coff ? coff + (long long)b * Wj : nullptr, Wj};
}

// --------------------------------------- warp-redundant row scans --
// Every warp scans a row's T segment aggregates itself, lane l holding
// elements l + 32 m (m < NE): the Kogge-Stone steps d < 32 take their
// partner by shuffle, d = 32, 64 from the lane's own registers.  Each
// element goes through the same combines in the same order as in
// ks_lin2 / tree_sum_max, so the results are bit-identical, with no
// block barrier.
constexpr int CREG = 4;   // template profile columns in registers
constexpr int CROW = 8;   // row state in registers (Wj <= 1024)
constexpr int NE = T / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(T == 128, "the warp scans hold four elements a lane");

__device__ __forceinline__ float pick(const float (&v)[NE], int m) {
  return m <= 0 ? v[0] : m == 1 ? v[1] : m == 2 ? v[2] : v[3];
}

// Element e (0 <= e < T, within one warp of this thread's own) of an
// array held as above: both registers it may be in are shuffled from
// lane e % 32, the reader picks.
template <bool REV>
__device__ __forceinline__ float elem_near(const float (&v)[NE], int e) {
  const int w = threadIdx.x >> 5;
  const float own = __shfl_sync(FULL, pick(v, w), e & 31, 32);
  const float far =
      __shfl_sync(FULL, pick(v, REV ? w + 1 : w - 1), e & 31, 32);
  return (e >> 5) == w ? own : far;
}

// ks_lin2's inclusive scan of two affine chains, (A, U) pairs combined
// as (A_x * A_y, U_y + A_y * U_x) with x the earlier element (REV: the
// one to the right).
template <bool REV>
__device__ __forceinline__ void ks_lin2_warp(float (&A0)[NE], float (&U0)[NE],
                                             float (&A1)[NE],
                                             float (&U1)[NE]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int src = REV ? (l + d) & 31 : (l - d) & 31;
    const bool wrap = REV ? l + d >= 32 : l < d;
    float rA0[NE], rU0[NE], rA1[NE], rU1[NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      rA0[m] = __shfl_sync(FULL, A0[m], src, 32);
      rU0[m] = __shfl_sync(FULL, U0[m], src, 32);
      rA1[m] = __shfl_sync(FULL, A1[m], src, 32);
      rU1[m] = __shfl_sync(FULL, U1[m], src, 32);
    }
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      // the partner: register m of lane src, or across the warp's edge
      // register m - 1 (REV: m + 1); none past the array's end
      const int mo = REV ? m + 1 : m - 1;
      const bool in = mo >= 0 && mo < NE;
      const int mc = in ? mo : m;
      const bool has = !wrap || in;
      const float xA0 = wrap ? rA0[mc] : rA0[m];
      const float xU0 = wrap ? rU0[mc] : rU0[m];
      const float xA1 = wrap ? rA1[mc] : rA1[m];
      const float xU1 = wrap ? rU1[mc] : rU1[m];
      if (has) {
        U0[m] = U0[m] + A0[m] * xU0;
        A0[m] = xA0 * A0[m];
        U1[m] = U1[m] + A1[m] * xU1;
        A1[m] = xA1 * A1[m];
      }
    }
  }
#pragma unroll
  for (int dm = 1; dm < NE; dm <<= 1) {
    if (REV) {
#pragma unroll
      for (int m = 0; m + dm < NE; ++m) {
        U0[m] = U0[m] + A0[m] * U0[m + dm];
        A0[m] = A0[m + dm] * A0[m];
        U1[m] = U1[m] + A1[m] * U1[m + dm];
        A1[m] = A1[m + dm] * A1[m];
      }
    } else {
#pragma unroll
      for (int m = NE - 1; m >= dm; --m) {
        U0[m] = U0[m] + A0[m] * U0[m - dm];
        A0[m] = A0[m - dm] * A0[m];
        U1[m] = U1[m] + A1[m] * U1[m - dm];
        A1[m] = A1[m - dm] * A1[m];
      }
    }
  }
}

// tree_sum_max's pairwise trees: h = 64, 32 inside the lane, 16..1 by
// shuffle; the results broadcast from lane 0.
__device__ __forceinline__ void tree_warp(float (&S)[NE], float (&M)[NE],
                                          float& sum, float& m) {
  S[0] = S[0] + S[2];
  M[0] = mx(M[0], M[2]);
  S[1] = S[1] + S[3];
  M[1] = mx(M[1], M[3]);
  S[0] = S[0] + S[1];
  M[0] = mx(M[0], M[1]);
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const float so = __shfl_down_sync(FULL, S[0], h, 32);
    const float mo = __shfl_down_sync(FULL, M[0], h, 32);
    S[0] = S[0] + so;
    M[0] = mx(M[0], mo);
  }
  sum = __shfl_sync(FULL, S[0], 0, 32);
  m = __shfl_sync(FULL, M[0], 0, 32);
}

// A row's scans from its published aggregates A = (a0, u0, a1, u1) of
// the two chains (and, with SUM, the segment sums and maxima R).  Gives
// this thread's carries (the inclusive value of the segment before it:
// t - 1, REV t + 1; 0 at the end), the neighbour's final chain values
// in its column next to this thread's (its u + a * its carry), and the
// row's sum and max.
template <bool REV, bool SUM>
__device__ __forceinline__ void scan_row(const float4* A, const float2* R,
                                         float& cg, float& ci, float& ng,
                                         float& ni, float& sum, float& m) {
  const int t = threadIdx.x, l = t & 31;
  float A0[NE], U0[NE], A1[NE], U1[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const float4 v = A[l + 32 * k];
    A0[k] = v.x;
    U0[k] = v.y;
    A1[k] = v.z;
    U1[k] = v.w;
  }
  if constexpr (SUM) {
    float S[NE], M[NE];
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const float2 r = R[l + 32 * k];
      S[k] = r.x;
      M[k] = r.y;
    }
    tree_warp(S, M, sum, m);
  }
  ks_lin2_warp<REV>(A0, U0, A1, U1);
  const int e1 = REV ? t + 1 : t - 1, e2 = REV ? t + 2 : t - 2;
  const bool h1 = e1 >= 0 && e1 < T, h2 = e2 >= 0 && e2 < T;
  const int c1 = h1 ? e1 : t, c2 = h2 ? e2 : t;
  const float g1 = elem_near<REV>(U0, c1), i1 = elem_near<REV>(U1, c1);
  const float g2 = elem_near<REV>(U0, c2), i2 = elem_near<REV>(U1, c2);
  cg = h1 ? g1 : 0.0f;
  ci = h1 ? i1 : 0.0f;
  const float4 nb = A[c1];
  ng = h1 ? nb.y + nb.x * (h2 ? g2 : 0.0f) : 0.0f;
  ni = h1 ? nb.w + nb.z * (h2 ? i2 : 0.0f) : 0.0f;
}

// A thread's C template profile columns (R1: its columns j, R2: j + 1):
// in registers up to CREG columns; beyond, the thread's own slots of
// shared memory at s[(k * 20 + a) * T] (s = base + threadIdx.x: lanes
// on consecutive words), written and read by this thread alone.
template <int C>
struct ProfCols {
  static constexpr bool REG = C <= CREG;
  // shared floats the profile takes (0: registers)
  static constexpr int SMEM = REG ? 0 : 20 * C * T;
  float r[REG ? C : 1][20];
  float* s;
  __device__ __forceinline__ void load(const float* col, bool in, int k) {
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const float4 v = in ? __ldg(reinterpret_cast<const float4*>(col) + u)
                          : float4{0.0f, 0.0f, 0.0f, 0.0f};
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (REG)
          r[k][4 * u + e] = w[e];
        else
          s[(k * 20 + 4 * u + e) * T] = w[e];
      }
    }
  }
  __device__ __forceinline__ float at(int k, int a) const {
    if constexpr (REG)
      return r[k][a];
    else
      return s[(k * 20 + a) * T];
  }
  // the 20-term profile dot of column k, in dot20's order
  __device__ __forceinline__ float dot(const float (&q)[20], int k) const {
    float acc = q[0] * at(k, 0);
#pragma unroll
    for (int a = 1; a < 20; ++a) acc = acc + q[a] * at(k, a);
    return acc;
  }
};

__device__ __forceinline__ void load_qrow(const float* qp, int i,
                                          float (&q)[20]) {
  const float4* r = reinterpret_cast<const float4*>(qp) + 5LL * i;
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const float4 v = __ldg(r + u);
    q[4 * u] = v.x;
    q[4 * u + 1] = v.y;
    q[4 * u + 2] = v.z;
    q[4 * u + 3] = v.w;
  }
}

// okf of this thread's C columns in one row of cell-off bytes
template <int C>
__device__ __forceinline__ void load_ok(const uint8_t* co_row, int j0, int Wj,
                                        float (&ok)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    ok[k] = (j >= 1 && j < Wj && !__ldg(co_row + j)) ? 1.0f : 0.0f;
  }
}

// A hit's SS factors of one row at C columns j0 + sh + k (0 past Wj):
// a dense row, or table entries at the row's offset ro plus the
// columns' (entry 0 for a negative column offset).
template <int C, int SS>
__device__ __forceinline__ void ss_row(const float* dense_row,
                                       const float* lut, int ro,
                                       const int (&cof)[C], int j0, int Wj,
                                       float (&s)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    if constexpr (SS == SS_DENSE)
      s[k] = j < Wj ? __ldg(dense_row + j) : 0.0f;
    else if constexpr (SS == SS_TABLE)
      s[k] = j < Wj ? lut[cof[k] < 0 ? 0 : ro + cof[k]] : 0.0f;
    else
      s[k] = 1.0f;
  }
}

// ------------------------------------------------------------------ R1 --
// Forward rows.  fwd (B, Lq+1, Wj); scales (B, Lq+2): 1, 1, 1, then
// scale[i+1] of rows i = 2..Lq; pfwd (B,) Pforward.  C = c columns a
// thread; the SS table (SS_TABLE) in the dynamic shared memory.
template <int C, int SS>
__global__ void __launch_bounds__(T) fb_forward_kernel(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ lut, int n_lut, const int* __restrict__ roff,
    const int* __restrict__ coff, const float* __restrict__ ss0,
    const int* __restrict__ tL, int Lq, int Wj, float cs, int local,
    float* __restrict__ fwd, float* __restrict__ scales,
    float* __restrict__ pfwd_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float4 sA[2][T];
  __shared__ float2 sR[2][T];
  __shared__ float sX[2][3][T];
  __shared__ float sLc[2];
  const int b = blockIdx.x, t = threadIdx.x, j0 = t * C;
  const long long plane = (long long)(Lq + 1) * Wj;
  const uint8_t* cob = co + b * plane;
  float* fw = fwd + b * plane;
  float* scb = scales + (long long)b * (Lq + 2);
  const float s0 = ss0 ? ss0[b] : 1.0f;
  // global mode: the hit's last column, where rows above Lq exit
  const int lc = tL ? tL[b] : Wj - 1;
  if (t < 3) scb[t] = 1.0f;
  const float* ssb = SS == SS_DENSE ? ssf + b * plane : nullptr;
  const int* rob = SS == SS_TABLE ? roff + (long long)b * (Lq + 1) : nullptr;
  int cof[C];
#pragma unroll
  for (int k = 0; k < C; ++k)
    cof[k] = SS == SS_TABLE && j0 + k < Wj
                 ? coff[(long long)b * Wj + j0 + k] : -1;
  // dynamic shared memory: the profile columns (C > CREG), the SS table
  float* slut = smem + ProfCols<C>::SMEM;
  if constexpr (SS == SS_TABLE) {
    for (int e = t; e < n_lut; e += T) slut[e] = lut[e];
    __syncthreads();
  }

  // the template's columns: the profile of j, transitions of j - 1
  // (M2M, D2M, I2M, M2D, D2D) and of j (M2I, I2I); zeros outside [0, Wj)
  enum { L_MM, L_DM, L_IM, L_MD, L_DD };
  ProfCols<C> prof;
  prof.s = smem + t;
  float tl[C][5], tj[C][2];
  {
    const float* tpb = tp + (long long)b * (Wj + 1) * 20;
    const float* ttb = ttr + (long long)b * (Wj + 1) * 7;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const bool in = j < Wj, inl = j >= 1 && j - 1 < Wj;
      prof.load(tpb + j * 20, in, k);
      const float* tr = ttb + (j - 1) * 7;
      tl[k][L_MM] = inl ? __ldg(tr + M2M) : 0.0f;
      tl[k][L_DM] = inl ? __ldg(tr + D2M) : 0.0f;
      tl[k][L_IM] = inl ? __ldg(tr + I2M) : 0.0f;
      tl[k][L_MD] = inl ? __ldg(tr + M2D) : 0.0f;
      tl[k][L_DD] = inl ? __ldg(tr + D2D) : 0.0f;
      tj[k][0] = in ? __ldg(ttb + j * 7 + M2I) : 0.0f;
      tj[k][1] = in ? __ldg(ttb + j * 7 + I2I) : 0.0f;
    }
  }
  float q[20], ok[C];
  float MM[C], DG[C], MI[C], GD[C], IM[C];
  float yG[C], pG[C], yI[C], pI[C];
  float nbM, nbD, nbI, nbG, nbIm, cg, ci, rsum, rmax;

  // row 0 and row 1: MM = PF * Cshift (no SS factor); the IM and GD
  // prefix chains without the cell-off factor
  load_qrow(qp, 1, q);
  load_ok<C>(cob + Wj, j0, Wj, ok);
  float lsum = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    const float mm = ((j < Wj ? prof.dot(q, k) : 0.0f) * cs) * ok[k];
    MM[k] = mm;
    MI[k] = 0.0f;
    DG[k] = 0.0f;
    if (j < Wj) {
      fw[j] = 0.0f;
      fw[Wj + j] = mm;
    }
    lsum = k ? lsum + mm : mm;
    if (j == lc) sLc[1] = mm;
  }
  sX[1][0][t] = MM[C - 1];
  sX[1][1][t] = 0.0f;
  sX[1][2][t] = 0.0f;
  __syncthreads();
  nbM = t ? sX[1][0][t - 1] : 0.0f;
  nbD = t ? sX[1][1][t - 1] : 0.0f;
  nbI = t ? sX[1][2][t - 1] : 0.0f;
  {
    const float qmi = __ldg(qtr + 7 + M2I), qii = __ldg(qtr + 7 + I2I);
    float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float mL = k ? MM[k - 1] : nbM;
      const float tmm = tl[k][L_MM];
      const float ui = (mL * qmi) * tmm, ai = qii * tmm;
      const float ug = mL * tl[k][L_MD], ag = tl[k][L_DD];
      yg = k ? ug + ag * yg : ug;
      pg = k ? ag * pg : ag;
      yi = k ? ui + ai * yi : ui;
      pi = k ? ai * pi : ai;
      yG[k] = yg;
      pG[k] = pg;
      yI[k] = yi;
      pI[k] = pi;
    }
    sA[1][t] = float4{pg, yg, pi, yi};
    sR[1][t] = float2{lsum, 0.0f};
  }
  __syncthreads();
  scan_row<false, true>(sA[1], sR[1], cg, ci, nbG, nbIm, rsum, rmax);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    GD[k] = yG[k] + pG[k] * cg;
    IM[k] = yI[k] + pI[k] * ci;
  }
  float pfwd = local ? 1.0f + rsum : sLc[1];
  float pmin = local ? 1.0f : 0.0f;
  float scale_i = 1.0f, scale_prod = 1.0f;

  // row 2's inputs; each row loads the next one's during its scans
  float pf1[C], ssv[C];
  float qmm = 0.0f, qim = 0.0f, qdm = 0.0f, qmd = 0.0f, qdd = 0.0f;
  float qmi = 0.0f, qii = 0.0f;
  if (Lq >= 2) {
    load_qrow(qp, 2, q);
#pragma unroll
    for (int k = 0; k < C; ++k)
      pf1[k] = (j0 + k < Wj ? prof.dot(q, k) : 0.0f) * cs;
    const float* qa = qtr + 7;
    qmm = __ldg(qa + M2M);
    qim = __ldg(qa + I2M);
    qdm = __ldg(qa + D2M);
    qmd = __ldg(qa + M2D);
    qdd = __ldg(qa + D2D);
    qmi = __ldg(qa + 7 + M2I);
    qii = __ldg(qa + 7 + I2I);
    load_ok<C>(cob + 2LL * Wj, j0, Wj, ok);
    ss_row<C, SS>(ssb ? ssb + 2LL * Wj : nullptr, slut, rob ? rob[2] : 0,
                  cof, j0, Wj, ssv);
  }

  for (int i = 2; i <= Lq; ++i) {
    const int par = i & 1;
    scale_prod = scale_prod < FLUSH ? 0.0f : scale_prod * scale_i;
    const float si = scale_i;
    // the cells from the row above: the left neighbour's old MM, DG, MI
    // for the first column, then this thread's own
    float bm = nbM, bd = nbD, bi = nbI;
    float lmax = 0.0f;
    lsum = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const float pfc = SS ? pf1[k] * ssv[k] : pf1[k];
      const float tmmL = tl[k][L_MM];
      const float gL = k ? GD[k - 1] : nbG;
      const float iL = k ? IM[k - 1] : nbIm;
      const float om = MM[k], od = DG[k], oi = MI[k];
      float acc = pmin + (bm * qmm) * tmmL;
      acc = acc + (gL * qmm) * tl[k][L_DM];
      acc = acc + (iL * qim) * tmmL;
      acc = acc + (bd * qdm) * tmmL;
      acc = acc + (bi * qmm) * tl[k][L_IM];
      float mm = (pfc * si) * acc;
      if (j == 1) mm = (scale_prod * s0) * pf1[k];
      mm = mm * ok[k];
      const float dg = (si * ((om * qmd) + (od * qdd))) * ok[k];
      const float mi =
          (si * (((om * qmm) * tj[k][0]) + ((oi * qmm) * tj[k][1]))) * ok[k];
      MM[k] = mm;
      DG[k] = dg;
      MI[k] = mi;
      if (j < Wj) fw[(long long)i * Wj + j] = mm;
      const float v = j == 1 ? 0.0f : mm;
      lmax = k ? mx(lmax, v) : v;
      lsum = k ? lsum + mm : mm;
      if (j == lc) sLc[par] = mm;
      bm = om;
      bd = od;
      bi = oi;
    }
    sX[par][0][t] = MM[C - 1];
    sX[par][1][t] = DG[C - 1];
    sX[par][2][t] = MI[C - 1];
    __syncthreads();
    nbM = t ? sX[par][0][t - 1] : 0.0f;
    nbD = t ? sX[par][1][t - 1] : 0.0f;
    nbI = t ? sX[par][2][t - 1] : 0.0f;
    {
      float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float mL = k ? MM[k - 1] : nbM;
        const float tmmL = tl[k][L_MM];
        const float ug = (mL * tl[k][L_MD]) * ok[k];
        const float ag = tl[k][L_DD] * ok[k];
        const float ui = ((mL * qmi) * tmmL) * ok[k];
        const float ai = (qii * tmmL) * ok[k];
        yg = k ? ug + ag * yg : ug;
        pg = k ? ag * pg : ag;
        yi = k ? ui + ai * yi : ui;
        pi = k ? ai * pi : ai;
        yG[k] = yg;
        pG[k] = pg;
        yI[k] = yi;
        pI[k] = pi;
      }
      sA[par][t] = float4{pg, yg, pi, yi};
      sR[par][t] = float2{lsum, lmax};
    }
    __syncthreads();
    // the next row's inputs (the last row reloads its own), and its
    // profile dot, in the shadow of the scans
    const int nx = i < Lq ? i + 1 : i;
    load_qrow(qp, nx, q);
    float nq[7];
    {
      const float* qa = qtr + (long long)(nx - 1) * 7;
      nq[0] = __ldg(qa + M2M);
      nq[1] = __ldg(qa + I2M);
      nq[2] = __ldg(qa + D2M);
      nq[3] = __ldg(qa + M2D);
      nq[4] = __ldg(qa + D2D);
      nq[5] = __ldg(qa + 7 + M2I);
      nq[6] = __ldg(qa + 7 + I2I);
    }
    load_ok<C>(cob + (long long)nx * Wj, j0, Wj, ok);
    if constexpr (SS == SS_DENSE)
      ss_row<C, SS>(ssb + (long long)nx * Wj, slut, 0, cof, j0, Wj, ssv);
    if constexpr (SS == SS_TABLE)
      ss_row<C, SS>(nullptr, slut, __ldg(rob + nx), cof, j0, Wj, ssv);
#pragma unroll
    for (int k = 0; k < C; ++k)
      pf1[k] = (j0 + k < Wj ? prof.dot(q, k) : 0.0f) * cs;
    scan_row<false, true>(sA[par], sR[par], cg, ci, nbG, nbIm, rsum, rmax);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      GD[k] = yG[k] + pG[k] * cg;
      IM[k] = yI[k] + pI[k] * ci;
    }
    // Pmax over j >= 2 only (hhforwardalgorithm.cpp:139-143)
    const float scale_next = 1.0f / (mx(rmax, 0.0f) + 1.0f);
    if (local || i == Lq)
      pfwd = (pfwd + rsum) * scale_next;
    else
      pfwd = (pfwd + sLc[par]) * scale_next;
    pmin = pmin * scale_i;
    pmin = pmin < FLUSH ? 0.0f : pmin;
    if (t == 0) scb[i + 1] = scale_next;
    scale_i = scale_next;
    qmm = nq[0];
    qim = nq[1];
    qdm = nq[2];
    qmd = nq[3];
    qdd = nq[4];
    qmi = nq[5];
    qii = nq[6];
  }
  if (t == 0) pfwd_out[b] = pfwd;
}

// ------------------------------------------------------------------ R2 --
// Backward rows from Lq up to 1, each row's posterior written as it is
// done: pmm (B, Lq+1, Wj), p = fwd * bwd / Pforward on open cells, else
// 0.  A thread holds the profile of its columns' right neighbours j + 1
// (the match term's) and the transitions of its own.
template <int C, int SS>
__global__ void __launch_bounds__(T) fb_backward_kernel(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ lut, int n_lut, const int* __restrict__ roff,
    const int* __restrict__ coff, const float* __restrict__ fwd,
    const float* __restrict__ scales, const float* __restrict__ pfwd,
    const int* __restrict__ tL, int Lq, int Wj, float cs, int local,
    float* __restrict__ pmm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float4 sA[2][T];
  __shared__ float sN[2][T];
  const int b = blockIdx.x, t = threadIdx.x, j0 = t * C;
  const int W = T * C;
  const long long plane = (long long)(Lq + 1) * Wj;
  const uint8_t* cob = co + b * plane;
  const float* fw = fwd + b * plane;
  float* pb = pmm + b * plane;
  const float* scb = scales + (long long)b * (Lq + 2);
  const float P = pfwd[b];
  const float sLq1 = scb[Lq + 1];
  // column Lt's reset: the hit's last column in global mode (local mode
  // keeps the padded row's, as the JAX package; the columns past the
  // hit's are off, so its own would give the same rows)
  const int lc = tL && !local ? tL[b] : Wj - 1;
  const float* ssb = SS == SS_DENSE ? ssf + b * plane : nullptr;
  const int* rob = SS == SS_TABLE ? roff + (long long)b * (Lq + 1) : nullptr;
  // the SS columns are the match term's, j + 1
  int cof[C];
#pragma unroll
  for (int k = 0; k < C; ++k)
    cof[k] = SS == SS_TABLE && j0 + k + 1 < Wj
                 ? coff[(long long)b * Wj + j0 + k + 1] : -1;
  // dynamic shared memory: the profile columns (C > CREG), the SS table
  float* slut = smem + ProfCols<C>::SMEM;
  if constexpr (SS == SS_TABLE) {
    for (int e = t; e < n_lut; e += T) slut[e] = lut[e];
    __syncthreads();
  }

  ProfCols<C> prof;
  prof.s = smem + t;
  float tt[C][7];
  {
    const float* tpb = tp + (long long)b * (Wj + 1) * 20;
    const float* ttb = ttr + (long long)b * (Wj + 1) * 7;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      prof.load(tpb + (j + 1) * 20, j + 1 < Wj, k);
#pragma unroll
      for (int r = 0; r < 7; ++r)
        tt[k][r] = j < Wj ? __ldg(ttb + j * 7 + r) : 0.0f;
    }
  }
  float q[20], ok[C], fwv[C], pf1[C], ssv[C];
  float NM[C], ND[C], NI[C], PM[C];
  float yG[C], pG[C], yI[C], pI[C];
  float cg, ci, gR0, iR0, unused0, unused1;

  load_ok<C>(cob + (long long)Lq * Wj, j0, Wj, ok);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    const float nm = sLq1 * ok[k];
    NM[k] = nm;
    ND[k] = 0.0f;
    NI[k] = 0.0f;
    if (j < Wj) {
      pb[j] = 0.0f;
      pb[(long long)Lq * Wj + j] =
          ok[k] != 0.0f ? (__ldg(fw + (long long)Lq * Wj + j) * nm) / P
                        : 0.0f;
    }
  }
  sN[Lq & 1][t] = NM[0];
  float scale_prod = sLq1;
  float pmin = local ? sLq1 : 0.0f;
  // row Lq - 1's inputs; each row loads the next one's during its scans
  float si1 = 1.0f;
  float qmm = 0.0f, qim = 0.0f, qii = 0.0f, qmi = 0.0f, qmd = 0.0f,
        qdd = 0.0f, qdm = 0.0f;
  if (Lq >= 2) {
    const int i = Lq - 1;
    si1 = __ldg(scb + i + 1);
    load_qrow(qp, i + 1, q);
#pragma unroll
    for (int k = 0; k < C; ++k)
      pf1[k] = (j0 + k + 1 < Wj ? prof.dot(q, k) : 0.0f) * cs;
    ss_row<C, SS>(ssb ? ssb + (long long)(i + 1) * Wj + 1 : nullptr, slut,
                  rob ? rob[i + 1] : 0, cof, j0, Wj - 1, ssv);
    const float* qa = qtr + (long long)i * 7;
    qmm = __ldg(qa + M2M);
    qim = __ldg(qa + I2M);
    qii = __ldg(qa + I2I);
    qmi = __ldg(qa + M2I);
    qmd = __ldg(qa + M2D);
    qdd = __ldg(qa + D2D);
    qdm = __ldg(qa + D2M);
    load_ok<C>(cob + (long long)i * Wj, j0, Wj, ok);
#pragma unroll
    for (int k = 0; k < C; ++k)
      fwv[k] = j0 + k < Wj ? __ldg(fw + (long long)i * Wj + j0 + k) : 0.0f;
  }
  __syncthreads();
  float nbN = t < T - 1 ? sN[Lq & 1][t + 1] : 0.0f;

  for (int i = Lq - 1; i >= 1; --i) {
    const int par = i & 1;
    scale_prod = scale_prod * si1;
    scale_prod = scale_prod < FLUSH ? 0.0f : scale_prod;
    pmin = pmin * si1;
    pmin = pmin < FLUSH ? 0.0f : pmin;
    // the match term from the row below, then the reverse chains
    {
      float yg = 0.0f, pg = 0.0f, yi = 0.0f, pi = 0.0f;
#pragma unroll
      for (int k = C - 1; k >= 0; --k) {
        const int j = j0 + k;
        float pm = 0.0f;
        if (j + 1 < W) {
          const float pfc = SS ? pf1[k] * ssv[k] : pf1[k];
          pm = ((k < C - 1 ? NM[k + 1] : nbN) * pfc) * si1;
        }
        PM[k] = pm;
        const float tmm = tt[k][M2M];
        const float ug = ((pm * qmm) * tt[k][D2M]) * ok[k];
        const float ag = tt[k][D2D] * ok[k];
        const float ui = ((pm * qim) * tmm) * ok[k];
        const float ai = (qii * tmm) * ok[k];
        const bool first = k == C - 1;
        yg = first ? ug : ug + ag * yg;
        pg = first ? ag : ag * pg;
        yi = first ? ui : ui + ai * yi;
        pi = first ? ai : ai * pi;
        yG[k] = yg;
        pG[k] = pg;
        yI[k] = yi;
        pI[k] = pi;
      }
      sA[par][t] = float4{pg, yg, pi, yi};
    }
    __syncthreads();
    // the next row's inputs (row 0's after row 1: unused), and its
    // profile dot, in the shadow of the scan and the cells
    const int n = i - 1;
    const float nsi1 = __ldg(scb + n + 1);
    load_qrow(qp, n + 1, q);
    float nq[7], nok[C], nfw[C];
    {
      const float* qa = qtr + (long long)n * 7;
      nq[0] = __ldg(qa + M2M);
      nq[1] = __ldg(qa + I2M);
      nq[2] = __ldg(qa + I2I);
      nq[3] = __ldg(qa + M2I);
      nq[4] = __ldg(qa + M2D);
      nq[5] = __ldg(qa + D2D);
      nq[6] = __ldg(qa + D2M);
    }
    load_ok<C>(cob + (long long)n * Wj, j0, Wj, nok);
#pragma unroll
    for (int k = 0; k < C; ++k)
      nfw[k] = j0 + k < Wj ? __ldg(fw + (long long)n * Wj + j0 + k) : 0.0f;
    ss_row<C, SS>(ssb ? ssb + (long long)(n + 1) * Wj + 1 : nullptr, slut,
                  rob ? __ldg(rob + n + 1) : 0, cof, j0, Wj - 1, ssv);
#pragma unroll
    for (int k = 0; k < C; ++k)
      pf1[k] = (j0 + k + 1 < Wj ? prof.dot(q, k) : 0.0f) * cs;
    scan_row<true, false>(sA[par], nullptr, cg, ci, gR0, iR0, unused0,
                          unused1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      yG[k] = yG[k] + pG[k] * cg;
      yI[k] = yI[k] + pI[k] * ci;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const float pm = PM[k];
      const float gR = k < C - 1 ? yG[k + 1] : gR0;
      const float iR = k < C - 1 ? yI[k + 1] : iR0;
      const float nd = ND[k], ni = NI[k];
      const float tmm = tt[k][M2M];
      float acc = pmin + (pm * qmm) * tmm;
      acc = acc + gR * tt[k][M2D];
      acc = acc + (iR * qmi) * tmm;
      acc = acc + (nd * qmd) * si1;
      acc = acc + ((ni * qmm) * tt[k][M2I]) * si1;
      float mm = acc * ok[k];
      const float dg = (((pm * qdm) * tmm) + ((nd * qdd) * si1)) * ok[k];
      const float mi = (((pm * qmm) * tt[k][I2M]) +
                        (((ni * qmm) * tt[k][I2I]) * si1)) *
                       ok[k];
      // column Lt: the suffix starts here with the cumulative scale
      if (j == lc) mm = scale_prod * ok[k];
      NM[k] = mm;
      ND[k] = dg;
      NI[k] = mi;
      if (k == 0) sN[par][t] = mm;
      if (j < Wj)
        pb[(long long)i * Wj + j] =
            ok[k] != 0.0f ? (fwv[k] * mm) / P : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ok[k] = nok[k];
      fwv[k] = nfw[k];
    }
    si1 = nsi1;
    qmm = nq[0];
    qim = nq[1];
    qii = nq[2];
    qmi = nq[3];
    qmd = nq[4];
    qdd = nq[5];
    qdm = nq[6];
    __syncthreads();
    nbN = t < T - 1 ? sN[par][t + 1] : 0.0f;
  }
}

// ---------------------------------------------------- R1, wide rows --
// R1 for rows of more than CROW columns a thread: the row arrays in
// dynamic shared memory or the global scratch, the row's operands read
// from global memory, 20 block barriers a row.
template <int SS>
__global__ void __launch_bounds__(T) fb_forward_wide(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ lut, const int* __restrict__ roff,
    const int* __restrict__ coff, const float* __restrict__ ss0,
    const int* __restrict__ tL, int Lq, int Wj, int c, float cs, int local,
    float* scratch,
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
  const SsAt<SS> ss = ss_at<SS>(ssf, lut, roff, coff, b, Lq, Wj);
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
      const float pfc = SS ? pf1 * ss.at(i, j) : pf1;
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

// ---------------------------------------------------- R2, wide rows --
// R2 for rows of more than CROW columns a thread, as fb_forward_wide.
template <int SS>
__global__ void __launch_bounds__(T) fb_backward_wide(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const uint8_t* __restrict__ co, const float* __restrict__ ssf,
    const float* __restrict__ lut, const int* __restrict__ roff,
    const int* __restrict__ coff, const float* __restrict__ fwd,
    const float* __restrict__ scales, const float* __restrict__ pfwd,
    const int* __restrict__ tL, int Lq, int Wj, int c, float cs, int local,
    float* scratch, float* __restrict__ pmm) {
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
  const SsAt<SS> ss = ss_at<SS>(ssf, lut, roff, coff, b, Lq, Wj);
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
        const float pfc = SS ? pf1 * ss.at(i + 1, j + 1) : pf1;
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
// rows of inputs R3 has in flight
constexpr int MAC_PD = 4;

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The max-plus chain's Kogge-Stone scan of ks_maxplus, run by every warp
// over the T segment aggregates held as scan_row holds them (element l +
// 32 m in register m of lane l), each element through the same combines
// in the same order: bit-identical, no block barrier.
__device__ __forceinline__ void ks_maxplus_warp(float (&V)[NE],
                                                float (&D)[NE]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int src = (l - d) & 31;
    const bool wrap = l < d;
    float rV[NE], rD[NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      rV[m] = __shfl_sync(FULL, V[m], src, 32);
      rD[m] = __shfl_sync(FULL, D[m], src, 32);
    }
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      // the partner: register m of lane src, or across the warp's edge
      // register m - 1 (indices known at compile time: a register array
      // indexed at run time becomes a chain of selects); none before
      // element 0
      const int mo = m > 0 ? m - 1 : 0;
      const float xV = wrap ? rV[mo] : rV[m];
      const float xD = wrap ? rD[mo] : rD[m];
      if (!wrap || m > 0) {
        V[m] = mx(V[m], xV - D[m]);
        D[m] = xD + D[m];
      }
    }
  }
#pragma unroll
  for (int dm = 1; dm < NE; dm <<= 1) {
#pragma unroll
    for (int m = NE - 1; m >= dm; --m) {
      V[m] = mx(V[m], V[m - dm] - D[m]);
      D[m] = D[m - dm] + D[m];
    }
  }
}

// MAC rows, backtrace codes and the argmax for rows of C <= CROW columns
// a thread.  bmac (B, Lq+1, Wj) uint8; i2, j2 (B,) int32.  The row (S, the
// three-way maxima, the codes, the chain's running values) lives in
// registers; the row's inputs (p_mm and the cell-off bytes of columns j0
// - 1 .. j0 + C - 1) come by cp.async MAC_PD rows ahead.  A
// row publishes each segment's aggregate (its chain value and decay sum)
// in shared slots of two parities and meets one block barrier; every
// warp then scans the T aggregates itself (ks_maxplus_warp), and a
// thread rebuilds its left neighbour's final S (the IM code's S[j - 1],
// and the next row's S(i-1, j-1)) from that neighbour's aggregate and
// the scan.
template <int C>
__global__ void __launch_bounds__(T) mac_dp_kernel(
    const float* __restrict__ pmm, const uint8_t* __restrict__ co,
    const int* __restrict__ tL, int Lq, int Wj, float mact, int local,
    uint8_t* __restrict__ bmac, int* __restrict__ i2,
    int* __restrict__ j2) {
  constexpr int NW = (C + 7) / 4;  // words that hold C + 1 bytes
  __shared__ float2 sA[2][T];
  __shared__ float ring_p[MAC_PD][C][T];
  __shared__ float ring_c[MAC_PD][NW][T];
  __shared__ float red_v[T];
  __shared__ long long red_k[T];
  const int b = blockIdx.x, t = threadIdx.x, j0 = t * C;
  const long long plane = (long long)(Lq + 1) * Wj;
  const float* pb = pmm + b * plane;
  const uint8_t* cob = co + b * plane;
  uint8_t* bb = bmac + b * plane;
  const int lastcol = tL ? tL[b] : Wj - 1;
  const float half = 0.5f * mact;
  float best = -FLT_MAX;
  long long bestk = 0;
  // S of the row above in this thread's columns, and in column j0 - 1
  float S[C], nbS = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    S[k] = 0.0f;
    if (j0 + k < Wj) bb[j0 + k] = 0;
  }
  // a row's inputs, fetched MAC_PD rows ahead by cp.async into this
  // thread's own slots (read by no other thread: no barrier), one commit
  // group a row: p_mm of its C columns (zero past the row) and the
  // aligned words that hold the cell-off bytes of columns j0 - 1 .. j0 +
  // C - 1 (a word past the tensor's end copies only its bytes inside)
  const uint8_t* co_end = co + (long long)gridDim.x * plane;
  auto fetch = [&](int i) {
    if (i > Lq) {                 // past the last row: an empty group
      cp_async_commit();
      return;
    }
    const int d = i % MAC_PD;
    const float* prow = pb + (long long)i * Wj;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool in = j0 + k < Wj;
      cp_async4(&ring_p[d][k][t], in ? prow + j0 + k : pmm, in ? 4 : 0);
    }
    const uint8_t* w0 = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(cob + (long long)i * Wj + j0 - 1) &
        ~uintptr_t(3));
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const long long left = co_end - (w0 + 4 * w);
      cp_async4(&ring_c[d][w][t], w0 + 4 * w,
                left >= 4 ? 4 : left > 0 ? (int)left : 0);
    }
    cp_async_commit();
  };
  // row i's inputs from its slot: p_mm, and the cell-off byte of column
  // j0 - 1 + k (1 = off, also outside the row)
  float po[C];
  uint8_t cb[C + 1];
  auto take = [&](int i) {
    const int d = i % MAC_PD;
#pragma unroll
    for (int k = 0; k < C; ++k) po[k] = ring_p[d][k][t];
    unsigned wv[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      wv[w] = (unsigned)__float_as_int(ring_c[d][w][t]);
    const int o = (int)(reinterpret_cast<uintptr_t>(
                            cob + (long long)i * Wj + j0 - 1) & 3);
#pragma unroll
    for (int k = 0; k <= C; ++k) {
      // byte o + k of the words: in word k / 4 or the next one
      constexpr int NWm = NW - 1;
      const unsigned lo = wv[k / 4], hi = wv[k / 4 + 1 < NW ? k / 4 + 1 : NWm];
      const unsigned word = (k % 4) + o >= 4 ? hi : lo;
      const int j = j0 - 1 + k;
      const unsigned byte = (word >> (8 * ((k + o) & 3))) & 0xffu;
      cb[k] = j >= 0 && j < Wj ? (uint8_t)byte : (uint8_t)1;
    }
  };
  // row r's codes and best cells, from its final S (in S), the final S
  // of column j0 - 1 (nbr), its three-way maxima and codes, open cells
  float pMX[C];
  int pV[C];
  bool pok[C];
  auto codes = [&](int r, float nbr) {
    uint8_t* brow = bb + (long long)r * Wj;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const float t4 = (k ? S[k - 1] : nbr) - half;
      int v = t4 > pMX[k] ? IM : pV[k];
      if (!pok[k] || j == 0) v = STOP;
      if (j < Wj) brow[j] = (uint8_t)v;
      if (pok[k] && j >= 1 && (local || r == Lq || j == lastcol) &&
          S[k] > best) {
        best = S[k];
        bestk = (long long)r * Wj + j;
      }
    }
  };
  for (int i = 1; i <= MAC_PD; ++i) fetch(i);
  cp_async_wait<MAC_PD - 1>();     // row 1's group is in
  take(1);
  for (int i = 1; i <= Lq; ++i) {
    const int par = i & 1;
    float MX[C], sl[C], DL[C];
    int V[C];
    bool ok[C];
    float bS = nbS, s = 0.0f, D = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      ok[k] = j < Wj && !cb[k + 1];
      const float t1 = po[k] - mact;
      const float t2 = (bS + po[k]) - mact;
      const float t3 = S[k] - half;
      int v = t1 > t2 ? STOP : MM;
      float m = mx(t1, t2);
      v = t3 > m ? MI : v;
      m = mx(m, t3);
      MX[k] = m;
      V[k] = v;
      float mm = ok[k] ? m : -FLT_MIN;
      if (j == 0) mm = 0.0f;
      const float dec = ok[k] ? half : DECAY_OFF;
      s = k ? mx(mm, s - dec) : mm;
      D = k ? D + dec : dec;
      sl[k] = s;
      DL[k] = D;
      bS = S[k];
    }
    const bool okl = j0 >= 1 && !cb[0];
    sA[par][t] = float2{s, D};
    // row i + MAC_PD into the slot just read
    fetch(i + MAC_PD);
    __syncthreads();
    float Vv[NE], Dd[NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      const float2 a = sA[par][(t & 31) + 32 * m];
      Vv[m] = a.x;
      Dd[m] = a.y;
    }
    // the row above's codes and best cells (S still holds its final S)
    // in the shadow of this row's scan
    if (i > 1) codes(i - 1, nbS);
    ks_maxplus_warp(Vv, Dd);
    // the inclusive chain values of segments t - 1 (the carry) and t - 2
    const float v1 = elem_near<false>(Vv, t >= 1 ? t - 1 : t);
    const float v2 = elem_near<false>(Vv, t >= 2 ? t - 2 : t);
    if (i < Lq) {
      cp_async_wait<MAC_PD - 1>();   // row i + 1's group is in
      take(i + 1);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float sv = sl[k];
      if (t > 0) sv = mx(sv, v1 - DL[k]);
      sv = ok[k] ? sv : -FLT_MIN;
      if (j0 + k == 0) sv = 0.0f;
      S[k] = sv;
      pMX[k] = MX[k];
      pV[k] = V[k];
      pok[k] = ok[k];
    }
    // the left neighbour's final S in column j0 - 1, from its aggregate
    float nb = 0.0f;
    if (t > 0) {
      const float2 a = sA[par][t - 1];
      nb = a.x;
      if (t > 1) nb = mx(nb, v2 - a.y);
      nb = okl ? nb : -FLT_MIN;
      if (j0 - 1 == 0) nb = 0.0f;
    }
    nbS = nb;
  }
  codes(Lq, nbS);
  cp_async_wait<0>();
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

// ---------------------------------------------------- R3, wide rows --
// As mac_dp_kernel, for rows of more than CROW columns a thread: the row
// arrays S, DL, MX and V in dynamic shared memory or the global scratch,
// the block-wide scan (ks_maxplus), 11 barriers a row.
__global__ void __launch_bounds__(T) mac_dp_wide(
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
  const int c = (Wj + T - 1) / T;
  const long long W = (long long)T * c;
  switch (kind) {
    case 0: return c <= CROW ? 0 : 7 * W;
    case 1: return c <= CROW ? 0 : 8 * W;
    case 2: return c <= CROW ? 0 : 3 * W + (W + 3) / 4;
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

// The arguments R1 and R2 share: shapes, the SS form, the row arrays.
cudaError_t check_fb(int kind, int B, int Lq, int Wj, const float* ssf,
                     const float* lut, int n_lut, const int* roff,
                     const int* coff, const float* scratch,
                     int smem_bytes) {
  if (B < 0 || Lq < 1 || Wj < 2 || (ssf && lut) ||
      (lut && (n_lut < 1 || n_lut > SS_LUT_MAX || !roff || !coff)))
    return cudaErrorInvalidValue;
  const long long need = lane_floats(kind, Wj);
  if (need > 0 && !scratch && smem_bytes < 4 * need)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* hh_post_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of a CTA's row arrays for kernel kind 0 (R1), 1 (R2), 2 (R3) at
// a row of Wj cells: the dynamic shared bytes / 4, or a lane's share of
// the global scratch (0: R1-R3 keep their rows in registers); -1 for
// arguments the kernels do not take.
long long hh_post_lane_floats(int kind, int Wj) { return lane_floats(kind, Wj); }

// R1.  qp (Lq+2, 20), qtr (Lq+2, 7); tp (B, Wj+1, 20), ttr (B, Wj+1, 7)
// (qp and tp 16-byte aligned); co (B, Lq+1, Wj) bytes (nonzero = cell
// off); the SS factors: null, the dense ssf (B, Lq+1, Wj), or the table
// lut (n_lut <= 4096 floats) with roff (B, Lq+1) and coff (B, Wj) int32
// (the factor at (i, j): lut[coff < 0 ? 0 : roff[i] + coff[j]], offsets
// in range, not checked); ss0 (B,) or null; tL (B,) each hit's last
// column (global mode's exits; null for Wj - 1); cs = 2^shift.  Rows of
// more than 8 columns a thread (Wj > 1024): scratch null with smem_bytes
// >= 4 * hh_post_lane_floats(0, Wj), or B such slices.
int hh_post_forward(const float* qp, const float* qtr, const float* tp,
                    const float* ttr, const uint8_t* co, const float* ssf,
                    const float* lut, int n_lut, const int* roff,
                    const int* coff, const float* ss0, const int* tL, int B,
                    int Lq, int Wj, float cs, int local, float* scratch,
                    int smem_bytes, float* fwd, float* scales, float* pfwd,
                    void* stream) {
  cudaError_t e = check_fb(0, B, Lq, Wj, ssf, lut, n_lut, roff, coff,
                           scratch, smem_bytes);
  if (e != cudaSuccess) return e;
  if (B == 0) return 0;
  const int c = (Wj + T - 1) / T;
  const int ss = ssf ? SS_DENSE : lut ? SS_TABLE : SS_NONE;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c > CROW) {
#define HH_FWD_WIDE(S)                                                     \
  e = prepare(fb_forward_wide<S>, smem_bytes);                             \
  if (e != cudaSuccess) return e;                                          \
  fb_forward_wide<S><<<B, T, smem_bytes, s>>>(                             \
      qp, qtr, tp, ttr, co, ssf, lut, roff, coff, ss0, tL, Lq, Wj, c, cs,  \
      local, scratch, fwd, scales, pfwd);
    if (ss == SS_DENSE) {
      HH_FWD_WIDE(SS_DENSE)
    } else if (ss == SS_TABLE) {
      HH_FWD_WIDE(SS_TABLE)
    } else {
      HH_FWD_WIDE(SS_NONE)
    }
#undef HH_FWD_WIDE
    return cudaGetLastError();
  }
  const int lut_bytes = lut ? 4 * n_lut : 0;
#define HH_FWD(C, S)                                                       \
  {                                                                        \
    const int sm = 4 * ProfCols<C>::SMEM + lut_bytes;                      \
    e = prepare(fb_forward_kernel<C, S>, sm);                              \
    if (e != cudaSuccess) return e;                                        \
    fb_forward_kernel<C, S><<<B, T, sm, s>>>(                              \
        qp, qtr, tp, ttr, co, ssf, lut, n_lut, roff, coff, ss0, tL, Lq,    \
        Wj, cs, local, fwd, scales, pfwd);                                 \
  }
#define HH_FWD_C(C)                                                        \
  if (ss == SS_DENSE) {                                                    \
    HH_FWD(C, SS_DENSE)                                                    \
  } else if (ss == SS_TABLE) {                                             \
    HH_FWD(C, SS_TABLE)                                                    \
  } else {                                                                 \
    HH_FWD(C, SS_NONE)                                                     \
  }
  switch (c) {
    case 1: HH_FWD_C(1) break;
    case 2: HH_FWD_C(2) break;
    case 3: HH_FWD_C(3) break;
    case 4: HH_FWD_C(4) break;
    case 5: HH_FWD_C(5) break;
    case 6: HH_FWD_C(6) break;
    case 7: HH_FWD_C(7) break;
    default: HH_FWD_C(8) break;
  }
#undef HH_FWD_C
#undef HH_FWD
  return cudaGetLastError();
}

// R2.  As R1 (the SS factors in the same three forms), with R1's fwd,
// scales and pfwd; pmm (B, Lq+1, Wj); tL as R1 (the global mode's
// column-Lt reset).
int hh_post_backward(const float* qp, const float* qtr, const float* tp,
                     const float* ttr, const uint8_t* co, const float* ssf,
                     const float* lut, int n_lut, const int* roff,
                     const int* coff, const float* fwd, const float* scales,
                     const float* pfwd, const int* tL, int B, int Lq,
                     int Wj, float cs, int local, float* scratch,
                     int smem_bytes, float* pmm, void* stream) {
  cudaError_t e = check_fb(1, B, Lq, Wj, ssf, lut, n_lut, roff, coff,
                           scratch, smem_bytes);
  if (e != cudaSuccess) return e;
  if (B == 0) return 0;
  const int c = (Wj + T - 1) / T;
  const int ss = ssf ? SS_DENSE : lut ? SS_TABLE : SS_NONE;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c > CROW) {
#define HH_BWD_WIDE(S)                                                     \
  e = prepare(fb_backward_wide<S>, smem_bytes);                            \
  if (e != cudaSuccess) return e;                                          \
  fb_backward_wide<S><<<B, T, smem_bytes, s>>>(                            \
      qp, qtr, tp, ttr, co, ssf, lut, roff, coff, fwd, scales, pfwd, tL,   \
      Lq, Wj, c, cs, local, scratch, pmm);
    if (ss == SS_DENSE) {
      HH_BWD_WIDE(SS_DENSE)
    } else if (ss == SS_TABLE) {
      HH_BWD_WIDE(SS_TABLE)
    } else {
      HH_BWD_WIDE(SS_NONE)
    }
#undef HH_BWD_WIDE
    return cudaGetLastError();
  }
  const int lut_bytes = lut ? 4 * n_lut : 0;
#define HH_BWD(C, S)                                                       \
  {                                                                        \
    const int sm = 4 * ProfCols<C>::SMEM + lut_bytes;                      \
    e = prepare(fb_backward_kernel<C, S>, sm);                             \
    if (e != cudaSuccess) return e;                                        \
    fb_backward_kernel<C, S><<<B, T, sm, s>>>(                             \
        qp, qtr, tp, ttr, co, ssf, lut, n_lut, roff, coff, fwd, scales,    \
        pfwd, tL, Lq, Wj, cs, local, pmm);                                 \
  }
#define HH_BWD_C(C)                                                        \
  if (ss == SS_DENSE) {                                                    \
    HH_BWD(C, SS_DENSE)                                                    \
  } else if (ss == SS_TABLE) {                                             \
    HH_BWD(C, SS_TABLE)                                                    \
  } else {                                                                 \
    HH_BWD(C, SS_NONE)                                                     \
  }
  switch (c) {
    case 1: HH_BWD_C(1) break;
    case 2: HH_BWD_C(2) break;
    case 3: HH_BWD_C(3) break;
    case 4: HH_BWD_C(4) break;
    case 5: HH_BWD_C(5) break;
    case 6: HH_BWD_C(6) break;
    case 7: HH_BWD_C(7) break;
    default: HH_BWD_C(8) break;
  }
#undef HH_BWD_C
#undef HH_BWD
  return cudaGetLastError();
}

// R3.  pmm (B, Lq+1, Wj), co as R1; tL (B,) the global mode's last
// column per hit, or null for Wj - 1.  Rows of more than 8 columns a
// thread (Wj > 1024): scratch null with smem_bytes >= 4 *
// hh_post_lane_floats(2, Wj), or B such slices.
int hh_post_mac(const float* pmm, const uint8_t* co, const int* tL, int B,
                int Lq, int Wj, float mact, int local, float* scratch,
                int smem_bytes, uint8_t* bmac, int* i2, int* j2,
                void* stream) {
  if (B < 0 || Lq < 1 || Wj < 2) return cudaErrorInvalidValue;
  const int c = (Wj + T - 1) / T;
  if (c > CROW && !scratch && smem_bytes < 4 * lane_floats(2, Wj))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c > CROW) {
    cudaError_t e = prepare(mac_dp_wide, smem_bytes);
    if (e != cudaSuccess) return e;
    mac_dp_wide<<<B, T, smem_bytes, s>>>(pmm, co, tL, Lq, Wj, c, mact, local,
                                         scratch, bmac, i2, j2);
    return cudaGetLastError();
  }
#define HH_MAC(C)                                                          \
  mac_dp_kernel<C><<<B, T, 0, s>>>(pmm, co, tL, Lq, Wj, mact, local, bmac, \
                                   i2, j2);
  switch (c) {
    case 1: HH_MAC(1) break;
    case 2: HH_MAC(2) break;
    case 3: HH_MAC(3) break;
    case 4: HH_MAC(4) break;
    case 5: HH_MAC(5) break;
    case 6: HH_MAC(6) break;
    case 7: HH_MAC(7) break;
    default: HH_MAC(8) break;
  }
#undef HH_MAC
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
