// Hand-written Hopper (sm_90a) kernels for the HMM-HMM Viterbi search.
//
// Replaces four Pallas TPU kernels of the JAX package, and its device
// backtrace walk (plain jnp/lax there):
//   K1  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_score_lanes_fused
//       (score-only sweep, profile dot and log2 fused; si_mode fast|exact)
//       -> vit_score_kernel<FAST, SS_NONE, G> / hh_vit_score
//   K2  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_backtrace_lanes
//       (full local Viterbi with backtrace bytes, no cell-off, no SS)
//       -> vit_bt_kernel<false, false, true> / hh_vit_bt
//   K3  hhsuite_tpu/ops/viterbi_rows.py  : viterbi_batch_rows
//       (cell-off mask, optional SS term from a lookup table, local or
//       global, backtrace)
//       -> vit_bt_kernel<HAS_CO, HAS_SS, LOCAL> / hh_vit_bt
//   K6  hhsuite_tpu/ops/viterbi_lanes.py : viterbi_score_lanes
//       (score-only sweep, Si = log2f4(dot) + shift + a secondary-
//       structure term, dense or through a lookup table; f32 Si only)
//       -> vit_score_kernel<false, SS_DENSE | SS_LUT, G> / hh_vit_score
//   W1  hhsuite_tpu/ops/viterbi.py : _backtrace_walk_packed8 (:495) and
//       backtrace_walk_packed8_words (:389), driven by _walk_chunked
//       (:458): the walk from K2/K3's best cell over their backtrace
//       bytes into the packed payload
//       -> bt_walk_kernel / hh_vit_walk
//
// Exactness.  Every cell evaluates the same f32 expressions, in the same
// order, as the plain PyTorch versions beside the wrappers
// (ops/viterbi.py:viterbi_batch for K2/K3, ops/viterbi_lanes.py for K1):
// the 20-term profile dot in the reference's SSE summation tree
// (hhhit-inl.h:62-120), the log2 polynomials bit for bit, max as
// "a > b ? a : b", strict ">" updates, the best cell keyed by (score
// desc, i asc, j asc).  Built with -fmad=false (no FMA contraction) and
// never with --use_fast_math.
//
// What bounds them on the card.  Per cell: 39 FP32 operations for the dot
// (20 mul + 19 add), 10-12 for the log2 and 28 (K1) or ~45 (K2/K3, with
// the backtrace-bit compares; K3 +5 with a cell-off mask, +1 with SS)
// for the DP, K6 one more add for the SS term: 77 (K1 exact; K6 78, K1
// fast 79) to ~100 (K3) instructions a cell, all on CUDA cores.  With
// FMA contraction off every one is a separate instruction, so the ceiling
// is the card's f32 instruction rate, 132 SMs x 128 lanes x 1.98 GHz =
// 33.5e12/s (the published 67 TFLOP/s counts an FMA as two).  K2/K3
// write one backtrace byte a cell (K3 reads one cell-off byte): ~1-2
// B/cell against 3.35 TB/s, so the work is instruction-bound; K1/K6 move
// only the profiles (~0.4 B a cell at Lq = 320; K6's dense SS matrix 4 B
// a cell).
//
// Design, all four: a warp-wide wavefront per template (wave_sweep).  A
// group of G lanes (G = 8, 16 or 32, chosen per launch by
// ops/viterbi_lanes.py: bt_geometry for K2/K3, score_geometry for K1/K6)
// owns one template; lane k holds BT_R = 8 consecutive query rows of a
// pass of G x BT_R rows, their five states in registers.  At step s lane
// k computes template column j = s - k + 1: the row above its strip
// (lane k-1's last row at column j) and the diagonal (the same at column
// j-1, kept from the step before) arrive by __shfl_up_sync; lane 0 takes
// the pass boundary: row 0, or the previous pass's last row, which lane
// G-1 left in a per-template scratch row [Lt+1][5] (an L2 round trip of
// 5 floats a column per pass).  Fill and drain cost G-1 steps a pass.  A
// block of 256 threads holds 256/G templates, so B = 1024 templates at G
// = 32 fill 8 warps on each of 128 SMs.  The pass's query rows (profile,
// the transitions a cell reads, the SS table offset: 28 floats a row)
// sit in shared memory, each lane's 8 rows at a stride of 228 words, so
// that the lanes of a warp read distinct banks.  Template columns (tp
// [Lt+2][20][B], ttr [Lt+2][7][B], the SS offsets tidx [Lt][B]: the
// resident pack's lanes-last layout, coalesced along b) are staged by
// cp.async in chunks of G columns into a ring of three chunks: chunk m+1
// loads while the block computes chunk m, and chunk m-1 stays for the
// lanes behind (lane k reads column s - k + 1).  The ring's column stride
// is padded so the G lanes of a group, each on its own column, hit
// distinct banks.  The SS table (<= 1,936 floats) sits in shared memory.
//
// What differs between the kernels is the cell and what is kept.  K2/K3
// (vit_bt_kernel): the boundary -j*pt on row 0 and -i*pq on column 0,
// viterbi_batch's five-candidate code chain, the backtrace bytes and the
// cell-off mask laid out [B][Lt+1][Wq], row i at byte BT_ROW0 + i of a
// column, Wq = Lq + 8 rounded up to 16 (a lane writes its 8 bytes of a
// column with one 8-byte store and reads its 8 cell-off bytes with one
// load), and the best cell, reduced by __shfl_xor_sync under the (score,
// i, j) key.  K1/K6 (vit_score_kernel): MM +0 on row 0 and column 0, K1's
// two max trees, the fast or exact log2, no stores but the group's
// maximum (__shfl_xor_sync); K6's dense SS matrix is read where the
// caller has it, (B, Lq+1, Lt+1) row-major, one load a cell (no speed is
// asked of it: the search passes the table).  The score kernel takes G
// as a template parameter: the ring's modulo, the block's template count
// and the column stride become constants.
//
// What is left.  A K1/K6 thread holds ~145 registers (40 states, the
// 20-float template column, a query row in flight), so a block of 256
// threads has its SM alone (8 warps).  K1/K6 run at about a quarter of
// the f32 rate (PERF.md); with two warps on each scheduler and each cell
// a dependent chain of f32 operations, issue latency is the likely limit
// (no counter of the card's pipelines is read here); each cell also
// reads its query row from shared memory (7 16-byte loads, no broadcast
// between groups at G = 32).  Queries longer than G x 8 rows pay G-1
// fill and drain steps and the scratch round trip a pass.
//
// W1 (bt_walk_kernel) is one thread a lane in blocks of 128, R4's form
// (csrc/posterior.cu:mac_walk_kernel).  Its work is a chain of dependent
// byte loads, one a step, a few hundred a lane, from backtrace bytes that
// at the hot path's batch (B = 4096, Lq = 320, Lt = 384: ~530 MB) lie
// far outside L2; the bytes it must move are the payload and one byte a
// step (~5 MB), so its time is the latency of the longest chains, not
// the bound.  It never waits on the host: every lane stops at STOP or at
// kmax.  Its payload stores are one byte a thread and step, a row apart
// across the warp; staging them in shared memory or a warp per group of
// lanes is later work.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int M2M = 0, M2I = 1, M2D = 2, I2M = 3, I2I = 4, D2M = 5, D2D = 6;
constexpr int STOP = 0, MM = 2, GD = 3, IM = 4, DG = 5, MI = 6;
constexpr float NEG = -FLT_MAX;
// the SS term: none, dense ss[b][i][j], or lut[qidx[i-1] + tidx[j-1][b]]
constexpr int SS_NONE = 0, SS_DENSE = 1, SS_LUT = 2;
constexpr int SS_LUT_MAX = 4 * 11 * 4 * 11;  // S33: NSSPRED x MAXCF squared

// the wavefront (see the design note above; ops/viterbi_lanes.py
// mirrors BT_THREADS and BT_R, ops/viterbi.py BT_ROW0 and bt_col_bytes)
constexpr int BT_THREADS = 256;  // threads per block: 256 / G templates
constexpr int BT_R = 8;          // query rows per lane
constexpr int BT_ROW0 = 7;       // byte of row 0 in a bt / cell-off column
constexpr int BT_QF = 28;        // floats per staged query row
constexpr int BT_QB = BT_R * BT_QF + 4;  // words per lane's rows (228)
constexpr int BT_TF = 28;        // words per staged template column
constexpr int BT_SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

// words between two template columns of the ring: BT_TF words of each of
// the block's 256 / G templates, padded to 32 / G mod 32 so that the G
// lanes of a group (one column each) and the 32 / G groups of a warp
// read 32 distinct banks
__host__ __device__ constexpr int bt_col_stride(int G) {
  return BT_TF * (BT_THREADS / G)
         + ((32 / G - BT_TF * (BT_THREADS / G)) % 32 + 32) % 32;
}

__host__ __device__ constexpr int bt_smem_bytes(int G, bool ss) {
  return 4 * ((ss ? SS_LUT_MAX : 0) + G * BT_QB + 3 * G * bt_col_stride(G));
}

// bytes per backtrace / cell-off column: rows 0..Lq at BT_ROW0 + i, and
// the 8-byte word of the last lane, rounded up to 16
__host__ __device__ constexpr int bt_col_bytes(int Lq) {
  return (Lq + 8 + 15) / 16 * 16;
}

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

// (s, i, j) before (best, bi, bj) under the key (score desc, i asc, j asc)
__device__ __forceinline__ bool bt_better(float s, int i, int j, float best,
                                          int bi, int bj) {
  return s > best || (s == best && (i < bi || (i == bi && j < bj)));
}

// Stage template columns m*G .. m*G+G-1 of the block's templates into
// ring slot m % 3: word (column, field, group) = tp (fields 0-19), ttr
// (20-26) and, with the SS table, the SS offset of column j-1 (27).
// Columns past Lt and lanes past B are zero-filled.
template <bool HAS_SS>
__device__ __forceinline__ void bt_stage(float* s_t, int m, int G, int NG,
                                         int TS, int b0, int B, int Lt,
                                         const float* __restrict__ tp,
                                         const float* __restrict__ ttr,
                                         const int* __restrict__ tidx) {
  constexpr int NF = HAS_SS ? 28 : 27;
  float* dst = s_t + (m % 3) * G * TS;
  const int c0 = m * G;
  for (int e = threadIdx.x; e < G * NF * NG; e += BT_THREADS) {
    const int gg = e % NG, f = (e / NG) % NF, cc = e / (NG * NF);
    const int c = c0 + cc, bb = b0 + gg;
    bool ok = bb < B && c <= Lt;
    const void* src;
    if (f < 20) {
      src = tp + ((size_t)c * 20 + f) * B + bb;
    } else if (f < 27) {
      src = ttr + ((size_t)c * 7 + (f - 20)) * B + bb;
    } else {
      ok = ok && c >= 1;
      src = tidx + (size_t)(c - 1) * B + bb;
    }
    cp_async4(dst + cc * TS + f * NG + gg, ok ? src : (const void*)tp,
              ok ? 4 : 0);
  }
}

// ------------------------------------------------------------ wavefront --
// One sweep of the wavefront (design note above).  SCORE: K1/K6, the best
// local score per template with egq = egt = 0: MM is +0 on row 0 and
// column 0, the other states -FLT_MAX; K1's own arithmetic
// (viterbi_lanes.py:537-552), the five MM candidates factored into two
// max trees; Si = log2_quartic(dot, shift) (FAST: shift is the caller's
// shift - 127) or log2f4(dot) + shift, plus, in every cell (K6),
// ss[b][i][j] (SS_DENSE) or lut[qidx[i-1] + tidx[j-1][b]] (SS_LUT);
// padded template columns (zero profile, zero table offset) score as in
// the plain version, their -FLT_MAX transitions keeping them from
// extending a real path; out: score (B,).  !SCORE: K2/K3, the contract
// of ops/viterbi.py:viterbi_batch (hhviterbialgorithm.cpp:45-497): MM is
// -j*pt on row 0 and -i*pq on column 0; each cell adds the cell-off term
// (0 or -FLT_MAX) after the max when HAS_CO; with SS_LUT, Si gains
// lut[qidx[i-1] + tidx[j-1][b]] for 1 <= j <= t_L[b] and 0 elsewhere (the
// values build_ss_score writes); backtrace byte = MM predecessor code
// (bits 0-2) | GD/IM/DG/MI opened from MM (bits 3-6).  The best cell is
// taken over rows i <= Lq_true (global mode: last row Lq_true or the
// template's true last column), keyed by (score desc, i asc, j asc); out:
// score, i2, j2, bt.  GT: the group width as a constant (K1/K6), or 0 to
// take G_arg (K2/K3).
template <bool SCORE, bool FAST, bool HAS_CO, int SS, bool LOCAL, int GT>
__device__ __forceinline__ void wave_sweep(
    const float* __restrict__ qp, const float* __restrict__ qtr,
    const float* __restrict__ tp, const float* __restrict__ ttr,
    const int* __restrict__ t_L, const uint8_t* __restrict__ co,
    const float* __restrict__ ss, const float* __restrict__ lut, int n_lut,
    const int* __restrict__ qidx, const int* __restrict__ tidx, int B,
    int Lq, int Lt, int Lq_true, float shift, float pq, float pt, int G_arg,
    float* __restrict__ scratch, float* __restrict__ score,
    int* __restrict__ i2, int* __restrict__ j2, uint8_t* __restrict__ bt) {
  static_assert(!SCORE || (!HAS_CO && LOCAL), "K1/K6: local, no cell-off");
  static_assert(SCORE || (!FAST && SS != SS_DENSE),
                "K2/K3: exact log2, SS from the table");
  static_assert(!(FAST && SS != SS_NONE), "K6 uses the exact log2");
  constexpr bool LUT = SS == SS_LUT;
  extern __shared__ __align__(16) float smem[];
  const int G = GT ? GT : G_arg;
  const int NG = BT_THREADS / G;
  const int TS = bt_col_stride(G);
  const int RING = 3 * G;
  const int GR = G * BT_R;
  const int Wq = bt_col_bytes(Lq);
  float* s_lut = smem;
  float* s_q = smem + (LUT ? SS_LUT_MAX : 0);
  float* s_t = s_q + G * BT_QB;
  const int k = threadIdx.x % G;      // lane of the group
  const int g = threadIdx.x / G;      // group (template) of the block
  const int b0 = blockIdx.x * NG;
  const int b = b0 + g;
  const bool live = b < B;
  const int tL = !SCORE && live ? t_L[b] : 0;
  const float smin = LOCAL ? 0.0f : NEG;
  const int passes = (Lq + GR - 1) / GR;
  const size_t col0 = (size_t)(live ? b : 0) * (Lt + 1);
  uint8_t* btb = SCORE ? nullptr : bt + col0 * Wq;
  const uint8_t* cob = HAS_CO ? co + col0 * Wq : nullptr;
  float* scb = scratch ? scratch + col0 * 5 : nullptr;
  const float* ssb = SS == SS_DENSE ? ss + col0 * (Lq + 1) : nullptr;

  if constexpr (LUT)
    for (int e = threadIdx.x; e < n_lut; e += BT_THREADS) s_lut[e] = lut[e];
  if (!SCORE && live)   // column 0 of the backtrace bytes
    for (int w = k; w < Wq / 8; w += G)
      reinterpret_cast<unsigned long long*>(btb)[w] = 0ull;

  float best = NEG;
  int bi = 0, bj = 0;
  for (int p = 0; p < passes; ++p) {
    const int base = p * GR;        // the row above the pass
    const int i0 = base + k * BT_R + 1;
    const bool has_next = p + 1 < passes;
    cp_async_wait<0>();
    __syncthreads();                // the last pass is done with s_q, s_t
    // the pass's query rows: qp[i], the five transitions of row i-1 and
    // the two of row i that a cell reads, and the SS offset of row i
    for (int e = threadIdx.x; e < GR * BT_QF; e += BT_THREADS) {
      const int rr = e / BT_QF, f = e % BT_QF, i = base + rr + 1;
      float v = 0.0f;
      if (i <= Lq) {
        if (f < 20) {
          v = qp[(size_t)i * 20 + f];
        } else if (f < 25) {
          const int c = f == 20 ? M2M : f == 21 ? I2M : f == 22 ? D2M
                        : f == 23 ? M2D : D2D;
          v = qtr[(size_t)(i - 1) * 7 + c];
        } else if (f < 27) {
          v = qtr[(size_t)i * 7 + (f == 25 ? M2I : I2I)];
        } else if (LUT) {
          v = __int_as_float(qidx[i - 1]);
        }
      }
      s_q[(rr / BT_R) * BT_QB + (rr % BT_R) * BT_QF + f] = v;
    }
    bt_stage<LUT>(s_t, 0, G, NG, TS, b0, B, Lt, tp, ttr, tidx);
    cp_async_commit();
    if (G <= Lt) bt_stage<LUT>(s_t, 1, G, NG, TS, b0, B, Lt, tp, ttr, tidx);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // the strip's states at column j-1 (column 0 boundary to start)
    float cmm[BT_R], cgd[BT_R], cim[BT_R], cdg[BT_R], cmi[BT_R];
#pragma unroll
    for (int r = 0; r < BT_R; ++r) {
      cmm[r] = SCORE ? 0.0f : __fmul_rn(-(float)(i0 + r), pq);
      cgd[r] = cim[r] = cdg[r] = cmi[r] = NEG;
    }
    // the strip's last row at the lane's current column, for lane k+1
    float omm = cmm[BT_R - 1], ogd = NEG, oim = NEG, odg = NEG, omi = NEG;
    // the row above the strip at column j-1 (lane 0: the pass boundary at
    // column 0; the other lanes get theirs from lane k-1 before use)
    float pmm = SCORE ? 0.0f
                : base == 0 ? __fmul_rn(-0.0f, pt)
                            : __fmul_rn(-(float)base, pq);
    float pgd = NEG, pim = NEG, pdg = NEG, pmi = NEG;
    const float* qlane = s_q + k * BT_QB;
    const bool rows_on = i0 <= Lq;
    for (int s = 0; s < Lt + G - 1; ++s) {
      if (s % G == G - 1) {         // column s + 1 opens chunk m
        const int m = (s + 1) / G;
        cp_async_wait<0>();
        __syncthreads();
        if ((m + 1) * G <= Lt)
          bt_stage<LUT>(s_t, m + 1, G, NG, TS, b0, B, Lt, tp, ttr, tidx);
        cp_async_commit();
      }
      const int j = s - k + 1;
      // the row above the strip at column j
      float vmm = __shfl_up_sync(FULL, omm, 1, G);
      float vgd = __shfl_up_sync(FULL, ogd, 1, G);
      float vim = __shfl_up_sync(FULL, oim, 1, G);
      float vdg = __shfl_up_sync(FULL, odg, 1, G);
      float vmi = __shfl_up_sync(FULL, omi, 1, G);
      if (k == 0) {
        if (base == 0) {
          vmm = SCORE ? 0.0f : __fmul_rn(-(float)j, pt);
          vgd = vim = vdg = vmi = NEG;
        } else if (live && j <= Lt) {
          const float* sc = scb + (size_t)j * 5;
          vmm = sc[0]; vgd = sc[1]; vim = sc[2]; vdg = sc[3]; vmi = sc[4];
        }
      }
      if (j >= 1 && j <= Lt) {
        const float* tc = s_t + (j % RING) * TS + g;
        const float* tq = s_t + ((j - 1) % RING) * TS + g;
        float tcol[20];
#pragma unroll
        for (int a = 0; a < 20; ++a) tcol[a] = tc[a * NG];
        const float tm2m = tq[(20 + M2M) * NG], td2m = tq[(20 + D2M) * NG];
        const float ti2m = tq[(20 + I2M) * NG], tm2d = tq[(20 + M2D) * NG];
        const float td2d = tq[(20 + D2D) * NG];
        const float tm2i = tc[(20 + M2I) * NG], ti2i = tc[(20 + I2I) * NG];
        const int tj = LUT ? __float_as_int(tc[27 * NG]) : 0;
        const bool ss_on = j <= tL;
        unsigned long long cobits = 0ull, btbits = 0ull;
        if (HAS_CO && live && rows_on)
          cobits = *reinterpret_cast<const unsigned long long*>(
              cob + (size_t)j * Wq + BT_ROW0 + i0);
        float dmm = pmm, dgd = pgd, dim = pim, ddg = pdg, dmi = pmi;
        float umm = vmm, ugd = vgd, uim = vim, udg = vdg, umi = vmi;
#pragma unroll
        for (int r = 0; r < BT_R; ++r) {
          const int i = i0 + r;
          const float* qr = qlane + r * BT_QF;
          float q[BT_QF];
#pragma unroll
          for (int v = 0; v < BT_QF / 4; ++v) {
            const float4 x = reinterpret_cast<const float4*>(qr)[v];
            q[4 * v] = x.x; q[4 * v + 1] = x.y;
            q[4 * v + 2] = x.z; q[4 * v + 3] = x.w;
          }
          const float qm2m = q[20], qi2m = q[21], qd2m = q[22];
          const float qm2d = q[23], qd2d = q[24], qm2i = q[25], qi2i = q[26];
          const float lmm = cmm[r], lgd = cgd[r], lim = cim[r];
          const float ldg = cdg[r], lmi = cmi[r];
          float mm, gd, im, dg, mi;
          if constexpr (SCORE) {
            const float dot = dot20(q, tcol);
            float si = FAST ? log2_quartic(dot, shift)
                            : __fadd_rn(log2f4(dot), shift);
            if constexpr (LUT)
              si = __fadd_rn(si, s_lut[__float_as_int(q[27]) + tj]);
            if constexpr (SS == SS_DENSE)   // rows past Lq are never read
              si = __fadd_rn(si, i <= Lq ? ssb[(size_t)i * (Lt + 1) + j]
                                         : 0.0f);
            float t_a = fmax_(dmm + qm2m, dim + qi2m);
            t_a = fmax_(t_a, ddg + qd2m) + tm2m;
            const float t_b = fmax_(dgd + td2m, dmi + ti2m) + qm2m;
            mm = fmax_(fmax_(0.0f, t_a), t_b) + si;
            dg = fmax_(umm + qm2d, udg + qd2d);
            mi = fmax_(umm + tm2i, umi + ti2i) + qm2m;
            gd = fmax_(lmm + tm2d, lgd + td2d);
            im = fmax_(lmm + qm2i, lim + qi2i) + tm2m;
            if (i <= Lq) best = fmax_(best, mm);
          } else {
            float si = __fadd_rn(log2f4(dot20(q, tcol)), shift);
            if (LUT)
              si = si + (ss_on ? s_lut[__float_as_int(q[27]) + tj] : 0.0f);
            const float cof = HAS_CO && ((cobits >> (8 * r)) & 0xffull)
                                  ? NEG : 0.0f;
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
            mm = best5 + si;
            // DG/MI: predecessors at (i-1, j)
            const float a_dg = umm + qm2d, b_dg = udg + qd2d;
            dg = fmax_(a_dg, b_dg);
            const float a_mi = (umm + qm2m) + tm2i;
            const float b_mi = (umi + qm2m) + ti2i;
            mi = fmax_(a_mi, b_mi);
            // GD/IM: predecessors at (i, j-1)
            const float a_gd = lmm + tm2d, b_gd = lgd + td2d;
            gd = fmax_(a_gd, b_gd);
            const float a_im = (lmm + qm2i) + tm2m;
            const float b_im = (lim + qi2i) + tm2m;
            im = fmax_(a_im, b_im);
            if (HAS_CO) {
              mm = mm + cof;
              dg = dg + cof;
              mi = mi + cof;
              gd = gd + cof;
              im = im + cof;
            }
            btbits |= (unsigned long long)(code | (a_gd > b_gd ? 8 : 0)
                                           | (a_im > b_im ? 16 : 0)
                                           | (a_dg > b_dg ? 32 : 0)
                                           | (a_mi > b_mi ? 64 : 0))
                      << (8 * r);
            if (i <= Lq_true && (LOCAL || j == tL || i == Lq_true)
                && bt_better(mm, i, j, best, bi, bj)) {
              best = mm;
              bi = i;
              bj = j;
            }
          }
          dmm = lmm; dgd = lgd; dim = lim; ddg = ldg; dmi = lmi;
          umm = mm; ugd = gd; uim = im; udg = dg; umi = mi;
          cmm[r] = mm; cgd[r] = gd; cim[r] = im; cdg[r] = dg; cmi[r] = mi;
        }
        if (!SCORE && live && rows_on) {
          uint8_t* col = btb + (size_t)j * Wq;
          *reinterpret_cast<unsigned long long*>(col + BT_ROW0 + i0) = btbits;
          if (i0 == 1)              // the word holding row 0
            *reinterpret_cast<unsigned long long*>(col) = 0ull;
        }
        omm = umm; ogd = ugd; oim = uim; odg = udg; omi = umi;
        if (has_next && k == G - 1 && live) {
          float* sc = scb + (size_t)j * 5;
          sc[0] = umm; sc[1] = ugd; sc[2] = uim; sc[3] = udg; sc[4] = umi;
        }
      }
      pmm = vmm; pgd = vgd; pim = vim; pdg = vdg; pmi = vmi;
    }
  }
  if constexpr (SCORE) {
    // the group's maximum
    for (int off = G / 2; off > 0; off >>= 1)
      best = fmax_(best, __shfl_xor_sync(FULL, best, off, G));
    if (live && k == 0) score[b] = fmax_(best, NEG);
  } else {
    // the group's best cell
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off, G);
      const int oi = __shfl_xor_sync(FULL, bi, off, G);
      const int oj = __shfl_xor_sync(FULL, bj, off, G);
      if (bt_better(ob, oi, oj, best, bi, bj)) {
        best = ob;
        bi = oi;
        bj = oj;
      }
    }
    if (live && k == 0) {
      score[b] = best;
      i2[b] = bi;
      j2[b] = bj;
    }
  }
}

template <bool HAS_CO, bool HAS_SS, bool LOCAL>
__global__ void __launch_bounds__(BT_THREADS)
vit_bt_kernel(const float* __restrict__ qp, const float* __restrict__ qtr,
              const float* __restrict__ tp, const float* __restrict__ ttr,
              const int* __restrict__ t_L, const uint8_t* __restrict__ co,
              const float* __restrict__ lut, int n_lut,
              const int* __restrict__ qidx, const int* __restrict__ tidx,
              int B, int Lq, int Lt, int Lq_true, float shift, float pq,
              float pt, int G, float* __restrict__ scratch,
              float* __restrict__ score, int* __restrict__ i2,
              int* __restrict__ j2, uint8_t* __restrict__ bt) {
  wave_sweep<false, false, HAS_CO, HAS_SS ? SS_LUT : SS_NONE, LOCAL, 0>(
      qp, qtr, tp, ttr, t_L, co, nullptr, lut, n_lut, qidx, tidx, B, Lq, Lt,
      Lq_true, shift, pq, pt, G, scratch, score, i2, j2, bt);
}

// One block of 256 threads an SM: a thread holds ~145 registers, more
// than the 128 that a second block would leave it.
template <bool FAST, int SS, int G>
__global__ void __launch_bounds__(BT_THREADS, 1)
vit_score_kernel(const float* __restrict__ qp, const float* __restrict__ qtr,
                 const float* __restrict__ tp, const float* __restrict__ ttr,
                 const float* __restrict__ ss, const float* __restrict__ lut,
                 int n_lut, const int* __restrict__ qidx,
                 const int* __restrict__ tidx, int B, int Lq, int Lt,
                 float sh, float* __restrict__ scratch,
                 float* __restrict__ out) {
  wave_sweep<true, FAST, false, SS, true, G>(
      qp, qtr, tp, ttr, nullptr, nullptr, ss, lut, n_lut, qidx, tidx, B, Lq,
      Lt, Lq, sh, 0.0f, 0.0f, G, scratch, out, nullptr, nullptr, nullptr);
}

template <bool FAST, int SS, int G>
int launch_score(int smem, cudaStream_t stream, const float* qp,
                 const float* qtr, const float* tp, const float* ttr,
                 const float* ss, const float* lut, int n_lut,
                 const int* qidx, const int* tidx, int B, int Lq, int Lt,
                 float sh, float* scratch, float* out) {
  auto kern = vit_score_kernel<FAST, SS, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int ng = BT_THREADS / G;
  kern<<<(B + ng - 1) / ng, BT_THREADS, smem, stream>>>(
      qp, qtr, tp, ttr, ss, lut, n_lut, qidx, tidx, B, Lq, Lt, sh, scratch,
      out);
  return (int)cudaGetLastError();
}

template <bool HAS_CO, bool HAS_SS, bool LOCAL>
int launch_bt(int G, int smem, cudaStream_t stream, const float* qp,
              const float* qtr, const float* tp, const float* ttr,
              const int* t_L, const uint8_t* co, const float* lut, int n_lut,
              const int* qidx, const int* tidx, int B, int Lq, int Lt,
              int Lq_true, float shift, float pq, float pt, float* scratch,
              float* score, int* i2, int* j2, uint8_t* bt) {
  auto kern = vit_bt_kernel<HAS_CO, HAS_SS, LOCAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ng = BT_THREADS / G;
  kern<<<(B + ng - 1) / ng, BT_THREADS, smem, stream>>>(
      qp, qtr, tp, ttr, t_L, co, lut, n_lut, qidx, tidx, B, Lq, Lt, Lq_true,
      shift, pq, pt, G, scratch, score, i2, j2, bt);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ W1 --
// The backtrace walk, one thread a lane: from (i2, j2) in state MM over at
// most kmax steps, the step rules of ops/viterbi.py:
// backtrace_walk_packed8_plain (src/hhviterbi.cpp:83-160).  A step
// records the state; it is blocked when the state moves neither i nor j
// (STOP, the unused codes 1 and 7) or would cross row or column 1, and a
// blocked step turns the state into STOP; else the byte at (i, j) gives
// MM's next state (bits 0-2) or takes a gap state back to MM (its bit,
// 8 << (state - GD)), and i and j move.  bt is read in place through
// three byte strides.  The thread writes its own payload row: score f32,
// i2 int16, j2 int16, n int32 (the steps recorded before STOP),
// st[kmax] with zeros after the last recorded step; little-endian.
constexpr int WALK_THREADS = 128;

__global__ void __launch_bounds__(WALK_THREADS) bt_walk_kernel(
    const uint8_t* __restrict__ bt, long long sb, long long si,
    long long sj, const int* __restrict__ i2, const int* __restrict__ j2,
    const float* __restrict__ score, int B, int kmax,
    uint8_t* __restrict__ out) {
  const int b = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (b >= B) return;
  const uint8_t* bb = bt + b * sb;
  uint8_t* o = out + (long long)b * (12 + kmax);
  int i = i2[b], j = j2[b], s = MM, n = 0, k = 0;
  for (; k < kmax && s != STOP; ++k) {
    o[12 + k] = (uint8_t)s;
    ++n;
    const bool di = s == MM || s == DG || s == MI;
    const bool dj = s == MM || s == GD || s == IM;
    if ((!di && !dj) || (di && i <= 1) || (dj && j <= 1)) {
      s = STOP;
      continue;
    }
    const int c = bb[i * si + j * sj];
    s = s == MM ? (c & 7) : (c & (8 << (s - GD))) ? MM : s;
    i -= di;
    j -= dj;
  }
  for (; k < kmax; ++k) o[12 + k] = 0;
  const float sc = score[b];
  const int16_t hi = (int16_t)i2[b], hj = (int16_t)j2[b];
  memcpy(o, &sc, 4);
  memcpy(o + 4, &hi, 2);
  memcpy(o + 6, &hj, 2);
  memcpy(o + 8, &n, 4);
}

}  // namespace

extern "C" {

const char* hh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of one wavefront block (K1/K6 and K2/K3) at group
// width G (ss: with the SS table), or -1 for a width the kernels do not
// take.
int hh_bt_smem_bytes(int G, int ss) {
  if (G != 8 && G != 16 && G != 32) return -1;
  return bt_smem_bytes(G, ss != 0);
}

// Words between two template columns of a wavefront block's ring at
// group width G, or -1 for a width the kernels do not take.
int hh_bt_col_stride(int G) {
  if (G != 8 && G != 16 && G != 32) return -1;
  return bt_col_stride(G);
}

// K1 and K6.  qp (Lq+2, 20), qtr (Lq+2, 7), tp [Lt+2][20][B], ttr
// [Lt+2][7][B] f32; K6's SS term (exact only, one form or none): ss
// [B][Lq+1][Lt+1] f32, or the table lut (n_lut <= 1936) f32 with qidx
// (Lq,) i32 and tidx [Lt][B] i32 (0 <= qidx[i] + tidx[j][b] < n_lut, not
// checked).  sh = shift (exact) or shift - 127 (fast).  G lanes a
// template (8, 16 or 32: ops/viterbi_lanes.py:score_geometry), BT_R rows
// a lane, ceil(Lq / (G*BT_R)) passes; scratch [B][Lt+1][5] f32 when there
// is more than one pass.  Out: out (B,) f32.  Returns the cudaError_t of
// the launch, cudaErrorInvalidValue for arguments the kernel does not
// take.
int hh_vit_score(const float* qp, const float* qtr, const float* tp,
                 const float* ttr, const float* ss, const float* lut,
                 int n_lut, const int* qidx, const int* tidx, int B, int Lq,
                 int Lt, float sh, int fast, int G, float* scratch,
                 float* out, void* stream) {
  if (B <= 0) return 0;
  const int smem = hh_bt_smem_bytes(G, lut != nullptr);
  if (smem < 0 || smem > BT_SMEM_MAX || Lq < 1 || Lt < 1
      || (Lq > G * BT_R && !scratch) || (ss && lut) || (fast && (ss || lut))
      || (lut && (n_lut <= 0 || n_lut > SS_LUT_MAX || !qidx || !tidx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HH_SCORE(F, S, W)                                                 \
  return launch_score<F, S, W>(smem, s, qp, qtr, tp, ttr, ss, lut, n_lut, \
                               qidx, tidx, B, Lq, Lt, sh, scratch, out)
#define HH_SCORE_G(W)                     \
  if (G == W) {                           \
    if (fast) HH_SCORE(true, SS_NONE, W); \
    if (ss) HH_SCORE(false, SS_DENSE, W); \
    if (lut) HH_SCORE(false, SS_LUT, W);  \
    HH_SCORE(false, SS_NONE, W);          \
  }
  HH_SCORE_G(8)
  HH_SCORE_G(16)
  HH_SCORE_G(32)
#undef HH_SCORE_G
#undef HH_SCORE
  return (int)cudaErrorInvalidValue;
}

// K2 (co = lut = NULL, local = 1) and K3.  qp (Lq+2, 20), qtr (Lq+2, 7),
// tp [Lt+2][20][B], ttr [Lt+2][7][B] f32, t_L (B,) i32; co [B][Lt+1][Wq]
// u8 (row i of column j at byte j*Wq + BT_ROW0 + i, Wq = bt_col_bytes(Lq))
// or NULL; the SS table lut (n_lut <= 1936) f32 with qidx (Lq,) i32 and
// tidx [Lt][B] i32 (0 <= qidx[i] + tidx[j][b] < n_lut, not checked), or
// lut = NULL.  G lanes a template (8, 16 or 32: ops/viterbi_lanes.py:
// bt_geometry), BT_R rows a lane, ceil(Lq / (G*BT_R)) passes; scratch
// [B][Lt+1][5] f32 when there is more than one pass.  Out: score (B,)
// f32, i2/j2 (B,) i32, bt [B][Lt+1][Wq] u8 (rows 0..Lq of every column
// written).  Returns the cudaError_t of the launch, cudaErrorInvalidValue
// for arguments the kernel does not take.
int hh_vit_bt(const float* qp, const float* qtr, const float* tp,
              const float* ttr, const int* t_L, const uint8_t* co,
              const float* lut, int n_lut, const int* qidx, const int* tidx,
              int B, int Lq, int Lt, int Lq_true, int local, float shift,
              float pq, float pt, int G, float* scratch, float* score,
              int* i2, int* j2, uint8_t* bt, void* stream) {
  if (B <= 0) return 0;
  const int smem = hh_bt_smem_bytes(G, lut != nullptr);
  if (smem < 0 || smem > BT_SMEM_MAX || Lq < 1 || Lt < 1 || Lq_true < 0
      || Lq_true > Lq || (Lq > G * BT_R && !scratch)
      || (lut && (n_lut <= 0 || n_lut > SS_LUT_MAX || !qidx || !tidx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sel = (co ? 4 : 0) | (lut ? 2 : 0) | (local ? 1 : 0);
#define HH_BT(C, S, L)                                                    \
  return launch_bt<C, S, L>(G, smem, s, qp, qtr, tp, ttr, t_L, co, lut,    \
                            n_lut, qidx, tidx, B, Lq, Lt, Lq_true, shift,  \
                            pq, pt, scratch, score, i2, j2, bt)
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

// W1.  bt: the (B, Lq+1, Lt+1) backtrace bytes at byte strides sb, si, sj
// (K2/K3's [B][Lt+1][Wq] storage: (Lt+1) Wq, 1, Wq, bt at its byte
// BT_ROW0; contiguous: (Lq+1)(Lt+1), Lt+1, 1); i2, j2 (B,) i32 in range
// (0 <= i2 <= Lq, 0 <= j2 <= Lt, not checked); score (B,) f32.  Out: out
// (B, 12 + kmax) bytes.  Returns the cudaError_t of the launch,
// cudaErrorInvalidValue for B < 0, kmax < 1 or a null pointer.
int hh_vit_walk(const uint8_t* bt, long long sb, long long si, long long sj,
                const int* i2, const int* j2, const float* score, int B,
                int kmax, uint8_t* out, void* stream) {
  if (B < 0 || kmax < 1 || !bt || !i2 || !j2 || !score || !out)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  bt_walk_kernel<<<(B + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0,
                   (cudaStream_t)stream>>>(bt, sb, si, sj, i2, j2, score, B,
                                           kmax, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
