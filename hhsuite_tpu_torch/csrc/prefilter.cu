// Hand-written Hopper (sm_90a) kernels for the two-stage cs219 prefilter.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K4  hhsuite_tpu/ops/prefilter_pallas.py  : ungapped_scores_pallas
//       (stage 1: best ungapped diagonal score, uint8 saturation)
//       -> pf_ungapped_kernel / hh_pf_ungapped
//   K5  hhsuite_tpu/ops/prefilter_pallas2.py : gapped_scores_pallas
//       (stage 2: best gapped Smith-Waterman score, exact F fixpoint)
//       -> pf_gapped_kernel / hh_pf_gapped
//
// What they compute (hhprefilter.cpp:70-275, as the JAX scan versions in
// hhsuite_tpu/ops/prefilter.py and the plain PyTorch versions in
// ops/prefilter.py).  qc is the (220, Lq) query table, row x = cs219
// state x; every state value lies in [0, 255].  For each database
// position j < len with state x:
//   K4  S[i] = max(min(S[i-1]' + qc[x][i], 255) - off, 0)   (' = column j-1)
//   K5  vH = max(min(H[i-1]' + qc[x][i], 255) - off, 0)
//       H0 = max(vH, E[i]'),  F[0] = 0,
//       F[i] = max(F[i-1] - ge, H0[i-1] - gi, 0)  (the exclusive prefix
//       max max_{k<i} H0[k] - gi - (i-1-k) ge floored at 0, walked in
//       order: no scan), H = max(H0, F), E = max(E' - ge, H - gi, 0)
// and the result is the maximum of S (H) over all cells.  Integers
// throughout: the kernels equal the plain versions exactly.
//
// Database layout.  One flat uint8 array of cs219 states, a row's start
// (int64 offset) and its length (int32); no padding.  A row is walked up
// to its length only: the padding state 219 (row = off - 1) strictly
// decays the state, so streaming padding would give the same maximum.
//
// Design of K4.  One database sequence per thread, as the reference walks
// one sequence per SIMD loop (its query positions on the vector lanes); a
// block keeps the whole query table in shared memory when it fits (220 x
// Lq bytes: Lq <= 1024 with 220 KB), else reads it from global memory
// through L1/L2.  The grid is sized to the card's resident blocks and
// strides over the rows, so each block copies the table once.  K4 walks
// the sequence diagonal by diagonal: along a diagonal S is one register,
// so the ungapped stage needs no state vector at all.
//
// Design of K5: a warp-wide wavefront per database sequence, as
// csrc/viterbi.cu:wave_sweep runs one per template.  A group of G lanes
// (G = 8, 16 or 32, chosen per launch by ops/prefilter.py:pf_geometry)
// owns one sequence; lane k holds PF_R = 8 consecutive query rows of a
// pass of 8G rows, their H and E in registers (E runs along j, so it
// never leaves the lane).  At step s lane k computes sequence position
// j = s - k for its 8 rows.  From lane k-1 it takes, by one
// __shfl_up_sync of one int, H of lane k-1's last row at column j and
// the F entering its own first row: the F chain F[i+1] = max(F[i] - ge,
// H0[i] - gi, 0), F[0] = 0, is the exclusive prefix max of the plain
// version walked in order (equal to it when gi, ge >= 0), so it crosses
// a lane, and a pass, as one byte.  The H it takes is kept one step: the
// next column's diagonal.  Lane 0 takes the pass boundary: zeros on the
// first pass, after it what lane G-1 of the previous pass left in a
// per-sequence scratch row of 2 bytes a position (H of the pass's last
// row | the outgoing F << 8), laid out as the resident states are, at
// offsets[b] (hh_pf_gapped_scratch_bytes: only for more than one pass).
// Rows past Lq in the last pass are computed and left out of the best;
// the group's best is reduced by __shfl_xor_sync.  The groups of a warp
// run to the warp's longest sequence (rows come sorted by length), the
// finished ones idle but still in the shuffles.  The table sits in
// shared memory as for K4, each state's row padded to a pitch of a
// multiple of 8 bytes, so a lane reads its 8 bytes of a column with one
// 8-byte load; past Lq = 1024 from global memory.  One block of 256
// threads holds 256 / G sequences.
//
// What bounds them on the card.  Integer operations per DP cell, counted
// as Hopper retires them: an add followed by a min or max against a
// third operand, floored at 0 or not, is one instruction (VIADDMNMX
// [.RELU], which ptxas emits from the plain max/min below; the explicit
// DPX intrinsics were slower in a comparison on the card).  K4: 3
// (min(S + q, 255), max(t - off, 0), the running max) plus ~4 of
// addressing and loop control; K5: 8 (min(hdiag + q, 255), max(t - off,
// E), max(H0, F), H - gi and max(E - ge, ., 0), H0 - gi and max(F - ge,
// ., 0), the running max) plus a byte extraction a cell and ~20
// instructions a step of 8 cells (the shuffle, the state byte, the table
// word, the scratch).  Against the card's ~16.7e12 INT32 op/s (132 SMs x
// 64 lanes x 1.98 GHz) a stage-1 pass over 10^11 cells needs >= 18 ms;
// the bytes either stage must move (one state byte per database
// position, the table once) are far fewer, so both are operations-bound.
//
// What is left.  K4 still runs one sequence per thread: its table
// lookups hit random banks and its database bytes are read one at a
// time.  K5's table loads hit random banks too (each lane of a group is
// on its own column, so on its own state row), one 8-byte load per 8
// cells.  Neither packs cells: two 16-bit or four 8-bit cells in a
// 32-bit register (the reference's SIMD within a register) would
// multiply the useful work per instruction.  These are later steps.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 220;          // AS219 states + ANY
constexpr int THREADS = 256;     // sequences per block
constexpr int SMEM_MAX = 220 * 1024;
// K5's wavefront (ops/prefilter.py:pf_geometry assumes both)
constexpr int PF_THREADS = 256;  // threads per block: 256 / G sequences
constexpr int PF_R = 8;          // query rows per lane
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int table_bytes(int Lq) {
  return (NS * Lq + 15) / 16 * 16;
}

// K5's table pitch: a state's row padded to a multiple of PF_R bytes
__host__ __device__ constexpr int pf_pitch(int Lq) {
  return (Lq + PF_R - 1) / PF_R * PF_R;
}

__host__ __device__ constexpr bool pf_width(int G) {
  return G == 8 || G == 16 || G == 32;
}

// the query table: copied into shared memory (16-byte words; the wrapper
// pads the table to a multiple of 16 bytes) or read from global memory
template <bool SMEM>
__device__ __forceinline__ const uint8_t* stage_table(const uint8_t* qc_g,
                                                      int Lq,
                                                      uint8_t* smem) {
  if (!SMEM) return qc_g;
  const int words = table_bytes(Lq) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(qc_g);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = src[k];
  __syncthreads();
  return smem;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
    pf_ungapped_kernel(const uint8_t* __restrict__ qc_g, int Lq,
                       const uint8_t* __restrict__ states,
                       const int64_t* __restrict__ offsets,
                       const int* __restrict__ lengths, int B, int off,
                       int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* qc = stage_table<SMEM>(qc_g, Lq, smem);
  const int stride = gridDim.x * blockDim.x;
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B; b += stride) {
    const uint8_t* seq = states + offsets[b];
    const int Ld = lengths[b];
    int best = 0;
    // diagonal d = j - i; S restarts at 0 on row 0 and column 0
    for (int d = 1 - Lq; d < Ld; ++d) {
      const int i0 = d < 0 ? -d : 0;
      const int j0 = d < 0 ? 0 : d;
      const int n = min(Lq - i0, Ld - j0);
      const uint8_t* q = qc + i0;
      const uint8_t* x = seq + j0;
      int S = 0;
      for (int t = 0; t < n; ++t) {
        S = max(min(S + (int)q[(int)__ldg(x + t) * Lq + t], 255) - off, 0);
        best = max(best, S);
      }
    }
    out[b] = best;
  }
}

// K5: the wavefront (design note above).  qc: the table at pitch
// pf_pitch(Lq); scratch: 2 bytes a state position (H | F << 8 of the
// pass's last row), or NULL for one pass.
template <bool SMEM>
__global__ void __launch_bounds__(PF_THREADS)
    pf_gapped_kernel(const uint8_t* __restrict__ qc_g, int Lq,
                     const uint8_t* __restrict__ states,
                     const int64_t* __restrict__ offsets,
                     const int* __restrict__ lengths, int B, int gi, int ge,
                     int off, int G, uint16_t* __restrict__ scratch,
                     int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = pf_pitch(Lq);
  const uint8_t* qc = stage_table<SMEM>(qc_g, P, smem);
  const int k = threadIdx.x % G;                  // lane of the group
  const int b = blockIdx.x * (PF_THREADS / G) + threadIdx.x / G;
  const bool live = b < B;
  const int len = live ? lengths[b] : 0;
  const int64_t at = live ? offsets[b] : 0;
  const uint8_t* seq = states + at;
  uint16_t* sc = scratch ? scratch + at : nullptr;
  int wlen = len;                                 // the warp's longest
  for (int m = 16; m > 0; m >>= 1)
    wlen = max(wlen, __shfl_xor_sync(FULL, wlen, m, 32));
  const int GR = G * PF_R;
  const int passes = (Lq + GR - 1) / GR;
  int best = 0;
  for (int p = 0; p < passes; ++p) {
    const int i0 = p * GR + k * PF_R;             // the lane's first row
    const bool has_next = p + 1 < passes;
    // a lane wholly past Lq reads row 0's bytes and is left out below
    const uint8_t* ql = qc + (i0 < Lq ? i0 : 0);
    int H[PF_R], E[PF_R], bh[PF_R];
#pragma unroll
    for (int r = 0; r < PF_R; ++r) H[r] = E[r] = bh[r] = 0;
    int o = 0;      // H of the strip's last row | F leaving it << 8
    int diag = 0;   // H of the row above the strip at column j-1
    __syncwarp();   // the last pass's scratch row is written
    for (int s = 0; s < wlen + G - 1; ++s) {
      const int j = s - k;
      const bool on = j >= 0 && j < len;
      // the row above the strip at column j: lane k-1's, or the pass
      // boundary.  Lane G-1 overwrites scratch[j] for the next pass at
      // step j + G - 1, after this read (ordered by the next shuffle)
      int v = __shfl_up_sync(FULL, o, 1, G);
      if (k == 0) v = p > 0 && on ? sc[j] : 0;
      if (on) {
        const uint2 w = *reinterpret_cast<const uint2*>(
            ql + (int)__ldg(seq + j) * P);
        int F = v >> 8;
        int hd = diag;
#pragma unroll
        for (int r = 0; r < PF_R; ++r) {
          const int q = ((r < 4 ? w.x : w.y) >> (8 * (r % 4))) & 0xff;
          // max(vH, E) = max(min(hd + q, 255) - off, E): E >= 0
          const int H0 = max(min(hd + q, 255) - off, E[r]);
          hd = H[r];
          const int h = max(H0, F);
          E[r] = max(max(E[r] - ge, h - gi), 0);
          F = max(max(F - ge, H0 - gi), 0);
          H[r] = h;
          bh[r] = max(bh[r], h);
        }
        o = H[PF_R - 1] | F << 8;
        if (has_next && k == G - 1) sc[j] = (uint16_t)o;
      }
      diag = v & 0xff;
    }
#pragma unroll
    for (int r = 0; r < PF_R; ++r)
      if (i0 + r < Lq) best = max(best, bh[r]);
  }
  for (int m = G / 2; m > 0; m >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, m, G));
  if (live && k == 0) out[b] = best;
}

// grid of resident blocks for a kernel with `smem` bytes per block, at
// most enough for B rows
template <typename K>
int resident_grid(K kernel, int smem, int B, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess && smem > 48 * 1024)
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, smem);
  if (*err != cudaSuccess) return 0;
  const int need = (B + THREADS - 1) / THREADS;
  const int have = sms * (per_sm > 0 ? per_sm : 1);
  return need < have ? need : have;
}

template <bool SMEM>
int launch_gapped(int G, cudaStream_t stream, const uint8_t* qc, int Lq,
                  const uint8_t* states, const int64_t* offsets,
                  const int* lengths, int B, int gi, int ge, int off,
                  uint16_t* scratch, int* out) {
  const int smem = SMEM ? table_bytes(pf_pitch(Lq)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pf_gapped_kernel<SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int ng = PF_THREADS / G;
  pf_gapped_kernel<SMEM><<<(B + ng - 1) / ng, PF_THREADS, smem, stream>>>(
      qc, Lq, states, offsets, lengths, B, gi, ge, off, G, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hh_pf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K4.  qc: table_bytes(Lq) bytes, (220, Lq) row-major uint8, zero-padded;
// states/offsets/lengths: the database rows; out (B,) int32.
int hh_pf_ungapped(const uint8_t* qc, int Lq, const uint8_t* states,
                   const int64_t* offsets, const int* lengths, int B, int off,
                   int* out, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const int smem = table_bytes(Lq);
  if (smem <= SMEM_MAX) {
    const int grid = resident_grid(pf_ungapped_kernel<true>, smem, B, &err);
    if (err != cudaSuccess) return (int)err;
    pf_ungapped_kernel<true><<<grid, THREADS, smem, s>>>(
        qc, Lq, states, offsets, lengths, B, off, out);
  } else {
    const int grid = resident_grid(pf_ungapped_kernel<false>, 0, B, &err);
    if (err != cudaSuccess) return (int)err;
    pf_ungapped_kernel<false><<<grid, THREADS, 0, s>>>(
        qc, Lq, states, offsets, lengths, B, off, out);
  }
  return (int)cudaGetLastError();
}

// K5's passes over a query of Lq rows at group width G, or -1 for a
// width the kernel does not take.
int hh_pf_gapped_passes(int Lq, int G) {
  if (!pf_width(G) || Lq < 1) return -1;
  return (Lq + G * PF_R - 1) / (G * PF_R);
}

// K5's table pitch: the bytes between two state rows of qc.
int hh_pf_gapped_pitch(int Lq) { return pf_pitch(Lq); }

// K5's scratch bytes for a launch over resident states of n_states
// positions (2 a position, at the rows' offsets): 0 for one pass, -1 for
// arguments the kernel does not take.
long long hh_pf_gapped_scratch_bytes(int Lq, int G, long long n_states) {
  const int passes = hh_pf_gapped_passes(Lq, G);
  if (passes < 0 || n_states < 0) return -1;
  return passes > 1 ? 2 * n_states : 0;
}

// K5.  qc: table_bytes(pitch) bytes, (220, pitch) row-major uint8 with
// pitch = hh_pf_gapped_pitch(Lq), zero-padded; states/offsets/lengths
// as K4; gi = gap_init, ge = gap_extend, off (all >= 0: H, E and F then
// stay in [0, 255]); G lanes a sequence (8, 16 or 32: ops/prefilter.py:
// pf_geometry); scratch: hh_pf_gapped_scratch_bytes(Lq, G, n_states)
// bytes when there is more than one pass, else NULL.  Out: out (B,)
// int32.  Returns the cudaError_t of the launch, cudaErrorInvalidValue
// for arguments the kernel does not take.
int hh_pf_gapped(const uint8_t* qc, int Lq, const uint8_t* states,
                 const int64_t* offsets, const int* lengths, int B, int gi,
                 int ge, int off, int G, uint16_t* scratch, int* out,
                 void* stream) {
  if (B <= 0) return 0;
  const int passes = hh_pf_gapped_passes(Lq, G);
  if (passes < 0 || (passes > 1 && !scratch) || gi < 0 || ge < 0
      || off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bytes(pf_pitch(Lq)) <= SMEM_MAX)
    return launch_gapped<true>(G, s, qc, Lq, states, offsets, lengths, B,
                               gi, ge, off, scratch, out);
  return launch_gapped<false>(G, s, qc, Lq, states, offsets, lengths, B, gi,
                              ge, off, scratch, out);
}

}  // extern "C"
