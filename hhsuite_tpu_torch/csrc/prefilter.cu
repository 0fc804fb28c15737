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
//       H0 = max(vH, E[i]'),  F[i] = max(G[i], 0) with
//       G[0] = -inf, G[i] = max(G[i-1] - ge, H0[i-1] - gi)  (the exclusive
//       prefix max max_{k<i} H0[k] - gi - (i-1-k) ge, walked in order: no
//       scan), H = max(H0, F), E = max(max(E' - ge, 0), max(H - gi, 0))
// and the result is the maximum of S (H) over all cells.  Integers
// throughout: the kernels equal the plain versions exactly.
//
// Database layout.  One flat uint8 array of cs219 states, a row's start
// (int64 offset) and its length (int32); no padding.  A row is walked up
// to its length only: the padding state 219 (row = off - 1) strictly
// decays the state, so streaming padding would give the same maximum.
//
// Design.  One database sequence per thread, as the reference walks one
// sequence per SIMD loop (its query positions on the vector lanes); a
// block keeps the whole query table in shared memory when it fits
// (220 x Lq bytes: Lq <= 1024 with 220 KB), else reads it from global
// memory through L1/L2.  The grid is sized to the card's resident blocks
// and strides over the rows, so each block copies the table once.
//   K4 walks the sequence diagonal by diagonal: along a diagonal S is one
//   register, so the ungapped stage needs no state vector at all.
//   K5 walks j outer, i inner and keeps column j-1's H and E (one byte
//   each, packed in a uint16) in a global scratch laid out [Lq][slots]:
//   at one i the threads of a warp touch neighbouring addresses.
//
// What bounds it on the card.  Integer operations per DP cell, counted
// from the loops below: K4 5 (add, min, subtract, max, running max) plus
// ~4 of addressing and loop control; K5 16 (vH 4, H0 1, G 3, F 1, H 1,
// E 5, running max 1) plus ~6 of scratch packing, addressing and loop
// control.  Against the card's ~16.7e12 INT32 op/s (132 SMs x 64 lanes x
// 1.98 GHz) a stage-1 pass over 10^11 cells needs >= 30 ms; the bytes it
// must move (one state byte per database position, the table once) are
// far fewer, so both stages are operations-bound.  K5 also streams 4
// scratch bytes per cell through L2 / device memory.
//
// What the simple design leaves on the table.  The table lookups of a
// warp hit random banks (each thread has its own state x); the database
// bytes are read one at a time; K5's scratch traffic could live in
// shared memory or registers with a warp per sequence (lanes over i, the
// F recursion as a warp scan).  Packing four 8-bit cells into one 32-bit
// register (the reference's SIMD-within-a-register) would quadruple the
// useful work per instruction.  These are later steps.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 220;          // AS219 states + ANY
constexpr int THREADS = 256;     // sequences per block
constexpr int SMEM_MAX = 220 * 1024;
constexpr int NEG = -(1 << 29);  // G before the first query position
// K5 scratch budget: slots x Lq x 2 bytes
constexpr size_t SCRATCH_MAX = size_t(512) << 20;

__host__ __device__ inline int table_bytes(int Lq) {
  return (NS * Lq + 15) / 16 * 16;
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

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
    pf_gapped_kernel(const uint8_t* __restrict__ qc_g, int Lq,
                     const uint8_t* __restrict__ states,
                     const int64_t* __restrict__ offsets,
                     const int* __restrict__ lengths, int B, int gi, int ge,
                     int off, uint16_t* __restrict__ he, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* qc = stage_table<SMEM>(qc_g, Lq, smem);
  const int slots = gridDim.x * blockDim.x;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  uint16_t* col = he + slot;                 // col[i * slots]: H | E << 8
  for (int b = slot; b < B; b += slots) {
    const uint8_t* seq = states + offsets[b];
    const int Ld = lengths[b];
    for (int i = 0; i < Lq; ++i) col[(size_t)i * slots] = 0;
    int best = 0;
    for (int j = 0; j < Ld; ++j) {
      const uint8_t* q = qc + (int)__ldg(seq + j) * Lq;
      int hdiag = 0;   // H of (i-1, j-1)
      int G = NEG;
      for (int i = 0; i < Lq; ++i) {
        uint16_t* cell = col + (size_t)i * slots;
        const int w = *cell;
        const int ep = w >> 8;
        const int vH = max(min(hdiag + (int)q[i], 255) - off, 0);
        const int H0 = max(vH, ep);
        const int H = max(H0, max(G, 0));
        const int E = max(max(ep - ge, 0), max(H - gi, 0));
        best = max(best, H);
        *cell = (uint16_t)(H | (E << 8));
        hdiag = w & 0xff;
        G = max(G - ge, H0 - gi);
      }
    }
    out[b] = best;
  }
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
int gapped_grid(int Lq, int B, cudaError_t* err) {
  int grid = resident_grid(pf_gapped_kernel<SMEM>, SMEM ? table_bytes(Lq) : 0,
                           B, err);
  const size_t cap = SCRATCH_MAX / (size_t(2) * Lq * THREADS);
  if (size_t(grid) > cap) grid = cap > 0 ? int(cap) : 1;
  return grid;
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

// K5 scratch size: the number of thread slots a launch for (Lq, B) uses;
// the caller allocates slots x Lq uint16.  Negative: -cudaError_t.
int hh_pf_gapped_slots(int Lq, int B) {
  if (B <= 0) return 0;
  cudaError_t err;
  const int grid = table_bytes(Lq) <= SMEM_MAX ? gapped_grid<true>(Lq, B, &err)
                                               : gapped_grid<false>(Lq, B, &err);
  if (err != cudaSuccess) return -(int)err;
  return grid * THREADS;
}

// K5.  As K4, plus gi = gap_init, ge = gap_extend (both >= 0, off >= 0:
// H and E then stay in [0, 255]); he: slots x Lq uint16 scratch, slots
// from hh_pf_gapped_slots(Lq, B).
int hh_pf_gapped(const uint8_t* qc, int Lq, const uint8_t* states,
                 const int64_t* offsets, const int* lengths, int B, int gi,
                 int ge, int off, uint16_t* he, int slots, int* out,
                 void* stream) {
  if (B <= 0) return 0;
  if (slots <= 0 || slots % THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = slots / THREADS;
  const int smem = table_bytes(Lq);
  if (smem <= SMEM_MAX) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          pf_gapped_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
    }
    pf_gapped_kernel<true><<<grid, THREADS, smem, s>>>(
        qc, Lq, states, offsets, lengths, B, gi, ge, off, he, out);
  } else {
    pf_gapped_kernel<false><<<grid, THREADS, 0, s>>>(
        qc, Lq, states, offsets, lengths, B, gi, ge, off, he, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
