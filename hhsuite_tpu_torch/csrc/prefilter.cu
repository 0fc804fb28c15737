// Hand-written Hopper (sm_90a) kernels for the two-stage cs219 prefilter.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K4  hhsuite_tpu/ops/prefilter_pallas.py  : ungapped_scores_pallas
//       (stage 1: best ungapped diagonal score, uint8 saturation)
//       -> pf_wave_kernel<false, SMEM> / hh_pf_ungapped
//   K5  hhsuite_tpu/ops/prefilter_pallas2.py : gapped_scores_pallas
//       (stage 2: best gapped Smith-Waterman score, exact F fixpoint)
//       -> pf_wave_kernel<true, SMEM> / hh_pf_gapped
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
// Design: one kernel body, pf_wave_kernel<GAPPED, SMEM>, for both stages
// (K5 GAPPED, K4 not), as csrc/viterbi.cu:wave_sweep is the one body of
// K1, K2, K3 and K6: a warp-wide wavefront per database sequence.  A
// group of G lanes (G = 8, 16 or 32, chosen per launch by
// ops/prefilter.py:pf_geometry) owns one sequence; lane k holds PF_R = 8
// consecutive query rows of a pass of 8G rows in registers: K5 their H
// and E (E runs along j, so it never leaves the lane), K4 their S.  At
// step s lane k computes sequence position j = s - k for its 8 rows.
// From lane k-1 it takes, by one __shfl_up_sync of one int, H (S) of lane
// k-1's last row at column j and, for K5, the F entering its own first
// row: the F chain F[i+1] = max(F[i] - ge, H0[i] - gi, 0), F[0] = 0, is
// the exclusive prefix max of the plain version walked in order (equal
// to it when gi, ge >= 0), so it crosses a lane, and a pass, as one byte
// (K4 has no F: it stays 0).  The H it takes is kept one step: the next
// column's diagonal.  Lane 0 takes the pass boundary: zeros on the first
// pass, after it what lane G-1 of the previous pass left in a
// per-sequence scratch row of 2 bytes a position (H of the pass's last
// row | the outgoing F << 8), laid out as the resident states are, at
// offsets[b] (hh_pf_scratch_bytes: only for more than one pass).
// Rows past Lq in the last pass are computed and left out of the best;
// the group's best is reduced by __shfl_xor_sync.  The groups of a warp
// run to the warp's longest sequence (rows come sorted by length), the
// finished ones idle but still in the shuffles.  A position at or past a
// row's length is never computed, so the padding state 219 is never
// read.  The block keeps the whole query table in shared memory when it
// fits (220 x pitch bytes: Lq <= 1024 with 220 KB), each state's row
// padded to a pitch of a multiple of 8 bytes, so a lane reads its 8
// bytes of a column with one 8-byte load; past Lq = 1024 it reads the
// table from global memory through L1/L2.  One block of 256 threads
// holds 256 / G sequences.  K4's 8 cells of a step do not depend on each
// other (no F chain): the lane has 8 independent chains to issue.
//
// What bounds them on the card.  Integer instructions per DP cell that
// the function needs on Hopper: an add followed by a min or max against
// a third operand, floored at 0 or not, is one instruction (VIADDMNMX
// [.RELU]), and every value of both stages lies in [0, 255], so two cells
// share a register as s16x2 (VIADDMNMX.S16x2[.RELU], VIMNMX.S16x2.RELU:
// one instruction for both).  K4: 3 operations a cell (min(hdiag + q,
// 255), max(t - off, 0), the running max), 1.5 instructions a cell
// packed; K5: 8 (min(hdiag + q, 255), max(t - off, E), max(H0, F), H - gi
// and max(E - ge, ., 0), H0 - gi and max(F - ge, ., 0), the running max),
// 4 packed.  The card issues IADD3, VIADDMNMX and the s16x2 forms alike at
// 64 a SM and clock, ~16.7e12/s (tools/int_rate.py), so a stage-1 pass
// over 10^11 cells needs >= 9 ms; the bytes either stage must move (one
// state byte per database position, the table once) are far fewer, so
// both are operations-bound.  The kernels below keep one cell a register
// and plain max/min (ptxas fuses it into VIADDMNMX; the explicit DPX
// intrinsics were slower on the card): K4 4 instructions a cell (ptxas
// emits max(t - off, 0) as an add and a max) plus a byte extraction, K5 8
// plus one; both add ~20 a step of 8 cells (the shuffle, the pass
// boundary, the state byte, the table word's address and load, the
// scratch, loop control): K4 ~7.5 a cell in all, K5 ~11.5.
//
// What is left.  K4 runs at ~14% of its bound, K5 at ~28%, and the cell
// arithmetic is not what holds K4 back: two cells a register (rows r and
// r + 4 as s16x2, one instruction each) halved K4's cell instructions and
// left its time unchanged on the card, so it was not kept.  Per step of 8
// cells a lane also issues a state-byte load, a table load that hits a
// random bank (each lane of a group is on its own column, so on its own
// state row), a shuffle and the pass boundary's scratch access; cutting
// those per cell (more rows a lane, state bytes loaded a word at a time)
// is the next step.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 220;          // AS219 states + ANY
constexpr int SMEM_MAX = 220 * 1024;
// the wavefront (ops/prefilter.py:pf_geometry assumes both)
constexpr int PF_THREADS = 256;  // threads per block: 256 / G sequences
constexpr int PF_R = 8;          // query rows per lane
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int table_bytes(int pitch) {
  return (NS * pitch + 15) / 16 * 16;
}

// the table pitch: a state's row padded to a multiple of PF_R bytes
__host__ __device__ constexpr int pf_pitch(int Lq) {
  return (Lq + PF_R - 1) / PF_R * PF_R;
}

// the passes over a query of Lq rows at group width G, or -1 for
// arguments the kernels do not take
__host__ __device__ constexpr int pf_passes(int Lq, int G) {
  return (G == 8 || G == 16 || G == 32) && Lq >= 1
             ? (Lq + G * PF_R - 1) / (G * PF_R)
             : -1;
}

// the query table: copied into shared memory (16-byte words; the wrapper
// pads the table to a multiple of 16 bytes) or read from global memory
template <bool SMEM>
__device__ __forceinline__ const uint8_t* stage_table(const uint8_t* qc_g,
                                                      int pitch,
                                                      uint8_t* smem) {
  if (!SMEM) return qc_g;
  const int words = table_bytes(pitch) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(qc_g);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = src[k];
  __syncthreads();
  return smem;
}

// K5 (GAPPED) and K4: the wavefront (design note above).  qc: the table
// at pitch pf_pitch(Lq); scratch: 2 bytes a state position (H | F << 8 of
// the pass's last row; F = 0 for K4), or NULL for one pass; gi and ge
// unused by K4.
template <bool GAPPED, bool SMEM>
__global__ void __launch_bounds__(PF_THREADS)
    pf_wave_kernel(const uint8_t* __restrict__ qc_g, int Lq,
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
    int H[PF_R], E[PF_R], bh[PF_R];               // K4: H is S, no E
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
        int F = GAPPED ? v >> 8 : 0;
        int hd = diag;
#pragma unroll
        for (int r = 0; r < PF_R; ++r) {
          const int q = ((r < 4 ? w.x : w.y) >> (8 * (r % 4))) & 0xff;
          const int t = min(hd + q, 255) - off;
          hd = H[r];
          if constexpr (GAPPED) {
            // max(vH, E) = max(t, E): E >= 0
            const int H0 = max(t, E[r]);
            const int h = max(H0, F);
            E[r] = max(max(E[r] - ge, h - gi), 0);
            F = max(max(F - ge, H0 - gi), 0);
            H[r] = h;
          } else {
            H[r] = max(t, 0);
          }
          bh[r] = max(bh[r], H[r]);
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

template <bool GAPPED, bool SMEM>
int launch_wave(cudaStream_t stream, const uint8_t* qc, int Lq,
                const uint8_t* states, const int64_t* offsets,
                const int* lengths, int B, int gi, int ge, int off, int G,
                uint16_t* scratch, int* out) {
  const int smem = SMEM ? table_bytes(pf_pitch(Lq)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pf_wave_kernel<GAPPED, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int ng = PF_THREADS / G;
  pf_wave_kernel<GAPPED, SMEM><<<(B + ng - 1) / ng, PF_THREADS, smem,
                                 stream>>>(qc, Lq, states, offsets, lengths,
                                           B, gi, ge, off, G, scratch, out);
  return (int)cudaGetLastError();
}

// either stage's entry: refuses what the kernel does not take, then
// launches with the table in shared memory when it fits
template <bool GAPPED>
int launch_stage(const uint8_t* qc, int Lq, const uint8_t* states,
                 const int64_t* offsets, const int* lengths, int B, int gi,
                 int ge, int off, int G, uint16_t* scratch, int* out,
                 void* stream) {
  if (B <= 0) return 0;
  const int passes = pf_passes(Lq, G);
  if (passes < 0 || (passes > 1 && !scratch) || gi < 0 || ge < 0
      || off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bytes(pf_pitch(Lq)) <= SMEM_MAX)
    return launch_wave<GAPPED, true>(s, qc, Lq, states, offsets, lengths, B,
                                     gi, ge, off, G, scratch, out);
  return launch_wave<GAPPED, false>(s, qc, Lq, states, offsets, lengths, B,
                                    gi, ge, off, G, scratch, out);
}

}  // namespace

extern "C" {

const char* hh_pf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The passes over a query of Lq rows at group width G, or -1 for a width
// the kernels do not take.
int hh_pf_passes(int Lq, int G) { return pf_passes(Lq, G); }

// The table pitch: the bytes between two state rows of qc.
int hh_pf_pitch(int Lq) { return pf_pitch(Lq); }

// The scratch bytes of a launch over resident states of n_states
// positions (2 a position, at the rows' offsets): 0 for one
// pass, -1 for arguments the kernels do not take.
long long hh_pf_scratch_bytes(int Lq, int G, long long n_states) {
  const int passes = pf_passes(Lq, G);
  if (passes < 0 || n_states < 0) return -1;
  return passes > 1 ? 2 * n_states : 0;
}

// K4.  qc: table_bytes(pitch) bytes, (220, pitch) row-major uint8 with
// pitch = hh_pf_pitch(Lq), zero-padded; states/offsets/lengths:
// the database rows; off >= 0 (S then stays in [0, 255]); G lanes a
// sequence (8, 16 or 32: ops/prefilter.py:pf_geometry); scratch:
// hh_pf_scratch_bytes(Lq, G, n_states) bytes when there is more
// than one pass, else NULL.  Out: out (B,) int32.  Returns the
// cudaError_t of the launch, cudaErrorInvalidValue for arguments the
// kernel does not take.
int hh_pf_ungapped(const uint8_t* qc, int Lq, const uint8_t* states,
                   const int64_t* offsets, const int* lengths, int B, int off,
                   int G, uint16_t* scratch, int* out, void* stream) {
  return launch_stage<false>(qc, Lq, states, offsets, lengths, B, 0, 0, off,
                             G, scratch, out, stream);
}

// K5.  As K4, with gi = gap_init and ge = gap_extend (both >= 0: H, E
// and F then stay in [0, 255]).
int hh_pf_gapped(const uint8_t* qc, int Lq, const uint8_t* states,
                 const int64_t* offsets, const int* lengths, int B, int gi,
                 int ge, int off, int G, uint16_t* scratch, int* out,
                 void* stream) {
  return launch_stage<true>(qc, Lq, states, offsets, lengths, B, gi, ge, off,
                            G, scratch, out, stream);
}

}  // extern "C"
