// Issue rate of the card's integer instruction forms that the prefilter
// kernels' bound counts (chip_smoke.py: OPS_K4, OPS_K5), one kernel a
// form:
//   0  iadd3    x = x + y + w                      IADD3 (the INT32 pipe)
//   1  addmax   x = max(x + y, w)                  VIADDMNMX (32-bit)
//   2  addmin2  x = __viaddmin_s16x2(x, y, w)      VIADDMNMX.S16x2
//   3  addmax2  x = __viaddmax_s16x2_relu(x, y, w) VIADDMNMX.S16x2.RELU
//   4  max2     x = __vimax_s16x2_relu(x, w)       VIMNMX.S16x2.RELU
// A thread keeps CH values; at each of UNROLL steps of a loop trip value
// c takes w = value c + 1 of the step before, so the CH operations of a
// step are independent (the pipe, not a chain's latency, sets the time)
// and no two steps fold into one.  tools/int_rate.py counts the form's
// instructions in the built SASS and divides by the time.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 8;
constexpr int UNROLL = 16;

template <int OP>
__device__ __forceinline__ unsigned step(unsigned x, unsigned y,
                                         unsigned w) {
  if constexpr (OP == 0) return x + y + w;
  if constexpr (OP == 1) return (unsigned)max((int)(x + y), (int)w);
  if constexpr (OP == 2) return __viaddmin_s16x2(x, y, w);
  if constexpr (OP == 3) return __viaddmax_s16x2_relu(x, y, w);
  return __vimax_s16x2_relu(x, w);
}

template <int OP>
__global__ void rate_kernel(int trips, unsigned y, unsigned* out) {
  unsigned x[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) x[c] = threadIdx.x * 0x10003u + c;
#pragma unroll 1
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      unsigned nx[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) nx[c] = step<OP>(x[c], y, x[(c + 1) % CH]);
#pragma unroll
      for (int c = 0; c < CH; ++c) x[c] = nx[c];
    }
  }
  unsigned r = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) r ^= x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

template <int OP>
cudaError_t launch(int blocks, int threads, int trips, unsigned* out) {
  rate_kernel<OP><<<blocks, threads>>>(trips, 0x00030005u, out);
  return cudaGetLastError();
}

cudaError_t launch_op(int op, int blocks, int threads, int trips,
                      unsigned* out) {
  switch (op) {
    case 0: return launch<0>(blocks, threads, trips, out);
    case 1: return launch<1>(blocks, threads, trips, out);
    case 2: return launch<2>(blocks, threads, trips, out);
    case 3: return launch<3>(blocks, threads, trips, out);
    case 4: return launch<4>(blocks, threads, trips, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Operations a thread does in one loop trip.
int int_rate_ops_per_trip() { return CH * UNROLL; }

// Time reps launches of form op (blocks x threads, trips loop trips a
// thread) after one warm-up launch: their milliseconds in *ms.  Returns
// the cudaError_t.
int int_rate_time(int op, int blocks, int threads, int trips, int reps,
                  float* ms) {
  unsigned* out = nullptr;
  cudaEvent_t e0, e1;
  cudaError_t err = cudaMalloc(&out, sizeof(unsigned) * blocks * threads);
  if (err != cudaSuccess) return err;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  err = launch_op(op, blocks, threads, trips, out);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    cudaEventRecord(e0);
    for (int r = 0; r < reps && err == cudaSuccess; ++r)
      err = launch_op(op, blocks, threads, trips, out);
    cudaEventRecord(e1);
    if (err == cudaSuccess) err = cudaEventSynchronize(e1);
    if (err == cudaSuccess) err = cudaEventElapsedTime(ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return err;
}

const char* int_rate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
