// A CPU stand-in for the part of the CUDA runtime that
// hhsuite_tpu_torch/csrc/viterbi.cu, csrc/prefilter.cu and
// csrc/posterior.cu use, so that their kernels compile with g++ and run
// on the CPU (tests/test_torch_cuda_emulation.py,
// tests/test_torch_prefilter_emulation.py,
// tests/test_torch_posterior_emulation.py).
//
// Every CUDA thread of a block is a std::thread; blocks run one after
// another, so a function-scope `static` array is the block's shared
// memory.  __syncthreads is a barrier over the block, __syncwarp one over
// the warp, a warp shuffle (and __any_sync) a write-barrier-read-barrier
// over the warp's 32 threads.  The f32 intrinsics are plain IEEE operations (compile
// with -ffp-contract=off, as nvcc's -fmad=false).  The launch syntax and
// cp.async are rewritten by the test before compiling.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__ inline
#define __host__
#define __forceinline__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t buf[32];
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  float* smem;
};
inline thread_local EmuBlock* emu_block;

inline float* emu_dynamic_smem() { return emu_block->smem; }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp() {
  emu_block->warps[threadIdx.x / 32]->bar.arrive_and_wait();
}

template <class T>
inline T emu_shfl(T v, int src) {
  EmuWarp* w = emu_block->warps[threadIdx.x / 32].get();
  uint32_t u;
  std::memcpy(&u, &v, 4);
  w->buf[threadIdx.x % 32] = u;
  w->bar.arrive_and_wait();
  const uint32_t r = w->buf[src];
  w->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, 4);
  return out;
}
inline int __any_sync(unsigned, int pred) {
  EmuWarp* w = emu_block->warps[threadIdx.x / 32].get();
  w->buf[threadIdx.x % 32] = pred != 0;
  w->bar.arrive_and_wait();
  int any = 0;
  for (int l = 0; l < 32; ++l) any |= (int)w->buf[l];
  w->bar.arrive_and_wait();
  return any;
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d, int width) {
  const int lane = threadIdx.x % 32, l = lane % width;
  return emu_shfl(v, l >= d ? lane - d : lane);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width) {
  const int lane = threadIdx.x % 32;
  return emu_shfl(v, lane - lane % width + src % width);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int d, int width) {
  const int lane = threadIdx.x % 32, l = lane % width;
  return emu_shfl(v, l + d < width ? lane + d : lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m, int width) {
  const int lane = threadIdx.x % 32, l = lane % width;
  return emu_shfl(v, (l ^ m) < width ? lane - l + (l ^ m) : lane);
}

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __int2float_rn(int i) { return (float)i; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
template <class T>
inline T __ldg(const T* p) { return *p; }

template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// <<<grid, block, smem, stream>>>: every block in turn, its threads
// concurrently; shared memory starts poisoned (NaN) as a check that
// nothing reads what was not written
inline void emu_launch(dim3 grid, dim3 block, int smem, cudaStream_t,
                       const std::function<void()>& body) {
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    EmuBlock ctx;
    ctx.bar = std::make_unique<std::barrier<>>(block.x);
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
      ctx.warps.push_back(std::make_unique<EmuWarp>());
    std::vector<float> sm(smem / 4 + 8, __builtin_nanf(""));
    ctx.smem = reinterpret_cast<float*>(
        (reinterpret_cast<uintptr_t>(sm.data()) + 15) & ~uintptr_t(15));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t, bx] {
        threadIdx = dim3(t);
        blockIdx = dim3(bx);
        blockDim = block;
        gridDim = grid;
        emu_block = &ctx;
        body();
      });
    for (auto& th : ts) th.join();
  }
}
