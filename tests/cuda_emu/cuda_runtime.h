// A CPU stand-in for the part of the CUDA runtime that
// hhsuite_tpu_torch/csrc/viterbi.cu uses, so that its kernels compile
// with g++ and run on the CPU (tests/test_torch_cuda_emulation.py).
//
// Every CUDA thread of a block is a std::thread; blocks run one after
// another, so a function-scope `static` array is the block's shared
// memory.  __syncthreads is a barrier over the block, a warp shuffle a
// write-barrier-read-barrier over the warp's 32 threads.  The f32
// intrinsics are plain IEEE operations (compile with -ffp-contract=off,
// as nvcc's -fmad=false).  The launch syntax and cp.async are rewritten
// by the test before compiling.
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
#define __launch_bounds__(x)
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

inline thread_local dim3 threadIdx, blockIdx, blockDim;

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
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d, int width) {
  const int lane = threadIdx.x % 32, l = lane % width;
  return emu_shfl(v, l >= d ? lane - d : lane);
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
        emu_block = &ctx;
        body();
      });
    for (auto& th : ts) th.join();
  }
}
