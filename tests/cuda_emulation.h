// The CUDA surface that tropical_torch/csrc/hashgrid_encode.cu uses, on the
// CPU, so that the CPU tests can run its forward kernel
// (tests/test_torch_encode_forward.py): one std::thread a lane, a warp's 32
// lanes meeting at a std::barrier in each shuffle, a lane that returns
// leaving the barrier.  Float arithmetic is IEEE single precision rounded to
// nearest (built with -ffp-contract=off), as __fmul_rn and __fadd_rn are.
// The backwards' intrinsics (atomics, match, block barriers) compile but
// abort when called: only the forward is emulated.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__

using std::max;
using std::min;

struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

// volatile keeps each operation one rounding, as the intrinsics are
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

struct EmuWarp {
  std::barrier<> bar{32};
  float buf[32];
};
inline thread_local EmuWarp* emu_warp = nullptr;

inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = threadIdx.x & 31;
  emu_warp->buf[lane] = v;
  emu_warp->bar.arrive_and_wait();
  const float r = emu_warp->buf[(lane & ~(width - 1)) + src % width];
  emu_warp->bar.arrive_and_wait();
  return r;
}

[[noreturn]] inline void emu_unsupported(const char* what) {
  std::fprintf(stderr, "cuda_emulation.h: %s is not emulated\n", what);
  std::abort();
}
inline unsigned __match_any_sync(unsigned, int) { emu_unsupported("match"); }
inline bool __any_sync(unsigned, bool) { emu_unsupported("any"); }
inline void __syncwarp() { emu_unsupported("syncwarp"); }
inline void __syncthreads() { emu_unsupported("syncthreads"); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline float atomicAdd(float*, float) { emu_unsupported("atomicAdd"); }
inline float2 atomicAdd(float2*, float2) { emu_unsupported("atomicAdd"); }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
template <typename Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// an H100's 132 SMs with 2,048 resident threads each
template <typename Kernel>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, Kernel, int threads, size_t) {
  *blocks = 2048 / threads;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 132;
  return cudaSuccess;
}

// kernel<<<grid, block, shared, stream>>>(args) becomes
// EmuLaunch(grid, block, shared, stream).run(kernel, args): the blocks' warps
// in turn, a warp's 32 lanes as threads.
struct EmuLaunch {
  unsigned grid, block;
  EmuLaunch(long long g, int b, int = 0, cudaStream_t = nullptr)
      : grid(static_cast<unsigned>(g)), block(static_cast<unsigned>(b)) {}
  template <typename Kernel, typename... Args>
  void run(Kernel kernel, const Args&... args) {
    gridDim.x = grid;
    blockDim.x = block;
    for (unsigned bx = 0; bx < grid; ++bx)
      for (unsigned w = 0; w < block / 32; ++w) {
        auto warp = std::make_unique<EmuWarp>();
        std::vector<std::thread> lanes;
        for (unsigned lane = 0; lane < 32; ++lane)
          lanes.emplace_back([&, lane] {
            blockIdx.x = bx;
            threadIdx.x = w * 32 + lane;
            emu_warp = warp.get();
            kernel(args...);
            warp->bar.arrive_and_drop();
          });
        for (auto& t : lanes) t.join();
      }
  }
};
