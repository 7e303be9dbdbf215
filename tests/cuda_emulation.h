// The CUDA surface that tropical_torch/csrc/hashgrid_encode.cu and
// tropical_torch/csrc/bvh.cu use, on the CPU, so that the CPU tests can run
// the encode's forward kernel (tests/test_torch_encode_forward.py) and the
// BVH's four kernels (tests/test_torch_bvh.py): one std::thread a lane, a
// warp's 32 lanes meeting at a std::barrier in each shuffle, a lane that
// returns leaving the barrier.  Float arithmetic is IEEE single precision
// rounded to nearest (built with -ffp-contract=off), as __fmul_rn and
// __fadd_rn are.  The integer atomicAdd, __threadfence and __ldcg that the
// BVH's refit (and its instrumented build's counters) use are
// std::atomic_ref operations and sequentially consistent fences; a
// __device__ variable is a host one, which cudaMemcpyToSymbol and
// cudaMemcpyFromSymbol copy.  The encode backwards' intrinsics (float
// atomics, match, block barriers) compile but abort when called.
#pragma once
#include <algorithm>
#include <atomic>
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
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline int __clzll(long long x) {
  return x == 0 ? 64 : __builtin_clzll(static_cast<unsigned long long>(x));
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
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
inline cudaError_t cudaDeviceSynchronize() { return cudaSuccess; }
// a __device__ variable is a host variable here
template <typename T>
inline cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t n) {
  std::memcpy(&symbol, src, n);
  return cudaSuccess;
}
template <typename T>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t n) {
  std::memcpy(dst, &symbol, n);
  return cudaSuccess;
}
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
