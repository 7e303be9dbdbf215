// The CUDA surface that tropical_torch/csrc/hashgrid_encode.cu and
// tropical_torch/csrc/bvh.cu use, on the CPU, so that the CPU tests can run
// the encode's forward kernel (tests/test_torch_encode_forward.py) and the
// BVH's kernels (tests/test_torch_bvh.py): all the lanes of a block at once,
// each a fiber on the launching thread (below, EmuLaunch); a warp's 32 lanes
// meet at a barrier in each shuffle, vote, reduction and __syncwarp, a
// block's at another in __syncthreads, and a lane that returns leaves both.
// The blocks run one
// after another, so a __shared__ array is a function-static one, which each
// block's kernel sets before it reads it, as on the card.  Float arithmetic
// is IEEE single precision rounded to nearest (built with -ffp-contract=off),
// as __fmul_rn and __fadd_rn are.  The integer atomics (add, min, exchange,
// the 64-bit compare-and-swap), __threadfence and __ldcg that the BVH's and
// the faces' kernels (and the BVH's instrumented build's counters) use
// are std::atomic_ref operations and sequentially consistent fences, and
// cuda::atomic_ref (<cuda/atomic>) is std::atomic_ref whatever its scope; a
// __device__ variable is a host one, which cudaMemcpyToSymbol and
// cudaMemcpyFromSymbol copy.  The encode backwards' other intrinsics (float
// atomics, match, any) compile but abort when called.
#pragma once
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__ static

using std::isfinite;
using std::max;
using std::min;

struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return int2{a, b}; }
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
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
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline int atomicExch(int* p, int v) { return std::atomic_ref<int>(*p).exchange(v); }
inline unsigned long long atomicCAS(unsigned long long* p, unsigned long long cmp,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).compare_exchange_strong(cmp, v);
  return cmp;
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
inline unsigned __float_as_uint(float x) {
  unsigned r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline float __uint_as_float(unsigned x) {
  float r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline int __float_as_int(float x) { return static_cast<int>(__float_as_uint(x)); }
inline float __int_as_float(int x) { return __uint_as_float(static_cast<unsigned>(x)); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}

// --- a block's lanes as fibers ----------------------------------------------
//
// A launch runs on the calling thread: each lane of a block is a fiber with
// a stack of its own, and a lane runs until it reaches a barrier (a warp's
// or the block's) or returns; the next lane that can run then runs.  The
// lane that completes a barrier goes on without a switch.  A lane that
// loads an atomic yields first, so that one spinning on another lane's flag
// lets that lane run.  The lanes of a block thus run at once as on the card,
// on one core, and the blocks one after another.
struct EmuBar {
  unsigned expected = 0, arrived = 0, phase = 0;
};
struct EmuWarp {
  EmuBar bar;
  unsigned long long buf[32];
};
struct EmuBlock {
  EmuBar bar;
};
struct EmuFiber {
  ucontext_t ctx;  // its registers and stack while switched out
  char* stack = nullptr;
  const EmuBar* wait = nullptr;  // the barrier it waits at, and its phase
  unsigned phase = 0;
  bool done = false;
};

[[noreturn]] inline void emu_fatal(const char* what) {
  std::fprintf(stderr, "cuda_emulation.h: %s\n", what);
  std::abort();
}

struct EmuRun {
  static constexpr size_t kStack = 256 << 10;
  ucontext_t sched;  // the launching thread's context
  EmuFiber* lane = nullptr;  // the running lane
  void (*body)(const void*) = nullptr;  // the kernel with its arguments
  const void* args = nullptr;
  std::vector<EmuFiber> fibers;  // stacks kept from launch to launch
};
inline thread_local EmuRun emu_run;
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local EmuBlock* emu_block = nullptr;

// the running lane back to the launch's scheduler
inline void emu_yield() { swapcontext(&emu_run.lane->ctx, &emu_run.sched); }

inline void emu_complete(EmuBar& b) {
  b.arrived = 0;
  ++b.phase;
}

// the running lane at barrier b: waits until every lane still running has
// arrived
inline void emu_wait(EmuBar& b) {
  if (emu_run.lane == nullptr) return;  // host code
  const unsigned phase = b.phase;
  if (++b.arrived == b.expected) return emu_complete(b);
  emu_run.lane->wait = &b;
  emu_run.lane->phase = phase;
  emu_yield();
}

// a lane that returns leaves its barriers
inline void emu_drop(EmuBar& b) {
  --b.expected;
  if (b.arrived != 0 && b.arrived == b.expected) emu_complete(b);
}

// <cuda/atomic>'s atomic_ref and memory orders; every scope is the process
namespace cuda {
enum thread_scope {
  thread_scope_system,
  thread_scope_device,
  thread_scope_block,
  thread_scope_thread
};
namespace std {
using ::std::memory_order;
using ::std::memory_order_acq_rel;
using ::std::memory_order_acquire;
using ::std::memory_order_relaxed;
using ::std::memory_order_release;
using ::std::memory_order_seq_cst;
}  // namespace std
template <typename T, thread_scope = thread_scope_system>
struct atomic_ref : ::std::atomic_ref<T> {
  explicit atomic_ref(T& obj) : ::std::atomic_ref<T>(obj) {}
  // a lane that may spin on another's store lets the others run first
  T load(::std::memory_order order = ::std::memory_order_seq_cst) const {
    if (emu_run.lane != nullptr) emu_yield();
    return ::std::atomic_ref<T>::load(order);
  }
};
}  // namespace cuda

// each lane's value in, lane src's out (within sections of `width` lanes)
template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  const int lane = threadIdx.x & 31;
  std::memcpy(&emu_warp->buf[lane], &v, sizeof v);
  emu_wait(emu_warp->bar);
  T r;
  std::memcpy(&r, &emu_warp->buf[(lane & ~(width - 1)) + src % width], sizeof r);
  emu_wait(emu_warp->bar);
  return r;
}

// each lane's value in, lane (lane ^ mask)'s out
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  return __shfl_sync(0xffffffffu, v, ((threadIdx.x & 31) ^ mask) & (width - 1),
                     width);
}

// every lane's value in, f(all 32 values) out, in every lane
template <typename F>
inline unsigned emu_warp_fold(unsigned v, F f) {
  emu_warp->buf[threadIdx.x & 31] = v;
  emu_wait(emu_warp->bar);
  unsigned r = static_cast<unsigned>(emu_warp->buf[0]);
  for (int l = 1; l < 32; ++l) r = f(r, static_cast<unsigned>(emu_warp->buf[l]), l);
  emu_wait(emu_warp->bar);
  return r;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  return emu_warp_fold(pred ? 1u << (threadIdx.x & 31) : 0u,
                       [](unsigned a, unsigned b, int) { return a | b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_warp_fold(v, [](unsigned a, unsigned b, int) { return b < a ? b : a; });
}
inline void __syncthreads() { emu_wait(emu_block->bar); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(emu_warp->bar); }

[[noreturn]] inline void emu_unsupported(const char* what) {
  std::fprintf(stderr, "cuda_emulation.h: %s is not emulated\n", what);
  std::abort();
}
inline unsigned __match_any_sync(unsigned, int) { emu_unsupported("match"); }
inline bool __any_sync(unsigned, bool) { emu_unsupported("any"); }
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
// EmuLaunch(grid, block, shared, stream).run(kernel, args): the blocks in
// turn, a block's lanes as fibers, each round in lane order, or from the
// last lane down where the environment sets CUDA_EMULATION_LANES=reverse
// (a kernel's result must not depend on the order its atomics come in).
struct EmuLaunch {
  unsigned grid, block;
  EmuLaunch(long long g, int b, int = 0, cudaStream_t = nullptr)
      : grid(static_cast<unsigned>(g)), block(static_cast<unsigned>(b)) {}

  // a lane's first frame: runs the kernel, leaves its barriers and never
  // comes back
  static void entry() {
    emu_run.body(emu_run.args);
    EmuFiber* f = emu_run.lane;
    f->done = true;
    emu_drop(emu_warp->bar);
    emu_drop(emu_block->bar);
    emu_yield();
  }

  // fiber t's stack (kept) and a first frame that enters entry()
  static void start(unsigned t) {
    EmuFiber& f = emu_run.fibers[t];
    if (f.stack == nullptr) {
      void* m = mmap(nullptr, EmuRun::kStack, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK,
                     -1, 0);
      if (m == MAP_FAILED) emu_fatal("no memory for a lane's stack");
      f.stack = static_cast<char*>(m);
      mprotect(f.stack, 4096, PROT_NONE);  // an overflow faults
    }
    f.wait = nullptr;
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack;
    f.ctx.uc_stack.ss_size = EmuRun::kStack;
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, &entry, 0);
  }

  static void resume(unsigned t, unsigned bx, std::vector<EmuWarp>& warps,
                     EmuBlock& blk) {
    EmuFiber& f = emu_run.fibers[t];
    f.wait = nullptr;
    emu_run.lane = &f;
    blockIdx.x = bx;
    threadIdx.x = t;
    emu_warp = &warps[t / 32];
    emu_block = &blk;
    swapcontext(&emu_run.sched, &f.ctx);
  }

  template <typename Kernel, typename... Args>
  void run(Kernel kernel, const Args&... args) {
    if (emu_run.lane != nullptr) emu_fatal("a launch from a kernel");
    gridDim.x = grid;
    blockDim.x = block;
    auto call = [&] { kernel(args...); };
    emu_run.body = [](const void* c) {
      (*static_cast<const decltype(call)*>(c))();
    };
    emu_run.args = &call;
    if (emu_run.fibers.size() < block) emu_run.fibers.resize(block);
    const char* order = std::getenv("CUDA_EMULATION_LANES");
    const bool reverse = order != nullptr && std::strcmp(order, "reverse") == 0;
    std::vector<EmuWarp> warps((block + 31) / 32);
    for (unsigned bx = 0; bx < grid; ++bx) {
      EmuBlock blk;
      blk.bar.expected = block;
      for (unsigned w = 0; w < warps.size(); ++w)
        warps[w].bar = EmuBar{std::min(32u, block - 32 * w), 0, 0};
      for (unsigned t = 0; t < block; ++t) start(t);
      // each lane that can run, in turn, until all have returned
      for (unsigned live = block; live > 0;) {
        bool ran = false;
        for (unsigned i = 0; i < block; ++i) {
          const unsigned t = reverse ? block - 1 - i : i;
          const EmuFiber& f = emu_run.fibers[t];
          if (f.done || (f.wait != nullptr && f.wait->phase == f.phase))
            continue;
          resume(t, bx, warps, blk);
          ran = true;
          live -= f.done;
        }
        if (!ran) emu_fatal("every lane of a block waits: a deadlock");
      }
    }
    emu_run.lane = nullptr;
    emu_warp = nullptr;
    emu_block = nullptr;
  }
};
