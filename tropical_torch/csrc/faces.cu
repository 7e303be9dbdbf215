// K6: the device extraction engine's final filter and faces.
//
// Replaces the rest of the JAX package's fused engine program after the
// final insertion, tropical/extract/device.py make_extract_fn._run
// :1444-1772: the final filter (keep_v, e_keep, the used vertices and the
// funnel counts, :1444-1498) and the faces stage (:1518-1772: the region
// replicas of the used vertices by _grid_region_lut :254 and
// _expand4_keys :361 / _expand_keys :320, the regions as runs of equal
// keys, their fixed-point means, the duplicate regions, the angular sort
// of each polygon around the sdf normal at its mean, the duplicate ids,
// the fan triangles).  The caller (tropical_torch/extract/device.py
// Engine.faces) sorts between the kernels with torch.sort (the replicas by
// key, the regions by signature) and takes the normals from the net's
// encode kernels.  device_engine.cu includes this file, so that K3-K6 are
// one library; its names live in namespace faces, its launch functions are
// extern "C".  Each launch function takes device pointers, long long
// integers and float scalars in its declared order, then the stream, and
// returns the count of kernels it launched, or minus a CUDA error.  Each has
// its plain PyTorch version in that module, which it equals bit for bit:
// the integer work exactly, each float operation rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, sqrtf) in the plain
// version's order, the means from integer sums (2^-22 fixed point) and one
// division, so that no sum depends on an order of threads.
//
// Counts go to one int64 vector (device.py FC_*); the host reads it twice:
// after final_keep and face_keys_count (the funnel and the replicas) and
// after face_fans_count (the kept regions and the triangles).
//
// Bound: bytes (a few integer and float operations an item): a vertex's
// row read and flags written, an edge's ends, a replica's key and id, a
// region's members read a few times.  final_keep and face_regions are
// first designs, a thread an item: a vertex and an edge (final_keep), a
// replica that starts a run of equal keys (face_regions_runs), a region
// slot (face_regions_dups).
//
// face_keys and face_fans, the design: each ranks its items in the kernels,
// so that the stage takes no torch.sort of the zero counts and no
// torch.cumsum, two launches each:
// - face_keys_count: a tile of kTile = 1,024 vertices, a thread a vertex:
//   each used vertex's key row, and its rank in the tile among the used
//   and among the used of its zero count (a ballot a class present in the
//   warp, the warps' counts in shared memory); the tile's 36 class counts.
// - face_keys_fill, on the same tiles: the class counts of the tiles before
//   summed (a reduce, then a scan across the two launches: a decoupled
//   look-back over 36 counts a tile walks far back for an inclusive tile,
//   and was the slower at every preset), so that a used vertex's id is
//   its rank among all the used and its class rank that of the stable sort
//   by zero count; a warp's used vertices of one class have consecutive
//   ranks, so their replicas are one run of slots (the classes' runs from
//   the histogram), which the warp's lanes write a slot a lane.
// - face_fans_count: a tile of kTile region slots, a thread a slot, ranks
//   its kept regions and their triangles' offsets (a scan of both counts
//   packed in 64 bits in the tile, a decoupled look-back on one status word
//   across tiles, the tile's id from a counter) and writes the kept regions
//   as a compact list (start, count, triangle offset, triangles) and their
//   means, in rank order.
// - face_fans_fill: a thread a kept region; a region of at most kFanSmall
//   members (the presets' have 3 to 6) is scored, sorted and cleared of
//   repeated ids in shared memory, a larger one in its own segment of
//   global scratch (no cap on a region's size); the block's triangles are
//   one run of rows, which its threads then write an integer a thread.
// face_fans_count's look-back state (status words, the tile counter, the
// done ticket) is device variables, zero when the library loads, which the
// last block of every launch returns to zero: no memset, and graph replays
// of a recorded call stay valid.  Launches of one library are
// stream-ordered.
// The first design (-DFACES_FIRST, cuda_build.FACES_FIRST), a thread an
// item: face_keys_count a vertex, the caller's torch.cumsum of the used
// flags and stable torch.sort of the zero counts, face_keys_fill a used
// vertex in that order writing its 2^kz replicas; the caller's torch.cumsum
// of the kept flags, face_fans_count a region slot, the caller's
// torch.cumsum of the triangles, face_fans_fill a region slot, its
// insertion sort in its segment of global scratch.  Its launch functions
// are named *_first_launch; faces_first_design() says which build this is.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include "grid_region.cuh"

namespace faces {
namespace {

typedef long long ll;
typedef unsigned long long ull;
constexpr int R = 33;      // columns
constexpr int NW = 2;      // words a row
constexpr int kThreads = 256;
// the count vector (tropical_torch/extract/device.py FC_*)
constexpr int FC_KEEPV = 0, FC_PRE = 1, FC_LIVE = 2, FC_EKEEP = 3,
              FC_USED = 4, FC_REP = 5, FC_KEPT = 6, FC_TRI = 7, FC_HIST = 8;
constexpr int kKzMax = 3 + R - 1;  // zero columns: 3 grid, 32 neurons
constexpr int KZ_NONE = 64;        // an unused vertex's zero count
#ifdef FACES_FIRST
constexpr bool kFacesFirst = true;
#else
constexpr bool kFacesFirst = false;
#endif
constexpr ll SIG_NONE = 0x7FFFFFFFFFFFFFFFLL;
constexpr float kFix = 4194304.0f;  // 2^22, the means' fixed point
// a region key's grid fields (offset + 2, 10 bits), axis 0 highest, above
// the 32 hidden neurons' sign bits
__device__ __forceinline__ int key_shift(int d) { return 52 - 10 * d; }

int blocks(ll n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

int done(int launched = 1) {
  const int rc = static_cast<int>(cudaGetLastError());
  return rc ? -rc : launched;
}

// v summed over the block of kBlock threads (a warp's by shuffles, the
// warps' by one thread) into *dst by one atomic; every thread of the block
// calls it
template <int kBlock = kThreads>
__device__ __forceinline__ void block_sum(ull v, ull* dst) {
  __shared__ ull part[kBlock / 32];
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    ull s = 0;
    for (int w = 0; w < kBlock / 32; ++w) s += part[w];
    if (s) atomicAdd(dst, s);
  }
  __syncthreads();  // part is the next call's
}

// --- final_keep ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) keep_vertices_kernel(
    const float* __restrict__ V, const float* __restrict__ OUT, ll n,
    float eps, float scale, int* keep, ull* fc) {
  const ll v = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool k = false;
  if (v < n) {
    k = fabsf(OUT[R * v + R - 1]) < eps;
    for (int d = 0; d < 3; ++d) {
      const float xu = grid_region::unit(V[3 * v + d], scale);
      k = k && !(xu > 1.0f) && !(xu < 0.0f);
    }
    keep[v] = k;
  }
  block_sum(k, fc + FC_KEEPV);
}

// ends: [2, nV], row 0 the ends of an edge, row 1 those of a kept edge
// (set to 1 by every edge that has them: the stores race, with one value)
__global__ void __launch_bounds__(kThreads) keep_edges_kernel(
    const int* __restrict__ E, ll n, const int* __restrict__ keep, ll nV,
    int* ends, ull* fc) {
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool ek = false;
  if (e < n) {
    const int a = E[2 * e], b = E[2 * e + 1];
    ends[a] = 1;
    ends[b] = 1;
    ek = keep[a] && keep[b];
    if (ek) {
      ends[nV + a] = 1;
      ends[nV + b] = 1;
    }
  }
  block_sum(e < n, fc + FC_LIVE);
  block_sum(ek, fc + FC_EKEEP);
}

// --- face_keys and face_fans: shared pieces ----------------------------------

// a used vertex's all-minus region key (each zero column on its - side: a
// grid axis's cell below, a neuron's sign bit 0) and its zero columns: the
// key's low and high words, the zero neurons' bits, the on-plane axes' bits
__device__ __forceinline__ int4 region_row(
    const float* __restrict__ V, const int* __restrict__ SB,
    const int* __restrict__ ZB, ll v, const float* __restrict__ marks, int M,
    const int* __restrict__ lut, int lut_k, float eps, float scale) {
  ll key = 0;
  unsigned gz = 0u;
  for (int d = 0; d < 3; ++d) {
    bool on;
    const int off = grid_region::cell(grid_region::unit(V[3 * v + d], scale),
                                      eps, marks, M, lut, lut_k, &on);
    key |= static_cast<ll>(off + 2 - on) << key_shift(d);
    gz |= static_cast<unsigned>(on) << d;
  }
  const unsigned zw = static_cast<unsigned>(ZB[NW * v]);
  key |= static_cast<ll>(static_cast<unsigned>(SB[NW * v]) & ~zw);
  return make_int4(static_cast<int>(static_cast<unsigned>(key)),
                   static_cast<int>(key >> 32), static_cast<int>(zw),
                   static_cast<int>(gz));
}

// a key row's zero count (kz)
__device__ __forceinline__ int zero_count(int4 r) {
  return __popc(static_cast<unsigned>(r.z)) +
         __popc(static_cast<unsigned>(r.w));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// a kept region's fan, its members (ids from svid at s, c of them) sorted in
// place in (sc, id), element k at k * st: each member's angular score
// around the normal n against the first member, s = cos sign(dn) + 2 (dn <
// 0), inserted by a stable insertion sort, descending; then the repeated
// ids dropped in place (the first in angle order kept).  Returns the
// distinct ids' count.
__device__ __forceinline__ int sorted_fan(
    const int* __restrict__ svid, ll s, int c, float mx, float my, float mz,
    float nx, float ny, float nz, const float* __restrict__ Vf, float* sc,
    int* id, int st) {
  const ll v0 = svid[s];
  const float ax = sub(Vf[3 * v0], mx), ay = sub(Vf[3 * v0 + 1], my),
              az = sub(Vf[3 * v0 + 2], mz);
  const float na = sqrtf(add(add(mul(ax, ax), mul(ay, ay)), mul(az, az)));
  for (int k = 0; k < c; ++k) {
    const int v = svid[s + k];
    const ll w = v;
    const float ux = sub(Vf[3 * w], mx), uy = sub(Vf[3 * w + 1], my),
                uz = sub(Vf[3 * w + 2], mz);
    const float dx = sub(mul(ay, uz), mul(az, uy));
    const float dy = sub(mul(az, ux), mul(ax, uz));
    const float dz = sub(mul(ax, uy), mul(ay, ux));
    const float nu = sqrtf(add(add(mul(ux, ux), mul(uy, uy)), mul(uz, uz)));
    float den = mul(na, nu);
    den = den < 1e-8f ? 1e-8f : den;
    const float cs = __fdiv_rn(add(add(mul(ax, ux), mul(ay, uy)), mul(az, uz)),
                               den);
    const float dn = add(add(mul(dx, nx), mul(dy, ny)), mul(dz, nz));
    const float x = add(mul(cs, dn >= 0.0f ? 1.0f : -1.0f),
                        dn < 0.0f ? 2.0f : 0.0f);
    int p = k;
    for (; p > 0 && sc[(p - 1) * st] < x; --p) {
      sc[p * st] = sc[(p - 1) * st];
      id[p * st] = id[(p - 1) * st];
    }
    sc[p * st] = x;
    id[p * st] = v;
  }
  int m = 0;
  for (int k = 0; k < c; ++k) {
    const int v = id[k * st];
    bool seen = false;
    for (int q = 0; q < m && !seen; ++q) seen = id[q * st] == v;
    if (!seen) id[m++ * st] = v;
  }
  return m;
}

#ifdef FACES_FIRST

// --- face_keys, the first design ---------------------------------------------

// a used vertex's key row and zero count: rows [n, 4], kz [n]; an unused
// vertex's row 0 and kz KZ_NONE
__global__ void __launch_bounds__(kThreads) face_keys_count_kernel(
    const float* __restrict__ V, const int* __restrict__ SB,
    const int* __restrict__ ZB, const int* __restrict__ ends, ll n,
    const float* __restrict__ marks, int M, const int* __restrict__ lut,
    int lut_k, float eps, float scale, int* kz, int4* rows, ull* fc) {
  __shared__ int hist[kKzMax + 1];
  for (int t = threadIdx.x; t <= kKzMax; t += blockDim.x) hist[t] = 0;
  const ll v = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool pre = v < n && ends[v];
  const bool used = v < n && ends[n + v];
  ull reps = 0;
  __syncthreads();
  if (used) {
    const int4 r = region_row(V, SB, ZB, v, marks, M, lut, lut_k, eps, scale);
    const int k = zero_count(r);
    kz[v] = k;
    rows[v] = r;
    reps = 1ULL << k;
    atomicAdd(&hist[k], 1);
  } else if (v < n) {
    kz[v] = KZ_NONE;
    rows[v] = make_int4(0, 0, 0, 0);
  }
  block_sum(pre, fc + FC_PRE);
  block_sum(used, fc + FC_USED);
  block_sum(reps, fc + FC_REP);
  for (int t = threadIdx.x; t <= kKzMax; t += blockDim.x)
    if (hist[t]) atomicAdd(fc + FC_HIST + t, static_cast<ull>(hist[t]));
}

// thread i: the i-th used vertex in (kz, vertex) order (the stable sort of
// kz: kzs its values, order its permutation); its first replica's slot is
// the replicas of every smaller kz plus 2^kz for each earlier vertex of its
// own, from the histogram; replica p takes the + side of the zero columns
// whose rank is a set bit of p
__global__ void __launch_bounds__(kThreads) face_keys_fill_kernel(
    const float* __restrict__ V, const int4* __restrict__ rows,
    const int* __restrict__ kzs, const ll* __restrict__ order,
    const int* __restrict__ vcum, const ll* __restrict__ fc, ll n_used,
    ll* keys, int* rvid, float* Vf) {
  const ll i = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_used) return;
  const ll v = order[i];
  const int k = kzs[i];
  ll first = 0, before = 0;
  for (int q = 0; q < k; ++q) {
    first += fc[FC_HIST + q] << q;
    before += fc[FC_HIST + q];
  }
  first += (i - before) << k;
  const int vid = vcum[v] - 1;
  for (int d = 0; d < 3; ++d) Vf[3 * static_cast<ll>(vid) + d] = V[3 * v + d];
  const int4 r = rows[v];
  const ll base = static_cast<ll>(static_cast<unsigned>(r.x)) |
                  (static_cast<ll>(r.y) << 32);
  const unsigned zw = static_cast<unsigned>(r.z);
  const unsigned gz = static_cast<unsigned>(r.w);
  for (ll p = 0; p < (1LL << k); ++p) {
    ll key = base;
    int rank = 0;
    for (int d = 0; d < 3; ++d) {
      if (!((gz >> d) & 1u)) continue;
      if ((p >> rank) & 1) key += 1LL << key_shift(d);
      ++rank;
    }
    for (int c = 0; c < 32; ++c) {
      if (!((zw >> c) & 1u)) continue;
      if ((p >> rank) & 1) key += 1LL << c;
      ++rank;
    }
    keys[first + p] = key;
    rvid[first + p] = vid;
  }
}

// --- face_fans, the first design ---------------------------------------------

// thread j: a kept region slot's distinct members less 2, its triangles;
// its mean at its rank among the kept (kcum: the keep flags' inclusive
// prefix sum)
__global__ void __launch_bounds__(kThreads) face_fans_count_kernel(
    const ll* __restrict__ rord, const int* __restrict__ rcnt,
    const int* __restrict__ svid, const float* __restrict__ mean,
    const int* __restrict__ keep, const ll* __restrict__ kcum, ll n,
    ull* fc, ll* ntri, float* mk) {
  const ll j = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool kept = j < n && keep[j];
  ll nt = 0;
  if (kept) {
    const ll s = rord[j];
    const int c = rcnt[s];
    int distinct = 0;
    for (int k = 0; k < c; ++k) {
      const int v = svid[s + k];
      bool seen = false;
      for (int q = 0; q < k && !seen; ++q) seen = svid[s + q] == v;
      distinct += !seen;
    }
    nt = distinct > 2 ? distinct - 2 : 0;
    const ll r = kcum[j] - 1;
    for (int d = 0; d < 3; ++d) mk[3 * r + d] = mean[3 * s + d];
  }
  if (j < n) ntri[j] = nt;
  block_sum(kept, fc + FC_KEPT);
  block_sum(static_cast<ull>(nt), fc + FC_TRI);
}

// thread j: a kept region slot's fan (sorted_fan in the region's segment of
// the scratch score, ids), triangle t (v_t+2, v_t+1, v0) at the region's
// slot of tcum (ntri's inclusive prefix sum)
__global__ void __launch_bounds__(kThreads) face_fans_fill_kernel(
    const ll* __restrict__ rord, const int* __restrict__ rcnt,
    const int* __restrict__ svid, const float* __restrict__ mean,
    const int* __restrict__ keep, const ll* __restrict__ kcum,
    const ll* __restrict__ ntri, const ll* __restrict__ tcum,
    const float* __restrict__ nrm, const float* __restrict__ Vf, ll n,
    float* score, int* ids, ll* tris) {
  const ll j = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n || !keep[j]) return;
  const ll s = rord[j];
  const ll r = kcum[j] - 1;
  int* id = ids + s;
  const int m = sorted_fan(svid, s, rcnt[s], mean[3 * s], mean[3 * s + 1],
                           mean[3 * s + 2], nrm[3 * r], nrm[3 * r + 1],
                           nrm[3 * r + 2], Vf, score + s, id, 1);
  ll* out = tris + 3 * (tcum[j] - ntri[j]);
  for (int t = 0; t + 2 < m; ++t) {
    out[3 * t] = id[t + 2];
    out[3 * t + 1] = id[t + 1];
    out[3 * t + 2] = id[0];
  }
}

#else  // the design

constexpr int kClasses = kKzMax + 1;  // the zero counts 0..kKzMax
constexpr unsigned kFull = 0xFFFFFFFFu;
// face_keys_count, face_keys_fill and face_fans_count: a tile of kTile
// items, a thread an item
constexpr int kTile = 1024;
constexpr int kTileWarps = kTile / 32;
// face_fans_count's look-back: a tile's status word, its flag (top two
// bits) over its counts, the kept regions (bits 0-30) and their triangles
// (31-61); 0 before the tile publishes
constexpr int kMaxTiles = 1 << 16;
constexpr ull kAggregate = 1ull << 62;
constexpr ull kInclusive = 2ull << 62;
constexpr ull kFlags = 3ull << 62;
constexpr int kTriShift = 31;
constexpr ull kKeptMask = (1ull << kTriShift) - 1;
__device__ ull g_status[kMaxTiles];
__device__ int g_tile;
__device__ int g_done;
// face_keys_fill: the earlier tiles' class counts, summed by kParts rows of
// kClasses threads
constexpr int kParts = kTile / kClasses;
// face_fans_fill: a region of at most kFanSmall members sorts in shared
// memory
constexpr int kFanSmall = 8;

__device__ __forceinline__ ull status_load(int t) {
  return cuda::atomic_ref<ull, cuda::thread_scope_device>(g_status[t])
      .load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void status_store(int t, ull v) {
  cuda::atomic_ref<ull, cuda::thread_scope_device>(g_status[t])
      .store(v, cuda::std::memory_order_relaxed);
}

// the block's tile: the id thread 0 takes from the counter, so that a tile
// waits only on tiles already running
__device__ __forceinline__ int take_tile() {
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(&g_tile, 1);
  __syncthreads();
  return tile_s;
}

// lane 0 of warp 0, once the tile's look-back and statuses are done: true
// in the last block to get here, which then returns the state to zero
// (reset_state)
__device__ __forceinline__ bool take_done() {
  __threadfence();
  return atomicAdd(&g_done, 1) == static_cast<int>(gridDim.x) - 1;
}

// the look-back state back at zero, by every thread of the last block
__device__ __forceinline__ void reset_state() {
  for (int t = threadIdx.x; t < static_cast<int>(gridDim.x); t += blockDim.x)
    g_status[t] = 0ull;
  if (threadIdx.x == 0) {
    g_tile = 0;
    g_done = 0;
  }
}

// the exclusive sum of x over the tile's threads in order; *total the
// tile's sum.  Every thread calls it, once a launch.
__device__ __forceinline__ ull tile_exclusive(ull x, ull* total) {
  static_assert(kTileWarps == 32, "warp 0 scans a lane a warp");
  __shared__ ull part[kTileWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ull inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const ull y = __shfl_sync(kFull, inc, max(lane - d, 0));
    if (lane >= d) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' sums scanned
    const ull w = part[lane];
    ull wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const ull y = __shfl_sync(kFull, wi, max(lane - d, 0));
      if (lane >= d) wi += y;
    }
    part[lane] = wi - w;
    if (lane == 31) part[kTileWarps] = wi;
  }
  __syncthreads();
  *total = part[kTileWarps];
  return part[warp] + inc - x;
}

// the lane of the e-th (from 0) set bit of m
__device__ __forceinline__ int nth_lane(unsigned m, int e) {
  int lane = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (e >= c) {
      e -= c;
      m >>= w;
      lane += w;
    } else {
      m = low;
    }
  }
  return lane;
}

// replica p of a key row (lo, hi, zw, gz): the zero column of rank r takes
// its + side where bit r of p is set, the grid axes first, then the neurons
__device__ __forceinline__ ll replica_key(int lo, int hi, unsigned zw,
                                          unsigned gz, ll p) {
  ll key = static_cast<ll>(static_cast<unsigned>(lo)) |
           (static_cast<ll>(hi) << 32);
  for (unsigned g = gz; g; g &= g - 1u, p >>= 1)
    if (p & 1) key += 1LL << key_shift(__ffs(static_cast<int>(g)) - 1);
  for (unsigned z = zw; z; z &= z - 1u, p >>= 1)
    if (p & 1) key += 1LL << (__ffs(static_cast<int>(z)) - 1);
  return key;
}

// --- face_keys ---------------------------------------------------------------

// a tile of kTile vertices, a thread a vertex: each used vertex's key row
// (rows [n, 4], 0 for an unused one) and its rank in the tile among the
// used and among the used of its zero count (rk [n, 2], (-1, -1) for an
// unused one), a ballot a class present in the warp, the warps' counts in
// shared memory (cnt[w][c]: warp w's count of class c, c = kClasses the
// used, then its offset in the tile); the tile's class counts (agg
// [tiles, kClasses]); the vertices of an edge, the used, their replicas and
// the histogram into fc, by one atomic a block and a class
__global__ void __launch_bounds__(kTile) face_keys_count_kernel(
    const float* __restrict__ V, const int* __restrict__ SB,
    const int* __restrict__ ZB, const int* __restrict__ ends, ll n,
    const float* __restrict__ marks, int M, const int* __restrict__ lut,
    int lut_k, float eps, float scale, int4* rows, int2* rk, int* agg,
    ull* fc) {
  __shared__ int cnt[kTileWarps][kClasses + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const ll v = static_cast<ll>(blockIdx.x) * kTile + threadIdx.x;
  const bool pre = v < n && ends[v];
  int k = -1;
  if (v < n && ends[n + v]) {
    const int4 r = region_row(V, SB, ZB, v, marks, M, lut, lut_k, eps, scale);
    rows[v] = r;
    k = zero_count(r);
  } else if (v < n) {
    rows[v] = make_int4(0, 0, 0, 0);
  }
  for (int t = threadIdx.x; t < kTileWarps * (kClasses + 1); t += kTile)
    cnt[t / (kClasses + 1)][t % (kClasses + 1)] = 0;
  __syncthreads();
  const unsigned um = __ballot_sync(kFull, k >= 0);
  int wr = 0;
  for (unsigned pending = um; pending;) {
    const int leader = __ffs(static_cast<int>(pending)) - 1;
    const int kk = __shfl_sync(kFull, k, leader);
    const unsigned m = __ballot_sync(kFull, k == kk);
    if (k == kk) wr = __popc(m & lt);
    if (lane == leader) cnt[warp][kk] = __popc(m);
    pending &= ~m;
  }
  if (lane == 0) cnt[warp][kClasses] = __popc(um);
  __syncthreads();
  if (threadIdx.x <= kClasses) {
    const int c = threadIdx.x;
    int o = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      const int t = cnt[w][c];
      cnt[w][c] = o;
      o += t;
    }
    if (c < kClasses) {
      agg[static_cast<ll>(blockIdx.x) * kClasses + c] = o;
      if (o) {
        atomicAdd(fc + FC_HIST + c, static_cast<ull>(o));
        atomicAdd(fc + FC_REP, static_cast<ull>(o) << c);
      }
    } else if (o) {
      atomicAdd(fc + FC_USED, static_cast<ull>(o));
    }
  }
  __syncthreads();
  if (v < n)
    rk[v] = k < 0 ? make_int2(-1, -1)
                  : make_int2(cnt[warp][kClasses] + __popc(um & lt),
                              cnt[warp][k] + wr);
  block_sum<kTile>(pre, fc + FC_PRE);
}

// the tiles of face_keys_count, a thread a vertex: the used vertices and
// the used of each zero count of the tiles before (agg's earlier rows
// summed), then a used vertex's id (its rank among all the used) and its
// rank among the used of its class; its point at its id (Vf [n_used, 3])
// and its 2^kz replicas (keys, and the id in rvid) at its class's slots
// (first: the replicas of every smaller zero count, from the histogram in
// fc) and its rank there.  A warp's used vertices of one class have
// consecutive ranks, so their replicas fill one run of slots, which its
// lanes write a slot a lane, each slot's row and id shuffled from its
// vertex's lane.
__global__ void __launch_bounds__(kTile) face_keys_fill_kernel(
    const float* __restrict__ V, const int4* __restrict__ rows,
    const int2* __restrict__ rk, const int* __restrict__ agg,
    const ll* __restrict__ fc, ll n, ll* keys, int* rvid, float* Vf) {
  __shared__ int part[kParts][kClasses];
  __shared__ int before[kClasses + 1];
  __shared__ ll first[kClasses];
  const int lane = threadIdx.x & 31;
  const ll v = static_cast<ll>(blockIdx.x) * kTile + threadIdx.x;
  const int2 ir = v < n ? rk[v] : make_int2(-1, -1);
  const bool used = ir.x >= 0;
  int4 row = make_int4(0, 0, 0, 0);
  if (used) row = rows[v];
  {
    const int g = threadIdx.x / kClasses, c = threadIdx.x % kClasses;
    if (g < kParts) {
      int acc = 0;
      for (int p = g; p < static_cast<int>(blockIdx.x); p += kParts)
        acc += agg[static_cast<ll>(p) * kClasses + c];
      part[g][c] = acc;
    }
  }
  if (threadIdx.x == 0) {
    ll f = 0;
    for (int c = 0; c < kClasses; ++c) {
      first[c] = f;
      f += fc[FC_HIST + c] << c;
    }
  }
  __syncthreads();
  if (threadIdx.x < kClasses) {
    int b = 0;
    for (int g = 0; g < kParts; ++g) b += part[g][threadIdx.x];
    before[threadIdx.x] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int u = 0;
    for (int c = 0; c < kClasses; ++c) u += before[c];
    before[kClasses] = u;
  }
  __syncthreads();
  const int k = used ? zero_count(row) : -1;
  const int vid = used ? before[kClasses] + ir.x : -1;
  if (used)
    for (int d = 0; d < 3; ++d) Vf[3 * static_cast<ll>(vid) + d] = V[3 * v + d];
  for (unsigned pending = __ballot_sync(kFull, used); pending;) {
    const int leader = __ffs(static_cast<int>(pending)) - 1;
    const int kk = __shfl_sync(kFull, k, leader);
    const unsigned m = __ballot_sync(kFull, k == kk);
    pending &= ~m;
    const ll s0 = first[kk] +
                  (static_cast<ll>(before[kk] +
                                   __shfl_sync(kFull, ir.y, leader)) << kk);
    const ll total = static_cast<ll>(__popc(m)) << kk;
    for (ll b = 0; b < total; b += 32) {
      const ll j = b + lane;
      const bool ok = j < total;
      const int src = nth_lane(m, ok ? static_cast<int>(j >> kk) : 0);
      const int x = __shfl_sync(kFull, row.x, src);
      const int y = __shfl_sync(kFull, row.y, src);
      const int z = __shfl_sync(kFull, row.z, src);
      const int w = __shfl_sync(kFull, row.w, src);
      const int id = __shfl_sync(kFull, vid, src);
      if (ok) {
        keys[s0 + j] = replica_key(x, y, static_cast<unsigned>(z),
                                   static_cast<unsigned>(w),
                                   j & ((1LL << kk) - 1));
        rvid[s0 + j] = id;
      }
    }
  }
}

// --- face_fans ---------------------------------------------------------------

// warp 0 of tile t > 0: the packed counts of the tiles before it, from
// their status words, 32 a round (lane l reads tile t - 1 - l - 32 round):
// each word waited for, then the counts summed up to the nearest inclusive
// prefix (the lowest such lane)
__device__ __forceinline__ ull look_back(int t, int lane) {
  ull before = 0;
  for (int j = t - 1;; j -= 32) {
    const int p = j - lane;
    ull st = p >= 0 ? status_load(p) : kInclusive;
    while (__ballot_sync(kFull, (st & kFlags) == 0ull))
      if ((st & kFlags) == 0ull) st = status_load(p);
    const unsigned inc = __ballot_sync(kFull, (st & kFlags) == kInclusive);
    const int stop = inc ? __ffs(static_cast<int>(inc)) - 1 : 31;
    ull v = lane <= stop ? st & ~kFlags : 0ull;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    before += v;
    if (inc) return before;
  }
}

// a tile of kTile region slots, a thread a slot: each kept slot's region
// (rord[j]: its start in the sorted replicas, rcnt its count) ranked among
// the kept, its distinct members less 2 (its triangles) and their offset
// among all the triangles, by a scan of both counts packed in 64 bits in
// the tile and a decoupled look-back across tiles (the tile's id from a
// counter; warp 0 publishes the tile's counts, looks back and publishes its
// inclusive counts); the kept regions' (start, count, triangle offset,
// triangles) at their ranks (kl [n, 4]) and their means (mk [n, 3]), rows
// past the kept ones left as they were.  The last tile adds the kept
// regions and the triangles to fc.
__global__ void __launch_bounds__(kTile) face_fans_count_kernel(
    const ll* __restrict__ rord, const int* __restrict__ rcnt,
    const int* __restrict__ svid, const float* __restrict__ mean,
    const int* __restrict__ keep, ll n, ull* fc, int4* kl, float* mk) {
  __shared__ ull before_s;
  __shared__ int last_s;
  const int lane = threadIdx.x & 31;
  const int tile = take_tile();
  const ll j = static_cast<ll>(tile) * kTile + threadIdx.x;
  const ll s = j < n && keep[j] ? rord[j] : -1;
  const int c = s >= 0 ? rcnt[s] : 0;
  int distinct = 0;
  for (int k = 0; k < c; ++k) {
    const int v = svid[s + k];
    bool seen = false;
    for (int q = 0; q < k && !seen; ++q) seen = svid[s + q] == v;
    distinct += !seen;
  }
  const int nt = distinct > 2 ? distinct - 2 : 0;
  ull run;  // the tile's counts
  const ull off = tile_exclusive(
      static_cast<ull>(s >= 0) | (static_cast<ull>(nt) << kTriShift), &run);
  if (threadIdx.x < 32) {
    if (lane == 0)
      status_store(tile, (tile ? kAggregate : kInclusive) | run);
    const ull before = tile ? look_back(tile, lane) : 0ull;
    if (lane == 0) {
      if (tile) status_store(tile, kInclusive | (before + run));
      before_s = before;
      if (tile == static_cast<int>(gridDim.x) - 1) {  // the totals
        const ull tot = before + run;
        if (tot & kKeptMask) atomicAdd(fc + FC_KEPT, tot & kKeptMask);
        if (tot >> kTriShift) atomicAdd(fc + FC_TRI, tot >> kTriShift);
      }
      last_s = take_done();
    }
  }
  __syncthreads();
  if (s >= 0) {
    const ull o = before_s + off;
    const ll r = static_cast<ll>(o & kKeptMask);
    kl[r] = make_int4(static_cast<int>(s), c,
                      static_cast<int>(o >> kTriShift), nt);
    for (int d = 0; d < 3; ++d) mk[3 * r + d] = mean[3 * s + d];
  }
  if (last_s) reset_state();
}

// a thread a kept region (kl's row r, its mean mk and normal nrm at r): its
// fan sorted (sorted_fan) in shared memory (element k of thread t at k *
// kThreads + t) up to kFanSmall members, else in its segment of the scratch
// (score, ids at its start); then the block's triangles, one run of rows
// (t0, t1), an integer a thread: triangle t's region the block's last with
// an offset <= t, (v_t+2, v_t+1, v0) of its distinct ids
__global__ void __launch_bounds__(kThreads) face_fans_fill_kernel(
    const int4* __restrict__ kl, const int* __restrict__ svid,
    const float* __restrict__ mk, const float* __restrict__ nrm,
    const float* __restrict__ Vf, ll n_kept, float* score, int* ids,
    ll* tris) {
  __shared__ float sc_s[kFanSmall * kThreads];
  __shared__ int id_s[kFanSmall * kThreads];
  __shared__ int4 reg_s[kThreads];
  const ll r0 = static_cast<ll>(blockIdx.x) * kThreads;
  const ll r = r0 + threadIdx.x;
  const int nb = static_cast<int>(min(static_cast<ll>(kThreads), n_kept - r0));
  if (r < n_kept) {
    const int4 g = kl[r];
    reg_s[threadIdx.x] = g;
    const bool small = g.y <= kFanSmall;
    sorted_fan(svid, g.x, g.y, mk[3 * r], mk[3 * r + 1], mk[3 * r + 2],
               nrm[3 * r], nrm[3 * r + 1], nrm[3 * r + 2], Vf,
               small ? sc_s + threadIdx.x : score + g.x,
               small ? id_s + threadIdx.x : ids + g.x, small ? kThreads : 1);
  }
  __syncthreads();
  const ll t0 = reg_s[0].z;
  const ll t1 = static_cast<ll>(reg_s[nb - 1].z) + reg_s[nb - 1].w;
  for (ll e = threadIdx.x; e < 3 * (t1 - t0); e += kThreads) {
    const ll t = t0 + e / 3;
    const int col = static_cast<int>(e % 3);
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (reg_s[mid].z <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int4 g = reg_s[lo];
    const int pos = col == 2 ? 0 : static_cast<int>(t - g.z) + 2 - col;
    tris[3 * t0 + e] = g.y <= kFanSmall ? id_s[pos * kThreads + lo]
                                        : ids[g.x + pos];
  }
}

#endif  // FACES_FIRST

// --- face_regions ------------------------------------------------------------------

// thread i: replica i of the key-sorted order (perm: the sort's permutation)
// writes its member id; the one that starts a run of equal keys (a region)
// its signature (first member << 32 | count), count and mean: the members'
// coordinates rounded to 2^-22 and summed as integers, one division
__global__ void __launch_bounds__(kThreads) face_regions_runs_kernel(
    const ll* __restrict__ skey, const ll* __restrict__ perm,
    const int* __restrict__ rvid, const float* __restrict__ Vf, ll n,
    ll* sig, int* rcnt, float* mean, int* svid) {
  const ll i = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v0 = rvid[perm[i]];
  svid[i] = v0;
  const ll key = skey[i];
  if (i > 0 && skey[i - 1] == key) {
    sig[i] = SIG_NONE;
    rcnt[i] = 0;
    for (int d = 0; d < 3; ++d) mean[3 * i + d] = 0.0f;
    return;
  }
  ll sum[3] = {0, 0, 0};
  int c = 0;
  do {
    const ll v = rvid[perm[i + c]];
    for (int d = 0; d < 3; ++d) sum[d] += llrintf(__fmul_rn(Vf[3 * v + d], kFix));
    ++c;
  } while (i + c < n && skey[i + c] == key);
  const float den = __fmul_rn(static_cast<float>(c), kFix);
  for (int d = 0; d < 3; ++d)
    mean[3 * i + d] = __fdiv_rn(static_cast<float>(sum[d]), den);
  sig[i] = (static_cast<ll>(v0) << 32) | c;
  rcnt[i] = c;
}

// thread j: slot j of the signature-sorted regions (rord: the sort's
// permutation of the replica positions) is a duplicate if an earlier slot of
// its run of equal signatures (the same first member and count) has the
// same members, compared one by one with each of them
__global__ void __launch_bounds__(kThreads) face_regions_dups_kernel(
    const ll* __restrict__ ssig, const ll* __restrict__ rord,
    const int* __restrict__ rcnt, const int* __restrict__ svid, ll n,
    int* keep) {
  const ll j = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const ll g = ssig[j];
  if (g == SIG_NONE) {
    keep[j] = 0;
    return;
  }
  const ll s = rord[j];
  const int c = rcnt[s];
  bool dup = false;
  for (ll q = j - 1; q >= 0 && !dup && ssig[q] == g; --q) {
    const ll t = rord[q];
    bool same = true;
    for (int k = 1; k < c && same; ++k) same = svid[s + k] == svid[t + k];
    dup = same;
  }
  keep[j] = c >= 3 && !dup;
}

}  // namespace

// --- launch functions (tropical_torch/extract/device.py's stage order) --------

extern "C" {

// the vertex pass, then the edge pass (none without edges)
int final_keep_launch(const float* V, const float* OUT, ll nV, const int* E,
                      ll nE, float eps, float scale, int* keep, int* ends,
                      ull* fc, cudaStream_t stream) {
  int launched = 0;
  if (nV > 0) {
    keep_vertices_kernel<<<blocks(nV), kThreads, 0, stream>>>(
        V, OUT, nV, eps, scale, keep, fc);
    ++launched;
  }
  if (nE > 0) {
    keep_edges_kernel<<<blocks(nE), kThreads, 0, stream>>>(E, nE, keep, nV,
                                                          ends, fc);
    ++launched;
  }
  return done(launched);
}

int face_regions_runs_launch(const ll* skey, const ll* perm, const int* rvid,
                             const float* Vf, ll n, ll* sig, int* rcnt,
                             float* mean, int* svid, cudaStream_t stream) {
  face_regions_runs_kernel<<<blocks(n), kThreads, 0, stream>>>(
      skey, perm, rvid, Vf, n, sig, rcnt, mean, svid);
  return done();
}

int face_regions_dups_launch(const ll* ssig, const ll* rord, const int* rcnt,
                             const int* svid, ll n, int* keep,
                             cudaStream_t stream) {
  face_regions_dups_kernel<<<blocks(n), kThreads, 0, stream>>>(
      ssig, rord, rcnt, svid, n, keep);
  return done();
}

// 1 in a build of the first design (-DFACES_FIRST), whose launch functions
// are named *_first_launch and whose stage takes the caller's prefix sums
// and sort; else 0
int faces_first_design() { return kFacesFirst ? 1 : 0; }

#ifdef FACES_FIRST

int face_keys_count_first_launch(const float* V, const int* SB, const int* ZB,
                                 const int* ends, ll n, const float* marks,
                                 ll M, const int* lut, ll lut_k, float eps,
                                 float scale, int* kz, int* rows, ull* fc,
                                 cudaStream_t stream) {
  face_keys_count_kernel<<<blocks(n), kThreads, 0, stream>>>(
      V, SB, ZB, ends, n, marks, static_cast<int>(M), lut,
      static_cast<int>(lut_k), eps, scale, kz, reinterpret_cast<int4*>(rows),
      fc);
  return done();
}

int face_keys_fill_first_launch(const float* V, const int* rows,
                                const int* kzs, const ll* order,
                                const int* vcum, const ll* fc, ll n_used,
                                ll* keys, int* rvid, float* Vf,
                                cudaStream_t stream) {
  face_keys_fill_kernel<<<blocks(n_used), kThreads, 0, stream>>>(
      V, reinterpret_cast<const int4*>(rows), kzs, order, vcum, fc, n_used,
      keys, rvid, Vf);
  return done();
}

int face_fans_count_first_launch(const ll* rord, const int* rcnt,
                                 const int* svid, const float* mean,
                                 const int* keep, const ll* kcum, ll n,
                                 ull* fc, ll* ntri, float* mk,
                                 cudaStream_t stream) {
  face_fans_count_kernel<<<blocks(n), kThreads, 0, stream>>>(
      rord, rcnt, svid, mean, keep, kcum, n, fc, ntri, mk);
  return done();
}

int face_fans_fill_first_launch(const ll* rord, const int* rcnt,
                                const int* svid, const float* mean,
                                const int* keep, const ll* kcum,
                                const ll* ntri, const ll* tcum,
                                const float* nrm, const float* Vf, ll n,
                                float* score, int* ids, ll* tris,
                                cudaStream_t stream) {
  face_fans_fill_kernel<<<blocks(n), kThreads, 0, stream>>>(
      rord, rcnt, svid, mean, keep, kcum, ntri, tcum, nrm, Vf, n, score, ids,
      tris);
  return done();
}

#else

// a tile of kTile vertices a block; agg [tiles, 36]
int face_keys_count_launch(const float* V, const int* SB, const int* ZB,
                           const int* ends, ll n, const float* marks, ll M,
                           const int* lut, ll lut_k, float eps, float scale,
                           int* rows, int* rk, int* agg, ull* fc,
                           cudaStream_t stream) {
  face_keys_count_kernel<<<static_cast<int>((n + kTile - 1) / kTile), kTile,
                           0, stream>>>(
      V, SB, ZB, ends, n, marks, static_cast<int>(M), lut,
      static_cast<int>(lut_k), eps, scale, reinterpret_cast<int4*>(rows),
      reinterpret_cast<int2*>(rk), agg, fc);
  return done();
}

int face_keys_fill_launch(const float* V, const int* rows, const int* rk,
                          const int* agg, const ll* fc, ll n, ll* keys,
                          int* rvid, float* Vf, cudaStream_t stream) {
  face_keys_fill_kernel<<<static_cast<int>((n + kTile - 1) / kTile), kTile,
                          0, stream>>>(
      V, reinterpret_cast<const int4*>(rows), reinterpret_cast<const int2*>(rk),
      agg, fc, n, keys, rvid, Vf);
  return done();
}

// a tile of kTile region slots a block (at most kMaxTiles: -1, the CUDA
// error cudaErrorInvalidValue, past them)
int face_fans_count_launch(const ll* rord, const int* rcnt, const int* svid,
                           const float* mean, const int* keep, ll n, ull* fc,
                           int* kl, float* mk, cudaStream_t stream) {
  const ll tiles = (n + kTile - 1) / kTile;
  if (tiles > kMaxTiles) return -static_cast<int>(cudaErrorInvalidValue);
  face_fans_count_kernel<<<static_cast<int>(tiles), kTile, 0, stream>>>(
      rord, rcnt, svid, mean, keep, n, fc, reinterpret_cast<int4*>(kl), mk);
  return done();
}

int face_fans_fill_launch(const int* kl, const int* svid, const float* mk,
                          const float* nrm, const float* Vf, ll n_kept,
                          float* score, int* ids, ll* tris,
                          cudaStream_t stream) {
  face_fans_fill_kernel<<<blocks(n_kept), kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(kl), svid, mk, nrm, Vf, n_kept, score,
      ids, tris);
  return done();
}

#endif  // FACES_FIRST

}  // extern "C"

}  // namespace faces
