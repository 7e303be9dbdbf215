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
// Engine.faces) takes the normals from the net's encode kernels.
// device_engine.cu includes this file, so that K3-K6 are one library; its
// names live in namespace faces, its launch functions are extern "C".  Each
// launch function takes device pointers, long long integers and float
// scalars in its declared order, then the stream, and returns the count of
// kernels it launched, or minus a CUDA error.  Each has its plain PyTorch
// version in that module, which it equals bit for bit: the integer work
// exactly, each float operation rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, sqrtf) in the plain version's order, the means from
// integer sums (2^-22 fixed point) and one division, so that no sum depends
// on an order of threads.
//
// Counts go to one int64 vector (device.py FC_*); the host reads it twice:
// after final_keep and face_keys_count (the funnel and the replicas) and
// after face_fans_count (the kept regions and the triangles).
//
// Bound: bytes (a few integer and float operations an item): a vertex's
// row read and flags written, an edge's ends, a replica's key and id, a
// region's members read a few times.
//
// The design: each kernel ranks its items itself, so that the stage takes
// no torch.sort and no torch.cumsum between its kernels.
// - final_keep, one launch: a block of vertices or of edges, a thread an
//   item; a vertex's keep flag, and an edge's ends flags from its two ends'
//   keep tests made again in its own thread (a few loads more an edge, and
//   no block waits on another).
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
// - face_regions, three launches, the order of the two stable sorts (the
//   replicas by key, the regions by signature: first member, then count,
//   ties in key order) without a sort.  face_regions_insert, a thread a
//   replica: its key into a hash table (open addressing, linear probing, a
//   power of two of at least twice the replicas' slots; a 64-bit
//   compare-and-swap claims a slot), the slot's first replica (an atomic
//   min) and count (an atomic add), its first 11 replicas in the order
//   they came, the rest on a list (an atomic exchange of its head).
//   face_regions_rank, a tile of 64 used vertices, a thread a vertex (its
//   replicas are one run of face_keys_fill's order): the regions whose
//   first replica is one of its own, ordered by (count, key) in shared
//   memory up to kBucket of them, else in global scratch; the tile's
//   regions and members ranked by a scan and a decoupled look-back across
//   tiles, so that a region's slot is its rank in signature order and its
//   members' range follows the ranks; its replicas copied into that range
//   and its table slot cleared.  face_regions_members, a thread a region:
//   its replicas sorted in registers, written as ids in its range with the
//   count and the mean at its start; a duplicate where an earlier region
//   of its tie run (the same first member and count) has its members,
//   worked out again from that region's replicas.  The table lives across
//   calls (device.Kernels.region_table): empty when handed out and left
//   empty, as face_fans_count's look-back state below is.
// - face_fans_count: a tile of kTile region slots, a thread a slot, ranks
//   its kept regions and their triangles' offsets (a scan of both counts
//   packed in 64 bits in the tile, a decoupled look-back on one status word
//   across tiles, the tile's id from a counter) and writes the kept regions
//   as a compact list (start, count, triangle offset, triangles) and their
//   means, in rank order.
// - face_fans_fill: a thread a kept region; a region of at most kFanSmall
//   members (the presets' have 3 to 8) is scored, sorted and cleared of
//   repeated ids in shared memory, a larger one in its own segment of
//   global scratch (no cap on a region's size); the block's triangles are
//   one run of rows, which its threads then write an integer a thread.
// The look-back state (status words, the tile counter, the done ticket) is
// device variables, zero when the library loads,
// which the last block of every launch returns to zero: no memset, and
// graph replays of a recorded call stay valid.  Launches of one library
// are stream-ordered.
// The first design (-DFACES_FIRST, cuda_build.FACES_FIRST), a thread an
// item: final_keep a vertex pass, then an edge pass reading the keep
// flags; face_keys_count a vertex, the caller's torch.cumsum of the
// used flags and stable torch.sort of the zero counts, face_keys_fill a
// used vertex in that order writing its 2^kz replicas; the caller's stable
// torch.sort of the keys, face_regions_runs a replica that starts a run of
// equal keys, the caller's stable torch.sort of the signatures,
// face_regions_dups a signature-sorted slot; the caller's torch.cumsum of
// the kept flags, face_fans_count a region slot, the caller's torch.cumsum
// of the triangles, face_fans_fill a region slot, its insertion sort in its
// segment of global scratch.  Its launch functions are named
// *_first_launch but final_keep's; faces_first_design() says which build
// this is.

#include <climits>
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

// a vertex passes the final filter: |sdf| < eps, inside the unit cube
// (its loads independent of one another)
__device__ __forceinline__ bool kept(const float* __restrict__ V,
                                     const float* __restrict__ OUT, ll v,
                                     float eps, float scale) {
  bool k = fabsf(OUT[R * v + R - 1]) < eps;
  for (int d = 0; d < 3; ++d) {
    const float xu = grid_region::unit(V[3 * v + d], scale);
    k &= !(xu > 1.0f) & !(xu < 0.0f);
  }
  return k;
}

#ifdef FACES_FIRST

// --- final_keep, the first design ---------------------------------------------

__global__ void __launch_bounds__(kThreads) keep_vertices_kernel(
    const float* __restrict__ V, const float* __restrict__ OUT, ll n,
    float eps, float scale, int* keep, ull* fc) {
  const ll v = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool k = false;
  if (v < n) {
    k = kept(V, OUT, v, eps, scale);
    keep[v] = k;
  }
  block_sum(k, fc + FC_KEEPV);
}

// ends: [2, nV], zeroed by the caller, row 0 the ends of an edge, row 1
// those of a kept edge (set to 1 by every edge that has them: the stores
// race, with one value)
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

#endif  // FACES_FIRST

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
// the look-backs (face_fans_count, face_regions_rank): a tile's status
// word, its flag (top two bits) over its two counts, the first (kept
// regions; regions) in bits 0-30, the second (triangles; members) in
// 31-61; 0 before the tile publishes
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
// face_regions: a vertex's bucket of at most kBucket regions sorts in
// shared memory; the hash table's empty key (no region key is), and the
// multiplier of its hash (2^64 over the golden ratio)
constexpr int kBucket = 8;
// face_regions_rank: a tile of kRankTile vertices, a thread a vertex
constexpr int kRankTile = 64;
// face_regions_members: a region of at most kMembers members sorts in
// registers
constexpr int kMembers = 8;
constexpr ll kEmptyKey = LLONG_MIN;
constexpr ull kHashMul = 0x9E3779B97F4A7C15ull;

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

// one thread of the block, once the block's waits and statuses are done:
// true in the last block to get here, which then returns the state to zero
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

// the exclusive sum of x over the tile's kBlock threads in order; *total
// the tile's sum.  Every thread calls it, once a launch.
template <int kBlock>
__device__ __forceinline__ ull tile_exclusive(ull x, ull* total) {
  constexpr int kWarps = kBlock / 32;
  static_assert(kWarps <= 32, "warp 0 scans a lane a warp");
  __shared__ ull part[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ull inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const ull y = __shfl_sync(kFull, inc, max(lane - d, 0));
    if (lane >= d) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' sums scanned
    const ull w = lane < kWarps ? part[lane] : 0ull;
    ull wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const ull y = __shfl_sync(kFull, wi, max(lane - d, 0));
      if (lane >= d) wi += y;
    }
    if (lane < kWarps) part[lane] = wi - w;
    if (lane == 31) part[kWarps] = wi;
  }
  __syncthreads();
  *total = part[kWarps];
  return part[warp] + inc - x;
}

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

// every thread of tile t (run: its packed counts): the packed counts of
// the tiles before it, by warp 0 (publishes the tile's counts, looks back,
// publishes its inclusive counts); *last true in the last block done
__device__ __forceinline__ ull tiles_before(int t, ull run, bool* last) {
  __shared__ ull before_s;
  __shared__ int last_s;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    if (lane == 0) status_store(t, (t ? kAggregate : kInclusive) | run);
    const ull before = t ? look_back(t, lane) : 0ull;
    if (lane == 0) {
      if (t) status_store(t, kInclusive | (before + run));
      before_s = before;
      last_s = take_done();
    }
  }
  __syncthreads();
  *last = last_s;
  return before_s;
}

// --- final_keep --------------------------------------------------------------

// blocks 0..vtiles-1 a vertex a thread (its keep flag, the kept counted),
// the rest an edge a thread, each end's keep test made again in the edge's
// thread (no block waits on another): ends [2, nV], cleared by the caller,
// row 0 the ends of an edge, row 1 those of a kept edge (set to 1 by every
// edge that has them: the stores race, with one value); the edges and the
// kept edges counted
__global__ void __launch_bounds__(kThreads) final_keep_kernel(
    const float* __restrict__ V, const float* __restrict__ OUT, ll nV,
    const int* __restrict__ E, ll nE, int vtiles, float eps, float scale,
    int* keep, int* ends, ull* fc) {
  if (static_cast<int>(blockIdx.x) < vtiles) {
    const ll v = static_cast<ll>(blockIdx.x) * kThreads + threadIdx.x;
    bool k = false;
    if (v < nV) {
      k = kept(V, OUT, v, eps, scale);
      keep[v] = k;
    }
    block_sum(k, fc + FC_KEEPV);
    return;
  }
  const ll e = static_cast<ll>(blockIdx.x - vtiles) * kThreads + threadIdx.x;
  bool ek = false;
  if (e < nE) {
    const int a = E[2 * e], b = E[2 * e + 1];
    ends[a] = 1;
    ends[b] = 1;
    ek = kept(V, OUT, a, eps, scale) & kept(V, OUT, b, eps, scale);
    if (ek) {
      ends[nV + a] = 1;
      ends[nV + b] = 1;
    }
  }
  block_sum(e < nE, fc + FC_LIVE);
  block_sum(ek, fc + FC_EKEEP);
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

// a tile of kTile region slots, a thread a slot: each kept slot's region
// (rord[j]: its members' start in svid, rcnt its count) ranked among the
// kept, its distinct members less 2 (its triangles) and their offset among
// all the triangles, by a scan of both counts packed in 64 bits in the tile
// and a decoupled look-back across tiles (tiles_before); the kept regions'
// (start, count, triangle offset, triangles) at their ranks (kl [n, 4]) and
// their means (mk [n, 3]), rows past the kept ones left as they were.  The
// last tile adds the kept regions and the triangles to fc.
__global__ void __launch_bounds__(kTile) face_fans_count_kernel(
    const ll* __restrict__ rord, const int* __restrict__ rcnt,
    const int* __restrict__ svid, const float* __restrict__ mean,
    const int* __restrict__ keep, ll n, ull* fc, int4* kl, float* mk) {
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
  const ull off = tile_exclusive<kTile>(
      static_cast<ull>(s >= 0) | (static_cast<ull>(nt) << kTriShift), &run);
  bool last;
  const ull before = tiles_before(tile, run, &last);
  if (threadIdx.x == 0 && tile == static_cast<int>(gridDim.x) - 1) {
    const ull tot = before + run;  // the totals
    if (tot & kKeptMask) atomicAdd(fc + FC_KEPT, tot & kKeptMask);
    if (tot >> kTriShift) atomicAdd(fc + FC_TRI, tot >> kTriShift);
  }
  if (s >= 0) {
    const ull o = before + off;
    const ll r = static_cast<ll>(o & kKeptMask);
    kl[r] = make_int4(static_cast<int>(s), c,
                      static_cast<int>(o >> kTriShift), nt);
    for (int d = 0; d < 3; ++d) mk[3 * r + d] = mean[3 * s + d];
  }
  if (last) reset_state();
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

#ifdef FACES_FIRST

// --- face_regions, the first design -----------------------------------------

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

#else  // the design

// --- face_regions ------------------------------------------------------------

// a hash table slot, two 32-byte sectors: its key (kEmptyKey where
// empty), its first replica (INT_MAX where empty), its count, the head of
// its list of replicas past the first kInline (-1 where none), its first
// kInline replicas in the order they came
constexpr int kInline = 11;
struct Slot {
  ll key;
  int first;
  int count;
  int head;
  int m[kInline];
};
static_assert(sizeof(Slot) == 64, "a slot two sectors");

// a region of a bucket: its key, member count and table slot; ordered by
// (count, key), the signature order of one first member
struct Region {
  ll key;
  int c;
  int slot;
};

__device__ __forceinline__ bool region_before(const Region& a,
                                              const Region& b) {
  return a.c < b.c || (a.c == b.c && a.key < b.key);
}

// thread i: replica i's key into the table of 2^bits slots, probing from
// its hash (a 64-bit compare-and-swap claims an empty one); the slot's
// first replica (atomic min) and count, the replica in the slot's inline
// list at the count's old value, or past kInline on its list (next[i] the
// replica pushed before it, -1 at the end); its slot (rslot); a replica
// that starts its vertex's run, the run's start (vstart [n_used]); its
// signature slot's rord and keep set to -1 and 0, which the regions' slots
// overwrite
__global__ void __launch_bounds__(kThreads) face_regions_insert_kernel(
    const ll* __restrict__ keys, const int* __restrict__ rvid, ll n, int bits,
    Slot* __restrict__ table, int* __restrict__ rslot, int* __restrict__ next,
    int* __restrict__ vstart, ll* __restrict__ rord, int* __restrict__ keep) {
  const ll i = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ull key = static_cast<ull>(keys[i]);
  const ull empty = static_cast<ull>(kEmptyKey);
  const ull mask = (1ull << bits) - 1ull;
  ull h = (key * kHashMul) >> (64 - bits);
  for (;; h = (h + 1ull) & mask) {
    ull* slot = reinterpret_cast<ull*>(&table[h].key);
    ull cur = cuda::atomic_ref<ull, cuda::thread_scope_device>(*slot).load(
        cuda::std::memory_order_relaxed);
    if (cur == empty) cur = atomicCAS(slot, empty, key);
    if (cur == empty || cur == key) break;
  }
  Slot& sl = table[h];
  atomicMin(&sl.first, static_cast<int>(i));
  const int pos = atomicAdd(&sl.count, 1);
  if (pos < kInline)
    sl.m[pos] = static_cast<int>(i);
  else
    next[i] = atomicExch(&sl.head, static_cast<int>(i));
  rslot[i] = static_cast<int>(h);
  const int w = rvid[i];
  if (i == 0 || rvid[i - 1] != w) vstart[w] = static_cast<int>(i);
  rord[i] = -1;
  keep[i] = 0;
}

// a tile of kRankTile used vertices, a thread a vertex v (its replicas the
// run from vstart[v]): the regions whose first replica is in its run (its
// bucket), in (count, key) order, in shared memory up to kBucket of them,
// else in big at the run's start; the bucket's regions and members ranked
// by a scan and a decoupled look-back across tiles (tiles_before), so that
// region r of the bucket takes signature slot j (its rank) and the members'
// range from s (the members of every region before it): rord[j] = s,
// rcnt[s] its count, rsig[j] its signature (v << 32 | count), mem[s..] its
// replicas in the order they came; its table slot cleared (a thread that
// reads a cleared slot's first replica reads INT_MAX, no replica's)
__global__ void __launch_bounds__(kRankTile) face_regions_rank_kernel(
    const int* __restrict__ rvid, ll n, ll n_used, Slot* __restrict__ table,
    const int* __restrict__ rslot, const int* __restrict__ next,
    const int* __restrict__ vstart, Region* __restrict__ big,
    ll* __restrict__ rord, int* __restrict__ rcnt, ll* __restrict__ rsig,
    int* __restrict__ mem) {
  __shared__ Region reg_s[kBucket * kRankTile];
  const int tile = take_tile();
  const ll v = static_cast<ll>(tile) * kRankTile + threadIdx.x;
  ll i0 = 0;
  int L = 0;
  if (v < n_used) {  // the run's length, kBucket replicas' ids at a time
    i0 = vstart[v];
    for (int k = kBucket; k == kBucket;) {
      int w[kBucket];
#pragma unroll
      for (int q = 0; q < kBucket; ++q)
        w[q] = i0 + L + q < n ? rvid[i0 + L + q] : -1;
      k = 0;
#pragma unroll
      for (int q = 0; q < kBucket; ++q) k += (k == q) & (w[q] == v);
      L += k;
    }
  }
  const bool small = L <= kBucket;
  Region* b = small ? reg_s + threadIdx.x : big + i0;
  const int st = small ? kRankTile : 1;
  int N = 0;
  ll C = 0;
  for (int q0 = 0; q0 < L; q0 += kBucket) {  // kBucket replicas at a time
    int h[kBucket], f[kBucket];
#pragma unroll
    for (int q = 0; q < kBucket; ++q)
      h[q] = q0 + q < L ? rslot[i0 + q0 + q] : -1;
#pragma unroll
    for (int q = 0; q < kBucket; ++q)
      f[q] = h[q] >= 0 ? table[h[q]].first : -1;
#pragma unroll
    for (int q = 0; q < kBucket; ++q) {
      if (h[q] < 0 || f[q] != i0 + q0 + q) continue;  // not its region's first
      const Region e{table[h[q]].key, table[h[q]].count, h[q]};
      int p = N;
      for (; p > 0 && region_before(e, b[(p - 1) * st]); --p)
        b[p * st] = b[(p - 1) * st];
      b[p * st] = e;
      ++N;
      C += e.c;
    }
  }
  ull run;  // the tile's regions and members
  const ull off = tile_exclusive<kRankTile>(
      static_cast<ull>(N) | (static_cast<ull>(C) << kTriShift), &run);
  bool last;
  const ull o = tiles_before(tile, run, &last) + off;
  ll j = static_cast<ll>(o & kKeptMask), s = static_cast<ll>(o >> kTriShift);
  for (int r = 0; r < N; ++r, ++j) {
    const Region e = b[r * st];
    Slot& sl = table[e.slot];
    rord[j] = s;
    rcnt[s] = e.c;
    rsig[j] = (v << 32) | e.c;
    int m[kInline];
#pragma unroll
    for (int k = 0; k < kInline; ++k) m[k] = k < e.c ? sl.m[k] : 0;
#pragma unroll
    for (int k = 0; k < kInline; ++k)
      if (k < e.c) mem[s + k] = m[k];
    for (int i = sl.head, k = kInline; i >= 0; i = next[i], ++k)
      mem[s + k] = i;
    sl.key = kEmptyKey;
    sl.first = INT_MAX;
    sl.count = 0;
    sl.head = -1;
    s += e.c;
  }
  if (last) reset_state();
}

// a region's c members (their replicas at mem[0..c)) as ids in replica
// order: up to kMembers in w (registers: the replicas sorted by a network
// of compare-exchanges, then each replaced by its id), else in g[0..c)
// (global: an insertion sort, then the ids in place)
__device__ __forceinline__ void member_ids(const int* __restrict__ mem, int c,
                                           const int* __restrict__ rvid,
                                           int (&w)[kMembers], int* g) {
  if (c <= kMembers) {
#pragma unroll
    for (int k = 0; k < kMembers; ++k) w[k] = k < c ? mem[k] : INT_MAX;
#pragma unroll
    for (int k = 1; k < kMembers; ++k)
#pragma unroll
      for (int q = k; q > 0; --q) {
        const int lo = min(w[q - 1], w[q]), hi = max(w[q - 1], w[q]);
        w[q - 1] = lo;
        w[q] = hi;
      }
#pragma unroll
    for (int k = 0; k < kMembers; ++k) w[k] = k < c ? rvid[w[k]] : -1;
    return;
  }
  for (int k = 0; k < c; ++k) {
    const int i = mem[k];
    int p = k;
    for (; p > 0 && g[p - 1] > i; --p) g[p] = g[p - 1];
    g[p] = i;
  }
  for (int k = 0; k < c; ++k) g[k] = rvid[g[k]];
}

// thread j, signature slot j < the regions (rord[j] >= 0): its region's
// members (member_ids, in registers up to kMembers, else in svid) written
// as ids at s = rord[j], its count and mean (fixed-point sums, one
// division) at s and zeros past it; kept unless it has fewer than 3
// members or an earlier slot of its run of equal signatures (rsig; their
// ranges just before s, c members each) has its member ids (worked out
// again from that region's replicas, in registers, or in tmp at s past
// kMembers)
__global__ void __launch_bounds__(kThreads) face_regions_members_kernel(
    const int* __restrict__ rvid, const float* __restrict__ Vf, ll n,
    const int* __restrict__ mem, const ll* __restrict__ rsig,
    const ll* __restrict__ rord, int* __restrict__ rcnt,
    float* __restrict__ mean, int* __restrict__ svid, int* __restrict__ tmp,
    int* __restrict__ keep) {
  const ll j = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const ll s = rord[j];
  if (s < 0) return;
  const int c = rcnt[s];
  const ll g = rsig[j];
  const ll gp = j > 0 ? rsig[j - 1] : -1;
  const bool small = c <= kMembers;
  int w[kMembers], o[kMembers];
  member_ids(mem + s, c, rvid, w, svid + s);
  ll sum[3] = {0, 0, 0};
  if (small) {
#pragma unroll
    for (int k = 0; k < kMembers; ++k)
      if (k < c)
        for (int d = 0; d < 3; ++d)
          sum[d] +=
              llrintf(__fmul_rn(Vf[3 * static_cast<ll>(w[k]) + d], kFix));
#pragma unroll
    for (int k = 0; k < kMembers; ++k)
      if (k < c) svid[s + k] = w[k];
  } else {
    for (int k = 0; k < c; ++k)
      for (int d = 0; d < 3; ++d)
        sum[d] += llrintf(
            __fmul_rn(Vf[3 * static_cast<ll>(svid[s + k]) + d], kFix));
  }
  const float den = __fmul_rn(static_cast<float>(c), kFix);
  for (int d = 0; d < 3; ++d)
    mean[3 * s + d] = __fdiv_rn(static_cast<float>(sum[d]), den);
  for (int k = 1; k < c; ++k) {
    rcnt[s + k] = 0;
    for (int d = 0; d < 3; ++d) mean[3 * (s + k) + d] = 0.0f;
  }
  bool dup = false;
  for (ll q = j - 1; gp == g && q >= 0 && !dup && rsig[q] == g; --q) {
    const ll t = s - (j - q) * c;
    member_ids(mem + t, c, rvid, o, tmp + s);
    bool same = true;
    if (small) {
#pragma unroll
      for (int k = 1; k < kMembers; ++k) same &= k >= c || w[k] == o[k];
    } else {
      for (int k = 1; k < c && same; ++k) same = svid[s + k] == tmp[s + k];
    }
    dup = same;
  }
  keep[j] = c >= 3 && !dup;
}

#endif  // FACES_FIRST

}  // namespace

// --- launch functions (tropical_torch/extract/device.py's stage order) --------

extern "C" {

// 1 in a build of the first design (-DFACES_FIRST), whose launch functions
// are named *_first_launch (but final_keep's) and whose stage takes the
// caller's prefix sums and sorts; else 0
int faces_first_design() { return kFacesFirst ? 1 : 0; }

#ifdef FACES_FIRST

// the vertex pass, then the edge pass (none without edges); the caller
// clears ends
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

int face_regions_runs_first_launch(const ll* skey, const ll* perm,
                                   const int* rvid, const float* Vf, ll n,
                                   ll* sig, int* rcnt, float* mean, int* svid,
                                   cudaStream_t stream) {
  face_regions_runs_kernel<<<blocks(n), kThreads, 0, stream>>>(
      skey, perm, rvid, Vf, n, sig, rcnt, mean, svid);
  return done();
}

int face_regions_dups_first_launch(const ll* ssig, const ll* rord,
                                   const int* rcnt, const int* svid, ll n,
                                   int* keep, cudaStream_t stream) {
  face_regions_dups_kernel<<<blocks(n), kThreads, 0, stream>>>(
      ssig, rord, rcnt, svid, n, keep);
  return done();
}

#else

// one launch: the vertices' blocks, then the edges'; the caller clears
// ends
int final_keep_launch(const float* V, const float* OUT, ll nV, const int* E,
                      ll nE, float eps, float scale, int* keep, int* ends,
                      ull* fc, cudaStream_t stream) {
  const ll vtiles = (nV + kThreads - 1) / kThreads;
  const ll tiles = vtiles + (nE + kThreads - 1) / kThreads;
  if (tiles == 0) return done(0);
  if (tiles > INT_MAX) return -static_cast<int>(cudaErrorInvalidValue);
  final_keep_kernel<<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      V, OUT, nV, E, nE, static_cast<int>(vtiles), eps, scale, keep, ends, fc);
  return done();
}

// face_regions_insert a thread a replica, face_regions_rank a tile of
// kRankTile used vertices a block (at most kMaxTiles), face_regions_members
// a thread a signature slot; the table of 2^bits slots (at least 2 n),
// empty, is left empty.  -cudaErrorInvalidValue for a table too small or
// no used vertex.
int face_regions_launch(const ll* keys, const int* rvid, const float* Vf,
                        ll n, ll n_used, ll bits, void* table, int* rslot,
                        int* next, int* vstart, void* big, ll* rsig, int* mem,
                        int* tmp, ll* rord, int* rcnt, float* mean, int* svid,
                        int* keep, cudaStream_t stream) {
  const ll tiles = (n_used + kRankTile - 1) / kRankTile;
  if (n_used <= 0 || tiles > kMaxTiles || bits < 1 || bits > 30 ||
      (1LL << bits) < 2 * n)
    return -static_cast<int>(cudaErrorInvalidValue);
  Slot* slots = static_cast<Slot*>(table);
  face_regions_insert_kernel<<<blocks(n), kThreads, 0, stream>>>(
      keys, rvid, n, static_cast<int>(bits), slots, rslot, next, vstart, rord,
      keep);
  face_regions_rank_kernel<<<static_cast<int>(tiles), kRankTile, 0,
                             stream>>>(
      rvid, n, n_used, slots, rslot, next, vstart, static_cast<Region*>(big),
      rord, rcnt, rsig, mem);
  face_regions_members_kernel<<<blocks(n), kThreads, 0, stream>>>(
      rvid, Vf, n, mem, rsig, rord, rcnt, mean, svid, tmp, keep);
  return done(3);
}

#endif  // FACES_FIRST

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
