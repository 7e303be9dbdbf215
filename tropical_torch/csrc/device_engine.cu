// K3, K4, K4c and K5: the device extraction engine's kernels.
//
// Replace the XLA programs of the JAX package's fused engine,
// tropical/extract/device.py: K3 the skeleton (_lipschitz_keepv :1891,
// _edges_from_sgn :1808, _squeeze_edges :2049 under make_skeleton_fn
// :2092), K4 one insertion's split (make_step_fn's _busy_step s1-s7,
// :452-848, with _pack_out_words :144 and _edge_bits :180), K4c its curved
// rows and strict filter on the curved path (s3b and s5b, :564-715), K5 its
// connecting edges and prune (s8-s12, :858-1119, with _grid_region_lut
// :254, in grid_region.cuh, and _prune :1121); K6, the final filter and
// the faces, is faces.cu, included at the end into the same library.  Each
// launch function is one kernel; the caller
// (tropical_torch/extract/device.py) passes device pointers, long long
// integers and float scalars in the declared order, then the stream, and
// gets back the count of kernels it launched, or minus a CUDA error
// (cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses).
// Each has its plain PyTorch version in that module, which it equals bit
// for bit (K3's first design is held to them on its whole skeleton).
//
// Words: a vertex's 33 columns as 2 32-bit words (bit j of word w is
// column 32 w + j): sign (out > 0), zero (|out| <= eps), strict
// (|out| < eps).  An edge's split words (plane j splits it: both ends off
// the eps band, of opposite signs) and last differing column (the highest
// column whose eps-sign differs, -1 for none; the prune at plane idx keeps
// the edge iff it is >= idx).
//
// Bound: bytes everywhere (integer bit tests, a few float operations an
// item); one thread an item (lattice point, edge, candidate, vertex) but
// where a warp shares a row or a word (K3 and K4 below), shared-memory histograms
// flushed by one atomic a bin and block.  The
// pair search is the exception: each candidate scans the candidates of
// the 27 cells around its own, a data-dependent loop (about the cells'
// occupancy squared).
//
// K5's pair scan (connect_pairs) is bound by latency: chains of dependent loads
// and long instruction streams on few warps (a few hundred candidates at the
// small insertions).  It reads a column table that connect_table builds once an
// insertion: for each (x, y) column of the (M + 1)^2 cell grid, the [start,
// end) of its candidates in sorted order ((0, 0) for an empty column: the table
// comes zeroed and the kernel scatters each run's ends, with no search), and
// the candidate rows gathered into sorted order.  A block takes 32 candidates,
// a warp for each of the 9 neighbour columns and a lane for each candidate, so
// that a candidate's columns run side by side on 9 warps: a lane loads its
// column's table entry, searches inside the column for both ends of its z
// window in lockstep, then reads the window's rows one at a time (a row, then
// the words of a row that pairs).  The count pass writes a count for each
// candidate and column, so that their prefix sum gives each column its first
// slot in scan order (candidate, column, position): the fill pass scans a
// column once, and skips a column of no pairs.  No array is indexed by a value
// the compiler cannot fold, so nothing lives in local memory.  The first design
// (-DCONNECT_SEARCHES: connect_table launches nothing) took a thread a
// candidate and ran a lower and an upper bound over the whole sorted key array
// for each neighbour column, up to 18 chains of log2 n dependent loads, then
// the column's rows through the sort's permutation, a row at a time.
//
// compact_rows copies the outputs' pool (rows of R words) a word a thread,
// with 32-bit index arithmetic and the width fixed at compile time, so that a
// warp's loads and stores are contiguous; a row of any other width (at most 4
// words: the words, the vertices, the edges) a thread, which a warp reads
// contiguously.  Its first design (-DCOMPACT_ROW_THREAD) copied a row a thread at every width,
// a warp's loads 4 width bytes apart.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <climits>

#include "grid_region.cuh"
#include "trilinear_roots.cuh"

namespace {

typedef long long ll;
constexpr int R = 33;      // columns
constexpr int NW = 2;      // words a row
constexpr int kThreads = 256;
// the count vector (tropical_torch/extract/device.py META)
constexpr int N_LIVE = 1, N_USED = 2, SPLIT = 3, HIT = 3 + R;

#ifdef CONNECT_SEARCHES
constexpr bool kColumns = false;
#else
constexpr bool kColumns = true;
#endif
#ifdef COMPACT_ROW_THREAD
constexpr bool kCompactWords = false;
#else
constexpr bool kCompactWords = true;
#endif
#ifdef CURVED_FIRST
constexpr bool kCurvedFirst = true;
#else
constexpr bool kCurvedFirst = false;
#endif
// the pair scan's block: kPairLanes candidates, a warp a neighbour column
constexpr int kPairLanes = 32;
constexpr int kPairThreads = 9 * kPairLanes;

__device__ __forceinline__ unsigned bit_of(const int* w, int col) {
  return (static_cast<unsigned>(w[col >> 5]) >> (col & 31)) & 1u;
}

// a row's sign, zero and strict bits (bit j of word w is column 32 w + j)
__device__ __forceinline__ void pack_bits(const float* o, float eps,
                                          unsigned* s, unsigned* z,
                                          unsigned* t) {
  for (int w = 0; w < NW; ++w) s[w] = z[w] = t[w] = 0u;
  for (int c = 0; c < R; ++c) {
    const float v = o[c];
    const float a = fabsf(v);
    const unsigned b = 1u << (c & 31);
    const int w = c >> 5;
    if (v > 0.0f) s[w] |= b;
    if (a <= eps) z[w] |= b;
    if (a < eps) t[w] |= b;
  }
}

__device__ __forceinline__ void pack_row(const float* o, float eps, int* sb,
                                         int* zb, int* sz) {
  unsigned s[NW], z[NW], t[NW];
  pack_bits(o, eps, s, z, t);
  for (int w = 0; w < NW; ++w) {
    sb[w] = static_cast<int>(s[w]);
    zb[w] = static_cast<int>(z[w]);
    sz[w] = static_cast<int>(t[w]);
  }
}

// _edge_bits of one edge's ends
__device__ __forceinline__ int edge_bits(const int* sbp, const int* zbp,
                                         const int* sbq, const int* zbq,
                                         unsigned* eb) {
  int ld = -1;
  for (int w = 0; w < NW; ++w) {
    const unsigned zp = static_cast<unsigned>(zbp[w]);
    const unsigned zq = static_cast<unsigned>(zbq[w]);
    const unsigned sdif =
        (static_cast<unsigned>(sbp[w]) ^ static_cast<unsigned>(sbq[w])) &
        ~zp & ~zq;
    eb[w] = sdif;
    const unsigned dif = (zp ^ zq) | sdif;
    if (dif) ld = max(ld, 32 * w + 31 - __clz(static_cast<int>(dif)));
  }
  return ld;
}

__device__ __forceinline__ unsigned flag_of(const int* cum, ll i) {
  return static_cast<unsigned>(cum[i] - (i ? cum[i - 1] : 0));
}

// a block's histograms in shared memory: the per-plane counts of one or
// two bit sets and one counter, flushed to the count vector
struct Hist {
  int bins[2 * R + 1];
};

__device__ __forceinline__ void hist_zero(Hist& h) {
  for (int i = threadIdx.x; i < 2 * R + 1; i += blockDim.x) h.bins[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ void hist_bits(Hist& h, int base,
                                          const unsigned* w) {
  for (int k = 0; k < NW; ++k) {
    unsigned v = w[k];
    while (v) {
      const int j = 32 * k + __ffs(static_cast<int>(v)) - 1;
      if (j < R) atomicAdd(&h.bins[base + j], 1);
      v &= v - 1;
    }
  }
}

// bins [0, R) -> meta[first0 ...], [R, 2R) -> meta[first1 ...], the counter
// (bin 2R) -> meta[counter]
__device__ __forceinline__ void hist_flush(Hist& h, int* meta, int first0,
                                           int first1, int counter) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * R + 1; i += blockDim.x) {
    const int v = h.bins[i];
    if (!v) continue;
    const int dst = i < R ? first0 + i
                          : (i < 2 * R ? first1 + i - R : counter);
    if (dst >= 0) atomicAdd(&meta[dst], v);
  }
}

// the inclusive sum of x over lanes 0..lane
__device__ __forceinline__ int warp_scan(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_sync(0xFFFFFFFFu, x, max(lane - d, 0));
    if (lane >= d) x += y;
  }
  return x;
}

int blocks(ll n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// a launch function's result: the kernels it launched, or minus the error
int done(int launched = 1) {
  const int rc = static_cast<int>(cudaGetLastError());
  return rc ? -rc : launched;
}

// --- K3 skeleton_mark --------------------------------------------------------
//
// The design (six launches in dist mode, four in sign mode), every index in
// 32 bits (the engine takes at most 511 marks: M^3 < 2^31); bound by the
// bytes of out, which skeleton_words reads once:
// - skeleton_pool, a launch for axis 0 and one for axis 1: a block takes
//   kPoolLines whole lines along the axis (lanes across lines, so that a
//   warp reads 32 bytes of each of 4 planes; a warp a line along axis 2),
//   then a warp a line, the window maxima from doubling runs by shuffles
//   (three steps at the presets' radii): each value read once from device
//   memory and written once, no division.
// - skeleton_words: a block stages its 256 rows of out (33 floats each) in
//   shared memory with 16-byte loads, all in flight, so the 1 GB of out at
//   sphere-large is read in whole lines, and the 256 + 2k values of the
//   pooled |grad| its points' windows along axis 2 need; each thread packs
//   its row from there (the rows' pitch of 33 words is odd: no bank
//   conflicts) into the point's canonical columns, 9 bytes: an int2 of
//   columns 0-31's sign bits off the eps band and zero bits, and a byte of
//   column 32's two bits and the keep flag (|sdf| <= bc times the window's
//   max of the pooled |grad|, NaN winning).
// - skeleton_flags: a thread a lattice point, a block 1,024 points, no 64-bit
//   division.  A point flags its three upper edges (canonical columns
//   differ, both ends kept) and is used if one of its six edges is flagged;
//   a warp's ballots give one word of each of four bit masks (an axis's
//   edges by lower end, axis-major as _edges_from_sgn orders them, an absent
//   edge 0; the used points), and the block writes each word's exclusive
//   popcount prefix within the block and the block's counts.
// - skeleton_scan: one block, the exclusive prefix sums of the block counts
//   (the edges axis by axis, then the used points; tiles of 8 values a
//   thread through shared memory) and the two totals, which the caller reads
//   before it allocates the skeleton.
// - skeleton_compact: an edge's slot, and a used point's, is its block's
//   offset, its word's prefix and the popcount of the lower bits of its
//   word: the order of an inclusive prefix sum.  A warp takes 1 to 8 words
//   (empty ones skipped by one ballot), a lane a point; a used point's
//   thread copies its row (33 loads in flight) and packs its sign, zero and
//   strict words.
// The first design (-DSKELETON_CUMSUM, cuda_build.DEVICE_ENGINE_FIRST): three
// pools, a thread a value with its window read from device memory; a thread
// a row of out (33 loads a warp, each of 32 lines) writing its sign, zero and
// strict words and an int32 keep flag; a thread an edge (its ends decoded by
// 64-bit divisions) writing int32 edge and used flags, which two torch.cumsum
// calls in the caller turn into ranks; a squeeze that reads those back.

#ifdef SKELETON_CUMSUM
constexpr bool kSkeletonFirst = true;
#else
constexpr bool kSkeletonFirst = false;
// the most marks the engine takes, and the pool's radius skeleton_words
// takes (_dist_pool_k's limit)
constexpr int kMaxMarks = 511;
constexpr int kMaxRadius = 16;
// the pool: a warp a line of a block's kPoolLines, up to kPoolRounds
// positions a lane, the tile's rows kPoolPitch floats apart
constexpr int kPoolLines = kThreads / 32;
constexpr int kPoolPitch = (kMaxMarks + 27) / 32 * 32 + 4;
constexpr int kPoolRounds = (kMaxMarks + 31) / 32;
// skeleton_words: rows a block, float4 loads a thread; a lattice point's
// byte: column 32's canonical bits (0, 1) and the keep flag
constexpr int kWordRows = 256;
constexpr int kWordLoads = (kWordRows * R / 4 + kWordRows - 1) / kWordRows;
constexpr unsigned kKeepBit = 4u;
// skeleton_flags: points a block (32 words of each mask); the scan: threads
// and values a thread in a tile
constexpr int kFlagPoints = 1024;
constexpr int kScanThreads = 1024;
constexpr int kScanValues = 8;
// the compaction: a warp takes 1, 2, 4 or kWarpWords words, as many as
// leave kCompactWarps warps to the card
constexpr int kWarpWords = 8;
constexpr int kCompactWarps = 8192;
#endif

__device__ __forceinline__ float nan_max(float m, float v) {
  return !(v == v) || v > m ? v : m;  // NaN wins
}

#ifdef SKELETON_CUMSUM

__global__ void skeleton_pool_kernel(const float* __restrict__ g,
                                     float* __restrict__ out, int M, int k,
                                     int axis) {
  const ll n = static_cast<ll>(M) * M * M;
  const ll p = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const ll stride = axis == 0 ? static_cast<ll>(M) * M : (axis == 1 ? M : 1);
  const int i = static_cast<int>((p / stride) % M);
  float m = g[p];
  for (int j = max(i - k, 0); j <= min(i + k, M - 1); ++j)
    m = nan_max(m, g[p + (j - i) * stride]);
  out[p] = m;
}

__global__ void skeleton_points_kernel(const float* __restrict__ out,
                                       const float* __restrict__ dq,
                                       const float* __restrict__ gmax, ll n,
                                       float bc, float eps, int* sb, int* zb,
                                       int* sz, int* keep) {
  const ll p = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  pack_row(out + p * R, eps, sb + NW * p, zb + NW * p, sz + NW * p);
  keep[p] = dq == nullptr ? 1 : (dq[p] <= __fmul_rn(bc, gmax[p]));
}

// lattice edge e, axis-major (_edges_from_sgn): its (upper, lower) ends
__device__ __forceinline__ void lattice_edge(ll e, int M, ll* up, ll* lo) {
  const ll MM = static_cast<ll>(M) * M;
  const ll per = (M - 1) * MM;
  const int axis = static_cast<int>(e / per);
  const ll r = e % per;
  ll i, j, k;
  if (axis == 0) {
    i = r / MM, j = (r / M) % M, k = r % M;
  } else if (axis == 1) {
    i = r / ((M - 1) * static_cast<ll>(M)), j = (r / M) % (M - 1), k = r % M;
  } else {
    i = r / ((M - 1) * static_cast<ll>(M)), j = (r / (M - 1)) % M,
    k = r % (M - 1);
  }
  *lo = i * MM + j * M + k;
  *up = *lo + (axis == 0 ? MM : (axis == 1 ? M : 1));
}

__global__ void skeleton_edges_kernel(const int* __restrict__ sb,
                                      const int* __restrict__ zb,
                                      const int* __restrict__ keep, int M,
                                      int* flags, int* used) {
  const ll n = 3LL * (M - 1) * M * M;
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  ll up, lo;
  lattice_edge(e, M, &up, &lo);
  bool differ = false;
  for (int w = 0; w < NW; ++w) {
    const int za = zb[NW * up + w], zl = zb[NW * lo + w];
    differ |= (za != zl) || ((sb[NW * up + w] & ~za) != (sb[NW * lo + w] & ~zl));
  }
  const bool f = differ && keep[up] && keep[lo];
  flags[e] = f;
  if (f) {
    used[up] = 1;
    used[lo] = 1;
  }
}

__global__ void skeleton_squeeze_kernel(
    const int* __restrict__ ecum, const int* __restrict__ ucum,
    const float* __restrict__ marks, const float* __restrict__ out,
    const int* __restrict__ sb, const int* __restrict__ zb,
    const int* __restrict__ sz, int M, float scale, float* V, float* OUT,
    int* SB, int* ZB, int* SZ, int* E) {
  const ll ne = 3LL * (M - 1) * M * M;
  const ll np = static_cast<ll>(M) * M * M;
  const ll t = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < ne && flag_of(ecum, t)) {
    ll up, lo;
    lattice_edge(t, M, &up, &lo);
    const ll s = ecum[t] - 1;
    E[2 * s] = ucum[up] - 1;
    E[2 * s + 1] = ucum[lo] - 1;
  }
  if (t < np && flag_of(ucum, t)) {
    const ll v = ucum[t] - 1;
    const ll ix[3] = {t / (static_cast<ll>(M) * M), (t / M) % M, t % M};
    for (int d = 0; d < 3; ++d)
      V[3 * v + d] = __fsub_rn(__fmul_rn(marks[ix[d]], scale * 2.0f), scale);
    for (int c = 0; c < R; ++c) OUT[R * v + c] = out[R * t + c];
    for (int w = 0; w < NW; ++w) {
      SB[NW * v + w] = sb[NW * t + w];
      ZB[NW * v + w] = zb[NW * t + w];
      SZ[NW * v + w] = sz[NW * t + w];
    }
  }
}

#else  // the design

// line t of the M^2 lines along the axis: its first lattice point
__device__ __forceinline__ int line_start(int t, int M, int axis) {
  return axis == 0 ? t : (axis == 1 ? (t / M) * M * M + t % M : t * M);
}

// The max over [i - k, i + k] along the axis, clipped at the line's ends, of
// the block's kPoolLines lines.  The block loads its lines into the tile
// (along axes 0 and 1 lanes across lines, so that a warp reads 32 bytes of
// each of 4 planes; along axis 2 a warp a line), then a warp takes a line,
// lane l its positions l, l + 32, ... in registers: the maxima of runs of 1,
// 2, 4, ... P values (m_2s[i] = max(m_s[i], m_s[i + s]), P the largest power
// of two <= 2k + 1) by shuffles, then each window the max of the two runs of
// P that cover it, read back from shared memory (a window of fewer than P
// values, at a line's ends, from the values).  The results go back through
// the tile to stores laid out as the loads.
__global__ void __launch_bounds__(kThreads) skeleton_pool_kernel(
    const float* __restrict__ g, float* __restrict__ out, int M, int k,
    int axis) {
  // pitch = 4 mod 32: lanes on 8 lines and 4 positions hit distinct banks
  __shared__ float tile[kPoolLines * kPoolPitch];
  __shared__ float runs[kPoolLines * kPoolPitch];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = (M + 27) / 32 * 32 + 4;
  const int stride = axis == 0 ? M * M : (axis == 1 ? M : 1);
  // the loads' and stores' layout: line lt, positions li, li + 32, ...
  const int lt = axis == 2 ? warp : tid & (kPoolLines - 1);
  const int li = axis == 2 ? lane : tid / kPoolLines;
  const int lline = blockIdx.x * kPoolLines + lt;
  const bool llive = lline < M * M;
  const int lfirst = llive ? line_start(lline, M, axis) : 0;
  float m[kPoolRounds];
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = li + 32 * r;
    if (i >= M) break;
    if (llive) m[r] = g[lfirst + i * stride];
  }
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = li + 32 * r;
    if (i >= M) break;
    if (llive) tile[lt * pitch + i] = m[r];
  }
  __syncthreads();
  // a warp a line: the runs
  float* const row = tile + warp * pitch;
  float* const rrow = runs + warp * pitch;
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = lane + 32 * r;
    if (32 * r >= M) break;  // the whole warp
    m[r] = i < M ? row[i] : 0.0f;
  }
  const int P = 1 << (31 - __clz(2 * k + 1));
  for (int len = 1; len < P; len *= 2) {
    const int src = (lane + len) & 31;
#pragma unroll
    for (int r = 0; r < kPoolRounds; ++r) {
      if (32 * r >= M) break;  // the whole warp
      // position i + len: this round's lane + len, or the next round's
      const float a = __shfl_sync(0xFFFFFFFFu, m[r], src);
      const float b = __shfl_sync(0xFFFFFFFFu,
                                  r + 1 < kPoolRounds ? m[r + 1] : 0.0f, src);
      const int i = lane + 32 * r;
      if (i + len < M) m[r] = nan_max(m[r], lane + len < 32 ? a : b);
    }
  }
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = lane + 32 * r;
    if (i >= M) break;
    rrow[i] = m[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = lane + 32 * r;
    if (i >= M) break;
    const int lo = max(i - k, 0), hi = min(i + k, M - 1);
    if (hi - lo + 1 >= P) {
      m[r] = nan_max(rrow[lo], rrow[hi - P + 1]);
    } else {
      m[r] = row[lo];
      for (int j = lo + 1; j <= hi; ++j) m[r] = nan_max(m[r], row[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = lane + 32 * r;
    if (i >= M) break;
    row[i] = m[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPoolRounds; ++r) {
    const int i = li + 32 * r;
    if (i >= M) break;
    if (llive) out[lfirst + i * stride] = tile[lt * pitch + i];
  }
}

__global__ void __launch_bounds__(kWordRows) skeleton_words_kernel(
    const float* __restrict__ out, const float* __restrict__ dq,
    const float* __restrict__ g, int M, int k, float bc, float eps,
    int2* __restrict__ W, unsigned char* __restrict__ X) {
  __shared__ float4 staged[kWordRows * R / 4];
  __shared__ float gs[kWordRows + 2 * kMaxRadius];
  const float* rows = reinterpret_cast<const float*>(staged);
  const int n = M * M * M;
  const int p0 = blockIdx.x * kWordRows;
  const int nr = min(kWordRows, n - p0);
  // the block's rows: 16-byte aligned (p0 R floats, p0 a multiple of 256)
  const float* src = out + static_cast<ll>(p0) * R;
  const int nf = nr * R, n4 = nf >> 2;
  float4 v[kWordLoads];  // every load in flight, then the stores
#pragma unroll
  for (int b = 0; b < kWordLoads; ++b) {
    const int q = threadIdx.x + b * kWordRows;
    if (q < n4) v[b] = reinterpret_cast<const float4*>(src)[q];
  }
  // dist mode: g over [p0 - k, p0 + nr + k), for the windows along axis 2
  for (int q = threadIdx.x; dq != nullptr && q < nr + 2 * k; q += kWordRows) {
    const int gp = p0 - k + q;
    if (gp >= 0 && gp < n) gs[q] = g[gp];
  }
#pragma unroll
  for (int b = 0; b < kWordLoads; ++b) {
    const int q = threadIdx.x + b * kWordRows;
    if (q < n4) staged[q] = v[b];
  }
  for (int q = 4 * n4 + threadIdx.x; q < nf; q += kWordRows)
    reinterpret_cast<float*>(staged)[q] = src[q];
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= nr) return;
  unsigned s[NW], z[NW], t[NW];
  pack_bits(rows + r * R, eps, s, z, t);
  const int p = p0 + r;
  bool keep = true;
  if (dq != nullptr) {
    // the max of g over the point's window along axis 2, in its row
    const int kk = p % M;
    const int lo = max(kk - k, 0) - kk, hi = min(kk + k, M - 1) - kk;
    const float* at = gs + k + r;
    float gmax = at[lo];
    for (int d = lo + 1; d <= hi; ++d) gmax = nan_max(gmax, at[d]);
    keep = dq[p] <= __fmul_rn(bc, gmax);
  }
  W[p] = make_int2(static_cast<int>(s[0] & ~z[0]), static_cast<int>(z[0]));
  X[p] = static_cast<unsigned char>((s[1] & ~z[1] & 1u) | (z[1] & 1u) << 1 |
                                    (keep ? kKeepBit : 0u));
}

// lattice edge (a, b) is flagged: the canonical words (columns 0-31) or
// the bytes' column 32 differ, and both ends are kept
__device__ __forceinline__ bool edge_flag(int2 a, unsigned ax, int2 b,
                                          unsigned bx) {
  return (a.x != b.x || a.y != b.y || ((ax ^ bx) & 3u)) &&
         (ax & bx & kKeepBit);
}

// masks [4, nw]: the flagged edges of axes 0, 1, 2 by lower end, the used
// points; pre [4, nw]: each word's popcount prefix within its block; cnt
// [4, blocks]: each block's popcounts
__global__ void __launch_bounds__(kFlagPoints) skeleton_flags_kernel(
    const int2* __restrict__ W, const unsigned char* __restrict__ X, int M,
    int nw, int* __restrict__ masks,
    int* __restrict__ pre, int* __restrict__ cnt) {
  __shared__ int counts[4][32];
  const int MM = M * M, n = MM * M;
  const int p = blockIdx.x * kFlagPoints + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool f0 = false, f1 = false, f2 = false, used = false;
  if (p < n) {
    const int i = p / MM, j = (p - i * MM) / M, k = p - i * MM - j * M;
    const int2 a = W[p];
    const unsigned ax = X[p];
    if (i + 1 < M) f0 = edge_flag(a, ax, W[p + MM], X[p + MM]);
    if (j + 1 < M) f1 = edge_flag(a, ax, W[p + M], X[p + M]);
    if (k + 1 < M) f2 = edge_flag(a, ax, W[p + 1], X[p + 1]);
    used = f0 || f1 || f2 ||
           (i > 0 && edge_flag(W[p - MM], X[p - MM], a, ax)) ||
           (j > 0 && edge_flag(W[p - M], X[p - M], a, ax)) ||
           (k > 0 && edge_flag(W[p - 1], X[p - 1], a, ax));
  }
  const unsigned m0 = __ballot_sync(0xFFFFFFFFu, f0);
  const unsigned m1 = __ballot_sync(0xFFFFFFFFu, f1);
  const unsigned m2 = __ballot_sync(0xFFFFFFFFu, f2);
  const unsigned m3 = __ballot_sync(0xFFFFFFFFu, used);
  const int w = p >> 5;
  if (lane < 4) {
    const unsigned mine = lane == 0 ? m0 : (lane == 1 ? m1 : (lane == 2 ? m2 : m3));
    counts[lane][warp] = __popc(mine);
    if (w < nw) masks[lane * nw + w] = static_cast<int>(mine);
  }
  __syncthreads();
  if (warp < 4) {
    const int v = counts[warp][lane];
    const int x = warp_scan(v, lane);
    const int word = blockIdx.x * 32 + lane;
    if (word < nw) pre[warp * nw + word] = x - v;
    if (lane == 31) cnt[warp * gridDim.x + blockIdx.x] = x;
  }
}

// a tile's element e in shared memory: a word of padding every 32, so that
// a thread's kScanValues consecutive elements and a warp's 32 consecutive
// ones both fall in distinct banks
__device__ __forceinline__ int scan_at(int e) { return e + (e >> 5); }

// off: the exclusive prefix sums of cnt [4, nb], the edges' three rows as
// one sequence (axis-major), the used points' row as another; tot: their
// totals (edges, used points).  A tile of kScanThreads * kScanValues
// values: loaded coalesced into shared memory, a thread sums kScanValues
// consecutive ones, the block scans the sums, the thread writes its
// prefixes back, and the tile is stored coalesced.
__global__ void __launch_bounds__(kScanThreads) skeleton_scan_kernel(
    const int* __restrict__ cnt, int nb, int* __restrict__ off,
    int* __restrict__ tot) {
  constexpr int kTile = kScanThreads * kScanValues;
  __shared__ int tile[kTile + kTile / 32];
  __shared__ int sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int part = 0; part < 2; ++part) {
    const int base = part ? 3 * nb : 0, len = part ? nb : 3 * nb;
    int carry = 0;
    for (int start = 0; start < len; start += kTile) {
      int v[kScanValues];
#pragma unroll
      for (int j = 0; j < kScanValues; ++j) {
        const int e = j * kScanThreads + tid;
        v[j] = start + e < len ? cnt[base + start + e] : 0;
      }
#pragma unroll
      for (int j = 0; j < kScanValues; ++j)
        tile[scan_at(j * kScanThreads + tid)] = v[j];
      __syncthreads();
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kScanValues; ++j) {
        v[j] = tile[scan_at(kScanValues * tid + j)];
        sum += v[j];
      }
      const int x = warp_scan(sum, lane);
      if (lane == 31) sums[warp] = x;
      __syncthreads();
      const int s = sums[lane];
      const int ws = warp_scan(s, lane);
      int run = carry + __shfl_sync(0xFFFFFFFFu, ws - s, warp) + x - sum;
#pragma unroll
      for (int j = 0; j < kScanValues; ++j) {
        tile[scan_at(kScanValues * tid + j)] = run;
        run += v[j];
      }
      carry += __shfl_sync(0xFFFFFFFFu, ws, 31);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kScanValues; ++j) {
        const int e = j * kScanThreads + tid;
        if (start + e < len) off[base + start + e] = tile[scan_at(e)];
      }
      __syncthreads();
    }
    if (tid == 0) tot[part] = carry;
  }
}

// the used points' rank of lattice point q
__device__ __forceinline__ int used_rank(const int* __restrict__ U,
                                         const int* __restrict__ Upre,
                                         const int* __restrict__ Uoff, int q) {
  const int w = q >> 5;
  const unsigned below = (1u << (q & 31)) - 1u;
  return Uoff[w >> 5] + Upre[w] + __popc(static_cast<unsigned>(U[w]) & below);
}

// a used point's outputs, words and world coordinates at its rank v, from
// its row x
__device__ __forceinline__ void compact_point(
    const float* x, int p, int v, int M, const float* __restrict__ marks,
    float scale, float eps, float* __restrict__ V, float* __restrict__ OUT,
    int* __restrict__ SB, int* __restrict__ ZB, int* __restrict__ SZ) {
  for (int c = 0; c < R; ++c) OUT[static_cast<ll>(R) * v + c] = x[c];
  unsigned sw[NW], zw[NW], tw[NW];
  pack_bits(x, eps, sw, zw, tw);
  for (int k = 0; k < NW; ++k) {
    SB[NW * v + k] = static_cast<int>(sw[k]);
    ZB[NW * v + k] = static_cast<int>(zw[k]);
    SZ[NW * v + k] = static_cast<int>(tw[k]);
  }
  const int ix[3] = {p / (M * M), (p / M) % M, p % M};
  for (int d = 0; d < 3; ++d)
    V[3 * v + d] = __fsub_rn(__fmul_rn(marks[ix[d]], scale * 2.0f), scale);
}

// A warp `ww` words of the masks (a power of two, so that they lie in one
// block of skeleton_flags): lane j < ww loads word j's masks, prefixes and
// offsets, and the warp takes each word with a used point in turn, a lane a
// point: the edges whose lower end it is, and a used point's row (its 33
// loads in flight), outputs and words.
__global__ void __launch_bounds__(kThreads) skeleton_compact_kernel(
    const int* __restrict__ masks, const int* __restrict__ pre,
    const int* __restrict__ off, int nw, int nb, int ww,
    const float* __restrict__ marks, const float* __restrict__ out, int M,
    float scale, float eps, float* __restrict__ V, float* __restrict__ OUT,
    int* __restrict__ SB, int* __restrict__ ZB, int* __restrict__ SZ,
    int* __restrict__ E) {
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * kThreads + threadIdx.x) / 32 * ww;
  const int *U = masks + 3 * nw, *Upre = pre + 3 * nw, *Uoff = off + 3 * nb;
  const int mine = w0 + lane, blk = w0 >> 5, MM = M * M;
  // lane j < ww: word j's used bits, first vertex slot, edge bits and first
  // edge slots
  unsigned um = 0u, fm[3] = {0u, 0u, 0u};
  int vm = 0, sm[3] = {0, 0, 0};
  if (lane < ww && mine < nw) {
    um = static_cast<unsigned>(U[mine]);
    vm = Uoff[blk] + Upre[mine];
    for (int ax = 0; ax < 3; ++ax) {
      fm[ax] = static_cast<unsigned>(masks[ax * nw + mine]);
      sm[ax] = off[ax * nb + blk] + pre[ax * nw + mine];
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (unsigned todo = __ballot_sync(0xFFFFFFFFu, um != 0u); todo;
       todo &= todo - 1u) {
    const int j = __ffs(static_cast<int>(todo)) - 1;
    const int p = 32 * (w0 + j) + lane;
    const unsigned u = __shfl_sync(0xFFFFFFFFu, um, j);
    const int v = __shfl_sync(0xFFFFFFFFu, vm, j) + __popc(u & below);
    unsigned f[3];
    int slot[3];
    for (int ax = 0; ax < 3; ++ax) {
      f[ax] = __shfl_sync(0xFFFFFFFFu, fm[ax], j);
      slot[ax] = __shfl_sync(0xFFFFFFFFu, sm[ax], j);
    }
    const bool used = (u >> lane) & 1u;
    float x[R];
    if (used) {
      const float* row = out + static_cast<ll>(p) * R;
      for (int c = 0; c < R; ++c) x[c] = row[c];
    }
    // the edges whose lower end is this point, axis-major
    for (int ax = 0; ax < 3; ++ax) {
      if ((f[ax] >> lane) & 1u) {
        const int s = slot[ax] + __popc(f[ax] & below);
        const int q = p + (ax == 0 ? MM : (ax == 1 ? M : 1));
        E[2 * s] = used_rank(U, Upre, Uoff, q);
        E[2 * s + 1] = v;
      }
    }
    if (used) compact_point(x, p, v, M, marks, scale, eps, V, OUT, SB, ZB, SZ);
  }
}

#endif  // SKELETON_CUMSUM

// --- K4 split_step -----------------------------------------------------------
//
// The design: three launches a busy insertion, the forward of the new
// vertices (K1's encode and the MLP) after the first; bound by bytes at
// sphere-large's final insertion and by the launches' latency (a graph
// node's 1.18 us, the chains of dependent loads) at the hidden ones, whose
// splits are a few hundred rows:
// - split_select: the split edges of plane idx, their lerp and their ends'
//   shared zero words, in edge order, from one pass over the pool.  A tile
//   of kSelectTile = 512 edges (2 rounds of a block) takes its id from
//   a counter, so that it waits only on tiles already running (forward
//   progress on the card; the tests' emulation runs the blocks in order);
//   each thread loads its edges' split words and ends together; ranks
//   within the tile are ballots and popcounts of the split bits; warp 0
//   publishes the tile's count, looks back over the tiles before it 32 at
//   a time (their counts, up to the nearest inclusive prefix) and publishes
//   its inclusive prefix (a decoupled look-back), while the other warps
//   gather their split edges' V rows, outputs at idx and zero words, every
//   load in flight.  Its curved instance (the curved path, K4c below) also
//   selects the curved rows from what it gathered, by a second ballot and a
//   second look-back after the gathers.
// - split_check: the sign override's test, a thread a row, the outputs on
//   the row's override columns (both ends on the plane, columns < idx, and
//   idx) loaded together; the override is a whole-step any, which the last
//   block reads.
// - split_finish: a block stages its kFinishRows rows of OUTn by float4
//   loads (all in flight, with the rows' edge, ends and their words loaded
//   before them); each thread applies the override to its row where the
//   check fired (OUTn zeroed on those columns) and writes its words, E's
//   rewrite, the right edge and, but for the final insertion, both edges'
//   split words and last differing columns.  On the curved path the finish
//   runs alone on curved_filter's survivors, whose rows carry the override
//   already (two launches a busy insertion).
// The override fires at the final insertion of sphere-medium and -large
// (chip_smoke.py phase 11 counts it), so it takes a launch of its own: a
// last block applying it to every row, after a finish that wrote them
// unoverridden, took one block through the whole of large's 23.7 MB OUTn
// (2.81 ms on an H100, against the check and finish's 0.022).
// The kernels' counters, flags and status words are device variables, zero
// when the library loads, which the last tile or block of every launch
// returns to zero (split_check's answer, g_finish_fire, every check
// overwrites): no memset, and a CUDA graph of recorded calls replays them
// as they ran.  Launches of one library are stream-ordered: two at once on
// two streams would share them.
// The first design (-DSPLIT_FOUR_PASS, cuda_build.DEVICE_ENGINE_FIRST): four
// launches, a thread an item: split_mark's int32 flags, which a torch.cumsum
// in the caller turns into ranks, split_lerp, split_override (a row's 33
// columns walked with an early return) and split_append (the override, the
// words and the edges, its row read at a 132-byte stride).

#ifdef SPLIT_FOUR_PASS
constexpr bool kSplitFirst = true;
#else
constexpr bool kSplitFirst = false;
// split_select: edges a thread and a tile; the most tiles a launch (the
// status words': 2^27 edges)
constexpr int kSelectItems = 2;
constexpr int kSelectTile = kSelectItems * kThreads;
constexpr int kMaxTiles = 1 << 18;
// a tile's status word: its count (low 32 bits), published as an aggregate
// or as an inclusive prefix; 0 before it publishes
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
__device__ unsigned long long g_select_status[kMaxTiles];
// the curved rows' status words (split_select's curved instance)
__device__ unsigned long long g_curved_status[kMaxTiles];
__device__ int g_select_tile;
__device__ int g_select_done;
// split_finish: rows a block, float4 loads a thread; split_check's blocks'
// ticket (low 32 bits) and count of blocks whose rows violate the
// override (high 32), back at zero after every launch, and its answer,
// which every launch of it overwrites
constexpr int kFinishRows = 256;
constexpr int kFinishLoads = (kFinishRows * R / 4 + kFinishRows - 1) / kFinishRows;
__device__ unsigned long long g_check_ticket;
__device__ int g_finish_fire;
#endif

__global__ void pack_words_kernel(const float* __restrict__ out, ll n,
                                  float eps, int* sb, int* zb, int* sz) {
  const ll p = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p < n) pack_row(out + R * p, eps, sb + NW * p, zb + NW * p, sz + NW * p);
}

__global__ void edge_words_kernel(const int* __restrict__ E, ll n,
                                  const int* __restrict__ SB,
                                  const int* __restrict__ ZB, int* eb,
                                  int* ld) {
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const ll p = E[2 * e], q = E[2 * e + 1];
  unsigned w[NW];
  ld[e] = edge_bits(SB + NW * p, ZB + NW * p, SB + NW * q, ZB + NW * q, w);
  for (int k = 0; k < NW; ++k) eb[NW * e + k] = static_cast<int>(w[k]);
}

// the new vertex of a split edge whose ends v0, v1 have outputs d0, d1 at
// the plane, the host engine's lerp op for op: w = |d0| / |d1 - d0|,
// v = v0 (1 - w) + v1 w
__device__ __forceinline__ void lerp_vertex(float d0, float d1,
                                            const float* v0, const float* v1,
                                            float* v) {
  const float w = __fdiv_rn(fabsf(d0), fabsf(__fsub_rn(d1, d0)));
  const float om = __fsub_rn(1.0f, w);
  for (int d = 0; d < 3; ++d)
    v[d] = __fadd_rn(__fmul_rn(v0[d], om), __fmul_rn(v1[d], w));
}

#ifdef SPLIT_FOUR_PASS

__global__ void split_mark_kernel(const int* __restrict__ EB, ll n, int idx,
                                  int* flags) {
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n) flags[e] = bit_of(EB + NW * e, idx);
}

__global__ void split_lerp_kernel(const int* __restrict__ E,
                                  const int* __restrict__ cum, ll n,
                                  const float* __restrict__ V,
                                  const float* __restrict__ OUT,
                                  const int* __restrict__ ZB, int idx,
                                  int* lanes, int* ce, float* Vn, int* bz) {
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n || !flag_of(cum, e)) return;
  const ll s = cum[e] - 1;
  const ll a = E[2 * e], b = E[2 * e + 1];
  lanes[s] = static_cast<int>(e);
  ce[2 * s] = static_cast<int>(a);
  ce[2 * s + 1] = static_cast<int>(b);
  lerp_vertex(OUT[R * a + idx], OUT[R * b + idx], V + 3 * a, V + 3 * b,
              Vn + 3 * s);
  for (int k = 0; k < NW; ++k) bz[NW * s + k] = ZB[NW * a + k] & ZB[NW * b + k];
}

// the sign override's planes: both ends on it (columns < idx), and idx
__device__ __forceinline__ bool override_col(const int* bz, int c, int idx) {
  return c == idx || (c < idx && bit_of(bz, c));
}

__global__ void split_override_kernel(const float* __restrict__ OUTn,
                                      const int* __restrict__ bz, ll n,
                                      int idx, float eps, int* viol) {
  const ll s = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n) return;
  for (int c = 0; c < R; ++c)
    if (override_col(bz + NW * s, c, idx) && fabsf(OUTn[R * s + c]) > eps) {
      *viol = 1;  // every writer writes 1
      return;
    }
}

__global__ void split_append_kernel(
    float* OUTn, const int* __restrict__ bz, const int* __restrict__ viol,
    const int* __restrict__ lanes, const int* __restrict__ ce, int* E,
    int* EB, int* LD, const int* __restrict__ SB, const int* __restrict__ ZB,
    ll n, ll nV, int idx, float eps, int* sbn, int* zbn, int* szn, int* Er,
    int* EBr, int* LDr) {
  const ll s = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float* o = OUTn + R * s;
  if (*viol)
    for (int c = 0; c < R; ++c)
      if (override_col(bz + NW * s, c, idx)) o[c] = 0.0f;
  pack_row(o, eps, sbn + NW * s, zbn + NW * s, szn + NW * s);
  const ll e = lanes[s];
  const ll a = ce[2 * s], b = ce[2 * s + 1];
  const int id = static_cast<int>(nV + s);
  E[2 * e + 1] = id;
  Er[2 * s] = static_cast<int>(b);
  Er[2 * s + 1] = id;
  unsigned w[NW];
  if (EB != nullptr) {
    LD[e] = edge_bits(SB + NW * a, ZB + NW * a, sbn + NW * s, zbn + NW * s, w);
    for (int k = 0; k < NW; ++k) EB[NW * e + k] = static_cast<int>(w[k]);
  }
  if (EBr != nullptr) {
    LDr[s] = edge_bits(SB + NW * b, ZB + NW * b, sbn + NW * s, zbn + NW * s, w);
    for (int k = 0; k < NW; ++k) EBr[NW * s + k] = static_cast<int>(w[k]);
  }
}

#else  // the design

__device__ __forceinline__ unsigned long long status_load(
    unsigned long long* st, int t) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(st[t])
      .load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void status_store(unsigned long long* st, int t,
                                             unsigned long long v) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(st[t])
      .store(v, cuda::std::memory_order_relaxed);
}

// warp 0 of tile t > 0: the count of the items flagged before the tile, from
// its predecessors' status words in st, 32 a round (lane l reads tile t - 1 -
// l - 32 round): each word waited for, then the counts summed up to the
// nearest inclusive prefix (the lowest such lane); before tile 0, an
// inclusive 0
__device__ __forceinline__ int look_back(unsigned long long* st, int t,
                                         int lane) {
  int before = 0;
  for (int j = t - 1;; j -= 32) {
    const int p = j - lane;
    unsigned long long s = p >= 0 ? status_load(st, p) : kInclusive;
    while (__ballot_sync(0xFFFFFFFFu, (s >> 32) == 0u))
      if ((s >> 32) == 0u) s = status_load(st, p);
    const unsigned inc = __ballot_sync(0xFFFFFFFFu, (s >> 32) == 2u);
    const int stop = inc ? __ffs(static_cast<int>(inc)) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & 0xFFFFFFFFu) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    before += v;
    if (inc) return before;
  }
}

// the block's tile: the id thread 0 takes from the counter
__device__ __forceinline__ int rank_tile() {
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(&g_select_tile, 1);
  __syncthreads();
  return tile_s;
}

// warp 0 of tile t: the tile's count of flagged items published in st, the
// count before the tile looked back and the inclusive count published.
// Returns the count before the tile.
__device__ __forceinline__ int tile_scan(unsigned long long* st, int tile,
                                         int total, int lane) {
  if (lane == 0)
    status_store(st, tile, (tile ? kAggregate : kInclusive) |
                               static_cast<unsigned>(total));
  const int before = tile ? look_back(st, tile, lane) : 0;
  if (lane == 0 && tile)
    status_store(st, tile,
                 kInclusive | static_cast<unsigned>(before + total));
  return before;
}

// lane 0 of warp 0, once the tile's look-backs and statuses are done: the
// done ticket, true where the tile is the last to get here (which returns
// the state to zero, rank_reset)
__device__ __forceinline__ bool tile_done() {
  __threadfence();
  return atomicAdd(&g_select_done, 1) == static_cast<int>(gridDim.x) - 1;
}

// the rank state back at zero, by every thread of the last tile (and the
// curved rows' status words after split_select's curved instance)
__device__ __forceinline__ void rank_reset(bool curved = false) {
  for (int t = threadIdx.x; t < static_cast<int>(gridDim.x); t += kThreads) {
    status_store(g_select_status, t, 0ull);
    if (curved) status_store(g_curved_status, t, 0ull);
  }
  if (threadIdx.x == 0) {
    g_select_tile = 0;
    g_select_done = 0;
  }
}

// the count words (tropical_torch/extract/device.py CW_*)
constexpr int CW_CURVED = 0, CW_NOPLANE = 1, CW_SENT = 2, CW_GD = 3,
              CW_ANYD0 = 4, CW_KEPT = 5, CW_DROPS = 6;
// a curved row's state for the filter (CV_*): curved, root out of range,
// residual at the plane not inside the eps band
constexpr int CV_CURVED = 1, CV_GG = 2, CV_OFF = 4;

// one warp's count of pred added to *dst
__device__ __forceinline__ void warp_count(bool pred, int* dst) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(dst, __popc(m));
}

// a curved row's earlier plane: the highest column below idx zero at both
// ends (in its shared zero words z), -1 for none
__device__ __forceinline__ int plane_below(const int* z, int idx) {
  for (int w = NW - 1; w >= 0; --w) {
    const int lo = idx - 32 * w;  // the columns of word w below idx
    const unsigned below =
        static_cast<unsigned>(z[w]) &
        (lo >= 32 ? ~0u : (lo <= 0 ? 0u : (1u << lo) - 1u));
    if (below) return 32 * w + 31 - __clz(static_cast<int>(below));
  }
  return -1;
}

// lanes, ce, Vn, bz [n_split, ...]: the split edges' lanes, ends, new
// vertices and shared zero words, in edge order (split_lerp's outputs).
// The curved instance (K4c's selection, curved_select's outputs) also
// flags each split edge whose ends differ by more than eps in two or more
// coordinates, from the ends' rows and zero words it gathered for the
// lerp, and ranks the curved rows by a second ballot and a second look-back
// on status words of their own, published after the gathers: their slots,
// earlier planes, ends and corners [n_split, ...] in slot order, the first
// cw[CW_CURVED] set; a curved row on no earlier plane is counted into
// cw[CW_NOPLANE] (the caller raises)
template <bool kCurved>
__global__ void __launch_bounds__(kThreads) split_select_kernel(
    const int* __restrict__ E, const int* __restrict__ EB, int n,
    const float* __restrict__ V, const float* __restrict__ OUT,
    const int* __restrict__ ZB, int idx, float eps, int* __restrict__ lanes,
    int* __restrict__ ce, float* __restrict__ Vn, int* __restrict__ bz,
    int* __restrict__ qs, int* __restrict__ plane, float* __restrict__ e01,
    float* __restrict__ corners, int* __restrict__ cw) {
  // (round, warp) counts, then their exclusive prefix within the tile; the
  // same of the curved rows
  constexpr int kCounts = kSelectItems * kThreads / 32;
  __shared__ int counts[kCounts];
  __shared__ int ccounts[kCounts];
  __shared__ int base_s, last_s, cbase_s, cincl_s;
  static_assert(kCounts <= 32, "a count a lane");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = rank_tile();
  const int e0 = tile * kSelectTile + threadIdx.x;
  const int word = idx >> 5;
  const unsigned bit = 1u << (idx & 31);
  // the split words and the ends of the thread's edges, all in flight
  int w[kSelectItems];
  int2 ends[kSelectItems];
#pragma unroll
  for (int i = 0; i < kSelectItems; ++i) {
    const int e = e0 + i * kThreads;
    w[i] = e < n ? EB[NW * e + word] : 0;
    ends[i] = e < n ? reinterpret_cast<const int2*>(E)[e] : make_int2(0, 0);
  }
  unsigned mask[kSelectItems];
#pragma unroll
  for (int i = 0; i < kSelectItems; ++i) {
    mask[i] = __ballot_sync(0xFFFFFFFFu, static_cast<unsigned>(w[i]) & bit);
    if (lane == 0) counts[i * (kThreads / 32) + warp] = __popc(mask[i]);
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kCounts ? counts[lane] : 0;
    const int inc = warp_scan(c, lane);
    if (lane < kCounts) counts[lane] = inc - c;
    const int total = __shfl_sync(0xFFFFFFFFu, inc, 31);
    // the curved instance takes its done ticket after the second look-back
    const int before = tile_scan(g_select_status, tile, total, lane);
    if (lane == 0) {
      base_s = before;
      if (!kCurved) last_s = tile_done();
    }
  }
  // the split edges' rows, every load in flight, while warp 0 looks back
  bool split[kSelectItems];
  float d0[kSelectItems] = {}, d1[kSelectItems] = {},
        va[kSelectItems][3] = {}, vb[kSelectItems][3] = {};
  int z[kSelectItems][NW] = {};
#pragma unroll
  for (int i = 0; i < kSelectItems; ++i) {
    split[i] = (mask[i] >> lane) & 1u;
    if (!split[i]) continue;
    const ll a = ends[i].x, b = ends[i].y;
    d0[i] = OUT[R * a + idx];
    d1[i] = OUT[R * b + idx];
    for (int d = 0; d < 3; ++d) {
      va[i][d] = V[3 * a + d];
      vb[i][d] = V[3 * b + d];
    }
    for (int k = 0; k < NW; ++k) z[i][k] = ZB[NW * a + k] & ZB[NW * b + k];
  }
  // the curved instance: each split edge's curved flag and earlier plane
  // (curved_select's), from the rows just gathered, and their ballots
  bool curved[kSelectItems] = {};
  int pl[kSelectItems] = {};
  unsigned cmask[kSelectItems] = {};
  if constexpr (kCurved) {
#pragma unroll
    for (int i = 0; i < kSelectItems; ++i) {
      if (split[i]) {
        int dif = 0;
        for (int d = 0; d < 3; ++d)
          dif += fabsf(__fsub_rn(vb[i][d], va[i][d])) > eps;
        curved[i] = dif > 1;
        pl[i] = plane_below(z[i], idx);
      }
      cmask[i] = __ballot_sync(0xFFFFFFFFu, curved[i]);
      if (lane == 0) ccounts[i * (kThreads / 32) + warp] = __popc(cmask[i]);
      warp_count(curved[i] && pl[i] < 0, cw + CW_NOPLANE);
    }
  }
  __syncthreads();
  if constexpr (kCurved) {
    // the curved rows' look-back, while the other warps write their rows
    if (warp == 0) {
      const int c = lane < kCounts ? ccounts[lane] : 0;
      const int inc = warp_scan(c, lane);
      if (lane < kCounts) ccounts[lane] = inc - c;
      const int total = __shfl_sync(0xFFFFFFFFu, inc, 31);
      const int before = tile_scan(g_curved_status, tile, total, lane);
      if (lane == 0) {
        cbase_s = before;
        cincl_s = before + total;
        last_s = tile_done();
      }
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int slot[kSelectItems] = {};
#pragma unroll
  for (int i = 0; i < kSelectItems; ++i) {
    if (!split[i]) continue;
    const int s = base_s + counts[i * (kThreads / 32) + warp] +
                  __popc(mask[i] & below);
    slot[i] = s;
    lanes[s] = e0 + i * kThreads;
    ce[2 * s] = ends[i].x;
    ce[2 * s + 1] = ends[i].y;
    lerp_vertex(d0[i], d1[i], va[i], vb[i], Vn + 3 * s);
    for (int k = 0; k < NW; ++k) bz[NW * s + k] = z[i][k];
  }
  if constexpr (kCurved) {
    // the tile's curved rows by their rank within it, through shared
    // memory: their slots, planes and ends; then the tile's block of each
    // output (consecutive ranks) written a value a thread, so that a warp's
    // stores are contiguous (a curved row's 32 values stored by its own
    // thread, at a 96-byte stride, measured slower on an H100)
    __shared__ int cslot_s[kSelectTile], cplane_s[kSelectTile];
    __shared__ float cends_s[6 * kSelectTile];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSelectItems; ++i) {
      if (!curved[i]) continue;
      const int r = ccounts[i * (kThreads / 32) + warp] +
                    __popc(cmask[i] & below);
      cslot_s[r] = slot[i];
      cplane_s[r] = pl[i];
      for (int d = 0; d < 3; ++d) {
        cends_s[6 * r + d] = va[i][d];
        cends_s[6 * r + 3 + d] = vb[i][d];
      }
    }
    __syncthreads();
    const int base = cbase_s, cnt = cincl_s - cbase_s;
    for (int q = threadIdx.x; q < cnt; q += kThreads) {
      qs[base + q] = cslot_s[q];
      plane[base + q] = cplane_s[q];
    }
    for (int q = threadIdx.x; q < 6 * cnt; q += kThreads)
      e01[6 * static_cast<ll>(base) + q] = cends_s[q];
    // corner 4 i + 2 j + k = (x_k, y_j, z_i): coordinate d from end
    // (corner >> d) & 1
    for (int q = threadIdx.x; q < 24 * cnt; q += kThreads) {
      const int r = q / 24, c = q - 24 * r, corner = c / 3, d = c - 3 * corner;
      corners[24 * static_cast<ll>(base) + q] =
          cends_s[6 * r + 3 * ((corner >> d) & 1) + d];
    }
    if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0)
      cw[CW_CURVED] = cincl_s;
  }
  if (last_s) rank_reset(kCurved);
}

// the override's columns of a row, as words: both ends on the plane
// (columns < idx) and idx
__device__ __forceinline__ void override_mask(const int* __restrict__ bz,
                                              int idx, unsigned* m) {
  for (int w = 0; w < NW; ++w) {
    const int lo = idx - 32 * w;  // the columns of word w below idx
    const unsigned under = lo >= 32 ? ~0u : (lo <= 0 ? 0u : (1u << lo) - 1u);
    const unsigned at = lo >= 0 && lo < 32 ? 1u << lo : 0u;
    m[w] = (static_cast<unsigned>(bz[w]) & under) | at;
  }
}

// rows s0 .. s0 + kFinishRows - 1 of OUTn (fewer at its end) into staged:
// float4 loads, every load in flight, then the stores (16-byte aligned:
// OUTn is, and s0 R floats with s0 a multiple of 256); all the block's
// threads, which then meet at a barrier
__device__ __forceinline__ void stage_rows(const float* __restrict__ OUTn,
                                           int s0, int n, float4* staged) {
  const int r = threadIdx.x;
  const int nr = min(kFinishRows, n - s0);
  const float* src = OUTn + static_cast<ll>(s0) * R;
  const int nf = nr * R, n4 = nf >> 2;
  float4 v[kFinishLoads];
#pragma unroll
  for (int k = 0; k < kFinishLoads; ++k) {
    const int q = r + k * kFinishRows;
    if (q < n4) v[k] = reinterpret_cast<const float4*>(src)[q];
  }
#pragma unroll
  for (int k = 0; k < kFinishLoads; ++k) {
    const int q = r + k * kFinishRows;
    if (q < n4) staged[q] = v[k];
  }
  for (int q = 4 * n4 + r; q < nf; q += kFinishRows)
    reinterpret_cast<float*>(staged)[q] = src[q];
  __syncthreads();
}

// the sign override's test (split_override): a thread a row, the outputs
// on its override columns loaded together (predicated loads, no chain);
// each block adds 1 to its ticket and, if a row of it violates the
// override, 1 to the violations in one atomic, and the last block writes
// whether any did into g_finish_fire and returns the word to zero
__global__ void __launch_bounds__(kThreads) split_check_kernel(
    const float* __restrict__ OUTn, const int* __restrict__ bz, int n,
    int idx, float eps) {
  __shared__ int viol_s;
  if (threadIdx.x == 0) viol_s = 0;
  __syncthreads();
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s < n) {
    unsigned m[NW];
    override_mask(bz + NW * s, idx, m);
    const float* o = OUTn + static_cast<ll>(s) * R;
    float x[R];
#pragma unroll
    for (int c = 0; c < R; ++c)
      x[c] = (m[c >> 5] >> (c & 31)) & 1u ? o[c] : 0.0f;
    bool viol = false;
#pragma unroll
    for (int c = 0; c < R; ++c) viol |= fabsf(x[c]) > eps;
    if (viol) viol_s = 1;  // every writer writes 1
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(
        &g_check_ticket, 1ull + (viol_s ? 1ull << 32 : 0ull));
    if ((t & 0xFFFFFFFFull) == gridDim.x - 1u) {
      g_check_ticket = 0ull;
      g_finish_fire = viol_s || (t >> 32) != 0ull;
    }
  }
}

// the override (where the check fired), the new vertices' words and the
// edges (split_append's outputs); EB, LD, EBr and LDr null at the final
// insertion.  Without checked the rows are curved_filter's survivors,
// which carry the override already: it is not applied (g_finish_fire is
// not read)
__global__ void __launch_bounds__(kFinishRows) split_finish_kernel(
    float* OUTn, const int* __restrict__ bz, const int* __restrict__ lanes,
    const int* __restrict__ ce, int* E, int* EB, int* LD,
    const int* __restrict__ SB, const int* __restrict__ ZB, int n, int nV,
    int idx, float eps, int* sbn, int* zbn, int* szn, int* Er, int* EBr,
    int* LDr, int checked) {
  __shared__ float4 staged[kFinishRows * R / 4];
  const bool fire = checked && g_finish_fire;
  const int r = threadIdx.x, s0 = blockIdx.x * kFinishRows, s = s0 + r;
  const bool mine = s < n;
  // the row's edge, ends and their words, independent of OUTn: first
  int e = 0, a = 0, b = 0, sa[NW] = {}, za[NW] = {}, sb[NW] = {},
      zb[NW] = {};
  unsigned m[NW] = {0u, 0u};
  if (mine) {
    e = lanes[s];
    a = ce[2 * s];
    b = ce[2 * s + 1];
    if (fire) override_mask(bz + NW * s, idx, m);
    for (int k = 0; EBr != nullptr && k < NW; ++k) {
      sa[k] = SB[NW * a + k];
      za[k] = ZB[NW * a + k];
      sb[k] = SB[NW * b + k];
      zb[k] = ZB[NW * b + k];
    }
  }
  stage_rows(OUTn, s0, n, staged);
  if (!mine) return;
  float* o = reinterpret_cast<float*>(staged) + r * R;
  for (int w = 0; w < NW; ++w)
    for (unsigned u = m[w]; u; u &= u - 1u) {
      const int c = 32 * w + __ffs(static_cast<int>(u)) - 1;
      o[c] = 0.0f;
      OUTn[static_cast<ll>(s) * R + c] = 0.0f;
    }
  int sn[NW], zn[NW], tn[NW];
  pack_row(o, eps, sn, zn, tn);
  for (int k = 0; k < NW; ++k) {
    sbn[NW * s + k] = sn[k];
    zbn[NW * s + k] = zn[k];
    szn[NW * s + k] = tn[k];
  }
  const int id = nV + s;
  E[2 * e + 1] = id;
  Er[2 * s] = b;
  Er[2 * s + 1] = id;
  if (EBr != nullptr) {
    unsigned ew[NW];
    LD[e] = edge_bits(sa, za, sn, zn, ew);
    for (int k = 0; k < NW; ++k) EB[NW * e + k] = static_cast<int>(ew[k]);
    LDr[s] = edge_bits(sb, zb, sn, zn, ew);
    for (int k = 0; k < NW; ++k) EBr[NW * s + k] = static_cast<int>(ew[k]);
  }
}

// --- K4c curved_step: the curved insertion (force=False) --------------------
//
// Stage 3b of the JAX engine's busy insertion (tropical/extract/device.py
// :564-715), as the port's host engine computes it (extract/subdivide.py
// _curved_intersections, extract/failover.py gradient_descent_failover and
// strict_check), around K4's selection and finish, the net's forwards (K1)
// and the root solve (K7).  Bound by bytes: the filter's survivors' rows
// (132 bytes each, read and written) are most of them.  At a few hundred
// curved rows each launch is a graph node's floor (some 2 us on an H100),
// so the design runs the curved rows in as few launches as the forwards
// between them allow: four at a busy insertion with curved rows, two
// without, and on a rescue the mix and the filter's two again:
// - the selection, inside split_select's curved instance (above): a split
//   edge is curved when its ends differ by more than eps in two or more
//   coordinates; its earlier plane is the highest column below idx zero at
//   both ends (the selection's shared zero words); the curved rows,
//   compacted in edge order into a side buffer: their slots, planes, ends
//   and the 8 corners of their boxes; a curved row on no earlier plane is
//   counted, and the caller raises;
// - curved_roots (1): K7's kernel (trilinear_roots.cuh) on rows gathered
//   from the corner forward, each lane's float4 the column at the row's
//   plane (p) or at idx (q) of four corners, and each root written with
//   its point on the edge's box, e0 (1 - t) + e1 t, the input of the
//   on-surface forward;
// - curved_resolve: curved_gd (1), after that forward: the residuals at the
//   plane and at idx, the sentinel rows (a coordinate outside [0, 1]) and
//   the rows the gradient-descent rescue takes (in range, off either
//   surface), compacted in row order with their start, direction, plane
//   and root (up to kGdBlock rows by one block, with no look-back), and
//   each curved row mixed as if none were rescued: its
//   vertex e0 + t (e1 - e0) over the lerp, and its state for the filter;
//   curved_mix (1) only after a rescue: every curved row mixed again, the
//   rescued roots and residuals taken back (the caller clears the count
//   words the mix and the filter set, and filters again);
// - curved_filter (2): the sign override's test over every split row
//   (split_check, whose predicated loads touch only the sectors of a row's
//   override columns: a block staging its rows whole measured slower on an
//   H100), then curved_keep: a tile
//   of 256 rows, one contiguous range of OUTn, staged in shared memory by
//   float4 loads (split_finish's scheme), the override applied where it
//   fired, the strict filter (a flat row on the surface at idx; a curved
//   row on it, in range and, when any curved residual at the plane is off
//   the eps band, its own within it) and the survivors compacted in edge
//   order.  A tile's survivors take consecutive ranks, so its rows are
//   written as one contiguous block of the output, a float a thread.  K4's
//   finish then runs on the survivors without a test of its own (it cannot
//   fire).
// Every compaction ranks a thread's item in one pass: ballots within a
// tile of kThreads, a decoupled look-back across tiles, each tile's id from
// a counter (split_select's scheme and state, which the last block returns
// to zero; the launches of one stream do not overlap).  The counts go to
// the step's count words (cw, zeroed by the caller), which the caller
// reads: the curved rows and those on no plane after the selection; the
// sentinels and rescued rows, the survivors and dropped curved rows after
// the filter.  Floats are rounded an operation at a time (no FMA), in the
// host engine's order.
// The first design (-DCURVED_FIRST, cuda_build.CURVED_FIRST), eight
// launches at a busy insertion with curved rows, three without:
// curved_select, a pass of its own over the split rows (each row's ends
// and their V rows gathered again, a tile of 256, a curved row's 32 values
// stored by its thread); curved_pick (a thread a corner: p and q written),
// K7 on them and curved_points; curved_gd without the mix, and curved_mix
// after it whether or not a row is rescued; curved_keep a thread a row, a
// survivor's 33 floats copied by its thread at a 132-byte stride; and K4's
// finish with its own split_check.  It takes the design's launch functions
// (split_select_curved_launch runs the flat selection and curved_select,
// curved_roots_launch its three, curved_gd_launch its two,
// split_finish_launch always tests), so the engine has one route.

// the rank of the thread's item among the launch's flagged items (tiles in
// id order, a tile's threads in order), valid where flag; *incl: the
// flagged items of tiles 0..tile, *base: those of tiles before it.  Every
// thread of every block calls it once; the last block to finish its
// look-back returns the state to zero.
__device__ __forceinline__ int rank_flag(int tile, bool flag, int* incl,
                                         int* base = nullptr) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int counts[kWarps];
  __shared__ int base_s, incl_s, last_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) counts[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kWarps ? counts[lane] : 0;
    const int inc = warp_scan(c, lane);
    if (lane < kWarps) counts[lane] = inc - c;
    const int total = __shfl_sync(0xFFFFFFFFu, inc, 31);
    const int before = tile_scan(g_select_status, tile, total, lane);
    if (lane == 0) {
      base_s = before;
      incl_s = before + total;
      last_s = tile_done();
    }
  }
  __syncthreads();
  *incl = incl_s;
  if (base != nullptr) *base = base_s;
  const int r = base_s + counts[warp] + __popc(mask & ((1u << lane) - 1u));
  if (last_s) rank_reset();
  return r;
}

__device__ __forceinline__ bool out_of_range(const float* t) {
  bool gg = false;
  for (int d = 0; d < 3; ++d) gg |= t[d] < 0.0f || t[d] > 1.0f;
  return gg;
}

// a split row's strict filter (``st`` its CV_* state, ``chk`` its output at
// idx, the override applied)
__device__ __forceinline__ bool strict_keep(int st, float chk, float eps,
                                            bool anyd0) {
  const bool on = fabsf(chk) < eps;
  return st & CV_CURVED
             ? on && !(st & CV_GG) && (!(st & CV_OFF) || !anyd0)
             : on;
}

#ifdef CURVED_FIRST

// a curved row's outputs at rank r: its slot s, plane, ends (v0, v1) and
// the 8 corners of its box (z-major, corner 4 i + 2 j + k = (x_k, y_j, z_i))
__device__ __forceinline__ void curved_row(int r, int s, int pl,
                                           const float* v0, const float* v1,
                                           int* qs, int* plane, float* e01,
                                           float* corners) {
  const float* v[2] = {v0, v1};
  qs[r] = s;
  plane[r] = pl;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      e01[6 * static_cast<ll>(r) + 3 * e + d] = v[e][d];
  float* c = corners + 24 * static_cast<ll>(r);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* p = c + 3 * (4 * i + 2 * j + k);
        p[0] = v[k][0];
        p[1] = v[j][1];
        p[2] = v[i][2];
      }
}

// qs, plane [n]: the curved rows' slots and earlier planes, in slot order;
// e01 [n, 2, 3] their ends, corners [n, 8, 3]
__global__ void __launch_bounds__(kThreads) curved_select_kernel(
    const int* __restrict__ ce, const int* __restrict__ bz,
    const float* __restrict__ V, int n, int idx, float eps, int* qs,
    int* plane, float* e01, float* corners, int* cw) {
  const int tile = rank_tile();
  const int s = tile * kThreads + threadIdx.x;
  bool curved = false;
  int pl = -1;
  float v[2][3] = {};
  if (s < n) {
    const ll a = ce[2 * s], b = ce[2 * s + 1];
    int dif = 0;
    for (int d = 0; d < 3; ++d) {
      v[0][d] = V[3 * a + d];
      v[1][d] = V[3 * b + d];
      dif += fabsf(__fsub_rn(v[1][d], v[0][d])) > eps;
    }
    curved = dif > 1;
    pl = plane_below(bz + NW * s, idx);
  }
  warp_count(curved && pl < 0, cw + CW_NOPLANE);
  int incl;
  const int r = rank_flag(tile, curved, &incl);
  if (curved) curved_row(r, s, pl, v[0], v[1], qs, plane, e01, corners);
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0)
    cw[CW_CURVED] = incl;
}

// the survivors of the strict filter, in slot order: their vertices, outputs
// (the override applied where it fired), shared zero words, lanes and ends
__global__ void __launch_bounds__(kThreads) curved_keep_kernel(
    const float* __restrict__ OUTn, const int* __restrict__ bz,
    const int* __restrict__ lanes, const int* __restrict__ ce,
    const float* __restrict__ Vn, const int* __restrict__ cstate, int n,
    int idx, float eps, int* cw, float* Vs, float* OUTs, int* bzs,
    int* lanes_s, int* ces) {
  const int tile = rank_tile();
  const int s = tile * kThreads + threadIdx.x;
  const bool fire = g_finish_fire, anyd0 = cw[CW_ANYD0] != 0;
  bool keep = false, curved = false;
  if (s < n) {
    const int st = cstate[s];
    curved = st & CV_CURVED;
    keep = strict_keep(st, fire ? 0.0f : OUTn[R * static_cast<ll>(s) + idx],
                       eps, anyd0);
  }
  warp_count(curved && !keep, cw + CW_DROPS);
  int incl;
  const int r = rank_flag(tile, keep, &incl);
  if (keep) {
    unsigned m[NW] = {0u, 0u};
    if (fire) override_mask(bz + NW * s, idx, m);
    const float* o = OUTn + R * static_cast<ll>(s);
    float* os = OUTs + R * static_cast<ll>(r);
    for (int c = 0; c < R; ++c)
      os[c] = (m[c >> 5] >> (c & 31)) & 1u ? 0.0f : o[c];
    for (int d = 0; d < 3; ++d)
      Vs[3 * static_cast<ll>(r) + d] = Vn[3 * static_cast<ll>(s) + d];
    for (int k = 0; k < NW; ++k) bzs[NW * r + k] = bz[NW * s + k];
    lanes_s[r] = lanes[s];
    ces[2 * r] = ce[2 * s];
    ces[2 * r + 1] = ce[2 * s + 1];
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0)
    cw[CW_KEPT] = incl;
}

#else  // the design

// the survivors of the strict filter, in slot order: their vertices, outputs
// (the override applied where it fired), shared zero words, lanes and ends.
// A tile of kFinishRows rows (its id from the counter) stages its rows of
// OUTn, and loads each row's state, words, lane, ends and vertex, before it
// ranks; its survivors' rows then go out as one contiguous block of OUTs,
// a float a thread, and each survivor's small outputs from its thread.
__global__ void __launch_bounds__(kFinishRows) curved_keep_kernel(
    const float* __restrict__ OUTn, const int* __restrict__ bz,
    const int* __restrict__ lanes, const int* __restrict__ ce,
    const float* __restrict__ Vn, const int* __restrict__ cstate, int n,
    int idx, float eps, int* cw, float* Vs, float* OUTs, int* bzs,
    int* lanes_s, int* ces) {
  static_assert(kFinishRows == kThreads, "rank_flag's tile");
  __shared__ float4 staged[kFinishRows * R / 4];
  __shared__ int kept_s[kFinishRows];  // a survivor's row within the tile
  const int tile = rank_tile();
  const int r = threadIdx.x, s0 = tile * kFinishRows, s = s0 + r;
  const bool mine = s < n;
  const bool fire = g_finish_fire, anyd0 = cw[CW_ANYD0] != 0;
  int st = 0, lane = 0, z[NW] = {}, e[2] = {};
  float v[3] = {};
  if (mine) {
    st = cstate[s];
    lane = lanes[s];
    for (int w = 0; w < NW; ++w) z[w] = bz[NW * s + w];
    e[0] = ce[2 * s];
    e[1] = ce[2 * s + 1];
    for (int d = 0; d < 3; ++d) v[d] = Vn[3 * s + d];
  }
  stage_rows(OUTn, s0, n, staged);
  float* rows = reinterpret_cast<float*>(staged);
  bool keep = false;
  if (mine) {
    unsigned m[NW] = {0u, 0u};
    if (fire) override_mask(z, idx, m);
    for (int w = 0; w < NW; ++w)
      for (unsigned u = m[w]; u; u &= u - 1u)
        rows[r * R + 32 * w + __ffs(static_cast<int>(u)) - 1] = 0.0f;
    keep = strict_keep(st, rows[r * R + idx], eps, anyd0);
  }
  warp_count((st & CV_CURVED) && !keep, cw + CW_DROPS);
  int incl, base;
  const int k = rank_flag(tile, keep, &incl, &base);
  if (keep) {
    kept_s[k - base] = r;
    for (int d = 0; d < 3; ++d) Vs[3 * static_cast<ll>(k) + d] = v[d];
    for (int w = 0; w < NW; ++w) bzs[NW * k + w] = z[w];
    ces[2 * k] = e[0];
    ces[2 * k + 1] = e[1];
    lanes_s[k] = lane;
  }
  __syncthreads();
  // a float a thread a round, four rounds unrolled (the loop rolled, and
  // all R rounds unrolled, measured slower on an H100)
  float* dst = OUTs + static_cast<ll>(base) * R;
#pragma unroll 4
  for (int q = r; q < (incl - base) * R; q += kFinishRows) {
    const int j = q / R;
    dst[q] = rows[kept_s[j] * R + q - j * R];
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && r == 0) cw[CW_KEPT] = incl;
}

#endif  // CURVED_FIRST

// a curved row's vertex into Vn at its slot s, e0 + t (e1 - e0) at its root
// t, and its state into cstate (gg: t out of range, d0 its residual at the
// plane, 0 where gg); cw[CW_ANYD0] set where the residual is off the band
__device__ __forceinline__ void mix_row(ll s, const float* e0,
                                        const float* e1, const float* t,
                                        bool gg, float d0, float eps,
                                        float* Vn, int* cstate, int* cw) {
  for (int d = 0; d < 3; ++d)
    Vn[3 * s + d] = __fadd_rn(e0[d], __fmul_rn(t[d], __fsub_rn(e1[d], e0[d])));
  cstate[s] = CV_CURVED | (gg ? CV_GG : 0) | (fabsf(d0) < eps ? 0 : CV_OFF);
  if (fabsf(d0) > eps) cw[CW_ANYD0] = 1;  // every writer writes 1
}

#ifdef CURVED_FIRST

// p, q [n, 8]: the corner outputs d [n, 8, R] at each row's plane and at idx
__global__ void curved_pick_kernel(const float* __restrict__ d,
                                   const int* __restrict__ plane, ll n,
                                   int idx, float* p, float* q) {
  const ll t = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 8 * n) return;
  const float* o = d + R * t;
  p[t] = o[plane[t >> 3]];
  q[t] = o[idx];
}

// cand [n, 3]: e0 (1 - t) + e1 t at each row's root t
__global__ void curved_points_kernel(const float* __restrict__ e01,
                                     const float* __restrict__ ints, ll n,
                                     float* cand) {
  const ll r = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  for (int d = 0; d < 3; ++d) {
    const float t = ints[3 * r + d];
    cand[3 * r + d] = __fadd_rn(__fmul_rn(e01[6 * r + d], __fsub_rn(1.0f, t)),
                                __fmul_rn(e01[6 * r + 3 + d], t));
  }
}

#else  // the design

// curved_roots: K7's rows gathered from the corner forward d [n, 8, R] (p
// at each row's plane, q at idx: a lane's float4 is four corners' column,
// 132 bytes apart), and each root t written with its point on the row's
// edge, e0 (1 - t) + e1 t (the host engine's form), by the lane of its
// coordinate, from the ends that lane loaded before the solve
struct CornerRows {
  static constexpr int kEnds = (3 + k7::kLanes - 1) / k7::kLanes;
  struct Ends {
    float e0[kEnds], e1[kEnds];  // coordinates lane, lane + kLanes, ...
  };
  const float* __restrict__ d;
  const int* __restrict__ plane;
  int idx;
  const float* __restrict__ e01;
  float* __restrict__ ints;
  float* __restrict__ cand;
  __device__ __forceinline__ Ends prefetch(int row, int lane) const {
    Ends e{};
    for (int i = 0, j = lane; j < 3; ++i, j += k7::kLanes) {
      e.e0[i] = e01[6 * static_cast<ll>(row) + j];
      e.e1[i] = e01[6 * static_cast<ll>(row) + 3 + j];
    }
    return e;
  }
  __device__ __forceinline__ float4 load(int row, int k) const {
    const float* o = d + (8 * static_cast<ll>(row) + 4 * (k & 1)) * R +
                     (k < 2 ? plane[row] : idx);
    return make_float4(o[0], o[R], o[2 * R], o[3 * R]);
  }
  __device__ __forceinline__ void store(int row, int j, float t,
                                        const Ends& e) const {
    const ll r = row;
    const int i = j / k7::kLanes;
    ints[3 * r + j] = t;
    cand[3 * r + j] = __fadd_rn(__fmul_rn(e.e0[i], __fsub_rn(1.0f, t)),
                                __fmul_rn(e.e1[i], t));
  }
};

#endif  // CURVED_FIRST

// the most curved rows curved_gd ranks in one block
constexpr int kGdBlock = 1024;

// the rank of the thread's item among its block's flagged items (the
// block's threads in order), valid where flag; *total: the block's flagged
// items.  For a launch of one block: no tile id, status word or ticket
__device__ __forceinline__ int block_rank(bool flag, int* total) {
  __shared__ int counts[kGdBlock / 32];
  __shared__ int total_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) counts[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {
    const int warps = static_cast<int>(blockDim.x >> 5);
    const int c = lane < warps ? counts[lane] : 0;
    const int inc = warp_scan(c, lane);
    if (lane < warps) counts[lane] = inc - c;
    if (lane == 31) total_s = inc;
  }
  __syncthreads();
  *total = total_s;
  return counts[warp] + __popc(mask & ((1u << lane) - 1u));
}

// dnew [n, 2]: the residuals at the plane and at idx; grank [n]: a rescued
// row's rank, else -1; the rescued rows' start ge0, direction gde (e1 - e0),
// plane gcols and root gx, in row order.  The design also mixes each row as
// curved_mix would without a rescue (its root from ints, its residual from
// dnew): its vertex into Vn at its slot qs, its state into cstate, and
// cw[CW_ANYD0].  kOneBlock: the design's instance for n <= kGdBlock, one
// block ranking its rows by block_rank; else tiles of kThreads ranked by
// rank_flag's look-back.  At a few hundred rows the launch is a chain of
// latencies: the one block leaves out the tile counter's atomic, the status
// word and the done ticket's fence and atomic
template <bool kOneBlock>
__global__ void __launch_bounds__(kOneBlock ? kGdBlock : kThreads)
curved_gd_kernel(const float* __restrict__ outs,
                 const int* __restrict__ plane,
                 const float* __restrict__ ints,
                 const float* __restrict__ e01, const int* __restrict__ qs,
                 int n, int idx, float eps, float* dnew, int* grank,
                 float* ge0, float* gde, int* gcols, float* gx, float* Vn,
                 int* cstate, int* cw) {
  const int tile = kOneBlock ? 0 : rank_tile();
  const int r = tile * kThreads + threadIdx.x;
  bool gg = false, gd = false;
  if (r < n) {
    const ll r3 = 3 * static_cast<ll>(r);
    const float d0 = outs[R * static_cast<ll>(r) + plane[r]];
    const float d1 = outs[R * static_cast<ll>(r) + idx];
    gg = out_of_range(ints + r3);
    gd = !gg && (fabsf(d0) > eps || fabsf(d1) > eps);
    dnew[2 * static_cast<ll>(r)] = d0;
    dnew[2 * static_cast<ll>(r) + 1] = d1;
    if (!kCurvedFirst)
      mix_row(qs[r], e01 + 2 * r3, e01 + 2 * r3 + 3, ints + r3, gg,
              gg ? 0.0f : d0, eps, Vn, cstate, cw);
  }
  warp_count(gg, cw + CW_SENT);
  int incl;
  const int g = kOneBlock ? block_rank(gd, &incl) : rank_flag(tile, gd, &incl);
  if (r < n) grank[r] = gd ? g : -1;
  if (gd) {
    for (int d = 0; d < 3; ++d) {
      const float a = e01[6 * static_cast<ll>(r) + d];
      ge0[3 * static_cast<ll>(g) + d] = a;
      gde[3 * static_cast<ll>(g) + d] =
          __fsub_rn(e01[6 * static_cast<ll>(r) + 3 + d], a);
      gx[3 * static_cast<ll>(g) + d] = ints[3 * static_cast<ll>(r) + d];
    }
    gcols[g] = plane[r];
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0)
    cw[CW_GD] = incl;
}

// each curved row's root and residual, from the rescue (gx, gd0 by its rank
// grank) where it was rescued, else from ints and dnew, mixed (mix_row);
// gx null: no row rescued
__global__ void curved_mix_kernel(const int* __restrict__ qs,
                                  const float* __restrict__ e01,
                                  const float* __restrict__ ints,
                                  const float* __restrict__ dnew,
                                  const int* __restrict__ grank,
                                  const float* __restrict__ gx,
                                  const float* __restrict__ gd0, ll n,
                                  float eps, float* Vn, int* cstate, int* cw) {
  const ll r = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const ll g = gx != nullptr ? grank[r] : -1;
  const float* t = g >= 0 ? gx + 3 * g : ints + 3 * r;
  const bool gg = out_of_range(t);
  const float d0 = gg ? 0.0f : (g >= 0 ? gd0[g] : dnew[2 * r]);
  mix_row(qs[r], e01 + 6 * r, e01 + 6 * r + 3, t, gg, d0, eps, Vn, cstate,
          cw);
}

#endif  // SPLIT_FOUR_PASS

// --- K5 connect_step ---------------------------------------------------------

__global__ void hit_mark_kernel(const int* __restrict__ SZ, ll n, int idx,
                                int* flags) {
  const ll v = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v < n) flags[v] = bit_of(SZ + NW * v, idx);
}

__global__ void candidates_kernel(
    const float* __restrict__ Vx, const int* __restrict__ SBx,
    const int* __restrict__ ZBx, const int* __restrict__ hcum, ll nV,
    ll n_split, int idx, const float* __restrict__ marks, int M,
    const int* __restrict__ lut, int lut_k, float eps, float scale, int* C,
    int* key) {
  const ll t = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  ll row, vid;
  if (t < n_split) {
    row = t, vid = nV + t;
  } else if (t < n_split + nV && flag_of(hcum, t - n_split)) {
    vid = t - n_split, row = n_split + hcum[vid] - 1;
  } else {
    return;
  }
  // _grid_region_lut on the unit-cube point
  unsigned go = 0u;
  int o1[3];
  for (int d = 0; d < 3; ++d) {
    bool on_plane;
    const int off = grid_region::cell(grid_region::unit(Vx[3 * vid + d], scale),
                                      eps, marks, M, lut, lut_k, &on_plane);
    o1[d] = off + 1;
    go |= static_cast<unsigned>(off + 1) << (9 * d);
    go |= static_cast<unsigned>(on_plane) << (27 + d);
  }
  const unsigned act = idx >= 32 ? 0xFFFFFFFFu : (1u << idx) - 1u;
  const unsigned zb = static_cast<unsigned>(ZBx[NW * vid]);
  const unsigned sb = static_cast<unsigned>(SBx[NW * vid]);
  C[4 * row] = static_cast<int>(vid);
  C[4 * row + 1] = static_cast<int>(zb & act);
  C[4 * row + 2] = static_cast<int>(sb & ~zb & act);
  C[4 * row + 3] = static_cast<int>(go);
  const int W = M + 1;
  key[row] = (o1[0] * W + o1[1]) * W + o1[2];
}

// the first position in [lo, hi) of the sorted a whose value is >= key
__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// rows a, b in a common region (every active neuron column equal or zero in
// one; each axis's cell sets meet) sharing a zero plane
__device__ __forceinline__ bool pair_test(int4 a, int4 b) {
  const unsigned za = a.y, zb = b.y;
  if ((static_cast<unsigned>(a.z) ^ static_cast<unsigned>(b.z)) & ~za & ~zb)
    return false;
  const unsigned ga = a.w, gb = b.w;
  int shared = __popc(za & zb);
  for (int d = 0; d < 3; ++d) {
    const int oa = (ga >> (9 * d)) & 511, ob = (gb >> (9 * d)) & 511;
    const int pa = (ga >> (27 + d)) & 1, pb = (gb >> (27 + d)) & 1;
    if (oa - pa > ob || ob - pb > oa) return false;
    shared += pa & pb & (oa == ob);
  }
  return shared >= 1;
}

__device__ __forceinline__ int4 row_of(const int* C, ll r) {
  return make_int4(C[4 * r], C[4 * r + 1], C[4 * r + 2], C[4 * r + 3]);
}

// The column table and the sorted rows: thread t < n gathers row perm[t]
// to Cs[t] and, at the first (last) candidate of a column, writes the
// column's start (end); cols was zeroed.
__global__ void connect_table_kernel(const int* __restrict__ C,
                                     const int* __restrict__ skey,
                                     const int* __restrict__ perm, int n,
                                     int W, int2* cols, int4* Cs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  Cs[t] = row_of(C, perm[t]);
  const int col = skey[t] / W;
  if (t == 0 || skey[t - 1] / W != col) cols[col].x = t;
  if (t == n - 1 || skey[t + 1] / W != col) cols[col].y = t + 1;
}

// A connecting pair found by a candidate's scan: the pair at slot *at (the
// fill pass), or its ends in used and its split bits in the block's
// histogram (the count pass, but for the final insertion)
__device__ __forceinline__ void keep_pair(ll va, ll vb, const unsigned* w,
                                          ll* at, int* pairs, int* used,
                                          Hist& hist, bool histogram) {
  if (at != nullptr) {
    pairs[2 * *at] = static_cast<int>(min(va, vb));
    pairs[2 * *at + 1] = static_cast<int>(max(va, vb));
    ++*at;
  }
  if (used != nullptr) {
    used[va] = 1;
    used[vb] = 1;
  }
  if (histogram) hist_bits(hist, 0, w);
}

// The first design's scan of one candidate: for each neighbour column a
// lower and an upper bound over the whole sorted key array, then its rows
// through the permutation; each column's count to cnt (if given)
__device__ __forceinline__ void scan_searches(
    const int* C, const int* skey, const int* perm, int n, int p, int4 a,
    int W, const int* SBx, const int* ZBx, int idx, bool final_step,
    ll slot, int* cnt, int* pairs, int* used, Hist& hist, bool histogram) {
  const unsigned ga = a.w;
  const int o0 = ga & 511, o1 = (ga >> 9) & 511, o2 = (ga >> 18) & 511;
  const ll va = a.x;
  for (int c = 0; c < 9; ++c) {
    const int nx = o0 + c / 3 - 1, ny = o1 + c % 3 - 1;
    int found = 0;
    if (nx < 0 || nx >= W || ny < 0 || ny >= W) {
      if (cnt != nullptr) cnt[9 * p + c] = 0;
      continue;
    }
    const int col = (nx * W + ny) * W;
    const int lo = max(lower_bound(skey, 0, n, col + max(o2 - 1, 0)), p + 1);
    const int hi = upper_bound(skey, n, col + min(o2 + 1, W - 1));
    for (int q = lo; q < hi; ++q) {
      const int4 b = row_of(C, perm[q]);
      if (!pair_test(a, b)) continue;
      const ll vb = b.x;
      unsigned w[NW];
      const int ld = edge_bits(SBx + NW * va, ZBx + NW * va, SBx + NW * vb,
                               ZBx + NW * vb, w);
      if (!final_step && ld < idx) continue;
      ++found;
      keep_pair(va, vb, w, pairs != nullptr ? &slot : nullptr, pairs, used,
                hist, histogram);
    }
    if (cnt != nullptr) cnt[9 * p + c] = found;
  }
}

// The design's window of a candidate in cell (o0, o1, o2) in neighbour
// column c (0..8: dx, then dy): the sorted positions [lo, hi) of the
// column's candidates with z in [o2 - 1, o2 + 1], from the table entry and
// two searches inside the column in lockstep.  lo is not yet clamped to
// the candidate's own position.
__device__ __forceinline__ void column_window(
    const int2* __restrict__ cols, const int* __restrict__ skey, int c,
    int o0, int o1, int o2, int W, int* lo, int* hi) {
  const int nx = o0 + c / 3 - 1, ny = o1 + c % 3 - 1;
  if (nx < 0 || nx >= W || ny < 0 || ny >= W) {
    *lo = *hi = 0;
    return;
  }
  const int col = nx * W + ny;
  const int2 se = cols[col];
  // the first position with z >= o2 - 1, and the first with z > o2 + 1
  int l0 = se.x, h0 = se.y, l1 = se.x, h1 = se.y;
  const int k0 = col * W + o2 - 1, k1 = col * W + o2 + 2;
  while (l0 < h0 || l1 < h1) {
    const int m0 = (l0 + h0) >> 1, m1 = (l1 + h1) >> 1;
    const int v0 = l0 < h0 ? skey[m0] : 0, v1 = l1 < h1 ? skey[m1] : 0;
    if (l0 < h0) {
      if (v0 < k0) l0 = m0 + 1; else h0 = m0;
    }
    if (l1 < h1) {
      if (v1 < k1) l1 = m1 + 1; else h1 = m1;
    }
  }
  *lo = l0;
  *hi = l1;
}

// The design's scan of one window [q, hi) of a candidate: a row at a time,
// and the words of a row that pairs; the pairs kept in order (keep_pair, at
// *at if at is given).  Returns the pairs kept.
__device__ __forceinline__ int scan_window(
    int q, int hi, int4 a, const int* sa, const int* za,
    const int4* __restrict__ Cs, const int2* __restrict__ SB2,
    const int2* __restrict__ ZB2, int idx, bool final_step, ll* at,
    int* pairs, int* used, Hist& hist, bool histogram) {
  int found = 0;
  for (; q < hi; ++q) {
    const int4 b = Cs[q];
    if (!pair_test(a, b)) continue;
    const int2 sb = SB2[b.x], zb = ZB2[b.x];
    const int sq[NW] = {sb.x, sb.y}, zq[NW] = {zb.x, zb.y};
    unsigned w[NW];
    const int ld = edge_bits(sa, za, sq, zq, w);
    if (!final_step && ld < idx) continue;
    ++found;
    keep_pair(a.x, b.x, w, at, pairs, used, hist, histogram);
  }
  return found;
}

// The pair scan: cnt [n, 9] the pairs of each candidate and neighbour
// column (the count pass), or the pairs written at the slots of ccum, the
// inclusive prefix sum of those counts (the fill pass: scan order is
// candidate, column, position).  The design: a block of kPairLanes
// candidates, a warp a neighbour column, a lane a candidate; the fill pass
// skips a (candidate, column) of no pairs.  The first design: a thread a
// candidate, its 9 columns one after another.
__global__ void __launch_bounds__(kPairThreads) connect_pairs_kernel(
    const int* __restrict__ C, const int* __restrict__ skey,
    const int* __restrict__ perm, const int2* __restrict__ cols,
    const int4* __restrict__ Cs, int n, const int* __restrict__ SBx,
    const int* __restrict__ ZBx, int idx, int M, int final_step, int* cnt,
    const int* __restrict__ ccum, int* used, int* meta, int* pairs) {
  __shared__ Hist hist;
  const bool histogram = meta != nullptr;
  if (histogram) hist_zero(hist);
  const int W = M + 1;
  if (!kColumns) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) {
      const ll slot = ccum != nullptr ? (p ? ccum[9 * p - 1] : 0) : 0;
      scan_searches(C, skey, perm, n, p, row_of(C, perm[p]), W, SBx, ZBx,
                    idx, final_step, slot, cnt, pairs, used, hist, histogram);
    }
    if (histogram) hist_flush(hist, meta, SPLIT, -1, -1);
    return;
  }
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  const int p = blockIdx.x * kPairLanes + lane;
  bool live = p < n;
  ll slot = 0;
  if (live && ccum != nullptr) {
    const ll at = 9LL * p + c;
    slot = at ? ccum[at - 1] : 0;
    // the fill pass: a column of no pairs scans nothing
    if (slot == ccum[at]) live = false;
  }
  if (live) {
    const int4 a = Cs[p];
    const unsigned ga = a.w;
    int lo, hi;
    column_window(cols, skey, c, ga & 511, (ga >> 9) & 511, (ga >> 18) & 511,
                  W, &lo, &hi);
    const ll va = a.x;
    const int sa[NW] = {SBx[NW * va], SBx[NW * va + 1]};
    const int za[NW] = {ZBx[NW * va], ZBx[NW * va + 1]};
    const int found = scan_window(
        max(lo, p + 1), hi, a, sa, za, Cs,
        reinterpret_cast<const int2*>(SBx), reinterpret_cast<const int2*>(ZBx),
        idx, final_step, pairs != nullptr ? &slot : nullptr, pairs, used,
        hist, histogram);
    if (cnt != nullptr) cnt[9 * p + c] = found;
  }
  if (histogram) hist_flush(hist, meta, SPLIT, -1, -1);
}

__global__ void census_edges_kernel(const int* __restrict__ E,
                                    const int* __restrict__ EB,
                                    const int* __restrict__ LD, ll n0,
                                    const int* __restrict__ Er,
                                    const int* __restrict__ EBr,
                                    const int* __restrict__ LDr, ll n1,
                                    int idx, int* used, int* meta) {
  __shared__ Hist hist;
  hist_zero(hist);
  const ll t = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n0 + n1) {
    const bool old = t < n0;
    const ll e = old ? t : t - n0;
    const int* ee = old ? E : Er;
    if ((old ? LD : LDr)[e] >= idx) {
      used[ee[2 * e]] = 1;
      used[ee[2 * e + 1]] = 1;
      const int* eb = (old ? EB : EBr) + NW * e;
      const unsigned w[NW] = {static_cast<unsigned>(eb[0]),
                              static_cast<unsigned>(eb[1])};
      hist_bits(hist, 0, w);
      atomicAdd(&hist.bins[2 * R], 1);
    }
  }
  hist_flush(hist, meta, SPLIT, -1, N_LIVE);
}

__global__ void census_vertices_kernel(const int* __restrict__ used,
                                       const int* __restrict__ SZx, ll n,
                                       int* meta) {
  __shared__ Hist hist;
  hist_zero(hist);
  const ll v = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v < n && used[v]) {
    const unsigned w[NW] = {static_cast<unsigned>(SZx[NW * v]),
                            static_cast<unsigned>(SZx[NW * v + 1])};
    hist_bits(hist, R, w);
    atomicAdd(&hist.bins[2 * R], 1);
  }
  hist_flush(hist, meta, -1, HIT, N_USED);
}

// a thread a word of the n rows of R words (the outputs' pool: the width
// fixed at compile time, a multiply for the division), stored at its row's
// slot; n R < 2^31
__global__ void compact_words_kernel(const int* __restrict__ src,
                                     const int* __restrict__ cum, int n,
                                     int* dst) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * R) return;
  const int v = src[t];
  const int r = t / R;
  if (flag_of(cum, r)) dst[(cum[r] - 1) * R + (t - r * R)] = v;
}

// a thread a row (the first design; the design's for rows of other widths)
__global__ void compact_rows_kernel(const int* __restrict__ src,
                                    const int* __restrict__ cum, ll n,
                                    int width, int* dst) {
  const ll r = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n || !flag_of(cum, r)) return;
  const ll s = cum[r] - 1;
  for (int k = 0; k < width; ++k) dst[s * width + k] = src[r * width + k];
}

__global__ void compact_edges_kernel(const int* __restrict__ E,
                                     const int* __restrict__ cum,
                                     const int* __restrict__ vcum, ll n,
                                     int* out) {
  const ll e = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n || !flag_of(cum, e)) return;
  const ll s = cum[e] - 1;
  out[2 * s] = vcum[E[2 * e]] - 1;
  out[2 * s + 1] = vcum[E[2 * e + 1]] - 1;
}

}  // namespace

// --- launch functions (tropical_torch/extract/device.py's stage order) --------

extern "C" {

// 1 in a build of K3's first design (-DSKELETON_CUMSUM), whose skeleton takes
// skeleton_points, _edges, the caller's prefix sums and skeleton_squeeze;
// else 0 (skeleton_words, _flags, _scan and _compact)
int skeleton_first_design() { return kSkeletonFirst ? 1 : 0; }

// 1 in a build of K4's first design (-DSPLIT_FOUR_PASS), whose insertions
// take split_mark, the caller's prefix sum, split_lerp, split_override and
// split_append; else 0 (split_select and split_finish)
int split_first_design() { return kSplitFirst ? 1 : 0; }

int skeleton_pool_launch(const float* g, float* out, ll M, ll k, ll axis,
                         cudaStream_t stream) {
#ifdef SKELETON_CUMSUM
  skeleton_pool_kernel<<<blocks(M * M * M), kThreads, 0, stream>>>(
      g, out, static_cast<int>(M), static_cast<int>(k),
      static_cast<int>(axis));
#else
  skeleton_pool_kernel<<<static_cast<int>((M * M + kPoolLines - 1) /
                                          kPoolLines),
                         kThreads, 0, stream>>>(
      g, out, static_cast<int>(M), static_cast<int>(k),
      static_cast<int>(axis));
#endif
  return done();
}

#ifdef SKELETON_CUMSUM

int skeleton_points_launch(const float* out, const float* dq,
                           const float* gmax, ll n, float bc, float eps,
                           int* sb, int* zb, int* sz, int* keep,
                           cudaStream_t stream) {
  skeleton_points_kernel<<<blocks(n), kThreads, 0, stream>>>(
      out, dq, gmax, n, bc, eps, sb, zb, sz, keep);
  return done();
}

int skeleton_edges_launch(const int* sb, const int* zb, const int* keep,
                          ll M, int* flags, int* used, cudaStream_t stream) {
  skeleton_edges_kernel<<<blocks(3 * (M - 1) * M * M), kThreads, 0, stream>>>(
      sb, zb, keep, static_cast<int>(M), flags, used);
  return done();
}

int skeleton_squeeze_launch(const int* ecum, const int* ucum,
                            const float* marks, const float* out,
                            const int* sb, const int* zb, const int* sz, ll M,
                            float scale, float* V, float* OUT, int* SB,
                            int* ZB, int* SZ, int* E, cudaStream_t stream) {
  const ll n = max(3 * (M - 1) * M * M, M * M * M);
  skeleton_squeeze_kernel<<<blocks(n), kThreads, 0, stream>>>(
      ecum, ucum, marks, out, sb, zb, sz, static_cast<int>(M), scale, V, OUT,
      SB, ZB, SZ, E);
  return done();
}

#else

// out: 16-byte aligned (the block's rows are staged by float4 loads); g (dq
// given): the lattice values pooled along axes 0 and 1, k <= kMaxRadius
int skeleton_words_launch(const float* out, const float* dq, const float* g,
                          ll M, ll k, float bc, float eps, int* W,
                          unsigned char* X, cudaStream_t stream) {
  if (reinterpret_cast<unsigned long long>(out) % 16 || k < 0 ||
      k > kMaxRadius)
    return -static_cast<int>(cudaErrorInvalidValue);
  const ll n = M * M * M;
  skeleton_words_kernel<<<static_cast<int>((n + kWordRows - 1) / kWordRows),
                          kWordRows, 0, stream>>>(
      out, dq, g, static_cast<int>(M), static_cast<int>(k), bc, eps,
      reinterpret_cast<int2*>(W), X);
  return done();
}

// masks, pre: [4, ceil(M^3 / 32)]; cnt: [4, ceil(M^3 / 1024)]
int skeleton_flags_launch(const int* W, const unsigned char* X, ll M,
                          int* masks, int* pre, int* cnt,
                          cudaStream_t stream) {
  const ll n = M * M * M;
  skeleton_flags_kernel<<<static_cast<int>((n + kFlagPoints - 1) / kFlagPoints),
                          kFlagPoints, 0, stream>>>(
      reinterpret_cast<const int2*>(W), X, static_cast<int>(M),
      static_cast<int>((n + 31) / 32), masks, pre, cnt);
  return done();
}

int skeleton_scan_launch(const int* cnt, ll nb, int* off, int* tot,
                         cudaStream_t stream) {
  skeleton_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      cnt, static_cast<int>(nb), off, tot);
  return done();
}

int skeleton_compact_launch(const int* masks, const int* pre, const int* off,
                            ll M, const float* marks, const float* out,
                            float scale, float eps, float* V, float* OUT,
                            int* SB, int* ZB, int* SZ, int* E,
                            cudaStream_t stream) {
  const ll n = M * M * M, nw = (n + 31) / 32;
  ll ww = 1;
  while (ww < kWarpWords && nw / (2 * ww) >= kCompactWarps) ww *= 2;
  const ll warps = (nw + ww - 1) / ww;
  skeleton_compact_kernel<<<blocks(32 * warps), kThreads, 0, stream>>>(
      masks, pre, off, static_cast<int>(nw),
      static_cast<int>((n + kFlagPoints - 1) / kFlagPoints),
      static_cast<int>(ww), marks, out,
      static_cast<int>(M), scale, eps, V, OUT, SB, ZB, SZ, E);
  return done();
}

#endif  // SKELETON_CUMSUM

int pack_words_launch(const float* out, ll n, float eps, int* sb, int* zb,
                      int* sz, cudaStream_t stream) {
  pack_words_kernel<<<blocks(n), kThreads, 0, stream>>>(out, n, eps, sb, zb,
                                                        sz);
  return done();
}

int edge_words_launch(const int* E, ll n, const int* SB, const int* ZB,
                      int* eb, int* ld, cudaStream_t stream) {
  edge_words_kernel<<<blocks(n), kThreads, 0, stream>>>(E, n, SB, ZB, eb, ld);
  return done();
}

#ifdef SPLIT_FOUR_PASS

int split_mark_launch(const int* EB, ll n, ll idx, int* flags,
                      cudaStream_t stream) {
  split_mark_kernel<<<blocks(n), kThreads, 0, stream>>>(
      EB, n, static_cast<int>(idx), flags);
  return done();
}

int split_lerp_launch(const int* E, const int* cum, ll n, const float* V,
                      const float* OUT, const int* ZB, ll idx, int* lanes,
                      int* ce, float* Vn, int* bz, cudaStream_t stream) {
  split_lerp_kernel<<<blocks(n), kThreads, 0, stream>>>(
      E, cum, n, V, OUT, ZB, static_cast<int>(idx), lanes, ce, Vn, bz);
  return done();
}

int split_override_launch(const float* OUTn, const int* bz, ll n, ll idx,
                          float eps, int* viol, cudaStream_t stream) {
  split_override_kernel<<<blocks(n), kThreads, 0, stream>>>(
      OUTn, bz, n, static_cast<int>(idx), eps, viol);
  return done();
}

int split_append_launch(float* OUTn, const int* bz, const int* viol,
                        const int* lanes, const int* ce, int* E, int* EB,
                        int* LD, const int* SB, const int* ZB, ll n, ll nV,
                        ll idx, float eps, int* sbn, int* zbn, int* szn,
                        int* Er, int* EBr, int* LDr, cudaStream_t stream) {
  split_append_kernel<<<blocks(n), kThreads, 0, stream>>>(
      OUTn, bz, viol, lanes, ce, E, EB, LD, SB, ZB, n, nV,
      static_cast<int>(idx), eps, sbn, zbn, szn, Er, EBr, LDr);
  return done();
}

#else

// n: the pool's edges, at most kMaxTiles tiles
int split_select_launch(const int* E, const int* EB, ll n, const float* V,
                        const float* OUT, const int* ZB, ll idx, int* lanes,
                        int* ce, float* Vn, int* bz, cudaStream_t stream) {
  const ll tiles = (n + kSelectTile - 1) / kSelectTile;
  if (tiles > kMaxTiles) return -static_cast<int>(cudaErrorInvalidValue);
  split_select_kernel<false><<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      E, EB, static_cast<int>(n), V, OUT, ZB, static_cast<int>(idx), 0.0f,
      lanes, ce, Vn, bz, nullptr, nullptr, nullptr, nullptr, nullptr);
  return done();
}

// OUTn [n, R], 16-byte aligned; EB, LD, EBr and LDr null at the final
// insertion: split_check, then split_finish; without check (curved_filter's
// survivors, which carry the override already) split_finish alone, but in
// K4c's first design, which tests them again
int split_finish_launch(float* OUTn, const int* bz, const int* lanes,
                        const int* ce, int* E, int* EB, int* LD, const int* SB,
                        const int* ZB, ll n, ll nV, ll idx, float eps,
                        int* sbn, int* zbn, int* szn, int* Er, int* EBr,
                        int* LDr, ll check, cudaStream_t stream) {
  if (reinterpret_cast<unsigned long long>(OUTn) % 16 != 0 ||
      (nV + n) * R >= (1LL << 31))
    return -static_cast<int>(cudaErrorInvalidValue);
  check = check || kCurvedFirst;
  if (check) {
    split_check_kernel<<<blocks(n), kThreads, 0, stream>>>(
        OUTn, bz, static_cast<int>(n), static_cast<int>(idx), eps);
    const int rc = done();
    if (rc < 0) return rc;
  }
  split_finish_kernel<<<static_cast<int>((n + kFinishRows - 1) / kFinishRows),
                        kFinishRows, 0, stream>>>(
      OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, static_cast<int>(n),
      static_cast<int>(nV), static_cast<int>(idx), eps, sbn, zbn, szn, Er,
      EBr, LDr, check ? 1 : 0);
  return done(check ? 2 : 1);
}

// K4c (without SPLIT_FOUR_PASS): n the split rows (the selection,
// curved_filter) or the curved rows (curved_roots, curved_gd, curved_mix),
// each rank at most kMaxTiles tiles

// split_select with the curved rows of its n_split split edges (qs, plane,
// e01, corners: [n_split, ...], the first cw[CW_CURVED] set): the curved
// instance; in K4c's first design the flat one, then curved_select on its
// rows (two launches)
int split_select_curved_launch(const int* E, const int* EB, ll n, ll n_split,
                               const float* V, const float* OUT, const int* ZB,
                               ll idx, float eps, int* lanes, int* ce,
                               float* Vn, int* bz, int* qs, int* plane,
                               float* e01, float* corners, int* cw,
                               cudaStream_t stream) {
  const ll tiles = (n + kSelectTile - 1) / kSelectTile;
  if (tiles > kMaxTiles) return -static_cast<int>(cudaErrorInvalidValue);
#ifdef CURVED_FIRST
  if ((n_split + kThreads - 1) / kThreads > kMaxTiles)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int rc = split_select_launch(E, EB, n, V, OUT, ZB, idx, lanes, ce, Vn,
                                     bz, stream);
  if (rc < 0 || n_split <= 0) return rc;
  curved_select_kernel<<<static_cast<int>((n_split + kThreads - 1) /
                                          kThreads),
                         kThreads, 0, stream>>>(
      ce, bz, V, static_cast<int>(n_split), static_cast<int>(idx), eps, qs,
      plane, e01, corners, cw);
  return done(2);
#else
  split_select_kernel<true><<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      E, EB, static_cast<int>(n), V, OUT, ZB, static_cast<int>(idx), eps,
      lanes, ce, Vn, bz, qs, plane, e01, corners, cw);
  return done();
#endif
}

// the roots of the curved rows (K7) from the corner forward d [n, 8, R] and
// their points: ints, cand [n, 3]; the design's curved_roots, one launch
// (the scratch p, q unused), the first design's curved_pick into p, q
// [n, 8] (16-byte aligned), K7 on them and curved_points (three)
int curved_roots_launch(const float* d, const int* plane, const float* e01,
                        ll n, ll idx, float* ints, float* cand, float* p,
                        float* q, cudaStream_t stream) {
  if (n > INT_MAX / k7::kLanes) return -static_cast<int>(cudaErrorInvalidValue);
#ifdef CURVED_FIRST
  curved_pick_kernel<<<blocks(8 * n), kThreads, 0, stream>>>(
      d, plane, n, static_cast<int>(idx), p, q);
  int rc = done();
  if (rc < 0) return rc;
  rc = k7::launch(k7::PlainRows{reinterpret_cast<const float4*>(p),
                                reinterpret_cast<const float4*>(q), ints},
                  static_cast<int>(n), stream);
  if (rc) return -rc;
  curved_points_kernel<<<blocks(n), kThreads, 0, stream>>>(e01, ints, n, cand);
  return done(3);
#else
  const int rc = k7::launch(CornerRows{d, plane, static_cast<int>(idx), e01,
                                       ints, cand},
                            static_cast<int>(n), stream);
  return rc ? -rc : 1;
#endif
}

// curved_gd, in the design with each row mixed as no rescue would change
// it (one launch: one block up to kGdBlock rows); in the first design
// curved_gd (tiles of kThreads), then curved_mix without the rescue (two)
int curved_gd_launch(const float* outs, const int* plane, const float* ints,
                     const float* e01, const int* qs, ll n, ll idx, float eps,
                     float* dnew, int* grank, float* ge0, float* gde,
                     int* gcols, float* gx, float* Vn, int* cstate, int* cw,
                     cudaStream_t stream) {
  const ll tiles = (n + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles) return -static_cast<int>(cudaErrorInvalidValue);
  if (!kCurvedFirst && n <= kGdBlock) {
    curved_gd_kernel<true><<<1, static_cast<int>((n + 31) / 32 * 32), 0,
                             stream>>>(
        outs, plane, ints, e01, qs, static_cast<int>(n),
        static_cast<int>(idx), eps, dnew, grank, ge0, gde, gcols, gx, Vn,
        cstate, cw);
    return done();
  }
  curved_gd_kernel<false><<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      outs, plane, ints, e01, qs, static_cast<int>(n), static_cast<int>(idx),
      eps, dnew, grank, ge0, gde, gcols, gx, Vn, cstate, cw);
  if (!kCurvedFirst) return done();
  const int rc = done();
  if (rc < 0) return rc;
  curved_mix_kernel<<<blocks(n), kThreads, 0, stream>>>(
      qs, e01, ints, dnew, grank, nullptr, nullptr, n, eps, Vn, cstate, cw);
  return done(2);
}

// after a rescue: every curved row mixed, the rescued ones from gx, gd0
int curved_mix_launch(const int* qs, const float* e01, const float* ints,
                      const float* dnew, const int* grank, const float* gx,
                      const float* gd0, ll n, float eps, float* Vn,
                      int* cstate, int* cw, cudaStream_t stream) {
  curved_mix_kernel<<<blocks(n), kThreads, 0, stream>>>(
      qs, e01, ints, dnew, grank, gx, gd0, n, eps, Vn, cstate, cw);
  return done();
}

// split_check, then curved_keep (its verdict); OUTn [n, R], 16-byte aligned
// but in the first design
int curved_filter_launch(const float* OUTn, const int* bz, const int* lanes,
                         const int* ce, const float* Vn, const int* cstate,
                         ll n, ll idx, float eps, int* cw, float* Vs,
                         float* OUTs, int* bzs, int* lanes_s, int* ces,
                         cudaStream_t stream) {
  const ll tiles = (n + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles ||
      (!kCurvedFirst && (reinterpret_cast<unsigned long long>(OUTn) % 16 != 0 ||
                         n * R >= (1LL << 31))))
    return -static_cast<int>(cudaErrorInvalidValue);
  split_check_kernel<<<blocks(n), kThreads, 0, stream>>>(
      OUTn, bz, static_cast<int>(n), static_cast<int>(idx), eps);
  const int rc = done();
  if (rc < 0) return rc;
  curved_keep_kernel<<<static_cast<int>(tiles), kThreads, 0, stream>>>(
      OUTn, bz, lanes, ce, Vn, cstate, static_cast<int>(n),
      static_cast<int>(idx), eps, cw, Vs, OUTs, bzs, lanes_s, ces);
  return done(2);
}

#endif  // SPLIT_FOUR_PASS

int hit_mark_launch(const int* SZ, ll n, ll idx, int* flags,
                    cudaStream_t stream) {
  hit_mark_kernel<<<blocks(n), kThreads, 0, stream>>>(
      SZ, n, static_cast<int>(idx), flags);
  return done();
}

int candidates_launch(const float* Vx, const int* SBx, const int* ZBx,
                      const int* hcum, ll nV, ll n_split, ll idx,
                      const float* marks, ll M, const int* lut, ll lut_k,
                      float eps, float scale, int* C, int* key,
                      cudaStream_t stream) {
  candidates_kernel<<<blocks(n_split + nV), kThreads, 0, stream>>>(
      Vx, SBx, ZBx, hcum, nV, n_split, static_cast<int>(idx), marks,
      static_cast<int>(M), lut, static_cast<int>(lut_k), eps, scale, C, key);
  return done();
}

// cols: [(M + 1)^2] (start, end) pairs, zeroed by the caller; the first
// design leaves it and Cs as they are, and launches nothing
int connect_table_launch(const int* C, const int* skey, const int* perm,
                         ll n, ll M, int* cols, int* Cs, cudaStream_t stream) {
  if (!kColumns) return 0;
  const ll W = M + 1;
  connect_table_kernel<<<blocks(n), kThreads, 0, stream>>>(
      C, skey, perm, static_cast<int>(n), static_cast<int>(W),
      reinterpret_cast<int2*>(cols), reinterpret_cast<int4*>(Cs));
  return done();
}

int connect_pairs_launch(const int* C, const int* skey, const int* perm,
                         const int* cols, const int* Cs, ll n, const int* SBx,
                         const int* ZBx, ll idx, ll M, ll final_step,
                         int* cnt, const int* ccum, int* used, int* meta,
                         int* pairs, cudaStream_t stream) {
  const int grid = kColumns ? static_cast<int>((n + kPairLanes - 1) / kPairLanes)
                            : blocks(n);
  connect_pairs_kernel<<<grid, kColumns ? kPairThreads : kThreads, 0,
                         stream>>>(
      C, skey, perm, reinterpret_cast<const int2*>(cols),
      reinterpret_cast<const int4*>(Cs), static_cast<int>(n), SBx, ZBx,
      static_cast<int>(idx), static_cast<int>(M),
      static_cast<int>(final_step), cnt, ccum, used, meta, pairs);
  return done();
}

int census_edges_launch(const int* E, const int* EB, const int* LD, ll n0,
                        const int* Er, const int* EBr, const int* LDr, ll n1,
                        ll idx, int* used, int* meta, cudaStream_t stream) {
  census_edges_kernel<<<blocks(n0 + n1), kThreads, 0, stream>>>(
      E, EB, LD, n0, Er, EBr, LDr, n1, static_cast<int>(idx), used, meta);
  return done();
}

int census_vertices_launch(const int* used, const int* SZx, ll n, int* meta,
                           cudaStream_t stream) {
  census_vertices_kernel<<<blocks(n), kThreads, 0, stream>>>(used, SZx, n,
                                                             meta);
  return done();
}

// the outputs' pool takes 32-bit word indices: n R < 2^31
int compact_rows_launch(const int* src, const int* cum, ll n, ll width,
                        int* dst, cudaStream_t stream) {
  if (kCompactWords && width == R) {
    if (n * R >= (1LL << 31)) return -static_cast<int>(cudaErrorInvalidValue);
    compact_words_kernel<<<blocks(n * R), kThreads, 0, stream>>>(
        src, cum, static_cast<int>(n), dst);
  } else {
    compact_rows_kernel<<<blocks(n), kThreads, 0, stream>>>(
        src, cum, n, static_cast<int>(width), dst);
  }
  return done();
}

int compact_edges_launch(const int* E, const int* cum, const int* vcum, ll n,
                         int* out, cudaStream_t stream) {
  compact_edges_kernel<<<blocks(n), kThreads, 0, stream>>>(E, cum, vcum, n,
                                                           out);
  return done();
}

}  // extern "C"

// K6, the final filter and the faces, in the same library
#include "faces.cu"
