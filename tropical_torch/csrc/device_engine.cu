// K3, K4 and K5: the device extraction engine's kernels (flat path).
//
// Replace the XLA programs of the JAX package's fused engine,
// tropical/extract/device.py: K3 the skeleton (_lipschitz_keepv :1891,
// _edges_from_sgn :1808, _squeeze_edges :2049 under make_skeleton_fn
// :2092), K4 one insertion's split (make_step_fn's _busy_step s1-s7,
// :452-848, with _pack_out_words :144 and _edge_bits :180), K5 its
// connecting edges and prune (s8-s12, :858-1119, with _grid_region_lut
// :254 and _prune :1121).  Each launch function is one kernel; the caller
// (tropical_torch/extract/device.py) passes device pointers, long long
// integers and float scalars in the declared order, then the stream, and
// gets back the count of kernels it launched, or minus a CUDA error
// (cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses).
// Each has its plain PyTorch version in that module, which it equals bit
// for bit.
//
// Words: a vertex's 33 columns as 2 32-bit words (bit j of word w is
// column 32 w + j): sign (out > 0), zero (|out| <= eps), strict
// (|out| < eps).  An edge's split words (plane j splits it: both ends off
// the eps band, of opposite signs) and last differing column (the highest
// column whose eps-sign differs, -1 for none; the prune at plane idx keeps
// the edge iff it is >= idx).
//
// Bound: bytes everywhere (integer bit tests, a few float operations an
// item); one thread an item (lattice point, edge, candidate, vertex),
// shared-memory histograms flushed by one atomic a bin and block.  The
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

#include <cuda_runtime.h>

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
// the pair scan's block: kPairLanes candidates, a warp a neighbour column
constexpr int kPairLanes = 32;
constexpr int kPairThreads = 9 * kPairLanes;

__device__ __forceinline__ unsigned bit_of(const int* w, int col) {
  return (static_cast<unsigned>(w[col >> 5]) >> (col & 31)) & 1u;
}

__device__ __forceinline__ void pack_row(const float* o, float eps, int* sb,
                                         int* zb, int* sz) {
  unsigned s[NW] = {0u, 0u}, z[NW] = {0u, 0u}, t[NW] = {0u, 0u};
  for (int c = 0; c < R; ++c) {
    const float v = o[c];
    const float a = fabsf(v);
    const unsigned b = 1u << (c & 31);
    const int w = c >> 5;
    if (v > 0.0f) s[w] |= b;
    if (a <= eps) z[w] |= b;
    if (a < eps) t[w] |= b;
  }
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

int blocks(ll n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// a launch function's result: the kernels it launched, or minus the error
int done(int launched = 1) {
  const int rc = static_cast<int>(cudaGetLastError());
  return rc ? -rc : launched;
}

// --- K3 skeleton_mark --------------------------------------------------------

__global__ void skeleton_pool_kernel(const float* __restrict__ g,
                                     float* __restrict__ out, int M, int k,
                                     int axis) {
  const ll n = static_cast<ll>(M) * M * M;
  const ll p = static_cast<ll>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const ll stride = axis == 0 ? static_cast<ll>(M) * M : (axis == 1 ? M : 1);
  const int i = static_cast<int>((p / stride) % M);
  float m = g[p];
  for (int j = max(i - k, 0); j <= min(i + k, M - 1); ++j) {
    const float v = g[p + (j - i) * stride];
    if (!(v == v) || v > m) m = v;  // NaN wins
  }
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

// --- K4 split_step -----------------------------------------------------------

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
  const float d0 = OUT[R * a + idx], d1 = OUT[R * b + idx];
  // the host engine's lerp, op for op: w = |d0| / |d1 - d0|,
  // v = v0 (1 - w) + v1 w
  const float w = __fdiv_rn(fabsf(d0), fabsf(__fsub_rn(d1, d0)));
  const float om = __fsub_rn(1.0f, w);
  for (int d = 0; d < 3; ++d)
    Vn[3 * s + d] = __fadd_rn(__fmul_rn(V[3 * a + d], om),
                              __fmul_rn(V[3 * b + d], w));
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
    const float xu = __fdiv_rn(__fadd_rn(Vx[3 * vid + d], scale), scale * 2.0f);
    const float q = __fadd_rn(xu, eps);
    const int j = min(max(static_cast<int>(__fmul_rn(q, 1024.0f)), 0), 1023);
    int cnt = lut[j];
    const int start = cnt;
    for (int s = 0; s < lut_k; ++s) {
      const int pos = start + s;
      cnt += (pos < M) && (marks[min(pos, M - 1)] < q);
    }
    const int off = cnt - 1;
    const int wrapped = off < 0 ? off + M : off;
    const float at = marks[min(max(wrapped, 0), M - 1)];
    const bool on_plane = !(fabsf(__fsub_rn(at, xu)) > eps);
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

int skeleton_pool_launch(const float* g, float* out, ll M, ll k, ll axis,
                         cudaStream_t stream) {
  skeleton_pool_kernel<<<blocks(M * M * M), kThreads, 0, stream>>>(
      g, out, static_cast<int>(M), static_cast<int>(k),
      static_cast<int>(axis));
  return done();
}

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
