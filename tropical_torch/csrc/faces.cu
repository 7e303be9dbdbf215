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
// Counts go to one int64 vector (device.py FC_*), each block's by one
// atomic; the host reads it twice: after final_keep and face_keys_count
// (the funnel and the replicas) and after face_fans_count (the kept
// regions and the triangles).
//
// Bound: bytes (a few integer and float operations an item): a vertex's
// row read and flags written, an edge's ends, a replica's key and id, a
// region's members read a few times.  These are first designs, a thread an
// item: a vertex (final_keep's first pass, face_keys_count), an edge
// (final_keep's second), a used vertex writing its 2^kz replicas
// (face_keys_fill), a replica that starts a run of equal keys
// (face_regions_runs), a region slot (face_regions_dups, face_fans_count,
// face_fans_fill).  A region's members are few (3 to 6 at the presets), so
// a thread walks them, its duplicate tests and its insertion sort O(count^2)
// over its own segment of scratch memory: no cap on a region's size.

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

// v summed over the block (a warp's by shuffles, the warps' by one thread)
// into *dst by one atomic; every thread of the block calls it
__device__ __forceinline__ void block_sum(ull v, ull* dst) {
  __shared__ ull part[kThreads / 32];
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    ull s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += part[w];
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

// --- face_keys -------------------------------------------------------------------

// a used vertex's all-minus region key (each zero column on its - side: a
// grid axis's cell below, a neuron's sign bit 0) and its zero columns:
// rows [n, 4] (the key's low and high words, the zero neurons' bits, the
// on-plane axes' bits), kz [n]; an unused vertex's row 0 and kz KZ_NONE
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
    const int k = __popc(zw) + __popc(gz);
    kz[v] = k;
    rows[v] = make_int4(static_cast<int>(static_cast<unsigned>(key)),
                        static_cast<int>(key >> 32), static_cast<int>(zw),
                        static_cast<int>(gz));
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

// --- face_fans ---------------------------------------------------------------------

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

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// thread j: a kept region slot's fan.  Each member's angular score around
// the normal against the first member, s = cos sign(dn) + 2 (dn < 0), is
// inserted into the region's segment of the scratch (score, id) by a stable
// insertion sort, descending; the repeated ids are dropped in place (the
// first in angle order kept); triangle t is (v_t+2, v_t+1, v0), at the
// region's slot of tcum (ntri's inclusive prefix sum)
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
  const int c = rcnt[s];
  const ll r = kcum[j] - 1;
  const float mx = mean[3 * s], my = mean[3 * s + 1], mz = mean[3 * s + 2];
  const float nx = nrm[3 * r], ny = nrm[3 * r + 1], nz = nrm[3 * r + 2];
  const ll v0 = svid[s];
  const float ax = sub(Vf[3 * v0], mx), ay = sub(Vf[3 * v0 + 1], my),
              az = sub(Vf[3 * v0 + 2], mz);
  const float na = sqrtf(add(add(mul(ax, ax), mul(ay, ay)), mul(az, az)));
  float* sc = score + s;
  int* id = ids + s;
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
    for (; p > 0 && sc[p - 1] < x; --p) {
      sc[p] = sc[p - 1];
      id[p] = id[p - 1];
    }
    sc[p] = x;
    id[p] = v;
  }
  int m = 0;
  for (int k = 0; k < c; ++k) {
    const int v = id[k];
    bool seen = false;
    for (int q = 0; q < m && !seen; ++q) seen = id[q] == v;
    if (!seen) id[m++] = v;
  }
  ll* out = tris + 3 * (tcum[j] - ntri[j]);
  for (int t = 0; t + 2 < m; ++t) {
    out[3 * t] = id[t + 2];
    out[3 * t + 1] = id[t + 1];
    out[3 * t + 2] = id[0];
  }
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

int face_keys_count_launch(const float* V, const int* SB, const int* ZB,
                           const int* ends, ll n, const float* marks, ll M,
                           const int* lut, ll lut_k, float eps, float scale,
                           int* kz, int* rows, ull* fc, cudaStream_t stream) {
  face_keys_count_kernel<<<blocks(n), kThreads, 0, stream>>>(
      V, SB, ZB, ends, n, marks, static_cast<int>(M), lut,
      static_cast<int>(lut_k), eps, scale, kz, reinterpret_cast<int4*>(rows),
      fc);
  return done();
}

int face_keys_fill_launch(const float* V, const int* rows, const int* kzs,
                          const ll* order, const int* vcum, const ll* fc,
                          ll n_used, ll* keys, int* rvid, float* Vf,
                          cudaStream_t stream) {
  face_keys_fill_kernel<<<blocks(n_used), kThreads, 0, stream>>>(
      V, reinterpret_cast<const int4*>(rows), kzs, order, vcum, fc, n_used,
      keys, rvid, Vf);
  return done();
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

int face_fans_count_launch(const ll* rord, const int* rcnt, const int* svid,
                           const float* mean, const int* keep, const ll* kcum,
                           ll n, ull* fc, ll* ntri, float* mk,
                           cudaStream_t stream) {
  face_fans_count_kernel<<<blocks(n), kThreads, 0, stream>>>(
      rord, rcnt, svid, mean, keep, kcum, n, fc, ntri, mk);
  return done();
}

int face_fans_fill_launch(const ll* rord, const int* rcnt, const int* svid,
                          const float* mean, const int* keep, const ll* kcum,
                          const ll* ntri, const ll* tcum, const float* nrm,
                          const float* Vf, ll n, float* score, int* ids,
                          ll* tris, cudaStream_t stream) {
  face_fans_fill_kernel<<<blocks(n), kThreads, 0, stream>>>(
      rord, rcnt, svid, mean, keep, kcum, ntri, tcum, nrm, Vf, n, score, ids,
      tris);
  return done();
}

}  // extern "C"

}  // namespace faces
