// Closest-hit and any-hit traversal of the clustered triangle soup: the v7
// pair kernels.
//
// Replaces the TPU kernel gradientdomain_mitsuba_tpu/ops/pallas_trace.py
// _v7_kernel (both its closest-hit and any-hit variants) together with the
// XLA-side culling it is driven by (_v7_phase1, _v7_expand).  Plain
// version: ops/trace.py pair_plain.
//
// Inputs (row-major f32, contiguous): rays o [N,3], d [N,3], mint [N],
// maxt [N]; the per-cluster linear-MT slabs mt_slabs [K+3, 8, 4W]
// (ops/intersect.build_mt_slabs: columns [0,3W) = det|u|v coefficients of
// the features (o x d, d) in rows 0-5, columns [3W,4W) = t coefficients of
// (o, 1) in rows 0-3), 16-byte aligned; supercluster bounds sbounds
// [6, S] (ops/trace._super_bounds transposed: rows min x, y, z, max x, y,
// z; 128 clusters each); member bounds members [S, 8, 128] (ops/trace.
// _member_slabs: rows 1-3 min xyz, rows 4-6 max xyz of the supercluster's
// 128 member clusters).  W is a runtime multiple of 128 (at
// most ops/trace.MAX_WINDOW), S at most kMaxSupers (ops/trace.MAX_SUPERS).
//
// What bounds it on an H100: reading slabs, and the latency of each
// ray's walk.  A swept cluster costs its 22 x W coefficient floats (11 KB
// at W = 128) against ~44 flops per triangle, and the forest's 556 MB slab
// table is ten times the 50 MB L2.  The forest needs 1.2 clusters per
// camera ray against the final hit t, so what the kernel controls is how
// many clusters a ray sweeps beyond those, how many boxes it tests to find
// them, and how long a warp waits on each.  Design: ONE WARP PER RAY,
// persistent warps:
//  1. the lanes test the S supercluster boxes against maxt (lane l takes
//     s = l, l+32, ...; the SoA rows make each step one coalesced line per
//     row) and keep the key max(tn, 0) of each pending one in the warp's
//     slice of shared memory (a lane reads and writes only its own
//     entries);
//  2. near to far: each lane caches the minimum of its entries; a warp
//     min-reduction (__reduce_min_sync on the key bits, which order as the
//     non-negative floats do) picks the nearest supercluster, and the walk
//     stops when that key exceeds max(t, 0), t the ray's running bound
//     (maxt, then its closest hit so far);
//  3. within a supercluster lane l tests members 4l..4l+3 against t, one
//     float4 per bound row of `members`, and keeps their keys in
//     registers; the warp visits them nearest first the same way and
//     stops at the first key above max(t, 0).  The keys carry the box
//     results: no box is tested twice;
//  4. sweeping a cluster, lane l takes triangles 4l..4l+3 of each
//     128-wide chunk as one float4 per slab row: 22 independent 16-byte
//     loads, all issued before the arithmetic that uses them.  They hold
//     88 registers; the kernel takes 128 a thread (two blocks of 8 warps
//     an SM), which measured faster than more warps with fewer registers
//     and spills;
//  5. each warp takes its next 4 consecutive rays from a device counter
//     (the wrapper zeroes it), so a warp that ends its rays early takes
//     more and no block waits on its slowest ray.
// Early exit skips no needed cluster: a cluster holding a hit at t' has
// member tn <= t' (the hit lies in its box), and its supercluster's tn is
// no greater (a member box lies inside its supercluster box, both
// computed from the same floats, and (x - o)*inv rounds monotonically in
// x), so both keys are <= max(t', 0) <= max(t, 0) for every running t
// the walk holds before finding t' (t only falls, and never below the
// final hit).  Keys are visited in ascending order, so the walk reaches
// both before it stops.  The argument holds in exact arithmetic; rounded,
// a hit on its box's face may come out an ulp before the box's computed
// entry and lose a tie within rounding to another cluster's hit, as under
// any cull by a running t (the v4 kernel's too).  The
// card runs hold every forest batch bit for bit against the plain
// version.  The any-hit kernel culls with maxt throughout and returns at
// the first cluster with a hit.
// The TPU form is not carried over: no (super, 128-bit mask) records, SMEM
// bit scans, slab DMA ring, RB/NB/SS/GW blocking or rounds of XLA-side
// expansion; culling and ordering are folded into the kernel.
//
// Semantics held exactly (the plain version computes the same values):
//  - boxes: inv = |d| > 1e-12 ? 1/d : 1e30 (IEEE division), per axis
//    (lo - o)*inv and (hi - o)*inv, tn = max of the minima, tf = min of
//    the maxima; pending = tn <= tf & tf >= mint & tn <= t & t >= mint, and
//    a member id below K.  The plain version tests every box against
//    maxt; the bound t only culls boxes whose entry lies beyond a hit
//    already found;
//  - triangles, divide first for both queries (as v7):
//    inv = 1/det (__frcp_rn: IEEE round to nearest, the same float as
//    1.0f / det; built without --use_fast_math), u = u_num*inv,
//    v = v_num*inv, t = t_num*inv, ok = u>=0 & v>=0 & u+v<=1 & t>mint &
//    t<maxt.  det == 0 (padding columns are all zero) can never pass (u
//    becomes NaN or +-inf);
//  - each lane keeps the lexicographically least (t, prim) of its hits and
//    the final shuffle reduction takes the least over the lanes, so the
//    hit is the lowest prim among equal minimal t whatever the visit
//    order;
//  - lanes whose maxt <= mint (dead wavefront lanes carry maxt = -1) do
//    no work and come back unhit: t = 3e38 (F32_MAX), u = v = 0,
//    prim = -1 / not occluded;
//  - prim = k*W + slot, the row of tri_shade.
// Precision: true fp32 throughout.  The TPU kernel's dots run at
// Precision.DEFAULT (pallas_trace.py:1024,1029, bf16 passes on the MXU);
// the port does not copy that.  The features are formed with _rn
// intrinsics (no contraction), and each dot product is an fmaf chain in
// feature order, s = f0*c0, s = fma(f_k, c_k, s), as sweep.cu's are; the
// reference's f32 matmul (interpret mode on a CPU) rounds the same way.
// The plain version emulates each fma in float64, so it reproduces t, u
// and v bit for bit apart from double-rounding ties (about one fma in
// 2^29).
//
// Optional visit counts: with `stats` non-null the kernel adds the
// clusters it swept to stats[0] and the superclusters whose members it
// tested to stats[1].  The main path passes null, which launches the
// instantiation compiled without the counters (the same walk, no
// registers held for them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kRaysPerTake = 4;    // consecutive rays a warp takes at once
constexpr int kSuper = 128;        // clusters per supercluster
constexpr int kMaxSupers = 4096;   // ops/trace.MAX_SUPERS
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // key of an entry not pending
constexpr float kF32Max = 3.0e38f;

struct Ray {
  float o[3], inv[3];
  float fa[6];   // (o x d, d): det | u | v features
  float mint, maxt;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ mint,
                                        const float* __restrict__ maxt,
                                        int i) {
  Ray r;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  r.o[0] = ox; r.o[1] = oy; r.o[2] = oz;
  const float dd[3] = {dx, dy, dz};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.inv[a] = fabsf(dd[a]) > 1e-12f ? __fdiv_rn(1.0f, dd[a]) : 1e30f;
  r.fa[0] = __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy));
  r.fa[1] = __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz));
  r.fa[2] = __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx));
  r.fa[3] = dx; r.fa[4] = dy; r.fa[5] = dz;
  r.mint = mint[i];
  r.maxt = maxt[i];
  return r;
}

// The reference's ray/box test of the box (lo, hi) against bound t:
// returns the key max(tn, 0) as bits when the box is pending, else kNone.
__device__ __forceinline__ unsigned box_key(const float (&lo)[3],
                                            const float (&hi)[3],
                                            const Ray& r, float t) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(lo[a], r.o[a]), r.inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(hi[a], r.o[a]), r.inv[a]);
    const float mn = fminf(t0, t1), mx = fmaxf(t0, t1);
    tn = a == 0 ? mn : fmaxf(tn, mn);
    tf = a == 0 ? mx : fminf(tf, mx);
  }
  const bool pending = (tn <= tf) & (tf >= r.mint) & (tn <= t) &
                       (t >= r.mint);
  return pending ? __float_as_uint(tn > 0.0f ? tn : 0.0f) : kNone;
}

// whether key bits (kNone included) lie beyond the walk's bound t
__device__ __forceinline__ bool beyond(unsigned key, float t) {
  return key == kNone || __uint_as_float(key) > fmaxf(t, 0.0f);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Triangles c, c+1, c+2, c+3 of a slab (c = 4 * lane within a 128-wide
// chunk; `row` = 4W floats): divide-first test against (mint, maxt).
// All 22 loads are issued before the arithmetic that uses them.
__device__ __forceinline__ void tri_test4(const float* __restrict__ c,
                                          int W, const Ray& r, float (&t)[4],
                                          float (&u)[4], float (&v)[4],
                                          bool (&ok)[4]) {
  const size_t row = 4 * (size_t)W;
  float4 cd[6], cu[6], cv[6], ct[4];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    cd[k] = load4(c + k * row);
    cu[k] = load4(c + k * row + W);
    cv[k] = load4(c + k * row + 2 * W);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) ct[k] = load4(c + k * row + 3 * W);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float det = __fmul_rn(r.fa[0], comp(cd[0], q));
    float un = __fmul_rn(r.fa[0], comp(cu[0], q));
    float vn = __fmul_rn(r.fa[0], comp(cv[0], q));
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      det = fmaf(r.fa[k], comp(cd[k], q), det);
      un = fmaf(r.fa[k], comp(cu[k], q), un);
      vn = fmaf(r.fa[k], comp(cv[k], q), vn);
    }
    float tn = __fmul_rn(r.o[0], comp(ct[0], q));
    tn = fmaf(r.o[1], comp(ct[1], q), tn);
    tn = fmaf(r.o[2], comp(ct[2], q), tn);
    tn = __fadd_rn(tn, comp(ct[3], q));
    const float inv = __frcp_rn(det);
    u[q] = __fmul_rn(un, inv);
    v[q] = __fmul_rn(vn, inv);
    t[q] = __fmul_rn(tn, inv);
    ok[q] = (u[q] >= 0.0f) & (v[q] >= 0.0f) &
            (__fadd_rn(u[q], v[q]) <= 1.0f) & (t[q] > r.mint) &
            (t[q] < r.maxt);
  }
}

// Per-warp visit counts, the optional `stats` counters: clusters swept
// and superclusters whose members were tested.  Without kCount (the main
// path, `stats` null) they compile away and hold no registers.
enum { kSwept, kSupers };
template <bool kCount>
struct Visits {
  unsigned c[2] = {0, 0};
  __device__ __forceinline__ void add(int i) {
    if constexpr (kCount) ++c[i];
  }
};

// The near-to-far walk of one ray by its warp.  keys: the warp's S
// entries of shared memory.  visit(k, t) sweeps cluster k, may lower the
// bound t, and returns true to end the walk.
template <typename Counts, typename Visit>
__device__ __forceinline__ void walk(const Ray& r, unsigned* keys,
                                     const float* __restrict__ sbounds,
                                     const float* __restrict__ members,
                                     int K, int S, Counts& n, Visit visit) {
  const int lane = threadIdx.x & 31;
  float t = r.maxt;
  // 1. supercluster keys against maxt; lmin / lidx: this lane's nearest
  unsigned lmin = kNone;
  int lidx = 0;
  for (int s = lane; s < S; s += 32) {
    const float lo[3] = {__ldg(sbounds + s), __ldg(sbounds + S + s),
                         __ldg(sbounds + 2 * S + s)};
    const float hi[3] = {__ldg(sbounds + 3 * S + s),
                         __ldg(sbounds + 4 * S + s),
                         __ldg(sbounds + 5 * S + s)};
    const unsigned key = box_key(lo, hi, r, t);
    keys[s] = key;
    if (key < lmin) {
      lmin = key;
      lidx = s;
    }
  }
  for (;;) {
    // 2. the nearest pending supercluster
    const unsigned m = __reduce_min_sync(kFull, lmin);
    if (beyond(m, t)) return;
    const int owner = __ffs(__ballot_sync(kFull, lmin == m)) - 1;
    const int s = __shfl_sync(kFull, lidx, owner);
    if (lane == owner) {
      keys[s] = kNone;
      lmin = kNone;
      for (int e = lane; e < S; e += 32) {
        const unsigned key = keys[e];
        if (key < lmin) {
          lmin = key;
          lidx = e;
        }
      }
    }
    n.add(kSupers);
    // 3. its members 4*lane .. 4*lane+3 against the running t
    const float* mb = members + (size_t)s * 8 * kSuper + 4 * lane;
    float4 b[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) b[a] = load4(mb + (a + 1) * kSuper);
    unsigned mk[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float lo[3] = {comp(b[0], q), comp(b[1], q), comp(b[2], q)};
      const float hi[3] = {comp(b[3], q), comp(b[4], q), comp(b[5], q)};
      mk[q] = s * kSuper + 4 * lane + q < K ? box_key(lo, hi, r, t) : kNone;
    }
    for (;;) {
      const unsigned lm = min(min(mk[0], mk[1]), min(mk[2], mk[3]));
      const unsigned mm = __reduce_min_sync(kFull, lm);
      if (beyond(mm, t)) break;
      const int ow = __ffs(__ballot_sync(kFull, lm == mm)) - 1;
      const int q = mk[0] == mm ? 0 : mk[1] == mm ? 1 : mk[2] == mm ? 2 : 3;
      const int j = __shfl_sync(kFull, 4 * lane + q, ow);
      if (lane == ow) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c == q) mk[c] = kNone;
      }
      n.add(kSwept);
      if (visit(s * kSuper + j, t)) return;
    }
  }
}

template <bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kWarps * 32, 2)
pair_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ mint, const float* __restrict__ maxt,
            const float* __restrict__ slabs,
            const float* __restrict__ sbounds,
            const float* __restrict__ members, int n_rays, int K, int S,
            int W, float* __restrict__ t_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int32_t* __restrict__ prim_out,
            uint8_t* __restrict__ occ_out, int* __restrict__ next_ray,
            unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned skeys[];
  unsigned* keys = skeys + (threadIdx.x >> 5) * S;
  const int lane = threadIdx.x & 31;
  Visits<kCount> n;
  int next = 0, left = 0;     // the warp's rays taken and not yet traced
  for (;;) {
    if (left == 0) {
      int first = 0;
      if (lane == 0) first = atomicAdd(next_ray, kRaysPerTake);
      next = __shfl_sync(kFull, first, 0);
      left = kRaysPerTake;
    }
    const int i = next++;
    --left;
    if (i >= n_rays) break;   // whole warp
    const Ray r = load_ray(o, d, mint, maxt, i);
    float bt = kF32Max, bu = 0.0f, bv = 0.0f;
    int bp = -1;
    bool occluded = false;
    if (r.maxt > r.mint) {    // warp-uniform
      walk(r, keys, sbounds, members, K, S, n,
           [&](int k, float& t) {
             const float* slab = slabs + (size_t)k * 8 * 4 * W + 4 * lane;
             for (int j0 = 0; j0 < W; j0 += 128) {
               float th[4], uh[4], vh[4];
               bool ok[4];
               tri_test4(slab + j0, W, r, th, uh, vh, ok);
               if constexpr (kAnyHit) {
                 occluded = __any_sync(kFull, ok[0] | ok[1] | ok[2] | ok[3]);
                 if (occluded) return true;
               } else {
#pragma unroll
                 for (int q = 0; q < 4; ++q) {
                   const int p = k * W + j0 + 4 * lane + q;
                   if (ok[q] && (th[q] < bt ||
                                 (th[q] == bt &&
                                  (unsigned)p < (unsigned)bp))) {
                     bt = th[q]; bu = uh[q]; bv = vh[q]; bp = p;
                   }
                 }
               }
             }
             if constexpr (!kAnyHit) t = fminf(r.maxt, warp_min(bt));
             return false;
           });
    }
    if constexpr (kAnyHit) {
      if (lane == 0) occ_out[i] = occluded ? 1 : 0;
    } else {
      // lowest (t, prim) over the lanes; a lane without a hit carries
      // prim = -1, which compares as the largest unsigned value
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(kFull, bt, off);
        const float u2 = __shfl_xor_sync(kFull, bu, off);
        const float v2 = __shfl_xor_sync(kFull, bv, off);
        const int p2 = __shfl_xor_sync(kFull, bp, off);
        if (t2 < bt || (t2 == bt && (unsigned)p2 < (unsigned)bp)) {
          bt = t2; bu = u2; bv = v2; bp = p2;
        }
      }
      if (lane == 0) {
        const bool hit = bp >= 0;
        t_out[i] = hit ? bt : kF32Max;
        u_out[i] = hit ? bu : 0.0f;
        v_out[i] = hit ? bv : 0.0f;
        prim_out[i] = hit ? bp : -1;
      }
    }
  }
  if constexpr (kCount) {
    if (lane == 0)
      for (int c = 0; c < 2; ++c)
        atomicAdd(stats + c, (unsigned long long)n.c[c]);
  }
}

template <bool kAnyHit, bool kCount>
int launch(const float* o, const float* d, const float* mint,
           const float* maxt, const float* slabs, const float* sbounds,
           const float* members, int n_rays, int K, int S, int W, float* t,
           float* u, float* v, int32_t* prim, uint8_t* occ, int* next_ray,
           unsigned long long* stats, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (S < 1 || S > kMaxSupers || K < 1 || K > S * kSuper ||
      W < 128 || W % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pair_kernel<kAnyHit, kCount>;
  const size_t smem = (size_t)kWarps * S * sizeof(unsigned);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks as fit at once, fewer for a small batch
  const int needed = (n_rays + kWarps * kRaysPerTake - 1) /
                     (kWarps * kRaysPerTake);
  const int grid = per_sm * sms < needed ? per_sm * sms : needed;
  kernel<<<grid > 0 ? grid : 1, kWarps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, mint, maxt, slabs, sbounds, members, n_rays, K, S, W, t, u, v,
      prim, occ, next_ray, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns a CUDA error code
// (cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// window, cluster or supercluster count the kernels do not take).
// next_ray: one int32 on the device, zero at the launch (the wrapper
// allocates and zeroes it); stats: null (the kernel without counters), or
// two uint64 counters the kernel adds its visits to (Visits).
extern "C" int pair_closest(const float* o, const float* d, const float* mint,
                            const float* maxt, const float* slabs,
                            const float* sbounds, const float* members,
                            int n_rays, int K, int S, int W, float* t,
                            float* u, float* v, int32_t* prim, int* next_ray,
                            unsigned long long* stats, void* stream) {
  return (stats ? launch<false, true> : launch<false, false>)(
      o, d, mint, maxt, slabs, sbounds, members, n_rays, K, S, W, t, u, v,
      prim, nullptr, next_ray, stats, stream);
}

extern "C" int pair_occluded(const float* o, const float* d, const float* mint,
                             const float* maxt, const float* slabs,
                             const float* sbounds, const float* members,
                             int n_rays, int K, int S, int W, uint8_t* occ,
                             int* next_ray, unsigned long long* stats,
                             void* stream) {
  return (stats ? launch<true, true> : launch<true, false>)(
      o, d, mint, maxt, slabs, sbounds, members, n_rays, K, S, W, nullptr,
      nullptr, nullptr, nullptr, occ, next_ray, stats, stream);
}
