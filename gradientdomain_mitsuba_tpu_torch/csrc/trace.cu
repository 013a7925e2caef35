// Closest-hit and any-hit traversal of the clustered triangle soup.
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
// (o, 1) in rows 0-3); cluster bounds cbounds [K,6]; supercluster bounds
// sbounds [S,6] (ops/trace._super_bounds, 128 clusters each).  W is a
// runtime multiple of 128 (at most ops/trace.MAX_WINDOW).
//
// What bounds it on an H100: reading slabs.  A pending cluster costs its
// 22 x W coefficient floats (11 KB at W = 128) against ~30 flops per
// triangle, and the forest's 556 MB slab table is ten times the 50 MB L2,
// so incoherent rays stream slabs from HBM.  Design, simple first: ONE
// WARP PER RAY.  The lanes test 32 superclusters at a time and ballot;
// for each pending supercluster, in index order, they test its 128 member
// boxes (4 per lane) against the ray's running t and ballot; each pending
// member (re-tested against the current t) is swept with lane l taking
// triangles l, l+32, ..., so every slab row is read as coalesced 128-byte
// lines and no lane idles on another ray's divergent work (the reason for
// a warp rather than a thread per ray: bounce rays of one warp would
// otherwise visit the union of 32 rays' clusters).  After each swept
// cluster the lanes min-reduce t with shuffles, which tightens the box
// tests that follow.  The any-hit kernel returns at the first cluster
// with a hit.  The TPU form is not carried over: no (super, 128-bit mask)
// records, SMEM bit scans, slab DMA ring, RB/NB/SS/GW blocking or rounds
// of XLA-side expansion; culling is folded into the kernel.  Not done yet
// (later work): near-to-far supercluster order, ray sorting, staging slabs
// through shared memory for a block of coherent rays.
//
// Semantics held exactly (the plain version computes the same values):
//  - boxes: inv = |d| > 1e-12 ? 1/d : 1e30 (IEEE division), per axis
//    (lo - o)*inv and (hi - o)*inv, tn = max of the minima, tf = min of
//    the maxima; pending = tn <= tf & tf >= mint & tn <= t & t >= mint.
//    The reference tests superclusters against maxt and members against
//    the t at the start of a round; a running t only culls boxes whose
//    entry lies beyond a hit already found (a member's tn is never below
//    its supercluster's, as both are computed from the same floats);
//  - triangles, divide first for both queries (as v7):
//    inv = 1/det (IEEE; built without --use_fast_math), u = u_num*inv,
//    v = v_num*inv, t = t_num*inv, ok = u>=0 & v>=0 & u+v<=1 & t>mint &
//    t<bound with a strict `<`.  det == 0 (padding columns are all zero)
//    can never pass (u becomes NaN or +-inf) and is skipped;
//  - lanes whose maxt <= mint (dead wavefront lanes carry maxt = -1) do
//    no work and come back unhit: t = 3e38 (F32_MAX), u = v = 0,
//    prim = -1 / not occluded;
//  - clusters are visited in ascending id and triangles within a lane in
//    ascending slot, and the final reduction takes the lowest prim among
//    equal t, so the hit is the lowest prim among equal minimal t;
//  - prim = k*W + lane, the row of tri_shade.
// Precision: true fp32 throughout.  The TPU kernel's dots run at
// Precision.DEFAULT (pallas_trace.py:1024,1029, bf16 passes on the MXU);
// the port does not copy that.  The features are formed with _rn
// intrinsics (no contraction), and each dot product is an fmaf chain in
// feature order, s = f0*c0, s = fma(f_k, c_k, s), as sweep.cu's are; the
// reference's f32 matmul (interpret mode on a CPU) rounds the same way.
// The plain version emulates each fma in float64, so it reproduces t, u
// and v bit for bit apart from double-rounding ties (about one fma in
// 2^29).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rays (warps) per block
constexpr int kSuper = 128;        // clusters per supercluster
constexpr unsigned kFull = 0xffffffffu;
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

// The reference's ray/box test of box b = (min xyz, max xyz) against
// bound t.
__device__ __forceinline__ bool box_pending(const float* __restrict__ b,
                                            const Ray& r, float t) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(b[a], r.o[a]), r.inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(b[3 + a], r.o[a]), r.inv[a]);
    const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
    tn = a == 0 ? lo : fmaxf(tn, lo);
    tf = a == 0 ? hi : fminf(tf, hi);
  }
  return (tn <= tf) & (tf >= r.mint) & (tn <= t) & (t >= r.mint);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// One triangle of a slab: divide-first test against (mint, bound).
// Returns false for det == 0 or a miss; else t, u, v.
__device__ __forceinline__ bool tri_test(const float* __restrict__ slab,
                                         int W, int j, const Ray& r,
                                         float bound, float& t, float& u,
                                         float& v) {
  const size_t row = 4 * (size_t)W;
  float det = __fmul_rn(r.fa[0], slab[j]);
#pragma unroll
  for (int k = 1; k < 6; ++k) det = fmaf(r.fa[k], slab[k * row + j], det);
  if (det == 0.0f) return false;
  float un = __fmul_rn(r.fa[0], slab[W + j]);
  float vn = __fmul_rn(r.fa[0], slab[2 * W + j]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    un = fmaf(r.fa[k], slab[k * row + W + j], un);
    vn = fmaf(r.fa[k], slab[k * row + 2 * W + j], vn);
  }
  const float* ts = slab + 3 * W + j;
  float tn = __fmul_rn(r.o[0], ts[0]);
  tn = fmaf(r.o[1], ts[row], tn);
  tn = fmaf(r.o[2], ts[2 * row], tn);
  tn = __fadd_rn(tn, ts[3 * row]);
  const float inv = __fdiv_rn(1.0f, det);
  u = __fmul_rn(un, inv);
  v = __fmul_rn(vn, inv);
  t = __fmul_rn(tn, inv);
  return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
         (t > r.mint) & (t < bound);
}

// Walks the ray's pending clusters in ascending id; calls
// visit(k, bound) -> new bound for each cluster whose box passes against
// the current bound.  visit returns a negative bound to stop the walk.
template <typename Visit>
__device__ __forceinline__ void walk(const Ray& r, float bound,
                                     const float* __restrict__ cbounds,
                                     const float* __restrict__ sbounds,
                                     int K, int S, Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    unsigned sm = __ballot_sync(
        kFull, s < S && box_pending(sbounds + 6 * (size_t)s, r, bound));
    while (sm) {
      const int sb = s0 + __ffs(sm) - 1;
      sm &= sm - 1;
      if (!box_pending(sbounds + 6 * (size_t)sb, r, bound)) continue;
      for (int q = 0; q < kSuper; q += 32) {
        const int k = sb * kSuper + q + lane;
        unsigned mm = __ballot_sync(
            kFull, k < K && box_pending(cbounds + 6 * (size_t)k, r, bound));
        while (mm) {
          const int kk = sb * kSuper + q + __ffs(mm) - 1;
          mm &= mm - 1;
          if (!box_pending(cbounds + 6 * (size_t)kk, r, bound)) continue;
          bound = visit(kk, bound);
          if (bound < 0.0f) return;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
pair_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ mint,
                    const float* __restrict__ maxt,
                    const float* __restrict__ slabs,
                    const float* __restrict__ cbounds,
                    const float* __restrict__ sbounds, int n_rays, int K,
                    int S, int W, float* __restrict__ t_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int32_t* __restrict__ prim_out) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_rays) return;   // whole warp
  const int lane = threadIdx.x & 31;
  const Ray r = load_ray(o, d, mint, maxt, i);
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bp = -1;
  if (r.maxt > r.mint) {     // warp-uniform
    walk(r, r.maxt, cbounds, sbounds, K, S, [&](int k, float bound) {
      const float* slab = slabs + (size_t)k * 8 * 4 * W;
      for (int j = lane; j < W; j += 32) {
        float t, u, v;
        if (tri_test(slab, W, j, r, bound, t, u, v)) {
          bound = t; bt = t; bu = u; bv = v; bp = k * W + j;
        }
      }
      return warp_min(bound);
    });
  }
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

__global__ void __launch_bounds__(kWarps * 32)
pair_occluded_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ mint,
                     const float* __restrict__ maxt,
                     const float* __restrict__ slabs,
                     const float* __restrict__ cbounds,
                     const float* __restrict__ sbounds, int n_rays, int K,
                     int S, int W, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_rays) return;   // whole warp
  const int lane = threadIdx.x & 31;
  const Ray r = load_ray(o, d, mint, maxt, i);
  bool occluded = false;
  if (r.maxt > r.mint) {     // warp-uniform
    walk(r, r.maxt, cbounds, sbounds, K, S, [&](int k, float bound) {
      const float* slab = slabs + (size_t)k * 8 * 4 * W;
      bool hit = false;
      for (int j = lane; j < W && !hit; j += 32) {
        float t, u, v;
        hit = tri_test(slab, W, j, r, bound, t, u, v);
      }
      occluded = __any_sync(kFull, hit);
      return occluded ? -1.0f : bound;
    });
  }
  if (lane == 0) occ_out[i] = occluded ? 1 : 0;
}

inline int grid_for(int n_rays) { return (n_rays + kWarps - 1) / kWarps; }

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int pair_closest(const float* o, const float* d, const float* mint,
                            const float* maxt, const float* slabs,
                            const float* cbounds, const float* sbounds,
                            int n_rays, int K, int S, int W, float* t,
                            float* u, float* v, int32_t* prim, void* stream) {
  if (n_rays > 0) {
    pair_closest_kernel<<<grid_for(n_rays), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        o, d, mint, maxt, slabs, cbounds, sbounds, n_rays, K, S, W, t, u, v,
        prim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_occluded(const float* o, const float* d, const float* mint,
                             const float* maxt, const float* slabs,
                             const float* cbounds, const float* sbounds,
                             int n_rays, int K, int S, int W, uint8_t* occ,
                             void* stream) {
  if (n_rays > 0) {
    pair_occluded_kernel<<<grid_for(n_rays), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        o, d, mint, maxt, slabs, cbounds, sbounds, n_rays, K, S, W, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
