// Closest-hit and any-hit sweeps of a ray batch over a whole triangle soup.
//
// Replaces the two TPU kernels of gradientdomain_mitsuba_tpu/ops/
// pallas_sweep.py: _sweep_kernel (closest hit) and _occl_kernel (any hit).
// Plain versions: ops/intersect.py intersect_matmul / occluded_matmul.
//
// Input: the linear Moeller-Trumbore table linC [10, 4T] (row-major f32,
// column groups det | u_num | v_num | t_num; ops/intersect.build_linear_mt)
// and rays o [N,3], d [N,3], mint [N], maxt [N], all f32 and contiguous.
// Per (ray, triangle) the four terms are dot products of the ray features
// f = [o x d, d, o, 1] with the triangle's four 10-coefficient columns.
//
// What bounds it on an H100: arithmetic.  Per ray it reads 32 B and writes
// 16 B (closest) or 1 B (any hit), while it does 4 x 10 FMAs plus a
// reciprocal and a few compares per triangle, so even a 36-triangle soup
// is compute bound.  Design: one thread per ray, 256 threads a block; the
// coefficients are staged tile by tile (256 triangles x 40 floats = 40 KB)
// into shared memory, where every thread of a warp reads the same
// triangle's column at once (a broadcast, no bank conflict).  Triangles
// are visited in index order with a running best updated on a strict `<`,
// which is exactly the reference's lowest-index tie-break among equal
// minimal t.  The TPU layout (transposed [8, Np] rays, [n_chunks, 4Ct, 16]
// coefficient chunks, 128-lane padding) is not carried over.
//
// Semantics held exactly:
//  - divide first: inv = 1/det (IEEE; built without --use_fast_math),
//    u = u_num*inv, v = v_num*inv, t = t_num*inv;
//    ok = u>=0 & v>=0 & u+v<=1 & t>mint & t<maxt;
//  - a miss leaves t = 3.0e38 (F32_MAX, not inf) and prim = -1;
//  - det == 0 (parallel ray, all-zero padding column) can never hit under
//    either test (u becomes NaN or +-inf), so it is skipped — a uniform
//    branch across the warp for padding columns;
//  - rays with maxt <= mint (dead lanes carry maxt = -1) cannot hit and
//    skip the loop;
//  - any hit: s = sign(det) with sign(0) = 0, su,sv >= 0, su+sv <= |det|,
//    |det| > 0, mint*|det| < st < maxt*|det|.
// Precision: the ray features use explicit _rn intrinsics, so nvcc cannot
// contract o.y*d.z - o.z*d.y into an FMA; the four 10-term dot products
// are fmaf chains in feature order.  The plain version's matmul sums in
// cuBLAS's order, so t may differ by an ulp or so; agreement is checked
// within tolerances (chip_smoke.py, tests/test_torch_sweep.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // threads (= rays) per block
constexpr int kTile = 256;    // triangles staged per shared-memory tile
constexpr int kCoef = 40;     // 4 column groups x 10 features
constexpr float kF32Max = 3.0e38f;

struct Ray {
  float f[10];
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
  r.f[0] = __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy));
  r.f[1] = __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz));
  r.f[2] = __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx));
  r.f[3] = dx; r.f[4] = dy; r.f[5] = dz;
  r.f[6] = ox; r.f[7] = oy; r.f[8] = oz;
  r.f[9] = 1.0f;
  r.mint = mint[i];
  r.maxt = maxt[i];
  return r;
}

__device__ __forceinline__ float dot10(const float* __restrict__ c,
                                       const float* f) {
  float s = __fmul_rn(c[0], f[0]);
#pragma unroll
  for (int k = 1; k < 10; ++k) s = fmaf(c[k], f[k], s);
  return s;
}

// Stage triangles [base, base + n) of linC into sh[j * 40 + g * 10 + k]
// (triangle j, column group g, feature k).
__device__ __forceinline__ void stage(float* sh, const float* __restrict__ linC,
                                      int T, int base, int n) {
  for (int idx = threadIdx.x; idx < kCoef * n; idx += blockDim.x) {
    const int row = idx / n;          // row = k * 4 + g of the [10, 4T] table
    const int j = idx - row * n;
    const int k = row >> 2, g = row & 3;
    sh[j * kCoef + g * 10 + k] = linC[(size_t)k * 4 * T + (size_t)g * T + base + j];
  }
}

__global__ void __launch_bounds__(kBlock)
sweep_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ mint,
                     const float* __restrict__ maxt,
                     const float* __restrict__ linC, int n_rays, int T,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int32_t* __restrict__ prim_out) {
  __shared__ float sh[kTile * kCoef];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r;
  bool live = false;
  if (in_range) {
    r = load_ray(o, d, mint, maxt, i);
    live = r.maxt > r.mint;
  }
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();
    stage(sh, linC, T, base, n);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* c = sh + j * kCoef;
      const float det = dot10(c, r.f);
      if (det == 0.0f) continue;
      const float inv = 1.0f / det;
      const float u = __fmul_rn(dot10(c + 10, r.f), inv);
      const float v = __fmul_rn(dot10(c + 20, r.f), inv);
      const float t = __fmul_rn(dot10(c + 30, r.f), inv);
      const bool ok = (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                      (t > r.mint) & (t < r.maxt);
      if (ok && t < bt) {
        bt = t; bu = u; bv = v; bj = base + j;
      }
    }
  }
  if (in_range) {
    t_out[i] = bt;
    u_out[i] = bu;
    v_out[i] = bv;
    prim_out[i] = bj;
  }
}

__global__ void __launch_bounds__(kBlock)
sweep_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ mint,
                      const float* __restrict__ maxt,
                      const float* __restrict__ linC, int n_rays, int T,
                      uint8_t* __restrict__ occ_out) {
  __shared__ float sh[kTile * kCoef];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r;
  bool live = false;
  if (in_range) {
    r = load_ray(o, d, mint, maxt, i);
    live = r.maxt > r.mint;
  }
  bool hit = false;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();
    stage(sh, linC, T, base, n);
    __syncthreads();
    if (!live || hit) continue;
    for (int j = 0; j < n; ++j) {
      const float* c = sh + j * kCoef;
      const float det = dot10(c, r.f);
      if (det == 0.0f) continue;
      const float s = det > 0.0f ? 1.0f : -1.0f;
      const float ad = __fmul_rn(det, s);
      const float su = __fmul_rn(dot10(c + 10, r.f), s);
      const float sv = __fmul_rn(dot10(c + 20, r.f), s);
      const float st = __fmul_rn(dot10(c + 30, r.f), s);
      if ((su >= 0.0f) & (sv >= 0.0f) & (__fadd_rn(su, sv) <= ad) &
          (ad > 0.0f) & (st > __fmul_rn(r.mint, ad)) &
          (st < __fmul_rn(r.maxt, ad))) {
        hit = true;
        break;
      }
    }
  }
  if (in_range) occ_out[i] = hit ? 1 : 0;
}

inline int grid_for(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int sweep_closest(const float* o, const float* d, const float* mint,
                             const float* maxt, const float* linC, int n_rays,
                             int T, float* t, float* u, float* v,
                             int32_t* prim, void* stream) {
  if (n_rays > 0) {
    sweep_closest_kernel<<<grid_for(n_rays), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        o, d, mint, maxt, linC, n_rays, T, t, u, v, prim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sweep_occluded(const float* o, const float* d, const float* mint,
                              const float* maxt, const float* linC, int n_rays,
                              int T, uint8_t* occ, void* stream) {
  if (n_rays > 0) {
    sweep_occluded_kernel<<<grid_for(n_rays), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        o, d, mint, maxt, linC, n_rays, T, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
