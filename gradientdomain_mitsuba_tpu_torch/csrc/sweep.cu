// Closest-hit and any-hit sweeps of a ray batch over a whole triangle soup.
//
// Replaces the two TPU kernels of gradientdomain_mitsuba_tpu/ops/
// pallas_sweep.py: _sweep_kernel (closest hit) and _occl_kernel (any hit).
// Plain versions: ops/intersect.py intersect_matmul / occluded_matmul.
//
// Input: the packed triangle table of ops/sweep.pack_linear_mt and rays
// o [N,3], d [N,3], mint [N], maxt [N], all f32 and contiguous.  The table
// holds one 80-byte record (5 float4s) for each column of the linear
// Moeller-Trumbore table linC [10, 4T] (ops/intersect.build_linear_mt)
// whose det coefficients are not all zero, in increasing column order:
//   x[0]  det  rows 3 4 5 | u row 0
//   x[1]  u    rows 1 2 3 4
//   x[2]  u    row 5      | v rows 0 1 2
//   x[3]  v    rows 3 4 5 | t row 6
//   x[4]  t    rows 7 8 9 | the column index (prim) as int bits
// These are the 19 coefficients build_linear_mt can make non-zero; the
// other 21 are zero by construction (the pack raises otherwise), and a
// column whose det coefficients are all zero (window padding, zero-area
// triangles) gives det = 0 for every ray and can never hit.  Per (ray,
// record) the four terms are dot products with the ray features
// f = [o x d, d, o, 1].
//
// What bounds it on an H100: arithmetic.  Per ray it reads 32 B and writes
// 16 B (closest) or 1 B (any hit), while per (ray, record) it does 19 FMAs,
// a reciprocal and a few multiplies and compares.  Design: one thread a
// ray; the block stages the whole table into shared memory once (at most
// 2,048 records, 160 KB, coalesced float4 loads) and each thread then
// sweeps it with broadcast 128-bit loads (every thread of a warp reads the
// same record) and no barrier inside the loop.  Blocks are 256 threads
// for every table (a 160 KB table leaves room for one such block an SM).
// Records are visited in column order with a running best replaced on a strict
// `<`: the reference's lowest index among equal minimal t.  The TPU layout
// (transposed [8, Np] rays, [n_chunks, 4Ct, 16] coefficient chunks,
// 128-lane padding, the trim to round_up(n_tris, 64) columns) is not
// carried over.
//
// Semantics held exactly:
//  - divide first: inv = __frcp_rn(det) (the IEEE reciprocal; built
//    without --use_fast_math), u = u_num*inv, v = v_num*inv,
//    t = t_num*inv; ok = u>=0 & v>=0 & u+v<=1 & t>mint & t<maxt;
//    det == 0 gives u, v of +-inf or NaN, so ok fails without a branch;
//  - a miss leaves t = 3.0e38 (F32_MAX, not inf) and prim = -1;
//  - rays with maxt <= mint (dead lanes carry maxt = -1) cannot hit and
//    skip the loop;
//  - any hit: s = sign(det) (det == 0 gives ad = -0, which fails), su,sv
//    >= 0, su+sv <= |det|, |det| > 0, mint*|det| < st < maxt*|det|; a
//    thread stops at its first hit.
// Precision: the ray features use explicit _rn intrinsics, so nvcc cannot
// contract o.y*d.z - o.z*d.y into an FMA.  Each term is the chain of the
// dense 10-term dot product in feature order with the zero terms left
// out: __fmul_rn of the first structural term, then fmaf (t's constant
// row as fmaf(c9, 1, s)).  A zero term adds a zero to the chain, so for
// finite rays every value equals the dense chain's bit for bit, up to the
// sign of a zero.  The plain version's matmul sums in cuBLAS's order, so t
// may differ from it by an ulp or so; agreement is checked within
// tolerances (chip_smoke.py, tests/test_torch_sweep_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // threads (= rays) a block
constexpr int kRecord = 5;         // float4s per packed record
constexpr int kSmallTable = 48 * 1024;   // bytes
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

// The four terms of one record for one ray, and its prim.
struct Terms {
  float det, u, v, t;
  int prim;
};

__device__ __forceinline__ Terms terms(const float4* x, const float* f) {
  const float4 a = x[0], b = x[1], c = x[2], e = x[3], g = x[4];
  Terms r;
  r.det = fmaf(a.z, f[5], fmaf(a.y, f[4], __fmul_rn(a.x, f[3])));
  r.u = fmaf(c.x, f[5], fmaf(b.w, f[4], fmaf(b.z, f[3], fmaf(
      b.y, f[2], fmaf(b.x, f[1], __fmul_rn(a.w, f[0]))))));
  r.v = fmaf(e.z, f[5], fmaf(e.y, f[4], fmaf(e.x, f[3], fmaf(
      c.w, f[2], fmaf(c.z, f[1], __fmul_rn(c.y, f[0]))))));
  r.t = fmaf(g.z, 1.0f, fmaf(g.y, f[8], fmaf(g.x, f[7],
                                             __fmul_rn(e.w, f[6]))));
  r.prim = __float_as_int(g.w);
  return r;
}

// The whole table into shared memory, once per block.
__device__ __forceinline__ void stage(float4* sh,
                                      const float4* __restrict__ recs,
                                      int n_rec) {
  for (int q = threadIdx.x; q < n_rec * kRecord; q += blockDim.x)
    sh[q] = __ldg(recs + q);
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
sweep_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ mint,
                     const float* __restrict__ maxt,
                     const float4* __restrict__ recs, int n_rays, int n_rec,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int32_t* __restrict__ prim_out) {
  extern __shared__ float4 sh[];
  stage(sh, recs, n_rec);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, mint, maxt, i);
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  if (r.maxt > r.mint) {
    for (int j = 0; j < n_rec; ++j) {
      const Terms x = terms(sh + j * kRecord, r.f);
      const float inv = __frcp_rn(x.det);
      const float u = __fmul_rn(x.u, inv);
      const float v = __fmul_rn(x.v, inv);
      const float t = __fmul_rn(x.t, inv);
      const bool ok = (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                      (t > r.mint) & (t < r.maxt);
      if (ok && t < bt) {
        bt = t; bu = u; bv = v; bj = x.prim;
      }
    }
  }
  t_out[i] = bt;
  u_out[i] = bu;
  v_out[i] = bv;
  prim_out[i] = bj;
}

__global__ void __launch_bounds__(kBlock)
sweep_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ mint,
                      const float* __restrict__ maxt,
                      const float4* __restrict__ recs, int n_rays, int n_rec,
                      uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 sh[];
  stage(sh, recs, n_rec);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, mint, maxt, i);
  bool hit = false;
  if (r.maxt > r.mint) {
    for (int j = 0; j < n_rec; ++j) {
      const Terms x = terms(sh + j * kRecord, r.f);
      const float s = x.det > 0.0f ? 1.0f : -1.0f;
      const float ad = __fmul_rn(x.det, s);
      const float su = __fmul_rn(x.u, s);
      const float sv = __fmul_rn(x.v, s);
      const float st = __fmul_rn(x.t, s);
      if ((su >= 0.0f) & (sv >= 0.0f) & (__fadd_rn(su, sv) <= ad) &
          (ad > 0.0f) & (st > __fmul_rn(r.mint, ad)) &
          (st < __fmul_rn(r.maxt, ad))) {
        hit = true;
        break;
      }
    }
  }
  occ_out[i] = hit ? 1 : 0;
}

// One launch of `kernel` over n_rays, kBlock rays a block, with the
// table's bytes of dynamic shared memory (opting in above 48 KB: the
// attribute is the current device's, so it is set at every such launch).
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int n_rec, int n_rays, void* stream,
           A... args) {
  const int smem = n_rec * kRecord * (int)sizeof(float4);
  if (smem > kSmallTable) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rays > 0) {
    kernel<<<(n_rays + kBlock - 1) / kBlock, kBlock, smem,
             static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  `recs` is the packed table
// [n_rec, 20] (16-byte aligned).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int sweep_closest(const float* o, const float* d, const float* mint,
                             const float* maxt, const float* recs, int n_rays,
                             int n_rec, float* t, float* u, float* v,
                             int32_t* prim, void* stream) {
  return launch(sweep_closest_kernel, n_rec, n_rays, stream, o, d, mint, maxt,
                reinterpret_cast<const float4*>(recs), n_rays, n_rec, t, u, v,
                prim);
}

extern "C" int sweep_occluded(const float* o, const float* d, const float* mint,
                              const float* maxt, const float* recs, int n_rays,
                              int n_rec, uint8_t* occ, void* stream) {
  return launch(sweep_occluded_kernel, n_rec, n_rays, stream, o, d, mint,
                maxt, reinterpret_cast<const float4*>(recs), n_rays, n_rec,
                occ);
}
