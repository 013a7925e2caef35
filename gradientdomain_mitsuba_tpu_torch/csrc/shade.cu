// One bounce of the path tracer's shading wavefront, one thread a lane.
//
// Replaces no TPU kernel: the reference's bounce (gradientdomain_mitsuba_tpu/
// models/path.py PathTracer._bounce) is jnp code that XLA fuses, so there is
// no Pallas kernel behind it.  On the card the same bounce as eager PyTorch
// (models/path.py _bounce) is about a thousand launches, each reading and
// writing whole lane arrays.  This kernel does the bounce in one pass.
// Plain version: ops/shade.py PathShade.plain, built from the ops/ functions
// the eager bounce calls.
//
// It shades the scenes ops/shade.py admits (models/path.py _fused_scene):
// diffuse rows only, no textures, the 29-column tri_shade, no spheres, area
// lights only, the independent sampler.  Launch b does, per lane, in the
// eager bounce's order of floating-point operations:
//   1. L += the pending NEE of bounce b-1 where its shadow ray was clear;
//   2. the hit record from the closest hit (t, u, v, prim) and one tri_shade
//      row (ops/common.fill_intersection);
//   3. L += the MIS-weighted area emission (ops/emitter.area_emission);
//   4. the maxDepth cut; 5. the shading frame (core/math.build_frame);
//   6. the counter RNG's draws (core/rng.random_bits, uint32 arithmetic);
//   7. the area-light NEE sample (uniform emitter pick, the CDF search of
//      ops/emitter._searchsorted_segment): the shadow ray written for the
//      any-hit call, tp * f * Le * w / pdf kept as pending;
//   8. the diffuse eval and pdf and the cosine sample (ops/bsdf.py, two-sided
//      rows flipped); 9. Russian roulette; 10. the next ray written for the
//      closest-hit call (maxt = -1 on dead lanes).
// The first launch (flag kFirst) starts the lane state itself; the last
// (kFinal) adds the pending NEE and the last vertex's emission only.
//
// What bounds it on an H100: bytes.  A lane reads its hit (17 B), ray
// (24 B), shadow answer (1 B), counters (16 B), state (46 B) and one
// tri_shade row (88 of its 116 B), and writes the shadow ray, the next ray
// and the state (~110 B); its arithmetic, ~600 integer and float operations,
// is small beside that.  Design: one thread a lane, no shared memory, every
// lane array read and written once, the small material and emitter tables
// left to the L1 / L2 caches.
//
// Numerics: built with -fmad=false, and every expression is written in the
// order the eager ops evaluate it, so each float operation rounds as there:
//  - torch.sum(a * b, -1) over 3 values on the card: the products, then the
//    reduction's order for a 3-wide last axis (two threads of one row, the
//    first summing x0 and x2, then the pair): (x0 + x2) + x1 (sum3 below);
//  - `s / tensor` for a Python scalar s is tensor.reciprocal() * s; a CUDA
//    tensor divided by a Python number is multiplied by its float
//    reciprocal (inv_n_total);
//  - clamp and amax propagate NaN; sign(NaN) is 0; int casts truncate;
//  - IEEE division and sqrtf, the device's sinf / cosf (no fast math).
//
// csrc/gpt_shade.cu includes this file with GDMT_SHADE_HELPERS_ONLY defined
// for the helpers above the kernel (the vector ops, the rounding-order sums,
// the counter RNG), without the kernel and its exported functions.

#include <cuda_runtime.h>
#include <stdint.h>

// Must match ops/shade.py _Args field for field.  Outside the unnamed
// namespace: the exported functions below take it, and a parameter type
// of internal linkage would leave them unexported.
struct ShadeArgs {
  const float* hit_t;
  const float* hit_u;
  const float* hit_v;
  const int32_t* hit_prim;
  const uint8_t* hit_valid;
  const uint8_t* occl;          // the last shadow rays' answers
  const float* ray_o_in;        // the rays the hit answers
  const float* ray_d_in;
  const int64_t* seed;          // counters: null = the *_value scalar
  const int64_t* pixel;
  const int64_t* sample;
  const float* tri_shade;       // [n_tri, shade_cols]
  const float* mat;             // [n_mat, mat_cols]
  const int32_t* em_offset;     // [E]
  const int32_t* em_count;      // [E]
  const float* em_cdf;          // [cdf_len]
  const float* em_geo;          // [cdf_len, 12]
  const float* em_area;         // [E]
  const float* em_radiance;     // [E, 3]
  const float* eps;             // scene.ray_eps, a 0-d tensor
  float* ray_o;                 // the next rays (in place of ray_*_in)
  float* ray_d;
  float* ray_maxt;
  float* shadow_o;
  float* shadow_d;
  float* shadow_maxt;
  float* L;
  float* tp;
  float* eta;
  float* last_pdf;
  uint8_t* alive;
  uint8_t* last_delta;
  float* pending;               // NEE contributions awaiting their answer
  int n;
  int n_tri;
  int shade_cols;
  int n_mat;
  int mat_cols;
  int n_area;
  int cdf_len;
  int cdf_iters;
  int bounce;
  int max_depth;
  int rr_depth;
  int flags;
  int seed_stride;
  int pixel_stride;
  int sample_stride;
  uint32_t seed_value;
  uint32_t pixel_value;
  uint32_t sample_value;
  float n_total;                // float(n_area): u_sel * n_total
  float pick_pdf;               // float(1.0 / n_area)
  float inv_n_total;            // 1.0f / float(n_area): pdf / n_total
};

namespace {

constexpr int kBlock = 256;
constexpr int kFirst = 1;   // start the lane state (bounce 0)
constexpr int kFinal = 2;   // the last launch: pending NEE and emission only
constexpr int kDirect = 4;  // weight 1 on the input rays' emitter hits
constexpr uint32_t kM1 = 0x7FEB352Du, kM2 = 0x846CA68Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kInv2_32 = 2.3283064365386963e-10f;
constexpr float kInvPi = 0.318309886183790671538f;   // float(1 / math.pi)
constexpr float kPi4 = 0.785398163397448309616f;     // float(math.pi / 4)
constexpr float kPi2 = 1.57079632679489661923f;      // float(math.pi / 2)
constexpr int kCamDims = 8, kBounceDims = 8;   // core/rng.DimAllocator
constexpr int kLightSelect = 0, kLightUV = 1, kBsdfUV = 4, kRR = 6;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return V3{a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 zero3() { return V3{0.0f, 0.0f, 0.0f}; }

// torch.sum over a 3-wide last axis on the card (see the note above); the
// zeros are its accumulators' starting values.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  const float a = (0.0f + x0) + (0.0f + x2);
  const float b = 0.0f + x1;
  return ((a + 0.0f) + 0.0f) + ((b + 0.0f) + 0.0f);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const V3 p = mul(a, b);
  return sum3(p.x, p.y, p.z);
}

// torch.clamp_min / clamp_max / clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return (x != x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
// amax over a 3-wide axis: NaN if any is NaN
__device__ __forceinline__ float amax3(V3 v) {
  if (v.x != v.x) return v.x;
  if (v.y != v.y) return v.y;
  if (v.z != v.z) return v.z;
  float m = v.x > v.y ? v.x : v.y;
  return m > v.z ? m : v.z;
}
__device__ __forceinline__ float sgn(float x) {
  return (float)(0.0f < x) - (float)(x < 0.0f);
}

// m.normalize: v / clamp_min(sqrt(clamp_min(dot(v, v), 0)), 1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  return divs(v, clamp_min(sqrtf(clamp_min(dot(v, v), 0.0f)), 1e-20f));
}

// common.offset_ray_origin: p + ng * sign(dot(ng, d)) * eps
__device__ __forceinline__ V3 offset_origin(V3 p, V3 ng, V3 d, float eps) {
  return add(p, scale(scale(ng, sgn(dot(ng, d))), eps));
}

// The power heuristic (ops/emitter.mis_weight).
__device__ __forceinline__ float mis_weight(float a, float b) {
  const float a2 = a * a;
  return a > 0.0f ? a2 / clamp_min(a2 + b * b, 1e-30f) : 0.0f;
}

// core/rng.py in uint32 arithmetic.
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t combine_mixed(uint32_t a, uint32_t mb) {
  return mix(a ^ (mb + (kGolden + (a << 6) + (a >> 2))));
}

struct Counters {
  uint32_t sample, pixel, seed;   // each mixed once
  __device__ float uniform(int dim) const {
    uint32_t h = mix((uint32_t)dim + kGolden);
    h = combine_mixed(h, sample);
    h = combine_mixed(h, pixel);
    h = combine_mixed(h, seed);
    return __uint2float_rn(h) * kInv2_32;
  }
};

__device__ __forceinline__ uint32_t counter(const int64_t* p, int stride,
                                            uint32_t value, int i) {
  return p ? (uint32_t)p[(int64_t)i * stride] : value;
}

// A flat-CDF index as torch indexes: negative ones count from the end; an
// index past the end (which torch would refuse) reads the last entry.
__device__ __forceinline__ int wrap(int k, int len) {
  k = k < 0 ? k + len : k;
  return k < 0 ? 0 : (k >= len ? len - 1 : k);
}

#ifndef GDMT_SHADE_HELPERS_ONLY
__global__ void __launch_bounds__(kBlock) path_bounce_kernel(ShadeArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const bool first = a.flags & kFirst;
  const bool final_launch = a.flags & kFinal;

  // ---- lane state; 1. the last bounce's NEE where its shadow ray was clear
  V3 L, tp;
  float eta, last_pdf;
  bool alive, last_delta;
  if (first) {
    L = zero3();
    tp = V3{1.0f, 1.0f, 1.0f};
    eta = 1.0f;
    last_pdf = 0.0f;
    alive = true;
    last_delta = a.flags & kDirect;
  } else {
    L = load3(a.L, i);
    tp = load3(a.tp, i);
    eta = a.eta[i];
    last_pdf = a.last_pdf[i];
    alive = a.alive[i] != 0;
    last_delta = a.last_delta[i] != 0;
    L = add(L, a.occl[i] ? zero3() : load3(a.pending, i));
  }

  // ---- 2. the hit record (common.fill_intersection, 29 columns)
  const V3 o = load3(a.ray_o_in, i);
  const V3 d = load3(a.ray_d_in, i);
  const bool valid = a.hit_valid[i] != 0;
  int prim = a.hit_prim[i];
  prim = prim < 0 ? 0 : (prim > a.n_tri - 1 ? a.n_tri - 1 : prim);
  const float* row = a.tri_shade + (int64_t)prim * a.shade_cols;
  const float hu = a.hit_u[i], hv = a.hit_v[i];
  const float w = (1.0f - hu) - hv;
  const float t_safe = valid ? a.hit_t[i] : 1.0f;
  const V3 p = add(o, scale(d, t_safe));
  const V3 ng = V3{row[0], row[1], row[2]};
  V3 ns = add(add(scale(V3{row[3], row[4], row[5]}, w),
                  scale(V3{row[6], row[7], row[8]}, hu)),
              scale(V3{row[9], row[10], row[11]}, hv));
  ns = normalize(ns);
  const bool ns_ok = dot(ns, ns) > 0.5f;
  const bool use_face_n = row[21] > 0.5f;
  ns = (use_face_n || !ns_ok) ? ng : ns;
  const int bsdf_id = valid ? (int)row[18] : -1;
  const int emitter_id = valid ? (int)row[19] : -1;

  // ---- 3. the emitter hit (ops/emitter.area_emission)
  {
    const float cos_front = dot(ns, neg(d));
    const bool is_emitter = valid && emitter_id >= 0 && cos_front > 0.0f;
    const int e = emitter_id < 0 ? 0 : emitter_id;
    const V3 rad = load3(a.em_radiance, e);
    // pdf_area_direct
    const V3 to_l = sub(p, o);
    const float dist2 = clamp_min(dot(to_l, to_l), 1e-12f);
    const V3 dl = divs(to_l, sqrtf(dist2));
    const float cos_l = -dot(dl, ng);
    const float area = a.em_area[e];
    float pdf = dist2 / (clamp_min(cos_l, 1e-9f) * clamp_min(area, 1e-12f));
    pdf = pdf * a.inv_n_total;
    const float lum_pdf = (emitter_id >= 0 && cos_l > 1e-6f) ? pdf : 0.0f;
    const float w_hit = last_delta ? 1.0f : mis_weight(last_pdf, lum_pdf);
    L = add(L, (alive && is_emitter) ? scale(mul(tp, rad), w_hit) : zero3());
  }
  if (final_launch) {
    store3(a.L, i, L);
    return;
  }

  // ---- 4. the maxDepth cut
  const int depth = a.bounce + 1;
  alive = alive && valid;
  if (a.max_depth > 0) alive = alive && (depth < a.max_depth);

  // ---- 5. the shading frame (core/math.build_frame, to_local)
  const float sign = ns.z >= 0.0f ? 1.0f : -1.0f;
  const float fa = (1.0f / (sign + ns.z)) * -1.0f;
  const float fb = (ns.x * ns.y) * fa;
  const V3 fs = V3{1.0f + (((sign * ns.x) * ns.x) * fa), sign * fb,
                   (-sign) * ns.x};
  const V3 ft = V3{fb, sign + ((ns.y * ns.y) * fa), -ns.y};
  const V3 wi_world = neg(d);
  const V3 wi = V3{dot(wi_world, fs), dot(wi_world, ft), dot(wi_world, ns)};
  const float* mrow = a.mat + (int64_t)(bsdf_id < 0 ? 0 : bsdf_id) *
                                  a.mat_cols;
  const V3 refl = V3{mrow[2], mrow[3], mrow[4]};
  const bool twosided = ((int)mrow[1] & 1) != 0;
  // bsdf._flip_sign: two-sided rows lit from behind shade their back
  const float flip = (twosided && wi.z < 0.0f) ? -1.0f : 1.0f;
  const float wi_z = wi.z * flip;

  // ---- 6. the counters, each mixed once
  Counters rng;
  rng.sample = mix(counter(a.sample, a.sample_stride, a.sample_value, i));
  rng.pixel = mix(counter(a.pixel, a.pixel_stride, a.pixel_value, i));
  rng.seed = mix(counter(a.seed, a.seed_stride, a.seed_value, i));
  const int dims = kCamDims + a.bounce * kBounceDims;

  // ---- 7. NEE toward one area light (emitter.sample_direct)
  const float eps = *a.eps;
  const float u_sel = rng.uniform(dims + kLightSelect);
  const float up0 = rng.uniform(dims + kLightUV);
  const float up1 = rng.uniform(dims + kLightUV + 1);
  const int n_total = a.n_area;
  int idx = (int)(u_sel * a.n_total);
  idx = idx > n_total - 1 ? n_total - 1 : idx;
  const float u_resc = clamp(u_sel * a.n_total - (float)idx, 0.0f, 1.0f);
  const int e = idx > a.n_area - 1 ? a.n_area - 1 : idx;
  const int off = a.em_offset[e];
  int lo = off, hi = off + a.em_count[e] - 1;
  for (int it = 0; it < a.cdf_iters; ++it) {
    const int mid = (lo + hi) >> 1;   // floor, as Python's //
    const bool go_right = a.em_cdf[wrap(mid, a.cdf_len)] < u_resc;
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
  }
  const float* g = a.em_geo + (int64_t)wrap(lo, a.cdf_len) * 12;
  const float sq = sqrtf(clamp_min(1.0f - up0, 0.0f));
  const float b0 = 1.0f - sq, b1 = sq * up1;
  const V3 pos = add(add(V3{g[0], g[1], g[2]}, scale(V3{g[3], g[4], g[5]}, b0)),
                     scale(V3{g[6], g[7], g[8]}, b1));
  const V3 eng = V3{g[9], g[10], g[11]};
  const V3 to_l = sub(pos, p);
  const float dist2 = clamp_min(dot(to_l, to_l), 1e-12f);
  const float dist = sqrtf(dist2);
  const V3 ld = divs(to_l, dist);
  const float cos_l = -dot(ld, eng);
  const float pdf_area = (1.0f / clamp_min(a.em_area[e], 1e-12f)) * 1.0f;
  const float pdf_sa = ((a.pick_pdf * pdf_area) * dist2) /
                       clamp_min(cos_l, 1e-9f);
  const V3 rad_e = load3(a.em_radiance, e);
  const bool nee_possible = alive && (cos_l > 1e-6f) && (pdf_sa > 0.0f);
  store3(a.shadow_o, i, offset_origin(p, ng, ld, eps));
  store3(a.shadow_d, i, ld);
  a.shadow_maxt[i] = dist - (2.0f * eps) / clamp_min(fabsf(dot(ld, eng)),
                                                     1e-3f);

  // ---- 8. diffuse eval / pdf toward the light, then the cosine sample
  {
    const V3 wo = V3{dot(ld, fs), dot(ld, ft), dot(ld, ns)};
    const float wo_z = wo.z * flip;
    const bool ok = wi_z > 0.0f && wo_z > 0.0f;
    const V3 f = ok ? scale(scale(refl, kInvPi), clamp_min(wo_z, 0.0f))
                    : zero3();
    const float pdf_b = ok ? clamp_min(wo_z, 0.0f) * kInvPi : 0.0f;
    const float w_nee = mis_weight(pdf_sa, pdf_b);
    const V3 contrib = scale(mul(mul(tp, f), rad_e),
                             w_nee / clamp_min(pdf_sa, 1e-30f));
    store3(a.pending, i, nee_possible ? contrib : zero3());
  }
  const float u0 = rng.uniform(dims + kBsdfUV);
  const float u1 = rng.uniform(dims + kBsdfUV + 1);
  // warp.square_to_uniform_disk_concentric, lifted to the hemisphere
  const float r1 = 2.0f * u0 - 1.0f, r2 = 2.0f * u1 - 1.0f;
  const bool use_r1 = fabsf(r1) > fabsf(r2);
  const float r = use_r1 ? r1 : r2;
  float phi = use_r1 ? kPi4 * (r2 / (r1 == 0.0f ? 1.0f : r1))
                     : kPi2 - kPi4 * (r1 / (r2 == 0.0f ? 1.0f : r2));
  phi = (r1 == 0.0f && r2 == 0.0f) ? 0.0f : phi;
  const float px = r * cosf(phi), py = r * sinf(phi);
  const float pz = sqrtf(clamp_min((1.0f - px * px) - py * py, 0.0f));
  const float pdf_d = clamp_min(pz, 0.0f) * kInvPi;
  const bool b_valid = wi_z > 0.0f && pz > 0.0f;
  const V3 weight = b_valid ? refl : zero3();
  const V3 wo = V3{px * 1.0f, py * 1.0f, pz * flip};
  const float b_pdf = b_valid ? pdf_d : 0.0f;
  alive = alive && b_valid;
  tp = alive ? mul(tp, weight) : tp;
  eta = alive ? eta * 1.0f : eta;
  const V3 wo_world = add(add(scale(fs, wo.x), scale(ft, wo.y)),
                          scale(ns, wo.z));
  const V3 o_new = offset_origin(p, ng, wo_world, eps);

  // ---- 9. Russian roulette
  const float u_rr = rng.uniform(dims + kRR);
  const float q = clamp_max((amax3(tp) * eta) * eta, 0.95f);
  if (depth >= a.rr_depth) {
    tp = alive ? divs(tp, clamp_min(q, 1e-9f)) : tp;
    alive = alive && (u_rr < q);
  }
  alive = alive && (amax3(tp) > 0.0f);

  // ---- 10. the next ray and the lane state
  store3(a.ray_o, i, o_new);
  store3(a.ray_d, i, wo_world);
  a.ray_maxt[i] = alive ? 3e38f : -1.0f;
  store3(a.L, i, L);
  store3(a.tp, i, tp);
  a.eta[i] = eta;
  a.last_pdf[i] = b_pdf;
  a.alive[i] = alive;
  a.last_delta[i] = 0;
}
#endif  // GDMT_SHADE_HELPERS_ONLY

}  // namespace

#ifndef GDMT_SHADE_HELPERS_ONLY

// Plain C interface (bound with ctypes).  Launches one bounce on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int path_bounce(const ShadeArgs* args, void* stream) {
  if (args->n > 0) {
    path_bounce_kernel<<<(args->n + kBlock - 1) / kBlock, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(ShadeArgs), for the wrapper's check of its mirror of the struct.
extern "C" int path_bounce_args_size() {
  return static_cast<int>(sizeof(ShadeArgs));
}
#endif  // GDMT_SHADE_HELPERS_ONLY
