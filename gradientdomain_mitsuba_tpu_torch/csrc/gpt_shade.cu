// G-PT's shading wavefront, one thread a lane, one launch between each pair
// of traversal calls.
//
// Replaces no TPU kernel: the reference's bounce and shift (gradientdomain_
// mitsuba_tpu/models/gpt.py GPTracer._bounce, _shift_offsets) are jnp code
// that XLA fuses.  On the card the same work as eager PyTorch (models/gpt.py
// _bounce, _shift_offsets) is thousands of launches a pass, each reading and
// writing whole [4, N] lane arrays.  Plain version: ops/gpt_shade.py
// GPTShade.plain_*, built from the ops/ functions the eager bounce calls.
//
// It shades the scenes ops/shade.fused_scene admits (diffuse rows only, no
// textures, the 29-column tri_shade, no spheres, area lights only, the
// independent sampler) on a tracer without specular vertices that is not
// aux_only: every offset path is NOT CONNECTED at bounce 0 and reconnects or
// dies there, so it is RECENT or DONE (or dead) at bounce 1, and from bounce
// 2 on only the base path runs (the suffix factorization).  Stages:
//   kStart    the camera's hits (base N, offsets 4N): very_direct, the
//             base's NEE shadow ray and the offsets' rays toward the same
//             light point (5N), the base's next ray;
//   kConnect  after those shadow rays and the next ray's closest hit: the
//             NEE terms, the base's emission at its new vertex, the
//             offsets' reconnection rays (4N);
//   kShift    after the reconnection rays: the shift, the emission pair
//             MIS, Russian roulette, the lane state, bounce 1's rays;
//   kBounce   bounce b >= 1 after its shadow ray and next hit: its NEE,
//             emission (and bounce 1's offsets), roulette, bounce b+1's
//             rays; the last bounce adds the suffix to primal and grad.
// A launch recomputes its vertex (the hit record from the hit and the ray
// that reached it, the NEE and BSDF samples from the counter RNG) rather
// than reading intermediate values back: the recomputation is the same
// arithmetic on the same inputs, so it gives the same bits, and the lane
// state between launches is what the eager bounce carries between bounces.
//
// What bounds it on an H100: bytes.  A lane of kShift reads five hit
// records (17 B each), five camera rays (24 B) and five or six tri_shade
// rows (88 of their 116 B), its answers and state, and writes ~230 B of
// state and rays; kBounce reads two hit records and rays and ~60 B of state.
// Design: one thread a lane, no shared memory, every lane array of a launch
// read and written once, the small material and emitter tables left to the
// L1 / L2 caches.
//
// Numerics: built with -fmad=false and written in the eager ops' order of
// rounding, as csrc/shade.cu (whose helpers it includes) explains.

#define GDMT_SHADE_HELPERS_ONLY
#include "shade.cu"

// Must match ops/gpt_shade.py _Args field for field.
struct GptArgs {
  // the camera rays and hits: base [N], offsets [4N]
  const float* cam_o;
  const float* cam_d;
  const float* cam_t;
  const float* cam_u;
  const float* cam_v;
  const int32_t* cam_prim;
  const uint8_t* cam_valid;
  const float* off_o;
  const float* off_d;
  const float* off_t;
  const float* off_u;
  const float* off_v;
  const int32_t* off_prim;
  const uint8_t* off_valid;
  // kBounce: the hit of the current vertex (reached by vtx_o / vtx_d)
  const float* vtx_t;
  const float* vtx_u;
  const float* vtx_v;
  const int32_t* vtx_prim;
  const uint8_t* vtx_valid;
  // the closest hit of the base's last next ray
  const float* hit_t;
  const float* hit_u;
  const float* hit_v;
  const int32_t* hit_prim;
  const uint8_t* hit_valid;
  const uint8_t* occl;          // the last any-hit call's answers
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
  const int32_t* shape_emitter; // [n_shapes]
  const float* eps;             // scene.ray_eps, a 0-d tensor
  // the lane state (ops/gpt_shade.py GPTState)
  float* very;
  float* primal;
  float* rest;
  float* grad;                  // [4, N, 3]
  float* coeff;                 // [4, N, 3]
  float* tp;
  uint8_t* alive;
  float* o_tp;                  // [4, N, 3]
  float* o_r;                   // [4, N]
  int32_t* o_conn;              // [4, N]
  uint8_t* o_alive;             // [4, N]
  float* o_wi;                  // [4, N, 3]
  float* shadow_o;              // [5N, 3]: kStart writes 5N, later N
  float* shadow_d;
  float* shadow_maxt;
  float* recon_o;               // [4N, 3]
  float* recon_d;
  float* recon_maxt;
  float* ray_o;                 // the base's next rays (written)
  float* ray_d;
  float* ray_maxt;
  const float* vtx_o;           // the rays that reached the current vertex;
  const float* vtx_d;           // kBounce writes ray_* over them in place
  int n;
  int n_tri;
  int shade_cols;
  int n_mat;
  int mat_cols;
  int n_area;
  int n_shapes;
  int cdf_len;
  int cdf_iters;
  int stage;
  int bounce;
  int n_bounces;
  int max_depth;
  int rr_depth;
  int diffuse_vertex;           // a diffuse row's roughness > shiftThreshold
  int seed_stride;
  int pixel_stride;
  int sample_stride;
  uint32_t seed_value;
  uint32_t pixel_value;
  uint32_t sample_value;
  float n_total;                // float(n_area): u_sel * n_total
  float pick_pdf;               // float(1.0 / n_area)
  float n_lights;               // float(max(n_lights, 1))
};

namespace {

constexpr int kStart = 0, kConnect = 1, kShift = 2, kBounce = 3;
constexpr int kNone = 0, kRecent = 1, kDone = 2;   // connection states

__device__ __forceinline__ V3 div3(V3 a, V3 b) {
  return V3{a.x / b.x, a.y / b.y, a.z / b.z};
}
__device__ __forceinline__ V3 sub_s(V3 a, float s) {
  return V3{a.x - s, a.y - s, a.z - s};
}
__device__ __forceinline__ V3 clamp_min3(V3 a, float lo) {
  return V3{clamp_min(a.x, lo), clamp_min(a.y, lo), clamp_min(a.z, lo)};
}
__device__ __forceinline__ V3 abs3(V3 a) {
  return V3{fabsf(a.x), fabsf(a.y), fabsf(a.z)};
}

// common.fill_intersection on the 29-column table (its.t is the hit's t)
struct Its {
  V3 p, ng, ns;
  float t;
  bool valid;
  int bsdf_id, emitter_id, shape_id;
};

__device__ Its fill(const GptArgs& a, V3 o, V3 d, const float* ht,
                    const float* hu_, const float* hv_, const int32_t* hp,
                    const uint8_t* hvalid, int j) {
  Its s;
  s.valid = hvalid[j] != 0;
  int prim = hp[j];
  prim = prim < 0 ? 0 : (prim > a.n_tri - 1 ? a.n_tri - 1 : prim);
  const float* row = a.tri_shade + (int64_t)prim * a.shade_cols;
  const float hu = hu_[j], hv = hv_[j];
  const float w = (1.0f - hu) - hv;
  s.t = ht[j];
  const float t_safe = s.valid ? s.t : 1.0f;
  s.p = add(o, scale(d, t_safe));
  s.ng = V3{row[0], row[1], row[2]};
  V3 ns = add(add(scale(V3{row[3], row[4], row[5]}, w),
                  scale(V3{row[6], row[7], row[8]}, hu)),
              scale(V3{row[9], row[10], row[11]}, hv));
  ns = normalize(ns);
  const bool ns_ok = dot(ns, ns) > 0.5f;
  const bool use_face_n = row[21] > 0.5f;
  s.ns = (use_face_n || !ns_ok) ? s.ng : ns;
  s.bsdf_id = s.valid ? (int)row[18] : -1;
  s.emitter_id = s.valid ? (int)row[19] : -1;
  s.shape_id = s.valid ? (int)row[20] : -1;
  return s;
}

// core/math.build_frame and to_local / to_world
struct Frame {
  V3 s, t, n;
};
__device__ __forceinline__ Frame frame_of(V3 ns) {
  const float sign = ns.z >= 0.0f ? 1.0f : -1.0f;
  const float fa = (1.0f / (sign + ns.z)) * -1.0f;
  const float fb = (ns.x * ns.y) * fa;
  return Frame{V3{1.0f + (((sign * ns.x) * ns.x) * fa), sign * fb,
                  (-sign) * ns.x},
               V3{fb, sign + ((ns.y * ns.y) * fa), -ns.y}, ns};
}
__device__ __forceinline__ V3 to_local(V3 v, const Frame& f) {
  return V3{dot(v, f.s), dot(v, f.t), dot(v, f.n)};
}
__device__ __forceinline__ V3 to_world(V3 v, const Frame& f) {
  return add(add(scale(f.s, v.x), scale(f.t, v.y)), scale(f.n, v.z));
}

// A diffuse row (bsdf.gather_params) and its eval and pdf (bsdf.eval /
// bsdf.pdf: two-sided rows lit from behind flip both z's).
struct Mat {
  V3 refl;
  bool twosided;
};
__device__ __forceinline__ Mat mat_of(const GptArgs& a, int bsdf_id) {
  const float* r = a.mat + (int64_t)(bsdf_id < 0 ? 0 : bsdf_id) * a.mat_cols;
  return Mat{V3{r[2], r[3], r[4]}, ((int)r[1] & 1) != 0};
}
__device__ __forceinline__ V3 diffuse_eval(const Mat& m, V3 wi, V3 wo,
                                           float* pdf) {
  const float flip = (m.twosided && wi.z < 0.0f) ? -1.0f : 1.0f;
  const float wi_z = wi.z * flip, wo_z = wo.z * flip;
  const bool ok = wi_z > 0.0f && wo_z > 0.0f;
  *pdf = ok ? clamp_min(wo_z, 0.0f) * kInvPi : 0.0f;
  return ok ? scale(scale(m.refl, kInvPi), clamp_min(wo_z, 0.0f)) : zero3();
}

// ops/emitter.sample_direct toward one area light: the NEE sample
struct Nee {
  V3 d, pos, n, rad;
  float dist, pdf_area, cos_l;
};
__device__ Nee sample_light(const GptArgs& a, const Counters& rng, int dims,
                            V3 p) {
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
    const int mid = (lo + hi) >> 1;
    const bool go_right = a.em_cdf[wrap(mid, a.cdf_len)] < u_resc;
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
  }
  const float* g = a.em_geo + (int64_t)wrap(lo, a.cdf_len) * 12;
  const float sq = sqrtf(clamp_min(1.0f - up0, 0.0f));
  const float b0 = 1.0f - sq, b1 = sq * up1;
  Nee s;
  s.pos = add(add(V3{g[0], g[1], g[2]}, scale(V3{g[3], g[4], g[5]}, b0)),
              scale(V3{g[6], g[7], g[8]}, b1));
  s.n = V3{g[9], g[10], g[11]};
  const V3 to_l = sub(s.pos, p);
  const float dist2 = clamp_min(dot(to_l, to_l), 1e-12f);
  s.dist = sqrtf(dist2);
  s.d = divs(to_l, s.dist);
  s.cos_l = -dot(s.d, s.n);
  s.pdf_area = a.pick_pdf * ((1.0f / clamp_min(a.em_area[e], 1e-12f)) *
                             1.0f);
  s.rad = load3(a.em_radiance, e);
  return s;
}

// GPTracer._bounce for the base up to its traversal calls: the vertex, its
// NEE sample and strategy terms, its BSDF sample and next ray.
struct Vtx {
  Its its;
  Frame fr;
  Mat mat;
  V3 wi;
  bool alive, c;
  Nee ds;
  V3 f;                  // f at the vertex toward the light
  V3 wo_l;               // the light direction in the local frame
  float conv, pe_u, pb_u;
  bool nee_live;
  V3 sh_o;
  float maxt_sh;
  V3 bwo, bweight;       // the BSDF sample (local), its weight and pdf
  float bpdf;
  bool cont;
  V3 wo_w, o_new, tp, tp_new;
};

__device__ Vtx vertex(const GptArgs& a, const Counters& rng, int b, Its its,
                      V3 d, V3 tp, bool alive_in, float eps) {
  Vtx v;
  v.its = its;
  v.tp = tp;
  const int depth = b + 1;
  v.alive = alive_in && its.valid;
  v.fr = frame_of(its.ns);
  v.wi = to_local(neg(d), v.fr);
  v.mat = mat_of(a, its.bsdf_id);
  v.c = its.valid && a.diffuse_vertex;
  bool ext_alive = v.alive;
  if (a.max_depth > 0) ext_alive = ext_alive && (depth < a.max_depth);
  const int dims = kCamDims + b * kBounceDims;

  // NEE
  v.ds = sample_light(a, rng, dims, its.p);
  v.conv = clamp_min(v.ds.cos_l, 0.0f) /
           clamp_min(v.ds.dist * v.ds.dist, 1e-12f);
  v.pe_u = v.ds.pdf_area;
  v.wo_l = to_local(v.ds.d, v.fr);
  float pdf_l;
  v.f = diffuse_eval(v.mat, v.wi, v.wo_l, &pdf_l);
  v.pb_u = pdf_l * v.conv;
  v.sh_o = offset_origin(its.p, its.ng, v.ds.d, eps);
  v.nee_live = ext_alive && (v.ds.cos_l > 1e-6f) && (v.pe_u > 0.0f);
  v.maxt_sh = v.nee_live
                  ? v.ds.dist - (2.0f * eps) /
                                    clamp_min(fabsf(dot(v.ds.d, v.ds.n)),
                                              1e-3f)
                  : -1.0f;

  // the BSDF sample (warp.square_to_cosine_hemisphere, bsdf.sample)
  const float u0 = rng.uniform(dims + kBsdfUV);
  const float u1 = rng.uniform(dims + kBsdfUV + 1);
  const float flip = (v.mat.twosided && v.wi.z < 0.0f) ? -1.0f : 1.0f;
  const float wi_z = v.wi.z * flip;
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
  v.bweight = b_valid ? v.mat.refl : zero3();
  v.bwo = V3{px * 1.0f, py * 1.0f, pz * flip};
  v.bpdf = b_valid ? pdf_d : 0.0f;
  v.cont = ext_alive && b_valid;
  v.wo_w = to_world(v.bwo, v.fr);
  v.o_new = offset_origin(its.p, its.ng, v.wo_w, eps);
  v.tp_new = v.cont ? mul(tp, v.bweight) : zero3();
  return v;
}

// The base's emission at its new vertex n (the BSDF strategy) and the
// densities the pair MIS reads.
struct Emit {
  float conv_m_seg, pe_u_n, pb_for_mis, w_std_b;
  bool esc, has_emit_m;
  V3 contrib_m_b, rad_n;
  float pe_area_n2;      // _shift_offsets' pe_area_n (indexed by emitter)
};

__device__ Emit emission(const GptArgs& a, const Vtx& v, const Its& n) {
  Emit e;
  const float cos_n_m = fabsf(dot(n.ng, v.wo_w));
  const float dist2_m = clamp_min(n.t * n.t, 1e-12f);
  e.conv_m_seg = n.valid ? cos_n_m / dist2_m : 1.0f;
  const float pb_m_u = v.bpdf * e.conv_m_seg;
  const float cosf_n = dot(n.ns, neg(v.wo_w));
  const bool hit_em = n.valid && n.emitter_id >= 0 && cosf_n > 0.0f;
  const int em = n.emitter_id < 0 ? 0 : n.emitter_id;
  e.rad_n = load3(a.em_radiance, em);
  int sid = n.shape_id < 0 ? 0 : n.shape_id;
  sid = sid > a.n_shapes - 1 ? a.n_shapes - 1 : sid;
  int eos = a.shape_emitter[sid];
  eos = eos < 0 ? 0 : eos;
  const float pe_area_n =
      hit_em ? (1.0f / (clamp_min(a.em_area[eos], 1e-12f) * a.n_lights)) *
                   1.0f
             : 0.0f;
  e.pe_area_n2 = (n.valid && n.emitter_id >= 0)
                     ? (1.0f / (clamp_min(a.em_area[em], 1e-12f) *
                                a.n_lights)) * 1.0f
                     : 0.0f;
  e.esc = v.cont && !n.valid;
  const V3 emit_m = add(hit_em ? e.rad_n : zero3(), zero3());
  e.pe_u_n = e.esc ? 0.0f : pe_area_n;
  e.pb_for_mis = e.esc ? v.bpdf : pb_m_u;
  e.has_emit_m = v.cont && (hit_em || e.esc);
  e.contrib_m_b = e.has_emit_m ? mul(v.tp_new, emit_m) : zero3();
  e.w_std_b = mis_weight(e.pb_for_mis, e.pe_u_n);
  return e;
}

// The base's NEE term once its shadow ray has its answer.
struct NeeBase {
  bool vis_m;
  V3 contrib_m;
};
__device__ __forceinline__ NeeBase nee_base(const Vtx& v, bool occ_m,
                                            V3* primal) {
  NeeBase r;
  r.vis_m = v.nee_live && !occ_m;
  const V3 c_m_val = scale(mul(mul(v.tp, v.f), v.ds.rad),
                           v.conv / clamp_min(v.pe_u, 1e-30f));
  r.contrib_m = r.vis_m ? c_m_val : zero3();
  const float w_std = mis_weight(v.pe_u, v.pb_u);
  *primal = add(*primal, scale(r.contrib_m, w_std));
  return r;
}

// An offset's NEE pair-MIS gradient term: f_o0 / pb_o0_u / conv_o0 /
// occ_o0 the NOT-CONNECTED technique's (zero, occluded past bounce 0).
__device__ V3 nee_offset(const Vtx& v, const NeeBase& nb, bool occ_m,
                         int conn, bool o_alive, V3 o_tp, float o_r,
                         V3 wi_o_main, V3 f_o0, float pb_o0_u, float conv_o0,
                         bool occ_o0) {
  float pdf_o1;
  const V3 f_o1 = diffuse_eval(v.mat, wi_o_main, v.wo_l, &pdf_o1);
  const float pb_o1_u = pdf_o1 * v.conv;
  const bool is0 = conn == kNone, is1 = conn == kRecent;
  const V3 f_o = is0 ? f_o0 : (is1 ? f_o1 : v.f);
  const float pb_o_u = is0 ? pb_o0_u : (is1 ? pb_o1_u : v.pb_u);
  const float conv_o = is0 ? conv_o0 : v.conv;
  const bool vis_o = is0 ? !occ_o0 : !occ_m;
  const bool ok_o = o_alive && vis_o && nb.vis_m;
  const V3 c_o_val = scale(mul(mul(o_tp, f_o), v.ds.rad),
                           conv_o / clamp_min(v.pe_u, 1e-30f));
  const V3 contrib_o = ok_o ? c_o_val : zero3();
  const float r_eff = ok_o ? o_r : 0.0f;
  const float pe2 = v.pe_u * v.pe_u;
  const float den = (pe2 + v.pb_u * v.pb_u) +
                    (r_eff * r_eff) * (pe2 + pb_o_u * pb_o_u);
  const float w_pair = (nb.vis_m || ok_o) ? pe2 / clamp_min(den, 1e-30f)
                                          : 0.0f;
  return scale(sub(contrib_o, nb.contrib_m), w_pair);
}

// An offset at bounce 0: its own vertex (NOT CONNECTED), from the camera.
struct Off {
  Its its;
  Frame fr;
  Mat mat;
  V3 wi_loc, wi_main, o_wi;
  bool alive, c;
};
__device__ Off offset_of(const GptArgs& a, const Vtx& v, bool base_valid,
                         int k, int i) {
  Off o;
  const int j = k * a.n + i;
  const V3 oo = load3(a.off_o, j), od = load3(a.off_d, j);
  o.its = fill(a, oo, od, a.off_t, a.off_u, a.off_v, a.off_prim, a.off_valid,
               j);
  o.o_wi = neg(od);
  o.alive = (o.its.valid && base_valid) && v.alive;
  o.fr = frame_of(o.its.ns);
  o.wi_loc = to_local(o.o_wi, o.fr);
  o.mat = mat_of(a, o.its.bsdf_id);
  o.c = o.its.valid && a.diffuse_vertex;
  o.wi_main = to_local(o.o_wi, v.fr);
  return o;
}

// The offset's NOT-CONNECTED NEE toward the base's light point.
struct Conn0 {
  V3 d, sh, f;
  float pb_u, conv, maxt;
};
__device__ Conn0 conn0_of(const Vtx& v, const Off& o, float eps) {
  Conn0 c;
  const V3 to_l = sub(v.ds.pos, o.its.p);
  const float dist_o = sqrtf(clamp_min(dot(to_l, to_l), 1e-12f));
  c.d = divs(to_l, dist_o);
  c.conv = clamp_min(-dot(c.d, v.ds.n), 0.0f) /
           clamp_min(dist_o * dist_o, 1e-12f);
  const V3 wo = to_local(c.d, o.fr);
  float pdf;
  c.f = diffuse_eval(o.mat, o.wi_loc, wo, &pdf);
  c.pb_u = pdf * c.conv;
  c.sh = offset_origin(o.its.p, o.its.ng, c.d, eps);
  const bool live = o.alive && v.nee_live;   // every offset is NOT CONNECTED
  c.maxt = live ? dist_o - (2.0f * eps) /
                               clamp_min(fabsf(dot(c.d, v.ds.n)), 1e-3f)
                : -1.0f;
  return c;
}

// The offset's reconnection to the base's new vertex n.
struct Recon {
  bool recon_sel, live_sh;
  V3 dir_rc, dir_sh, sh, f_rc, f_env;
  float conv_o_seg, jac_rc, pb_rc, pb_env, maxt;
};
__device__ Recon recon_of(const GptArgs& a, const Vtx& v, const Emit& e,
                          const Off& o, const Its& n, float eps) {
  Recon r;
  const bool c_next = n.valid && a.diffuse_vertex;
  r.recon_sel = (v.c && o.c) && (c_next || e.esc);
  const V3 to_n = sub(n.p, o.its.p);
  const float dist_o2 = clamp_min(dot(to_n, to_n), 1e-12f);
  const float dist_o = sqrtf(dist_o2);
  r.dir_rc = divs(to_n, dist_o);
  const float cos_n_o = fabsf(dot(n.ng, r.dir_rc));
  r.conv_o_seg = cos_n_o / dist_o2;
  r.jac_rc = r.conv_o_seg / clamp_min(e.conv_m_seg, 1e-30f);
  r.f_rc = diffuse_eval(o.mat, o.wi_loc, to_local(r.dir_rc, o.fr), &r.pb_rc);
  r.f_env = diffuse_eval(o.mat, o.wi_loc, to_local(v.wo_w, o.fr), &r.pb_env);
  r.dir_sh = e.esc ? v.wo_w : r.dir_rc;
  r.sh = offset_origin(o.its.p, o.its.ng, r.dir_sh, eps);
  // every offset is NOT CONNECTED at bounce 0; no environment to escape to
  r.live_sh = (o.alive && r.recon_sel) && (e.esc ? false : n.valid);
  r.maxt = r.live_sh ? (e.esc ? 1e7f
                              : dist_o - (2.0f * eps) /
                                             clamp_min(cos_n_o, 1e-3f))
                     : -1.0f;
  return r;
}

// GPTracer._shift_offsets for one offset in an all-diffuse scene, then its
// emission pair MIS at the new vertex (rc: bounce 0's reconnection, null
// past it, where c_off is the base vertex's classification).
struct Shifted {
  V3 tp, wi, g;
  float r;
  int conn;
  bool alive;
};
__device__ Shifted shift_offset(const Vtx& v, const Emit& e, const Its& n,
                                const GptArgs& a, int conn, bool o_alive,
                                V3 o_tp, float o_r, V3 wi_o_main, bool c_off,
                                const Recon* rc, bool occ_sh) {
  const bool is0 = conn == kNone, is1 = conn == kRecent, is2 = conn == kDone;
  const bool c_next = n.valid && a.diffuse_vertex;
  float pb_o1;
  const V3 f_o1 = diffuse_eval(v.mat, wi_o_main, v.bwo, &pb_o1);
  const bool ok1 = amax3(abs3(f_o1)) >= 0.0f;
  const bool recon_sel = (v.c && c_off) && (c_next || e.esc);
  V3 dir_rc, f_rc, f_env;
  float conv_o_seg, jac_rc, pb_rc, pb_env;
  bool ok_rc, ok_env;
  if (rc) {
    dir_rc = rc->dir_rc;
    conv_o_seg = rc->conv_o_seg;
    jac_rc = rc->jac_rc;
    f_rc = rc->f_rc;
    pb_rc = rc->pb_rc;
    f_env = rc->f_env;
    pb_env = rc->pb_env;
    ok_rc = ((recon_sel && n.valid) && !occ_sh) && (amax3(f_rc) > 0.0f);
    ok_env = (((recon_sel && e.esc) && !occ_sh) && rc->live_sh) &&
             (amax3(f_env) > 0.0f);
  } else {
    dir_rc = v.wo_w;
    conv_o_seg = e.conv_m_seg;
    jac_rc = 1.0f;
    f_rc = zero3();
    pb_rc = 0.0f;
    f_env = zero3();
    pb_env = 0.0f;
    ok_rc = ok_env = false;
  }
  const bool use_rc = (is0 && recon_sel) && !e.esc;
  const bool use_env = (is0 && recon_sel) && e.esc;
  const float pb_base = clamp_min(v.bpdf, 1e-30f);
  const V3 fac0 = divs(use_rc ? scale(f_rc, jac_rc)
                              : (use_env ? f_env : zero3()),
                       pb_base);
  const bool ok0 = use_rc ? ok_rc : (use_env ? ok_env : false);
  const float r_fac0 = (use_rc ? pb_rc * jac_rc : (use_env ? pb_env : 0.0f)) /
                       pb_base;
  const float pb_conn = clamp_min(v.bpdf, 1e-30f);
  const V3 fac = is2 ? v.bweight : (is1 ? divs(f_o1, pb_conn) : fac0);
  const float r_fac = is2 ? 1.0f : (is1 ? pb_o1 / pb_conn : r_fac0);
  const bool ok = is2 ? v.cont : (is1 ? (ok1 && v.cont) : ok0);
  Shifted s;
  s.alive = o_alive && ok;
  s.tp = s.alive ? mul(o_tp, fac) : zero3();
  s.r = s.alive ? o_r * r_fac : 0.0f;

  // the offset's emission at the base's new vertex
  const V3 dir_in = use_rc ? dir_rc : v.wo_w;
  const float cosf_o = dot(n.ns, neg(dir_in));
  const bool hit_em_o = (n.valid && n.emitter_id >= 0) && cosf_o > 0.0f;
  const V3 off_emit = add(hit_em_o ? e.rad_n : zero3(), zero3());
  const float off_pe_u = e.esc ? 0.0f : e.pe_area_n2;
  const float pb_rc_u = pb_rc * conv_o_seg;
  const float pb_o1_u = pb_o1 * e.conv_m_seg;
  const float pb_conn_u = v.bpdf * e.conv_m_seg;
  const float off_pb_u =
      is2 ? pb_conn_u
          : (is1 ? pb_o1_u
                 : (use_rc ? pb_rc_u : (use_env ? pb_env : 0.0f)));
  const int conn2 = (is2 || is1) ? kDone
                                 : ((use_rc || use_env) ? kRecent : kNone);
  s.conn = s.alive ? conn2 : conn;
  s.wi = (use_rc && s.alive) ? neg(dir_rc) : neg(v.wo_w);

  // the pair MIS of the emission at the new vertex
  const bool has_pair = e.has_emit_m ||
                        (s.alive && dot(off_emit, off_emit) > 0.0f);
  const float r_eff_b = s.alive ? s.r : 0.0f;
  const float num_b = e.pb_for_mis * e.pb_for_mis;
  const float den_b = (e.pb_for_mis * e.pb_for_mis + e.pe_u_n * e.pe_u_n) +
                      (r_eff_b * r_eff_b) *
                          (off_pb_u * off_pb_u + off_pe_u * off_pe_u);
  const float w_pair_b = has_pair ? num_b / clamp_min(den_b, 1e-30f) : 0.0f;
  const V3 contrib_o_b = s.alive ? mul(s.tp, off_emit) : zero3();
  s.g = scale(sub(contrib_o_b, e.contrib_m_b), w_pair_b);
  return s;
}

// Russian roulette after bounce b (gpt.py starts it one bounce before
// path.py): the throughput, 1/q and the lane's survival.
__device__ __forceinline__ bool roulette(const GptArgs& a,
                                         const Counters& rng, int b,
                                         const Vtx& v, const Its& n, V3* tp,
                                         float* inv_q) {
  const int depth = b + 1;
  const float u_rr = rng.uniform(kCamDims + b * kBounceDims + kRR);
  const float eta = 1.0f;    // a diffuse sample keeps eta
  const float q = clamp_max((amax3(v.tp_new) * eta) * eta, 0.95f);
  bool survive = true;
  *inv_q = 1.0f;
  if (depth + 1 >= a.rr_depth) {
    survive = u_rr < q;
    *inv_q = (1.0f / clamp_min(q, 1e-9f)) * 1.0f;
  }
  *tp = scale(v.tp_new, *inv_q);
  return ((v.cont && n.valid) && survive) && (amax3(*tp) > 0.0f);
}

// Bounce b's shadow ray and next ray from its vertex.
__device__ __forceinline__ void write_rays(const GptArgs& a,
                                           const Counters& rng, int b,
                                           const Its& its, V3 d, V3 tp,
                                           bool alive, float eps, int i) {
  const Vtx v = vertex(a, rng, b, its, d, tp, alive, eps);
  store3(a.shadow_o, i, v.sh_o);
  store3(a.shadow_d, i, v.ds.d);
  a.shadow_maxt[i] = v.maxt_sh;
  store3(a.ray_o, i, v.o_new);
  store3(a.ray_d, i, v.wo_w);
  a.ray_maxt[i] = v.cont ? 3e38f : -1.0f;
}

__device__ __forceinline__ Counters counters_of(const GptArgs& a, int i) {
  Counters rng;
  rng.sample = mix(counter(a.sample, a.sample_stride, a.sample_value, i));
  rng.pixel = mix(counter(a.pixel, a.pixel_stride, a.pixel_value, i));
  rng.seed = mix(counter(a.seed, a.seed_stride, a.seed_value, i));
  return rng;
}

// Bounce 0's base vertex from the camera hit.
__device__ __forceinline__ Vtx camera_vertex(const GptArgs& a,
                                             const Counters& rng, int i,
                                             float eps) {
  const V3 o = load3(a.cam_o, i), d = load3(a.cam_d, i);
  const Its its = fill(a, o, d, a.cam_t, a.cam_u, a.cam_v, a.cam_prim,
                       a.cam_valid, i);
  return vertex(a, rng, 0, its, d, V3{1.0f, 1.0f, 1.0f}, its.valid, eps);
}

__device__ __forceinline__ Its new_vertex(const GptArgs& a, const Vtx& v,
                                          int i) {
  return fill(a, v.o_new, v.wo_w, a.hit_t, a.hit_u, a.hit_v, a.hit_prim,
              a.hit_valid, i);
}

__global__ void __launch_bounds__(kBlock) gpt_start_kernel(GptArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const float eps = *a.eps;
  const Counters rng = counters_of(a, i);
  const Vtx v = camera_vertex(a, rng, i, eps);
  {
    const V3 d = load3(a.cam_d, i);
    const float cosf = dot(v.its.ns, neg(d));
    const bool is_em = (v.its.valid && v.its.emitter_id >= 0) && cosf > 0.0f;
    const int e = v.its.emitter_id < 0 ? 0 : v.its.emitter_id;
    store3(a.very, i, add(zero3(), is_em ? load3(a.em_radiance, e)
                                         : zero3()));
  }
  store3(a.shadow_o, i, v.sh_o);
  store3(a.shadow_d, i, v.ds.d);
  a.shadow_maxt[i] = v.maxt_sh;
  for (int k = 0; k < 4; ++k) {
    const Off o = offset_of(a, v, v.its.valid, k, i);
    const Conn0 c = conn0_of(v, o, eps);
    const int j = (k + 1) * a.n + i;
    store3(a.shadow_o, j, c.sh);
    store3(a.shadow_d, j, c.d);
    a.shadow_maxt[j] = c.maxt;
  }
  store3(a.ray_o, i, v.o_new);
  store3(a.ray_d, i, v.wo_w);
  a.ray_maxt[i] = v.cont ? 3e38f : -1.0f;
}

__global__ void __launch_bounds__(kBlock) gpt_connect_kernel(GptArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const float eps = *a.eps;
  const Counters rng = counters_of(a, i);
  const Vtx v = camera_vertex(a, rng, i, eps);
  const bool occ_m = a.occl[i] != 0;
  V3 primal = zero3();
  const NeeBase nb = nee_base(v, occ_m, &primal);
  const Its n = new_vertex(a, v, i);
  const Emit e = emission(a, v, n);
  primal = add(primal, scale(e.contrib_m_b, e.w_std_b));
  store3(a.primal, i, primal);
  for (int k = 0; k < 4; ++k) {
    const Off o = offset_of(a, v, v.its.valid, k, i);
    const Conn0 c = conn0_of(v, o, eps);
    const V3 g = nee_offset(v, nb, occ_m, kNone, o.alive, V3{1.0f, 1.0f, 1.0f},
                            1.0f, o.wi_main, c.f, c.pb_u, c.conv,
                            a.occl[(k + 1) * a.n + i] != 0);
    const int j = k * a.n + i;
    store3(a.grad, j, add(zero3(), g));
    const Recon r = recon_of(a, v, e, o, n, eps);
    store3(a.recon_o, j, r.sh);
    store3(a.recon_d, j, r.dir_sh);
    a.recon_maxt[j] = r.maxt;
  }
}

__global__ void __launch_bounds__(kBlock) gpt_shift_kernel(GptArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const float eps = *a.eps;
  const Counters rng = counters_of(a, i);
  const Vtx v = camera_vertex(a, rng, i, eps);
  const Its n = new_vertex(a, v, i);
  const Emit e = emission(a, v, n);
  V3 tp;
  float inv_q;
  const bool alive = roulette(a, rng, 0, v, n, &tp, &inv_q);
  for (int k = 0; k < 4; ++k) {
    const Off o = offset_of(a, v, v.its.valid, k, i);
    const Recon r = recon_of(a, v, e, o, n, eps);
    const int j = k * a.n + i;
    const Shifted s = shift_offset(v, e, n, a, kNone, o.alive,
                                   V3{1.0f, 1.0f, 1.0f}, 1.0f, o.wi_main,
                                   o.c, &r, a.occl[j] != 0);
    store3(a.grad, j, add(load3(a.grad, j), s.g));
    store3(a.o_tp, j, scale(s.tp, inv_q));
    a.o_r[j] = s.r;
    a.o_conn[j] = s.conn;
    a.o_alive[j] = s.alive && alive;
    store3(a.o_wi, j, s.wi);
  }
  store3(a.tp, i, tp);
  a.alive[i] = alive;
  if (a.n_bounces > 1) write_rays(a, rng, 1, n, v.wo_w, tp, alive, eps, i);
}

__global__ void __launch_bounds__(kBlock) gpt_bounce_kernel(GptArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int b = a.bounce;
  const float eps = *a.eps;
  const Counters rng = counters_of(a, i);
  const V3 vo = load3(a.vtx_o, i), vd = load3(a.vtx_d, i);
  const Its its = fill(a, vo, vd, a.vtx_t, a.vtx_u, a.vtx_v, a.vtx_prim,
                       a.vtx_valid, i);
  const Vtx v = vertex(a, rng, b, its, vd, load3(a.tp, i), a.alive[i] != 0,
                       eps);
  const bool occ_m = a.occl[i] != 0;
  const Its n = new_vertex(a, v, i);
  const Emit e = emission(a, v, n);
  V3 tp;
  float inv_q;
  if (b == 1) {
    V3 primal = load3(a.primal, i);
    const NeeBase nb = nee_base(v, occ_m, &primal);
    primal = add(primal, scale(e.contrib_m_b, e.w_std_b));
    const bool alive = roulette(a, rng, b, v, n, &tp, &inv_q);
    const V3 tp_safe = clamp_min3(tp, 1e-30f);
    for (int k = 0; k < 4; ++k) {
      const int j = k * a.n + i;
      const int conn = a.o_conn[j];
      const bool o_alive = (a.o_alive[j] != 0) && v.alive;
      const V3 o_tp = load3(a.o_tp, j);
      const float o_r = a.o_r[j];
      const V3 wi_main = to_local(load3(a.o_wi, j), v.fr);
      V3 g = add(load3(a.grad, j),
                 nee_offset(v, nb, occ_m, conn, o_alive, o_tp, o_r, wi_main,
                            zero3(), 0.0f, 0.0f, true));
      const Shifted s = shift_offset(v, e, n, a, conn, o_alive, o_tp, o_r,
                                     wi_main, v.c, nullptr, false);
      g = add(g, s.g);
      store3(a.grad, j, g);
      const V3 o_tp2 = scale(s.tp, inv_q);
      const bool o_alive2 = s.alive && alive;
      store3(a.o_tp, j, o_tp2);
      a.o_r[j] = s.r;
      a.o_conn[j] = s.conn;
      a.o_alive[j] = o_alive2;
      store3(a.o_wi, j, s.wi);
      if (a.n_bounces > 2) {
        // the suffix factorization (gpt.py trace_pass)
        const V3 rho = o_alive2 ? div3(o_tp2, tp_safe) : zero3();
        const float r_c = o_alive2 ? s.r : 0.0f;
        store3(a.coeff, j, (o_alive2 || alive)
                               ? divs(sub_s(rho, 1.0f), 1.0f + r_c * r_c)
                               : zero3());
      }
    }
    store3(a.primal, i, primal);
    if (a.n_bounces > 2) store3(a.rest, i, zero3());
    store3(a.tp, i, tp);
    a.alive[i] = alive;
    if (b + 1 < a.n_bounces) write_rays(a, rng, b + 1, n, v.wo_w, tp, alive,
                                        eps, i);
    return;
  }
  V3 rest = load3(a.rest, i);
  nee_base(v, occ_m, &rest);
  rest = add(rest, scale(e.contrib_m_b, e.w_std_b));
  const bool alive = roulette(a, rng, b, v, n, &tp, &inv_q);
  if (b == a.n_bounces - 1) {
    store3(a.primal, i, add(load3(a.primal, i), rest));
    for (int k = 0; k < 4; ++k) {
      const int j = k * a.n + i;
      store3(a.grad, j, add(load3(a.grad, j), mul(load3(a.coeff, j), rest)));
    }
  } else {
    write_rays(a, rng, b + 1, n, v.wo_w, tp, alive, eps, i);
  }
  store3(a.rest, i, rest);
  store3(a.tp, i, tp);
  a.alive[i] = alive;
}

}  // namespace

// Plain C interface (bound with ctypes).  Launches one stage on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int gpt_shade(const GptArgs* args, void* stream) {
  if (args->n > 0) {
    const dim3 grid((args->n + kBlock - 1) / kBlock), block(kBlock);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (args->stage) {
      case kStart: gpt_start_kernel<<<grid, block, 0, s>>>(*args); break;
      case kConnect: gpt_connect_kernel<<<grid, block, 0, s>>>(*args); break;
      case kShift: gpt_shift_kernel<<<grid, block, 0, s>>>(*args); break;
      case kBounce: gpt_bounce_kernel<<<grid, block, 0, s>>>(*args); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(GptArgs), for the wrapper's check of its mirror of the struct.
extern "C" int gpt_shade_args_size() {
  return static_cast<int>(sizeof(GptArgs));
}
