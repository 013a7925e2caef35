// Block-cooperative closest-hit and any-hit traversal of the clustered
// triangle soup: one block walk (walk_kernel) instantiated with two slab
// policies, the v4 kernels (mt_closest, mt_occluded; MtSlab) and the v2
// kernels (tri9_closest, tri9_occluded; Tri9Slab).
//
// Replaces two TPU kernels of gradientdomain_mitsuba_tpu/ops/pallas_trace.py,
// each in its closest-hit and any-hit variant:
//  - _mt_kernel (v4) with the XLA-side worklist build that drives it
//    (_super_worklists, _rank_sort, _assemble_worklists): the divide-first
//    linear-MT test over the per-cluster slabs mt_slabs [K+3, 8, 4W]
//    (ops/intersect.build_mt_slabs).  Plain version: ops/trace.pair_plain,
//    the v7 kernels' (csrc/trace.cu) plain version too: v4 and v7 compute
//    the same function over the same tables.
//  - _traverse_kernel (v2) with its per-block cluster worklists (_run): the
//    pairwise Moeller-Trumbore test (ops/intersect._mt) over the tri9
//    slabs [K', 16, W] (rows 0-8 = v0, e1, e2 xyz of the cluster's W
//    slots).  Plain version: ops/trace.tri9_plain.
// Both take rays o [N,3], d [N,3], mint [N], maxt [N], all f32 and
// contiguous, and a BLOCK OF 64 CONSECUTIVE RAYS (the reference's MT_RBLK)
// shares one near-to-far worklist of superclusters (128 consecutive
// clusters each).  W is a runtime multiple of 128 (at most ops/trace.
// MAX_WINDOW), S at most kMaxSupers.
//
// What bounds both on an H100: reading triangle slabs, and the latency of
// the walk.  A swept cluster costs its 22 x W linear-MT coefficients
// (11 KB at W = 128; 9 x W, 4.5 KB, for v2) against ~44-46 flops per
// (ray, triangle), and the forest's slab table is ten times the 50 MB L2.
// The warp-per-ray kernels of trace.cu read a cluster's slab once per ray
// that enters it; here a slab is read once per block and reused by every
// ray of the block that enters the cluster.
//
// The walk: lanes across triangles, 2 warps a block of 64 rays.
// Box tables are the pair kernels' SoA tables (ops/trace.py box_tables):
// sbounds [6, S] (rows min x, y, z, max x, y, z) and members [S, 8, 128]
// (rows 1-3 min xyz, rows 4-6 max xyz of the supercluster's member
// clusters).
//  0. The block's ray state (origin, inverse direction, the features
//     (o x d, d), mint, maxt) lives in shared memory, with each ray's best
//     hit as one 64-bit word (order-preserving bits of t) << 32 | prim,
//     initially (maxt, no prim): its high word is always the ray's
//     culling bound t (maxt, then its closest hit so far).
//  1. The 64 x S supercluster tests against maxt are spread over all
//     threads: a thread holds one box in registers and tests the block's
//     rays, read from shared memory (a broadcast), keeping the least key
//     max(tn, 0); one shared atomicMin per box that some ray enters leaves
//     the block's key of each supercluster.
//  2. The entries some ray enters are compacted (ballots) and rank-sorted
//     (an entry's place is the count of entries below it: one pass, one
//     barrier), ascending (key, index).  This takes the place of
//     _super_worklists.
//  3. The walk has no block barrier.  Each warp takes the next entry, near
//     to far, from a shared counter.  Lanes over rays: the supercluster box
//     against each ray's current t (two rays a lane); the warp stops when
//     the entry's key exceeds every live ray's max(t, 0) (the reference's
//     early exit: every later entry is farther).  Lanes over boxes: lane l
//     holds member boxes l, l+32, l+64, l+96 in registers and tests them
//     against every entering ray, building each member's 64-bit list of
//     rays and its key, the least max(tn, 0) of those rays.  The entered
//     members are swept nearest first (a warp min-reduction on the key
//     bits picks the next).  For each, lanes over rays again: the listed
//     rays whose bound, which may have fallen since, still reaches the
//     member box (any hit: those not yet occluded); if none is left the
//     slab is not read.  Else the warp loads the member's triangles 128 at
//     a time into registers, lane l triangles 4l..4l+3 as one float4 per
//     slab row (MtSlab: 22 independent 16-byte loads, 88 registers;
//     Tri9Slab: 9, 36 registers), and loops over ALL those rays: four
//     triangles a lane, every hit merged into the ray's word with a shared
//     atomicMin.  That is the lexicographic (t, prim) minimum whatever the
//     order in which warps merge, so results do not depend on scheduling;
//     only the number of sweeps does.  A t read for culling may be older
//     than another warp's merge: that only sweeps more, never less (t only
//     falls, and culling keeps ties, tn <= t).  Any hit: a hit clears the
//     ray's bit in the block's active mask, and a ray that is no longer
//     active is dropped from every later list and loop.
//  4. After the block's one closing barrier, a thread per ray writes the
//     results: u and v come from one more test of the winning triangle
//     through the same arithmetic, so their bits are those of the sweep's.
// A hit's t lies in (mint, maxt), of either sign: the order-preserving map
// of its bits (sign bit flipped for t >= 0, all bits for t < 0; -0
// canonicalised to +0) makes the unsigned order of the words the order of
// (t, prim) for any mint.  No lane idles because another ray entered a
// member, nothing is staged in shared memory, and shared memory per block
// is 4.1 KB + 16 S bytes, so registers (at most 128 a thread: eight
// blocks, 16 warps an SM; 80 and twelve for v2's any hit) bound
// residency.  Narrow blocks measured faster than wide ones (2 warps
// against 4 and 8): a block ends with its slowest warp, and more blocks an
// SM overlap one block's set-up with another's sweeps.  Nothing of the TPU
// form is carried over: no worklist DMA chunks, SMEM scalar walks,
// masked-iota lane extraction or ring of slab semaphores, and v2 is no
// longer one thread a ray over tiles staged for the block's union of
// clusters.
// A slab policy gives the walk the rows a lane loads for each 128-triangle
// tile, its test of one ray against one triangle, and the re-test of the
// winner at step 4; everything else is the one walk.
// With `stats` non-null the counting instantiation adds to stats[0..2] the
// (ray, 128-triangle tile) sweeps, the (block, member) slab reads and the
// worklist entries some ray entered; the main path passes null and
// launches the instantiation compiled without counters.
//
// Semantics held exactly (the plain versions compute the same values):
//  - boxes: inv = |d| > 1e-12 ? 1/d : 1e30 (IEEE division), per axis
//    (lo - o)*inv and (hi - o)*inv, tn = max of the minima, tf = min of
//    the maxima; pending = tn <= tf & tf >= mint & tn <= t & t >= mint,
//    the reference's expressions.  A member box lies inside its
//    supercluster box, so a ray entering a member enters its supercluster
//    (each slab bound is computed from the same floats);
//  - v4 triangles, as trace.cu: inv = 1/det (__frcp_rn: IEEE, the same
//    float as 1.0f / det), u = u_num*inv, v = v_num*inv, t = t_num*inv,
//    with the same fmaf chains in feature order; det == 0 (all-zero
//    padding columns) cannot pass.  So v4's hits equal v7's bit for bit;
//  - v2 triangles, ops/intersect._mt in one fixed order of _rn
//    intrinsics: products rounded once, crosses a*b - c*d, three-term dots
//    (x0 + x1) + x2, inv_det = __fdiv_rn(1.0f, det) (IEEE; measured
//    1-5% faster here than __frcp_rn, the same float), and |det| > 1e-12
//    ANDed into the hit, not a branch: zero padding slots (det = 0) and
//    near-zero det never hit (their reciprocal is taken of 1: the slow
//    path for 0 cost the v2 sweeps 7-25%);
//  - a hit needs u >= 0 & v >= 0 & u+v <= 1 & t > mint & t < maxt; the
//    result is the minimal t and, among equal minimal t, the lowest prim
//    (lexicographic (t, prim) updates; the visit order does not matter).
//    The reference keeps the first hit in its visit order instead;
//  - any hit: a ray stops at its first hit, and never lowers t (it culls
//    with maxt);
//  - lanes whose maxt <= mint (dead wavefront lanes carry maxt = -1) do no
//    work and come back unhit: t = 3e38 (F32_MAX), u = v = 0, prim = -1 /
//    not occluded;
//  - members at or above K are dropped before any slab read, so a table
//    of exactly K slabs (tri9) is never read past its end;
//  - prim = k*W + slot, the row of tri_shade.
// Precision: true fp32 throughout (the TPU's v4 runs its matmuls at
// Precision.DEFAULT).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRays = 64;        // rays per block
constexpr int kSuper = 128;      // clusters per supercluster
constexpr int kTile = 128;       // triangles per tile
constexpr int kMaxSupers = 4096; // ops/trace.MAX_SUPERS
constexpr float kF32Max = 3.0e38f;

// The reference's ray/box test of the box (lo, hi) against bound t for a
// ray with origin o, inverse direction inv and lower bound mint; tn is the
// entry distance.
__device__ __forceinline__ bool box_test(const float (&lo)[3],
                                         const float (&hi)[3],
                                         const float (&o)[3],
                                         const float (&inv)[3], float mint,
                                         float t, float& tn) {
  float tf = 0.0f;
  tn = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(lo[a], o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(hi[a], o[a]), inv[a]);
    const float mn = fminf(t0, t1), mx = fmaxf(t0, t1);
    tn = a == 0 ? mn : fmaxf(tn, mn);
    tf = a == 0 ? mx : fminf(tf, mx);
  }
  return (tn <= tf) & (tf >= mint) & (tn <= t) & (t >= mint);
}

// ---------------------------------------------------------------------
// The walk: lanes across triangles, each slab read once per block

constexpr int kWarps = 2;        // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 4;          // member boxes a lane holds per entry
constexpr int kSplit = kSuper / (32 * kPer);   // worklist items per entry
constexpr int kGroup = 64;       // rays a thread tests one supercluster on
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // no key / no prim

// Order-preserving bits of a float: a < b exactly when ord(a) < ord(b)
// (-0 orders below +0; callers canonicalise).
__device__ __forceinline__ unsigned ord(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// A block's rays.  om = (origin xyz, mint), im = (inverse direction xyz,
// maxt), fa | fb = the features (o x d, d); best = ord(t) << 32 | prim;
// live: maxt > mint and inside the batch; active: live and (any hit) not
// yet occluded.  One bit a ray, word r / 32.
struct BlockRays {
  float4 om[kRays];
  float4 im[kRays];
  float4 fa[kRays];
  float2 fb[kRays];
  unsigned long long best[kRays];
  unsigned live[kRays / 32];
  unsigned active[kRays / 32];
  int n_pending;
  int next_item;
};

__device__ __forceinline__ unsigned peek(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// ray r's culling bound: the high word of its best hit
__device__ __forceinline__ float bound_of(const BlockRays& sm, int r) {
  return unord(peek(reinterpret_cast<const unsigned*>(sm.best) + 2 * r + 1));
}

__device__ __forceinline__ bool is_active(const BlockRays& sm, int r) {
  return (peek(&sm.active[r >> 5]) >> (r & 31)) & 1u;
}

__device__ __forceinline__ bool ray_box(const float (&lo)[3],
                                        const float (&hi)[3],
                                        const float4& om, const float4& im,
                                        float t, float& tn) {
  const float o[3] = {om.x, om.y, om.z};
  const float inv[3] = {im.x, im.y, im.z};
  return box_test(lo, hi, o, inv, om.w, t, tn);
}

__device__ __forceinline__ void super_box(const float* __restrict__ sbounds,
                                          int S, int s, float (&lo)[3],
                                          float (&hi)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(sbounds + a * S + s);
    hi[a] = __ldg(sbounds + (a + 3) * S + s);
  }
}

__device__ __forceinline__ void member_box(const float* __restrict__ members,
                                           int s, int m, float (&lo)[3],
                                           float (&hi)[3]) {
  const float* b = members + (size_t)s * 8 * kSuper + m;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(b + (a + 1) * kSuper);
    hi[a] = __ldg(b + (a + 4) * kSuper);
  }
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The divide-first linear-MT test of one triangle from its 22 coefficients
// (cd | cu | cv: det, u, v against fa; ct: t against (o, 1)).
__device__ __forceinline__ bool mt_hit(const float (&cd)[6],
                                       const float (&cu)[6],
                                       const float (&cv)[6],
                                       const float (&ct)[4],
                                       const float (&fa)[6],
                                       const float (&o)[3], float mint,
                                       float maxt, float& t, float& u,
                                       float& v) {
  float det = __fmul_rn(fa[0], cd[0]);
  float un = __fmul_rn(fa[0], cu[0]);
  float vn = __fmul_rn(fa[0], cv[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    det = fmaf(fa[k], cd[k], det);
    un = fmaf(fa[k], cu[k], un);
    vn = fmaf(fa[k], cv[k], vn);
  }
  float tn = __fmul_rn(o[0], ct[0]);
  tn = fmaf(o[1], ct[1], tn);
  tn = fmaf(o[2], ct[2], tn);
  tn = __fadd_rn(tn, ct[3]);
  const float inv = __frcp_rn(det);
  u = __fmul_rn(un, inv);
  v = __fmul_rn(vn, inv);
  t = __fmul_rn(tn, inv);
  return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
         (t > mint) & (t < maxt);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float e) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, e));
}

// The pairwise Moeller-Trumbore test of one triangle from its tri9 rows
// c = v0, e1, e2 xyz (ops/intersect._mt, each step one _rn intrinsic).
__device__ __forceinline__ bool tri9_hit(const float (&c)[9],
                                         const float (&o)[3],
                                         const float (&d)[3], float mint,
                                         float maxt, float& t, float& u,
                                         float& v) {
  const float px = cross_term(d[1], c[8], d[2], c[7]);
  const float py = cross_term(d[2], c[6], d[0], c[8]);
  const float pz = cross_term(d[0], c[7], d[1], c[6]);
  const float det = dot3(c[3], c[4], c[5], px, py, pz);
  // |det| <= 1e-12 never hits; 1 in its place keeps the division off
  // its slow path for 0 (every padding slot) and subnormals
  const bool big = fabsf(det) > 1e-12f;
  const float inv_det = __fdiv_rn(1.0f, big ? det : 1.0f);
  const float tx = __fsub_rn(o[0], c[0]);
  const float ty = __fsub_rn(o[1], c[1]);
  const float tz = __fsub_rn(o[2], c[2]);
  u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = cross_term(ty, c[5], tz, c[4]);
  const float qy = cross_term(tz, c[3], tx, c[5]);
  const float qz = cross_term(tx, c[4], ty, c[3]);
  v = __fmul_rn(dot3(d[0], d[1], d[2], qx, qy, qz), inv_det);
  t = __fmul_rn(dot3(c[6], c[7], c[8], qx, qy, qz), inv_det);
  return big & (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
         (t > mint) & (t < maxt);
}

// Slab policies.  Each gives the walk: Tile, the registers of one lane's
// four triangles 4l..4l+3 of a 128-triangle tile (one float4 a row); Ray,
// what its test reads of a ray; lane(), the lane's first float of cluster
// k; load(), the tile at c (lane pointer + tile offset); hit(), the test
// of the lane's triangle q; retest(), the test of triangle `slot` of
// cluster k read from device memory (step 4); kBlocksPerSm and
// kAnyBlocksPerSm, the blocks an SM its closest-hit and any-hit
// instantiations are bounded to (65,536 / (64 x blocks) registers a
// thread).

// v4: mt_slabs [K+3, 8, 4W]; row f of the 8 holds at 0, W, 2W, 3W the det,
// u, v coefficients against fa = (o x d, d) (f < 6) and t's against (o, 1)
// (f < 4).
struct MtSlab {
  static constexpr int kBlocksPerSm = 8, kAnyBlocksPerSm = 8;   // 128 regs
  struct Tile {
    float4 cd[6], cu[6], cv[6], ct[4];
  };
  struct Ray {
    float fa[6], o[3];
  };

  __device__ static const float* lane(const float* slabs, int k, int W,
                                      int l) {
    return slabs + (size_t)k * 8 * (4 * (size_t)W) + 4 * l;
  }

  __device__ static void load(Tile& x, const float* c, int W) {
    const size_t row = 4 * (size_t)W;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      x.cd[f] = load4(c + f * row);
      x.cu[f] = load4(c + f * row + W);
      x.cv[f] = load4(c + f * row + 2 * W);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) x.ct[f] = load4(c + f * row + 3 * W);
  }

  __device__ static Ray ray(const BlockRays& sm, int r, const float4& om) {
    const float4 fa4 = sm.fa[r];
    const float2 fb2 = sm.fb[r];
    return Ray{{fa4.x, fa4.y, fa4.z, fa4.w, fb2.x, fb2.y},
               {om.x, om.y, om.z}};
  }

  __device__ static bool hit(const Tile& x, int q, const Ray& r, float mint,
                             float maxt, float& t, float& u, float& v) {
    float d6[6], u6[6], v6[6], t4[4];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      d6[f] = comp(x.cd[f], q);
      u6[f] = comp(x.cu[f], q);
      v6[f] = comp(x.cv[f], q);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) t4[f] = comp(x.ct[f], q);
    return mt_hit(d6, u6, v6, t4, r.fa, r.o, mint, maxt, t, u, v);
  }

  __device__ static void retest(const float* slabs, int k, int slot, int W,
                                const Ray& r, float mint, float maxt,
                                float& u, float& v) {
    const size_t row = 4 * (size_t)W;
    const float* c = slabs + (size_t)k * 8 * row + slot;
    float cd[6], cu[6], cv[6], ct[4];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      cd[f] = __ldg(c + f * row);
      cu[f] = __ldg(c + f * row + W);
      cv[f] = __ldg(c + f * row + 2 * W);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) ct[f] = __ldg(c + f * row + 3 * W);
    float t;
    mt_hit(cd, cu, cv, ct, r.fa, r.o, mint, maxt, t, u, v);
  }
};

// v2: tri9 [K', 16, W]; rows 0-8 = v0, e1, e2 xyz of the W slots (rows
// 9-15 are not read).
struct Tri9Slab {
  // any hit: 80 registers (24 B of spills) and 12 blocks an SM measured
  // 1-5% faster than 8 blocks; closest hits 1-6% slower at 10-16
  static constexpr int kBlocksPerSm = 8, kAnyBlocksPerSm = 12;
  struct Tile {
    float4 c[9];
  };
  struct Ray {
    float o[3], d[3];
  };

  __device__ static const float* lane(const float* tri9, int k, int W,
                                      int l) {
    return tri9 + (size_t)k * 16 * W + 4 * l;
  }

  __device__ static void load(Tile& x, const float* c, int W) {
#pragma unroll
    for (int f = 0; f < 9; ++f) x.c[f] = load4(c + f * (size_t)W);
  }

  __device__ static Ray ray(const BlockRays& sm, int r, const float4& om) {
    const float dx = sm.fa[r].w;
    const float2 fb2 = sm.fb[r];
    return Ray{{om.x, om.y, om.z}, {dx, fb2.x, fb2.y}};
  }

  __device__ static bool hit(const Tile& x, int q, const Ray& r, float mint,
                             float maxt, float& t, float& u, float& v) {
    float c[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) c[f] = comp(x.c[f], q);
    return tri9_hit(c, r.o, r.d, mint, maxt, t, u, v);
  }

  __device__ static void retest(const float* tri9, int k, int slot, int W,
                                const Ray& r, float mint, float maxt,
                                float& u, float& v) {
    const float* p = tri9 + (size_t)k * 16 * W + slot;
    float c[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) c[f] = __ldg(p + f * (size_t)W);
    float t;
    tri9_hit(c, r.o, r.d, mint, maxt, t, u, v);
  }
};

// Per-warp counts of the optional `stats`; without kCount (the main path)
// they compile away and hold no registers.
enum { kSweeps, kReads, kEntered };
template <bool kCount>
struct Visits {
  unsigned c[3] = {0, 0, 0};
  __device__ __forceinline__ void add(int i) {
    if constexpr (kCount) ++c[i];
  }
};

// Cluster k against every ray of `rays` (bit r = ray r of the block): its
// triangles, 128 at a time, are read once and every listed ray still
// active whose bound still reaches the member box (lo, hi) is tested.
template <class Slab, bool kAnyHit, typename Counts>
__device__ __forceinline__ void sweep(BlockRays& sm,
                                      const float* __restrict__ table,
                                      int k, int W, unsigned long long rays,
                                      const float (&lo)[3],
                                      const float (&hi)[3], Counts& n) {
  const int lane = threadIdx.x & 31;
  const float* slab = Slab::lane(table, k, W, lane);
  // The listed rays that still need the member; no read at all when none
  // is left.  Any hit: those not occluded since (their bound is maxt, as
  // when they were listed).  Closest hit, lanes over rays: those whose
  // bound, which may have fallen since, still reaches the box.
  unsigned long long left = 0ull;
#pragma unroll
  for (int h = 0; h < kRays / 32; ++h) {
    unsigned stays;
    if constexpr (kAnyHit) {
      stays = peek(&sm.active[h]);
    } else {
      const int r = 32 * h + lane;
      float tn;
      stays = __ballot_sync(kFull, ray_box(lo, hi, sm.om[r], sm.im[r],
                                           bound_of(sm, r), tn));
    }
    left |= (unsigned long long)stays << (32 * h);
  }
  left &= rays;
  if (!left) return;
  n.add(kReads);
  for (int j0 = 0; j0 < W; j0 += kTile) {
    typename Slab::Tile x;
    Slab::load(x, slab + j0, W);
    for (unsigned long long bits = left; bits; bits &= bits - 1) {
      const int r = __ffsll((long long)bits) - 1;
      if (kAnyHit && !is_active(sm, r)) continue;
      const float4 om = sm.om[r];
      const float maxt = sm.im[r].w;
      n.add(kSweeps);
      const typename Slab::Ray ray = Slab::ray(sm, r, om);
      bool any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float t, u, v;
        if (Slab::hit(x, q, ray, om.w, maxt, t, u, v)) {
          if constexpr (kAnyHit) {
            any = true;
          } else {
            const unsigned p = (unsigned)(k * W + j0 + 4 * lane + q);
            atomicMin(&sm.best[r],
                      ((unsigned long long)ord(__fadd_rn(t, 0.0f)) << 32) |
                          p);
          }
        }
      }
      if (kAnyHit && any) atomicAnd(&sm.active[r >> 5], ~(1u << (r & 31)));
    }
  }
}

// one of kPer warp-uniformly indexed values, without dynamic indexing
template <typename T>
__device__ __forceinline__ T pick(const T (&x)[kPer], int j) {
  T out = x[0];
#pragma unroll
  for (int c = 1; c < kPer; ++c) out = j == c ? x[c] : out;
  return out;
}

template <class Slab, bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kThreads, kAnyHit ? Slab::kAnyBlocksPerSm
                                                    : Slab::kBlocksPerSm)
walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ mint, const float* __restrict__ maxt,
            const float* __restrict__ table,
            const float* __restrict__ sbounds,
            const float* __restrict__ members, int n_rays, int K, int S,
            int W, float* __restrict__ t_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int32_t* __restrict__ prim_out,
            uint8_t* __restrict__ occ_out,
            unsigned long long* __restrict__ stats) {
  // S sorted entries (key bits << 32 | index; first the S keys), then the
  // S compacted ones
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* sorted = reinterpret_cast<unsigned long long*>(smem);
  unsigned* keys = reinterpret_cast<unsigned*>(smem);
  unsigned long long* list = sorted + S;
  __shared__ BlockRays sm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kRays;

  // 0. the block's rays
  for (int r = tid; r < kRays; r += kThreads) {   // whole warps
    const int i = base + r;
    const bool in = i < n_rays;
    const int ii = in ? i : n_rays - 1;
    const float ox = o[3 * ii], oy = o[3 * ii + 1], oz = o[3 * ii + 2];
    const float dx = d[3 * ii], dy = d[3 * ii + 1], dz = d[3 * ii + 2];
    const float mn = mint[ii], mx = maxt[ii];
    const float dd[3] = {dx, dy, dz};
    float inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      inv[a] = fabsf(dd[a]) > 1e-12f ? __fdiv_rn(1.0f, dd[a]) : 1e30f;
    sm.om[r] = make_float4(ox, oy, oz, mn);
    sm.im[r] = make_float4(inv[0], inv[1], inv[2], mx);
    sm.fa[r] = make_float4(
        __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy)),
        __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz)),
        __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx)), dx);
    sm.fb[r] = make_float2(dy, dz);
    sm.best[r] = ((unsigned long long)ord(mx) << 32) | kNone;
    const unsigned alive = __ballot_sync(kFull, in && mx > mn);
    if (lane == 0) sm.live[r >> 5] = sm.active[r >> 5] = alive;
  }
  for (int s = tid; s < S; s += kThreads) keys[s] = kNone;
  if (tid == 0) {
    sm.n_pending = 0;
    sm.next_item = 0;
  }
  __syncthreads();

  // 1. the block's key of each supercluster: the least max(tn, 0) over the
  // rays that enter it against maxt (a key is a non-negative float, so its
  // bits order as the floats do)
  for (int unit = tid; unit < S * (kRays / kGroup); unit += kThreads) {
    const int g = unit / S, s = unit - g * S;
    float lo[3], hi[3];
    super_box(sbounds, S, s, lo, hi);
    unsigned kmin = kNone;
#pragma unroll 8
    for (int r = g * kGroup; r < (g + 1) * kGroup; ++r) {
      const float4 om = sm.om[r], im = sm.im[r];
      float tn;
      if (ray_box(lo, hi, om, im, im.w, tn) &
          ((sm.live[r >> 5] >> (r & 31)) & 1u))
        kmin = min(kmin, __float_as_uint(tn > 0.0f ? tn : 0.0f));
    }
    if (kmin != kNone) atomicMin(&keys[s], kmin);
  }
  __syncthreads();

  // 2. compact the entries some ray enters, then rank-sort them
  for (int s0 = warp * 32; s0 < S; s0 += kThreads) {
    const int s = s0 + lane;
    const unsigned key = s < S ? keys[s] : kNone;
    const unsigned pend = __ballot_sync(kFull, key != kNone);
    int at = 0;
    if (lane == 0 && pend) at = atomicAdd(&sm.n_pending, __popc(pend));
    at = __shfl_sync(kFull, at, 0);
    if (key != kNone)
      list[at + __popc(pend & ((1u << lane) - 1u))] =
          ((unsigned long long)key << 32) | (unsigned)s;
  }
  __syncthreads();
  const int n_entries = sm.n_pending;
  for (int a = tid; a < n_entries; a += kThreads) {
    const unsigned long long e = list[a];
    int rank = 0;
    for (int b = 0; b < n_entries; ++b) rank += list[b] < e;
    sorted[rank] = e;
  }
  __syncthreads();

  // 3. the walk: a warp an item (kSuper / kSplit members of one entry),
  // near to far, no block barrier
  Visits<kCount> n;
  const int n_items = n_entries * kSplit;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&sm.next_item, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_items) break;
    const unsigned long long ent = sorted[item / kSplit];
    const int m0 = (item % kSplit) * (32 * kPer);
    const float key = __uint_as_float((unsigned)(ent >> 32));
    const int s = (int)(ent & 0xffffffffull);
    float lo[3], hi[3];
    super_box(sbounds, S, s, lo, hi);

    // lanes over rays: who enters the supercluster against its current t
    unsigned long long entering = 0ull;
    unsigned far = 0u;   // bits of the largest max(t, 0) of an active ray
    bool some = false;
#pragma unroll
    for (int h = 0; h < kRays / 32; ++h) {
      const int r = 32 * h + lane;
      const bool act = is_active(sm, r);
      const float t = bound_of(sm, r);
      float tn;
      const unsigned enter = __ballot_sync(
          kFull, act && ray_box(lo, hi, sm.om[r], sm.im[r], t, tn));
      entering |= (unsigned long long)enter << (32 * h);
      if (act) far = max(far, __float_as_uint(fmaxf(t, 0.0f)));
      some |= act;
    }
    // no ray left, or this entry and every later one beyond all of them
    if (!__any_sync(kFull, some) ||
        key > __uint_as_float(__reduce_max_sync(kFull, far)))
      break;
    if (!entering) continue;
    n.add(kEntered);

    // lanes over boxes: each member's list of rays
    float mlo[kPer][3], mhi[kPer][3];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      member_box(members, s, m0 + 32 * j + lane, mlo[j], mhi[j]);
    unsigned long long list_of[kPer];
    unsigned near[kPer];   // the member's key: the least max(tn, 0)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      list_of[j] = 0ull;
      near[j] = kNone;
    }
    for (unsigned long long bits = entering; bits; bits &= bits - 1) {
      const int r = __ffsll((long long)bits) - 1;
      const float4 om = sm.om[r], im = sm.im[r];
      const float t = bound_of(sm, r);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float tn;
        if (ray_box(mlo[j], mhi[j], om, im, t, tn)) {
          list_of[j] |= 1ull << r;
          near[j] = min(near[j], __float_as_uint(tn > 0.0f ? tn : 0.0f));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (s * kSuper + m0 + 32 * j + lane >= K) near[j] = kNone;

    // lanes over triangles: each entered member's slab, read once, the
    // nearest member first
    for (;;) {
      unsigned mine = near[0];
#pragma unroll
      for (int j = 1; j < kPer; ++j) mine = min(mine, near[j]);
      const unsigned next = __reduce_min_sync(kFull, mine);
      if (next == kNone) break;
      const int owner = __ffs(__ballot_sync(kFull, mine == next)) - 1;
      int j = 0;
#pragma unroll
      for (int c = kPer - 1; c > 0; --c) j = near[c] == next ? c : j;
      j = near[0] == next ? 0 : j;
      j = __shfl_sync(kFull, j, owner);
      const unsigned long long rays =
          __shfl_sync(kFull, pick(list_of, j), owner);
      if (lane == owner) {
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          if (c == j) near[c] = kNone;
      }
      const int m = m0 + 32 * j + owner;
      float blo[3], bhi[3];
      member_box(members, s, m, blo, bhi);
      sweep<Slab, kAnyHit>(sm, table, s * kSuper + m, W, rays, blo,
                           bhi, n);
    }
  }
  if constexpr (kCount) {
    if (lane == 0)
      for (int c = 0; c < 3; ++c)
        atomicAdd(stats + c, (unsigned long long)n.c[c]);
  }
  __syncthreads();

  // 4. results
  for (int r = tid; r < kRays && base + r < n_rays; r += kThreads) {
    const int i = base + r;
    if constexpr (kAnyHit) {
      occ_out[i] = ((sm.live[r >> 5] & ~sm.active[r >> 5]) >> (r & 31)) & 1u;
    } else {
      const unsigned long long b = sm.best[r];
      const unsigned p = (unsigned)(b & 0xffffffffull);
      float t = kF32Max, u = 0.0f, v = 0.0f;
      if (p != kNone) {
        const int k = (int)(p / (unsigned)W), slot = (int)(p % (unsigned)W);
        const float4 om = sm.om[r];
        Slab::retest(table, k, slot, W, Slab::ray(sm, r, om), om.w,
                     sm.im[r].w, u, v);
        t = unord((unsigned)(b >> 32));
      }
      t_out[i] = t;
      u_out[i] = u;
      v_out[i] = v;
      prim_out[i] = (int32_t)p;
    }
  }
}

// ---------------------------------------------------------------------
// Host side

template <class Slab, bool kAnyHit, bool kCount>
int launch(const float* o, const float* d, const float* mint,
           const float* maxt, const float* table, const float* sbounds,
           const float* members, int n_rays, int K, int S, int W, float* t,
           float* u, float* v, int32_t* prim, uint8_t* occ,
           unsigned long long* stats, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (S < 1 || S > kMaxSupers || K < 1 || K > S * kSuper || W < kTile ||
      W % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * (size_t)S * sizeof(unsigned long long);
  auto kernel = walk_kernel<Slab, kAnyHit, kCount>;
  if (smem + sizeof(BlockRays) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n_rays + kRays - 1) / kRays, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, mint, maxt, table, sbounds, members, n_rays, K, S, W, t, u, v,
      prim, occ, stats);
  return static_cast<int>(cudaGetLastError());
}

template <class Slab>
int closest(const float* o, const float* d, const float* mint,
            const float* maxt, const float* table, const float* sbounds,
            const float* members, int n_rays, int K, int S, int W, float* t,
            float* u, float* v, int32_t* prim, unsigned long long* stats,
            void* stream) {
  return (stats ? launch<Slab, false, true> : launch<Slab, false, false>)(
      o, d, mint, maxt, table, sbounds, members, n_rays, K, S, W, t, u, v,
      prim, nullptr, stats, stream);
}

template <class Slab>
int occluded(const float* o, const float* d, const float* mint,
             const float* maxt, const float* table, const float* sbounds,
             const float* members, int n_rays, int K, int S, int W,
             uint8_t* occ, unsigned long long* stats, void* stream) {
  return (stats ? launch<Slab, true, true> : launch<Slab, true, false>)(
      o, d, mint, maxt, table, sbounds, members, n_rays, K, S, W, nullptr,
      nullptr, nullptr, nullptr, occ, stats, stream);
}

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns a CUDA error code
// (cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// window, cluster or supercluster count the kernels do not take).
// table: mt_slabs (mt_*) or tri9 (tri9_*); sbounds [6, S] and members
// [S, 8, 128], the SoA box tables; stats: null (the kernel without
// counters) or three uint64 counters the kernel adds its visits to
// (Visits).
extern "C" int mt_closest(const float* o, const float* d, const float* mint,
                          const float* maxt, const float* slabs,
                          const float* sbounds, const float* members,
                          int n_rays, int K, int S, int W, float* t, float* u,
                          float* v, int32_t* prim, unsigned long long* stats,
                          void* stream) {
  return closest<MtSlab>(o, d, mint, maxt, slabs, sbounds, members, n_rays, K,
                         S, W, t, u, v, prim, stats, stream);
}

extern "C" int mt_occluded(const float* o, const float* d, const float* mint,
                           const float* maxt, const float* slabs,
                           const float* sbounds, const float* members,
                           int n_rays, int K, int S, int W, uint8_t* occ,
                           unsigned long long* stats, void* stream) {
  return occluded<MtSlab>(o, d, mint, maxt, slabs, sbounds, members, n_rays,
                          K, S, W, occ, stats, stream);
}

extern "C" int tri9_closest(const float* o, const float* d, const float* mint,
                            const float* maxt, const float* tri9,
                            const float* sbounds, const float* members,
                            int n_rays, int K, int S, int W, float* t,
                            float* u, float* v, int32_t* prim,
                            unsigned long long* stats, void* stream) {
  return closest<Tri9Slab>(o, d, mint, maxt, tri9, sbounds, members, n_rays,
                           K, S, W, t, u, v, prim, stats, stream);
}

extern "C" int tri9_occluded(const float* o, const float* d,
                             const float* mint, const float* maxt,
                             const float* tri9, const float* sbounds,
                             const float* members, int n_rays, int K, int S,
                             int W, uint8_t* occ, unsigned long long* stats,
                             void* stream) {
  return occluded<Tri9Slab>(o, d, mint, maxt, tri9, sbounds, members, n_rays,
                            K, S, W, occ, stats, stream);
}
