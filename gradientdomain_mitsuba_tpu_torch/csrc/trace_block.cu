// Block-cooperative closest-hit and any-hit traversal of the clustered
// triangle soup: the v4 and v2 kernels.
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
// Both take rays o [N,3], d [N,3], mint [N], maxt [N], cluster bounds
// cbounds [K,6] and supercluster bounds sbounds [S,6] (ops/trace.
// _super_bounds: 128 consecutive clusters each), all f32 and contiguous.
// W is a runtime multiple of 128 (at most ops/trace.MAX_WINDOW), S at most
// kMaxSupers.
//
// What bounds it on an H100: reading triangle slabs.  A pending cluster
// costs its 22 x W linear-MT coefficients (11 KB at W = 128; 9 x W, 4.5 KB,
// for v2) against ~50 flops per (ray, triangle), and the forest's slab
// table is ten times the 50 MB L2.  The warp-per-ray kernels of trace.cu
// read a cluster's slab once per ray that enters it.  Design here: ONE
// BLOCK OF 64 CONSECUTIVE RAYS (the reference's MT_RBLK), one thread per
// ray, stages each pending cluster once per block:
//  1. every ray tests the S supercluster boxes against its maxt; a block
//     entry per supercluster holds (min over the rays that enter it of
//     max(tn, 0), index), reduced with shared-memory atomicMin.  This
//     takes the place of _super_worklists;
//  2. the block sorts its S entries in shared memory (bitonic, next power
//     of two of S, ascending (key, index); non-pending entries sort last);
//  3. it walks the pending superclusters near to far, and stops as soon as
//     the next entry's key exceeds every live ray's current t (the
//     reference's early exit; a ray's t is its closest hit so far, or maxt;
//     an occluded any-hit ray is no longer live).  For each supercluster
//     each ray tests the 128 member boxes against its current t; the
//     block ORs the per-ray member bits, and for each member some ray
//     enters, in ascending member order, the block stages the member's
//     triangles in shared-memory TILES of 128 triangles (v4: slab rows
//     0-5 of the det|u|v columns and rows 0-3 of the t columns, 11 KB; v2:
//     tri9 rows 0-8, 4.5 KB), double-buffered with cp.async (the TPU
//     kernel's DEPTH = 8 DMA ring), so shared memory does not grow with W.
//     Every thread whose ray enters the member (re-tested against its
//     current t) sweeps its ray over the tile: all threads read the same
//     triangle at once (a broadcast, no bank conflict).
// The cost of the design is block-union dilution: a member some ray of the
// block enters is staged for all 64, and threads whose ray does not enter
// it idle through the sweep.  Coherent camera rays share most members;
// bounce rays of one block share few (the reference measured the pending
// union of a 64-ray block at 16-42x the per-ray set).
// Every thread runs every loop of the walk: trip counts come from shared
// memory and the early exit from __syncthreads_or, so a block whose rays
// all died (or all missed) still meets every barrier together.  Nothing of
// the TPU form is carried over: no worklist DMA chunks, SMEM scalar walks,
// masked-iota lane extraction or ring of slab semaphores.
//
// Semantics held exactly (the plain versions compute the same values):
//  - boxes: inv = |d| > 1e-12 ? 1/d : 1e30 (IEEE division), per axis
//    (lo - o)*inv and (hi - o)*inv, tn = max of the minima, tf = min of
//    the maxima; pending = tn <= tf & tf >= mint & tn <= t & t >= mint,
//    the reference's expressions.  A member box lies inside its
//    supercluster box, so a ray entering a member enters its supercluster
//    (each slab bound is computed from the same floats).  The same
//    supercluster -> member culling therefore serves v2, which the TPU
//    culls per cluster: it keeps every cluster a ray enters;
//  - v4 triangles, as trace.cu: inv = 1/det, u = u_num*inv, v = v_num*inv,
//    t = t_num*inv, with the same fmaf chains in feature order; det == 0
//    (all-zero padding columns) cannot pass and is skipped.  So v4's hits
//    equal v7's bit for bit;
//  - v2 triangles, ops/intersect._mt in one fixed order of _rn
//    intrinsics: products rounded once, crosses a*b - c*d, three-term dots
//    (x0 + x1) + x2, inv_det = 1/det where |det| > 1e-12;
//  - a hit needs u >= 0 & v >= 0 & u+v <= 1 & t > mint & t < maxt; the
//    result is the minimal t and, among equal minimal t, the lowest prim
//    (lexicographic (t, prim) updates; the visit order does not matter).
//    The reference keeps the first hit in its visit order instead;
//  - any hit: a ray stops at its first hit, and never lowers t (it culls
//    with maxt);
//  - lanes whose maxt <= mint (dead wavefront lanes carry maxt = -1) do no
//    work and come back unhit: t = 3e38 (F32_MAX), u = v = 0, prim = -1 /
//    not occluded;
//  - prim = k*W + lane, the row of tri_shade.
// Precision: true fp32 throughout (the TPU's v4 runs its matmuls at
// Precision.DEFAULT).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRays = 64;        // rays (threads) per block
constexpr int kSuper = 128;      // clusters per supercluster
constexpr int kTile = 128;       // triangles per staged tile
constexpr int kMaxSupers = 4096; // sort buffer: 32 KB of shared memory
constexpr float kF32Max = 3.0e38f;
constexpr unsigned long long kNoEntry = ~0ull;

struct Ray {
  float o[3], d[3], inv[3];
  float fa[6];   // (o x d, d): v4's det | u | v features
  float mint, maxt;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ mint,
                                        const float* __restrict__ maxt,
                                        int i) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[3 * i + a];
    r.d[a] = d[3 * i + a];
    r.inv[a] = fabsf(r.d[a]) > 1e-12f ? __fdiv_rn(1.0f, r.d[a]) : 1e30f;
  }
  r.fa[0] = __fsub_rn(__fmul_rn(r.o[1], r.d[2]), __fmul_rn(r.o[2], r.d[1]));
  r.fa[1] = __fsub_rn(__fmul_rn(r.o[2], r.d[0]), __fmul_rn(r.o[0], r.d[2]));
  r.fa[2] = __fsub_rn(__fmul_rn(r.o[0], r.d[1]), __fmul_rn(r.o[1], r.d[0]));
  r.fa[3] = r.d[0];
  r.fa[4] = r.d[1];
  r.fa[5] = r.d[2];
  r.mint = mint[i];
  r.maxt = maxt[i];
  return r;
}

// The reference's ray/box test of box b = (min xyz, max xyz) against bound
// t; tn is the entry distance.
__device__ __forceinline__ bool box_entry(const float* __restrict__ b,
                                          const Ray& r, float t, float& tn) {
  float tf = 0.0f;
  tn = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(__ldg(b + a), r.o[a]), r.inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(__ldg(b + 3 + a), r.o[a]), r.inv[a]);
    const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
    tn = a == 0 ? lo : fmaxf(tn, lo);
    tf = a == 0 ? hi : fminf(tf, hi);
  }
  return (tn <= tf) & (tf >= r.mint) & (tn <= t) & (t >= r.mint);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copies rows of 128 floats into a [kRows][kTile] tile, 16 bytes per
// cp.async; src_row(row) is the row's first float in device memory.
template <int kRows, typename SrcRow>
__device__ __forceinline__ void stage_rows(float* tile, SrcRow src_row) {
  for (int c = threadIdx.x; c < kRows * (kTile / 4); c += kRays) {
    const int row = c / (kTile / 4);
    const int q = (c % (kTile / 4)) * 4;
    cp_async16(tile + row * kTile + q, src_row(row) + q);
  }
}

// v4: divide-first linear MT over mt_slabs.  Tile rows 0-5 / 6-11 / 12-17
// hold the det / u / v coefficients of slab rows 0-5, rows 18-21 the t
// coefficients of slab rows 0-3.
struct MtTest {
  static constexpr int kRows = 22;

  __device__ static void stage(float* tile, const float* __restrict__ table,
                               int k, int W, int j0) {
    const float* slab = table + (size_t)k * 8 * 4 * W + j0;
    stage_rows<kRows>(tile, [&](int row) {
      const int g = row < 18 ? row / 6 : 3;
      const int r = row < 18 ? row % 6 : row - 18;
      return slab + (size_t)r * 4 * W + (size_t)g * W;
    });
  }

  __device__ static bool hit(const float* tile, int j, const Ray& r,
                             float& t, float& u, float& v) {
    const float* c = tile + j;
    float det = __fmul_rn(r.fa[0], c[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) det = fmaf(r.fa[k], c[k * kTile], det);
    if (det == 0.0f) return false;
    float un = __fmul_rn(r.fa[0], c[6 * kTile]);
    float vn = __fmul_rn(r.fa[0], c[12 * kTile]);
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      un = fmaf(r.fa[k], c[(6 + k) * kTile], un);
      vn = fmaf(r.fa[k], c[(12 + k) * kTile], vn);
    }
    float tn = __fmul_rn(r.o[0], c[18 * kTile]);
    tn = fmaf(r.o[1], c[19 * kTile], tn);
    tn = fmaf(r.o[2], c[20 * kTile], tn);
    tn = __fadd_rn(tn, c[21 * kTile]);
    const float inv = __fdiv_rn(1.0f, det);
    u = __fmul_rn(un, inv);
    v = __fmul_rn(vn, inv);
    t = __fmul_rn(tn, inv);
    return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
           (t > r.mint) & (t < r.maxt);
  }
};

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float e) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, e));
}

// v2: pairwise Moeller-Trumbore over tri9.  Tile rows 0-8 = v0, e1, e2 xyz.
struct Tri9Test {
  static constexpr int kRows = 9;

  __device__ static void stage(float* tile, const float* __restrict__ table,
                               int k, int W, int j0) {
    const float* slab = table + (size_t)k * 16 * W + j0;
    stage_rows<kRows>(tile, [&](int row) { return slab + (size_t)row * W; });
  }

  __device__ static bool hit(const float* tile, int j, const Ray& r,
                             float& t, float& u, float& v) {
    const float* c = tile + j;
    const float v0x = c[0], v0y = c[kTile], v0z = c[2 * kTile];
    const float e1x = c[3 * kTile], e1y = c[4 * kTile], e1z = c[5 * kTile];
    const float e2x = c[6 * kTile], e2y = c[7 * kTile], e2z = c[8 * kTile];
    const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
    const float px = cross_term(dy, e2z, dz, e2y);
    const float py = cross_term(dz, e2x, dx, e2z);
    const float pz = cross_term(dx, e2y, dy, e2x);
    const float det = dot3(e1x, e1y, e1z, px, py, pz);
    if (!(fabsf(det) > 1e-12f)) return false;
    const float inv_det = __fdiv_rn(1.0f, det);
    const float tx = __fsub_rn(r.o[0], v0x);
    const float ty = __fsub_rn(r.o[1], v0y);
    const float tz = __fsub_rn(r.o[2], v0z);
    u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv_det);
    const float qx = cross_term(ty, e1z, tz, e1y);
    const float qy = cross_term(tz, e1x, tx, e1z);
    const float qz = cross_term(tx, e1y, ty, e1x);
    v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
    t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
    return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
           (t > r.mint) & (t < r.maxt);
  }
};

// first set bit of the 128-bit mask b at or after `from`, else kSuper
__device__ __forceinline__ int next_bit(const unsigned (&b)[4], int from) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned w = b[q];
    if (from >= 32 * q + 32) w = 0u;
    else if (from > 32 * q) w &= ~0u << (from - 32 * q);
    if (w) return 32 * q + __ffs(w) - 1;
  }
  return kSuper;
}

__device__ __forceinline__ bool has_bit(const unsigned (&b)[4], int m) {
  unsigned w = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) w = (m >> 5) == q ? b[q] : w;
  return (w >> (m & 31)) & 1u;
}

// (member, tile) jobs in ascending order: the next tile, else the first
// tile of the next pending member
__device__ __forceinline__ void advance(const unsigned (&b)[4], int& m,
                                        int& tile, int n_tiles) {
  if (++tile == n_tiles) {
    tile = 0;
    m = next_bit(b, m + 1);
  }
}

template <class Test, bool kAnyHit>
__global__ void __launch_bounds__(kRays)
block_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ mint, const float* __restrict__ maxt,
             const float* __restrict__ table,
             const float* __restrict__ cbounds,
             const float* __restrict__ sbounds, int n_rays, int K, int S,
             int P2, int W, float* __restrict__ t_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             int32_t* __restrict__ prim_out, uint8_t* __restrict__ occ_out) {
  constexpr int kTileFloats = Test::kRows * kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);   // two tiles
  unsigned long long* order = reinterpret_cast<unsigned long long*>(
      smem + 2 * kTileFloats * sizeof(float));     // P2 entries
  __shared__ unsigned mbits[2][4];   // member union, by supercluster parity
  __shared__ int n_pending;

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kRays + tid;
  const Ray r = load_ray(o, d, mint, maxt, i < n_rays ? i : n_rays - 1);
  const bool live = i < n_rays && r.maxt > r.mint;
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bp = -1;
  bool done = false;   // any hit: occluded

  // 1. the block's supercluster entries (key bits << 32 | index); a key is
  // a non-negative float, so its bits order as the floats do
  for (int e = tid; e < P2; e += kRays)
    order[e] = e < S ? (0xffffffffull << 32) | (unsigned)e : kNoEntry;
  if (tid < 8) mbits[tid >> 2][tid & 3] = 0u;
  if (tid == 0) n_pending = 0;
  __syncthreads();
  if (live) {
    int s = tid % S;   // threads start at different entries
    for (int c = 0; c < S; ++c) {
      float tn;
      if (box_entry(sbounds + 6 * (size_t)s, r, r.maxt, tn)) {
        const float key = tn > 0.0f ? tn : 0.0f;
        atomicMin(&order[s],
                  ((unsigned long long)__float_as_uint(key) << 32) |
                      (unsigned)s);
      }
      if (++s == S) s = 0;
    }
  }
  __syncthreads();

  // 2. bitonic sort, ascending; entries no ray enters sort last
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int a = tid; a < P2; a += kRays) {
        const int b = a ^ j;
        if (b > a) {
          const unsigned long long x = order[a], y = order[b];
          if ((x > y) == ((a & k) == 0)) {
            order[a] = y;
            order[b] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int a = tid; a < P2; a += kRays) {
    const bool pa = (order[a] >> 32) != 0xffffffffull;
    const bool pb = a + 1 < P2 && (order[a + 1] >> 32) != 0xffffffffull;
    if (pa && !pb) n_pending = a + 1;
  }
  __syncthreads();
  const int count = n_pending;
  const int n_tiles = W / kTile;

  // 3. the walk, near to far
  for (int e = 0; e < count; ++e) {
    const unsigned long long ent = order[e];
    const float key = __uint_as_float((unsigned)(ent >> 32));
    const int s = (int)(ent & 0xffffffffull);
    const float cull = (!kAnyHit && bp >= 0) ? bt : r.maxt;
    const bool active = live && !done;
    if (!__syncthreads_or(active && key <= fmaxf(cull, 0.0f))) break;

    // this ray's pending members, against its current t
    unsigned my[4] = {0u, 0u, 0u, 0u};
    float tn;
    if (active && box_entry(sbounds + 6 * (size_t)s, r, cull, tn)) {
      const int k0 = s * kSuper;
      const int nm = min(kSuper, K - k0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned w = 0u;
        for (int b = 0; b < 32; ++b) {
          const int m = 32 * q + b;
          if (m < nm &&
              box_entry(cbounds + 6 * (size_t)(k0 + m), r, cull, tn))
            w |= 1u << b;
        }
        my[q] = w;
      }
    }
    unsigned* mb = mbits[e & 1];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (my[q]) atomicOr(&mb[q], my[q]);
    if (tid < 4) mbits[(e + 1) & 1][tid] = 0u;   // the next entry's union
    __syncthreads();
    unsigned bits[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bits[q] = mb[q];

    // stage (member, tile) jobs one ahead of the sweep
    int lm = next_bit(bits, 0), lt = 0;
    int cm = lm, ct = 0, buf = 0;
    if (lm < kSuper) Test::stage(tiles, table, s * kSuper + lm, W, 0);
    cp_async_commit();
    advance(bits, lm, lt, n_tiles);
    bool sweep = false;
    while (cm < kSuper) {
      if (lm < kSuper)
        Test::stage(tiles + (buf ^ 1) * kTileFloats, table, s * kSuper + lm,
                    W, lt * kTile);
      cp_async_commit();
      advance(bits, lm, lt, n_tiles);
      cp_async_wait_one();
      __syncthreads();
      const int k = s * kSuper + cm;
      if (ct == 0) {
        const float c2 = (!kAnyHit && bp >= 0) ? bt : r.maxt;
        sweep = live && !done && has_bit(my, cm) &&
                box_entry(cbounds + 6 * (size_t)k, r, c2, tn);
      }
      if (sweep) {
        const float* tile = tiles + buf * kTileFloats;
        const int p0 = k * W + ct * kTile;
        for (int j = 0; j < kTile; ++j) {
          float t, u, v;
          if (Test::hit(tile, j, r, t, u, v)) {
            if (kAnyHit) {
              done = true;
              break;
            }
            const int p = p0 + j;
            if (t < bt || (t == bt && (unsigned)p < (unsigned)bp)) {
              bt = t;
              bu = u;
              bv = v;
              bp = p;
            }
          }
        }
        if (done) sweep = false;
      }
      __syncthreads();   // the tile is free before it is staged again
      buf ^= 1;
      advance(bits, cm, ct, n_tiles);
    }
  }

  if (i < n_rays) {
    if (kAnyHit) {
      occ_out[i] = done ? 1 : 0;
    } else {
      const bool hit = bp >= 0;
      t_out[i] = hit ? bt : kF32Max;
      u_out[i] = hit ? bu : 0.0f;
      v_out[i] = hit ? bv : 0.0f;
      prim_out[i] = hit ? bp : -1;
    }
  }
}

template <class Test, bool kAnyHit>
int launch(const float* o, const float* d, const float* mint,
           const float* maxt, const float* table, const float* cbounds,
           const float* sbounds, int n_rays, int K, int S, int W, float* t,
           float* u, float* v, int32_t* prim, uint8_t* occ, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (S < 1 || S > kMaxSupers || K < 1 || W < kTile || W % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  int P2 = 1;
  while (P2 < S) P2 <<= 1;
  const size_t smem = 2 * Test::kRows * kTile * sizeof(float) +
                      P2 * sizeof(unsigned long long);
  auto kernel = block_kernel<Test, kAnyHit>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n_rays + kRays - 1) / kRays, kRays, smem,
           static_cast<cudaStream_t>(stream)>>>(o, d, mint, maxt, table,
                                                cbounds, sbounds, n_rays, K, S,
                                                P2, W, t, u, v, prim, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns a CUDA error code
// (cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// window, cluster or supercluster count the kernels do not take).
#define GDMT_BLOCK_ENTRY(NAME, TEST)                                          \
  extern "C" int NAME##_closest(                                              \
      const float* o, const float* d, const float* mint, const float* maxt,   \
      const float* table, const float* cbounds, const float* sbounds,         \
      int n_rays, int K, int S, int W, float* t, float* u, float* v,          \
      int32_t* prim, void* stream) {                                          \
    return launch<TEST, false>(o, d, mint, maxt, table, cbounds, sbounds,     \
                               n_rays, K, S, W, t, u, v, prim, nullptr,       \
                               stream);                                       \
  }                                                                           \
  extern "C" int NAME##_occluded(                                             \
      const float* o, const float* d, const float* mint, const float* maxt,   \
      const float* table, const float* cbounds, const float* sbounds,         \
      int n_rays, int K, int S, int W, uint8_t* occ, void* stream) {          \
    return launch<TEST, true>(o, d, mint, maxt, table, cbounds, sbounds,      \
                              n_rays, K, S, W, nullptr, nullptr, nullptr,     \
                              nullptr, occ, stream);                          \
  }

GDMT_BLOCK_ENTRY(mt, MtTest)
GDMT_BLOCK_ENTRY(tri9, Tri9Test)
