"""A/B timings of design variants of the v7 pair kernels, of the v4 or v2
block kernels or of the sweep kernels on one NVIDIA card.

    python3 tools/torch_pair_variants.py [--kernel pair|mt|tri9|sweep]
                                         [--parent DIR] [--variants A,B]
                                         [--json PATH]

--kernel pair (the default) builds the port's csrc/trace.cu as it is ("new")
and variants made from it by text substitution, one nvcc each, all started
together, into the git-ignored
gradientdomain_mitsuba_tpu_torch/_build/variants/:
  blocks8   one ray a warp in blocks of 8 warps (no persistent warps)
  blocks2   the same in blocks of 2 warps
  persist4  persistent warps in blocks of 4 warps
  idorder   superclusters and members visited in ascending id (the keys
            are the ids, so nothing stops the walk early)
  farfirst  superclusters and members visited far to near (largest entry
            first; meant for the any hit, which stops only at its first
            hit anyway)
  strided   lane l sweeps triangles l, l+32, l+64, l+96 with scalar loads
            instead of 4l..4l+3 as float4s
  regs80    __launch_bounds__(256, 3): at most 80 registers (spills), three
            blocks an SM
  div       1.0f / det by __fdiv_rn instead of __frcp_rn
  take1, take16  a warp takes 1 (16) consecutive rays from the counter at
            a time instead of 4
and one probe, timed but not checked (its results are not the kernel's):
  probe_supers  the walk ends after the supercluster box tests: the cost of
            taking and loading the rays, testing S boxes a ray and writing
            the (missed) results
--kernel mt builds csrc/trace_block.cu ("new") and, of its v4 kernels
(mt_closest, mt_occluded), each design step undone or changed once:
  noreuse   no slab reuse across rays: a member's slab is loaded again
            for every ray of its list (one warp a (ray, member) pair)
  bitonic   the block's S entries sorted whole by a bitonic network (next
            power of two of S, a barrier a stage) instead of compacted and
            rank-sorted
  aos       boxes read from cbounds [K, 6] and supercluster bounds [S, 6]
            instead of the SoA tables
  split2, split4  a worklist item is 64 (32) members of an entry, two (one)
            boxes a lane, instead of all 128 with four
  warps8, warps4, warps1  blocks of 8, 4, 1 warps (two, four, sixteen an
            SM) instead of 2 (eight an SM)
  persist   persistent blocks (as many as fit the card at once, each
            striding over the batch) instead of one block per 64 rays
  idjobs    an item's members swept in ascending id instead of nearest
            first
  guard     1/det taken of 1 where det == 0 (padding columns), with
            det != 0 ANDed into the hit, instead of __frcp_rn's slow path
            for 0
  rays32    blocks of 32 rays and 1 warp, sixteen an SM
  regs100   ten blocks an SM: at most 100 registers
  regs80    twelve blocks an SM: at most 80 registers (spills)
  group8, group16  a thread tests one supercluster box on 8 (16) of the
            block's rays instead of all 64 when the block's keys are built
and two probes, timed but not checked (their results are not the
kernel's):
  probe_sort   the kernel ends once the block's worklist is sorted: rays
            loaded, S boxes a ray tested, entries compacted and sorted
  probe_lists  the walk builds every member's list of rays but sweeps
            none (no hit lowers a t, so more entries are entered)
The step "lanes across triangles instead of one thread a ray" is undone
by the parent: the kernel of the commit before the redesign.
--kernel tri9 builds csrc/trace_block.cu ("new") and, of its v2 kernels
(tri9_closest, tri9_occluded; the Tri9Slab instantiations of the walk):
  noguard   the reciprocal taken of every det, 0 included (its slow path
            on every padding slot), instead of 1 where |det| <= 1e-12
  rcp       1/det by __frcp_rn instead of __fdiv_rn
  branch    the test returns early where |det| <= 1e-12 (the PR 3 test's
            branch) instead of ANDing the predicate into the hit
  per8      8 triangles a lane: half-warp h takes every other ray of the
            list, lane l of it triangles 8(l mod 16)..+7 of the tile (two
            float4s a row, 72 registers) instead of 4 triangles a lane
  any8      the v2 any-hit instantiations bounded to 8 blocks an SM (at
            most 128 registers a thread), as the closest-hit ones are,
            instead of 12 (80)
  blocks10, blocks12, blocks16  both v2 queries bounded to 10 (12, 16)
            blocks an SM, at most 96 (80, 64) registers a thread
and the parent is the PR 3 walk (one thread a ray, tiles staged in shared
memory for the block's union of clusters), which takes cbounds and [S, 6]
supercluster bounds.  Its batches are the forest's (below, on tri9 slabs
built on the card by ops/trace.tri9_from_soup) and random soups of K = 300
clusters at W = 128 and 256 with 1,048,576 rays
(ops/trace.random_cluster_soup); the render is not run (no render path
launches v2).
--kernel sweep builds csrc/sweep.cu (sweep_closest, sweep_occluded) and:
  threads128, threads512, threads1024  blocks of 128 / 512 / 1,024 threads
            (rays) instead of 256
  persist   persistent blocks (at most 2,048 threads an SM, each block
            striding over the batch) instead of one block per 256 rays
  div       1/det by __fdiv_rn instead of __frcp_rn
  branch    the dense design's `det == 0` branch put back
  cull      closest hit: t first, u and v only where t could win
  tma       the table staged by one cp.async.bulk (TMA) copy completed on
            an mbarrier instead of float4 loads by every thread
  unroll4   the record loop unrolled four times
  lanes     lanes across records: a warp's rays in turn, lane l testing
            records l, l+32, ... held in registers (at most 128 records;
            larger tables are skipped), hits merged by a warp minimum of
            (order-preserving t bits, prim)
and the parent (with --parent) is the dense 40-coefficient design.  Each build is
held against "new" bit for bit (t, u, v, prim, occluded; a zero may differ
in its sign) and timed in turns (CUDA events, 10 launches after 2
warm-ups) on 1,048,576 cbox camera and shadow rays (chip_smoke.cbox_rays),
random soups of T = 36, 130 and 2,048 triangles at 1,048,576 rays, and
the calls of one pass of the cbox render (chip_smoke.render_calls).  With
--parent the cbox G-PT render 256x256, 64 spp, maxDepth 6 + L1 runs
through the parent kernels and the new ones in turns (parent, new, new,
parent, five times over: ten walls each), its buffers, final and rays at
the same seed must be identical, and one more render of each runs under
torch.profiler (device busy time against the wall, the sweeps' device
time).
With --parent DIR (an unpacked checkout of another commit, such as one
from `git archive`) it also builds that checkout's source ("parent", with
this interface or the older one that took cbounds and [S, 6] supercluster
bounds).  On the forest's 1,048,576 camera, shadow and bounce rays
(chip_smoke.forest_rays), in random order and in the render's raster
order, every build is held against "new" bit for bit, its walk is counted
by the kernels' counting instantiation (pair: swept clusters and
superclusters whose members were tested; mt: (ray, tile) sweeps, (block,
cluster) slab reads and worklist entries entered; per live ray; not for
the parent or a probe), and all are timed in turns (parent, variants,
variants reversed, parent; CUDA events, 5 launches after one warm-up,
through the instantiation the main path launches).  With --kernel mt,
"new" and the parent are also timed with the GDMT_RAY_SORT sort around
them (sort and unsort included).  With --parent the forest render 256x256,
16 spp, maxDepth 5 (under GDMT_KERNEL=v4 for mt) is then timed through the
parent kernels and the new ones in turns (parent, new, new, parent, five
times over; host clock after a warm-up render, ended by a synchronise),
the images must be identical, and one more render of each runs under
torch.profiler: the device's busy time (the sum of its kernels' times)
against that render's wall, and the traversal kernels' share.  Prints the
card's name and power limit; with --json, also writes every number to
PATH.
Imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gradientdomain_mitsuba_tpu_torch import native  # noqa: E402
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec  # noqa: E402
from gradientdomain_mitsuba_tpu_torch.ops import sweep  # noqa: E402
from gradientdomain_mitsuba_tpu_torch.ops import trace  # noqa: E402

BUILD = os.path.join(native.BUILD_DIR, "variants")
KERNEL = "pair_kernel"
# per --kernel: the source, its C entry points, the text only this
# interface's source holds, the counters' names, the device kernels'
# names in a profile and the GDMT_KERNEL the render runs under
MODES = {
    "pair": dict(src=trace._SRC, fns=("pair_closest", "pair_occluded"),
                 marker="int* next_ray", counts=("swept", "supers"),
                 profile=("pair_",), env=None),
    "mt": dict(src=trace._BLOCK_SRC, fns=("mt_closest", "mt_occluded"),
               marker="const float* members",
               counts=("sweeps", "reads", "entered"),
               profile=("walk_kernel", "mt_kernel", "block_kernel"),
               env="v4"),
    "tri9": dict(src=trace._BLOCK_SRC, fns=("tri9_closest", "tri9_occluded"),
                 marker="Tri9Slab", counts=("sweeps", "reads", "entered"),
                 profile=None, env=None),
    "sweep": dict(src=sweep._SRC, fns=("sweep_closest", "sweep_occluded")),
}


def sub(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"variant anchor not found once: {old!r}")
    return src.replace(old, new)


def one_ray_a_warp(src, warps):
    src = sub(src, "    if (left == 0) {\n"
                   "      int first = 0;\n"
                   "      if (lane == 0) first = atomicAdd(next_ray, "
                   "kRaysPerTake);\n"
                   "      next = __shfl_sync(kFull, first, 0);\n"
                   "      left = kRaysPerTake;\n"
                   "    }\n"
                   "    const int i = next++;\n"
                   "    --left;\n"
                   "    if (i >= n_rays) break;   // whole warp\n",
              "    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
              "    if (i >= n_rays || left) break;\n"
              "    left = 1;\n")
    src = sub(src, "const int grid = per_sm * sms < needed ? per_sm * sms "
                   ": needed;", "const int grid = needed;")
    src = take(src, 1)
    return sub(src, "constexpr int kWarps = 8;",
               f"constexpr int kWarps = {warps};")


def take(src, n):
    return sub(src, "constexpr int kRaysPerTake = 4;",
               f"constexpr int kRaysPerTake = {n};")


def id_order(src):
    src = sub(src, "    const unsigned key = box_key(lo, hi, r, t);\n",
              "    const unsigned key = box_key(lo, hi, r, t) == kNone ? "
              "kNone : (unsigned)s;\n")
    return sub(src, "mk[q] = s * kSuper + 4 * lane + q < K ? "
                    "box_key(lo, hi, r, t) : kNone;",
               "mk[q] = s * kSuper + 4 * lane + q < K && "
               "box_key(lo, hi, r, t) != kNone ? (unsigned)(4 * lane + q) "
               ": kNone;")


def far_first(src):
    """Keys that order the pending boxes far to near (largest max(tn, 0)
    first); the walk then stops only when no box is left pending."""
    src = sub(src, "  return pending ? __float_as_uint(tn > 0.0f ? tn : 0.0f) "
                   ": kNone;",
              "  return pending ? 0x7f7fffffu - __float_as_uint(tn > 0.0f ? "
              "tn : 0.0f) : kNone;")
    return sub(src, "  return key == kNone || __uint_as_float(key) > "
                    "fmaxf(t, 0.0f);", "  return key == kNone;")


def probe_supers(src):
    anchor = "  for (;;) {\n    // 2. the nearest pending supercluster\n"
    return sub(src, anchor, "  if (lmin != 0xfffffffeu) return;\n" + anchor)


def strided(src):
    src = sub(src, "__device__ __forceinline__ float4 load4(const float* p) "
                   "{\n  return __ldg(reinterpret_cast<const float4*>(p));\n}",
              "__device__ __forceinline__ float4 load4(const float* p) {\n"
              "  return __ldg(reinterpret_cast<const float4*>(p));\n}\n"
              "__device__ __forceinline__ float4 load4s(const float* p) {\n"
              "  const float* b = p - 3 * (threadIdx.x & 31);\n"
              "  return make_float4(__ldg(b), __ldg(b + 32), __ldg(b + 64), "
              "__ldg(b + 96));\n}")
    for row in ("cd[k] = load4(", "cu[k] = load4(", "cv[k] = load4(",
                "ct[k] = load4("):
        src = sub(src, row, row.replace("load4", "load4s"))
    return sub(src, "const int p = k * W + j0 + 4 * lane + q;",
               "const int p = k * W + j0 + lane + 32 * q;")


SWEEP_CALL = ("      sweep<Slab, kAnyHit>(sm, table, s * kSuper + m, W, rays, "
              "blo,\n                           bhi, n);\n")


def no_reuse(src):
    """Each ray of a member's list loads the slab again: the pointer is
    made opaque to the compiler so the loads stay inside the loop."""
    return sub(src, SWEEP_CALL,
               "      for (unsigned long long one = rays; one; one &= one - 1) "
               "{\n"
               "        const float* again = table;\n"
               "        asm volatile(\"\" : \"+l\"(again));\n"
               "        sweep<Slab, kAnyHit>(sm, again, s * kSuper + m, W, "
               "one & (~one + 1), blo, bhi, n);\n"
               "      }\n")


BITONIC = """  // 2. (variant) the S entries sorted whole, bitonic, ascending
  {
    int P2 = 1;
    while (P2 < S) P2 <<= 1;
    unsigned mine[kMaxSupers / kThreads];
    for (int c = 0; c * kThreads + tid < S; ++c) mine[c] = keys[c * kThreads + tid];
    __syncthreads();
    for (int c = 0; c * kThreads + tid < P2; ++c) {
      const int e = c * kThreads + tid;
      sorted[e] = e < S && mine[c] != kNone
                      ? ((unsigned long long)mine[c] << 32) | (unsigned)e
                      : ~0ull;
      if (e < S && mine[c] != kNone) atomicAdd(&sm.n_pending, 1);
    }
    __syncthreads();
    for (int k = 2; k <= P2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int a = tid; a < P2; a += kThreads) {
          const int b = a ^ j;
          if (b > a) {
            const unsigned long long x = sorted[a], y = sorted[b];
            if ((x > y) == ((a & k) == 0)) {
              sorted[a] = y;
              sorted[b] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  const int n_entries = sm.n_pending;

"""


def bitonic(src):
    a = src.index("  // 2. compact the entries some ray enters")
    b = src.index("  // 3. the walk: a warp an item")
    return src[:a] + BITONIC + src[b:]


def aos(src):
    src = sub(src, "    lo[a] = __ldg(sbounds + a * S + s);\n"
                   "    hi[a] = __ldg(sbounds + (a + 3) * S + s);\n",
              "    lo[a] = __ldg(sbounds + 6 * s + a);\n"
              "    hi[a] = __ldg(sbounds + 6 * s + a + 3);\n")
    src = sub(src, "  const float* b = members + (size_t)s * 8 * kSuper + m;\n",
              "  const float* b = members + 6 * ((size_t)s * kSuper + m);\n")
    return sub(src, "    lo[a] = __ldg(b + (a + 1) * kSuper);\n"
                    "    hi[a] = __ldg(b + (a + 4) * kSuper);\n",
               "    lo[a] = __ldg(b + a);\n    hi[a] = __ldg(b + a + 3);\n")


def persistent(src):
    """As many blocks as fit the card at once, each striding over the
    batch's 64-ray blocks."""
    src = sub(src, "  const int base = blockIdx.x * kRays;\n",
              "  for (int blk = blockIdx.x; blk * kRays < n_rays; "
              "blk += gridDim.x) {\n  const int base = blk * kRays;\n")
    src = sub(src, "      prim_out[i] = (int32_t)p;\n    }\n  }\n}\n",
              "      prim_out[i] = (int32_t)p;\n    }\n  }\n"
              "  __syncthreads();\n  }\n}\n")
    return sub(src, "  kernel<<<(n_rays + kRays - 1) / kRays, kThreads, smem,\n",
               "  int sms = 0;\n"
               "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
               "0);\n"
               "  const int all = (n_rays + kRays - 1) / kRays;\n"
               "  kernel<<<all < sms * Slab::kBlocksPerSm ? all : sms * "
               "Slab::kBlocksPerSm, kThreads, smem,\n")


MT_BLOCKS = ("  static constexpr int kBlocksPerSm = 8, kAnyBlocksPerSm = 8;   "
             "// 128 regs\n")
TRI9_BLOCKS = ("  static constexpr int kBlocksPerSm = 8, kAnyBlocksPerSm = 12;"
               "\n")


def const(s, name, old, new):
    return sub(s, f"constexpr int {name} = {old};",
               f"constexpr int {name} = {new};")


def mt_variants(src):
    def blocks(s, warps, per_sm):
        """Blocks of `warps` warps, `per_sm` of them an SM (the registers
        a thread may hold follow: 65,536 / (32 * warps * per_sm))."""
        return sub(const(s, "kWarps", 2, warps), MT_BLOCKS,
                   MT_BLOCKS.replace("= 8", f"= {per_sm}"))
    return {
        "new": src,
        "noreuse": no_reuse(src),
        "bitonic": bitonic(src),
        "aos": aos(src),
        "split2": const(src, "kPer", 4, 2),
        "split4": const(src, "kPer", 4, 1),
        "warps8": blocks(src, 8, 2),
        "warps4": blocks(src, 4, 4),
        "warps1": blocks(src, 1, 16),
        "persist": persistent(src),
        "idjobs": sub(src, "          near[j] = min(near[j], __float_as_uint("
                           "tn > 0.0f ? tn : 0.0f));\n",
                      "          near[j] = (unsigned)(32 * j + lane);\n"),
        "rays32": const(const(blocks(src, 1, 16), "kRays", 64, 32), "kGroup",
                        64, 32),
        "guard": sub(sub(src, "  const float inv = __frcp_rn(det);\n",
                         "  const bool nz = det != 0.0f;\n"
                         "  const float inv = __frcp_rn(nz ? det : 1.0f);\n"),
                     "  return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) "
                     "<= 1.0f) &\n         (t > mint) & (t < maxt);\n",
                     "  return nz & (u >= 0.0f) & (v >= 0.0f) & "
                     "(__fadd_rn(u, v) <= 1.0f) &\n         (t > mint) & "
                     "(t < maxt);\n"),
        "regs100": blocks(src, 2, 10),
        "regs80": blocks(src, 2, 12),
        "group8": const(src, "kGroup", 64, 8),
        "group16": const(src, "kGroup", 64, 16),
        "probe_sort": sub(src, "  const int n_items = n_entries * kSplit;\n",
                          "  const int n_items = 0;\n"),
        "probe_lists": sub(src, SWEEP_CALL, ""),
    }


PER8 = """// (variant) 8 triangles a lane: half-warp h tests every other listed
// ray, lane l of it triangles 8(l mod 16)..8(l mod 16)+7 of the tile
template <class Slab, bool kAnyHit, typename Counts>
__device__ __forceinline__ void sweep8(BlockRays& sm,
                                       const float* __restrict__ table,
                                       int k, int W, unsigned long long rays,
                                       const float (&lo)[3],
                                       const float (&hi)[3], Counts& n) {
  if constexpr (!std::is_same<Slab, Tri9Slab>::value) {
    sweep<Slab, kAnyHit>(sm, table, k, W, rays, lo, hi, n);
  } else {
    const int lane = threadIdx.x & 31, half = lane >> 4, li = lane & 15;
    unsigned long long left = 0ull;
#pragma unroll
    for (int h = 0; h < kRays / 32; ++h) {
      unsigned stays;
      if constexpr (kAnyHit) {
        // one list for the whole warp: the halves pair its rays alike
        stays = __shfl_sync(kFull, peek(&sm.active[h]), 0);
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
    const float* slab = table + (size_t)k * 16 * W + 8 * li;
    for (int j0 = 0; j0 < W; j0 += kTile) {
      float4 a[9], b[9];
#pragma unroll
      for (int f = 0; f < 9; ++f) {
        a[f] = load4(slab + j0 + f * (size_t)W);
        b[f] = load4(slab + j0 + f * (size_t)W + 4);
      }
      for (unsigned long long bits = left; bits;) {
        const int r0 = __ffsll((long long)bits) - 1;
        bits &= bits - 1;
        int r1 = -1;
        if (bits) {
          r1 = __ffsll((long long)bits) - 1;
          bits &= bits - 1;
        }
        const bool a0 = !kAnyHit || is_active(sm, r0);
        const bool a1 = r1 >= 0 && (!kAnyHit || is_active(sm, r1));
        if (a0) n.add(kSweeps);
        if (a1) n.add(kSweeps);
        const int r = half ? r1 : r0;
        if (!(half ? a1 : a0)) continue;
        const float4 om = sm.om[r];
        const float maxt = sm.im[r].w;
        const Tri9Slab::Ray ray = Tri9Slab::ray(sm, r, om);
        bool any = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float c[9];
#pragma unroll
          for (int f = 0; f < 9; ++f) c[f] = comp(q < 4 ? a[f] : b[f], q & 3);
          float t, u, v;
          if (tri9_hit(c, ray.o, ray.d, om.w, maxt, t, u, v)) {
            if constexpr (kAnyHit) {
              any = true;
            } else {
              const unsigned p = (unsigned)(k * W + j0 + 8 * li + q);
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
}

"""


def tri9_variants(src):
    def blocks(s, closest, any_hit):
        return sub(s, TRI9_BLOCKS, TRI9_BLOCKS.replace("= 8,", f"= {closest},")
                   .replace("= 12;", f"= {any_hit};"))
    inv = "  const float inv_det = __fdiv_rn(1.0f, big ? det : 1.0f);\n"
    walk = "template <class Slab, bool kAnyHit, bool kCount>\n__global__"
    per8 = sub(sub(sub(src, walk, PER8 + walk), SWEEP_CALL,
                   SWEEP_CALL.replace("sweep<", "sweep8<")),
               "#include <stdint.h>\n", "#include <stdint.h>\n\n"
               "#include <type_traits>\n")
    return {
        "new": src,
        "noguard": sub(src, inv, inv.replace("big ? det : 1.0f", "det")),
        "rcp": sub(src, inv, inv.replace("__fdiv_rn(1.0f, ", "__frcp_rn(")),
        "branch": sub(src, inv, "  if (!big) return false;\n" + inv),
        "per8": per8,
        "any8": blocks(src, 8, 8),
        "blocks10": blocks(src, 10, 10),
        "blocks12": blocks(src, 12, 12),
        "blocks16": blocks(src, 16, 16),
    }


def variants(src):
    bounds = f"__launch_bounds__(kWarps * 32, 2)\n{KERNEL}"
    return {
        "new": src,
        "blocks8": one_ray_a_warp(src, 8),
        "blocks2": one_ray_a_warp(src, 2),
        "persist4": sub(src, "constexpr int kWarps = 8;",
                        "constexpr int kWarps = 4;"),
        "idorder": id_order(src),
        "farfirst": far_first(src),
        "strided": strided(src),
        "regs80": sub(src, bounds, bounds.replace(", 2)", ", 3)")),
        "div": sub(src, "const float inv = __frcp_rn(det);",
                   "const float inv = __fdiv_rn(1.0f, det);"),
        "take1": take(src, 1),
        "take16": take(src, 16),
        "probe_supers": probe_supers(src),
    }


SWEEP_LOOP = """      const Terms x = terms(sh + j * kRecord, r.f);
      const float inv = __frcp_rn(x.det);
      const float u = __fmul_rn(x.u, inv);
      const float v = __fmul_rn(x.v, inv);
      const float t = __fmul_rn(x.t, inv);
      const bool ok = (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                      (t > r.mint) & (t < r.maxt);
      if (ok && t < bt) {
"""

SWEEP_CULL = """      const Terms x = terms(sh + j * kRecord, r.f);
      const float inv = __frcp_rn(x.det);
      const float t = __fmul_rn(x.t, inv);
      if (!((t > r.mint) & (t < r.maxt) & (t < bt))) continue;
      const float u = __fmul_rn(x.u, inv);
      const float v = __fmul_rn(x.v, inv);
      if ((u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f)) {
"""

SWEEP_TMA = """// (variant) the table staged by one bulk copy (TMA) completed on
// an mbarrier
__device__ __forceinline__ void stage(float4* sh,
                                      const float4* __restrict__ recs,
                                      int n_rec) {
  __shared__ alignas(8) unsigned long long bar;
  const unsigned bytes = (unsigned)n_rec * kRecord * 16u;
  if (bytes == 0) return;
  const unsigned b = (unsigned)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"((unsigned)__cvta_generic_to_shared(sh)), "l"(recs),
           "r"(bytes), "r"(b) : "memory");
  }
  asm volatile("{\\n.reg .pred P1;\\nLAB_WAIT:\\n"
               "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\\n"
               "@P1 bra DONE;\\nbra LAB_WAIT;\\nDONE:\\n}\\n"
               :: "r"(b) : "memory");
}
"""

SWEEP_LANES = """// (variant) lanes across records: a warp's rays in turn, lane l
// testing records l, l + 32, ... held in registers; hits merged by a warp
// minimum of ord(t) << 32 | prim (t canonicalised: -0 -> +0)
constexpr int kHeld = 4;   // records a lane holds: at most 128 a table
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned ord(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ void hold(float4 (&x)[kHeld][kRecord],
                                     const float4* __restrict__ recs,
                                     int n_rec) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
    const int j = lane + 32 * h;
#pragma unroll
    for (int q = 0; q < kRecord; ++q)
      x[h][q] = j < n_rec ? __ldg(recs + j * kRecord + q)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kBlock)
sweep_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ mint,
                     const float* __restrict__ maxt,
                     const float4* __restrict__ recs, int n_rays, int n_rec,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int32_t* __restrict__ prim_out) {
  float4 x[kHeld][kRecord];
  hold(x, recs, n_rec);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Ray mine;
  bool live = false;
  if (i < n_rays) {
    mine = load_ray(o, d, mint, maxt, i);
    live = mine.maxt > mine.mint;
  }
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  for (unsigned todo = __ballot_sync(kFull, live); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    float f[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = __shfl_sync(kFull, mine.f[k], src);
    const float mn = __shfl_sync(kFull, mine.mint, src);
    const float mx = __shfl_sync(kFull, mine.maxt, src);
    unsigned long long best = ~0ull;
    float lu = 0.0f, lv = 0.0f;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      if (32 * h >= n_rec) break;
      const Terms y = terms(x[h], f);
      const float inv = __frcp_rn(y.det);
      const float u = __fmul_rn(y.u, inv);
      const float v = __fmul_rn(y.v, inv);
      const float t = __fmul_rn(y.t, inv);
      const bool ok = (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                      (t > mn) & (t < mx);
      const unsigned long long key =
          ((unsigned long long)ord(t == 0.0f ? 0.0f : t) << 32) |
          (unsigned)y.prim;
      if (ok && key < best) {
        best = key; lu = u; lv = v;
      }
    }
    unsigned long long m = best;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const unsigned long long y = __shfl_xor_sync(kFull, m, off);
      m = y < m ? y : m;
    }
    if (m != ~0ull) {
      const int who = __ffs(__ballot_sync(kFull, best == m)) - 1;
      const float wu = __shfl_sync(kFull, lu, who);
      const float wv = __shfl_sync(kFull, lv, who);
      if (lane == src) {
        bt = unord((unsigned)(m >> 32));
        bu = wu;
        bv = wv;
        bj = (int)(unsigned)m;
      }
    }
  }
  if (i < n_rays) {
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
                      const float4* __restrict__ recs, int n_rays, int n_rec,
                      uint8_t* __restrict__ occ_out) {
  float4 x[kHeld][kRecord];
  hold(x, recs, n_rec);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Ray mine;
  bool live = false;
  if (i < n_rays) {
    mine = load_ray(o, d, mint, maxt, i);
    live = mine.maxt > mine.mint;
  }
  bool hit = false;
  for (unsigned todo = __ballot_sync(kFull, live); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    float f[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = __shfl_sync(kFull, mine.f[k], src);
    const float mn = __shfl_sync(kFull, mine.mint, src);
    const float mx = __shfl_sync(kFull, mine.maxt, src);
    bool any = false;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      if (32 * h >= n_rec) break;
      const Terms y = terms(x[h], f);
      const float s = y.det > 0.0f ? 1.0f : -1.0f;
      const float ad = __fmul_rn(y.det, s);
      const float su = __fmul_rn(y.u, s);
      const float sv = __fmul_rn(y.v, s);
      const float st = __fmul_rn(y.t, s);
      any |= (su >= 0.0f) & (sv >= 0.0f) & (__fadd_rn(su, sv) <= ad) &
             (ad > 0.0f) & (st > __fmul_rn(mn, ad)) &
             (st < __fmul_rn(mx, ad));
    }
    const bool h = __any_sync(kFull, any);
    if (lane == src) hit = h;
  }
  if (i < n_rays) occ_out[i] = hit ? 1 : 0;
}

"""


def sweep_variants(src):
    def persist(s):
        for end in ("  prim_out[i] = bj;\n}\n",
                    "  occ_out[i] = hit ? 1 : 0;\n}\n"):
            s = sub(s, end, end[:-2] + "  }\n}\n")
        s = s.replace("  const int i = blockIdx.x * kBlock + threadIdx.x;\n"
                      "  if (i >= n_rays) return;\n",
                      "  for (int i = blockIdx.x * kBlock + threadIdx.x; "
                      "i < n_rays; i += gridDim.x * kBlock) {\n")
        return sub(s, "    kernel<<<(n_rays + kBlock - 1) / kBlock, "
                      "kBlock, smem,\n",
                   "    int sms = 0;\n"
                   "    cudaDeviceGetAttribute(&sms, "
                   "cudaDevAttrMultiProcessorCount, 0);\n"
                   "    const int all = (n_rays + kBlock - 1) / kBlock;\n"
                   "    const int most = 2048 / kBlock * sms;\n"
                   "    kernel<<<all < most ? all : most, kBlock, smem,\n")

    def replace_span(s, start, stop, text):
        a, b = s.index(start), s.index(stop)
        return s[:a] + text + s[b:]

    kernels = ("__global__ void __launch_bounds__(kBlock)\n"
               "sweep_closest_kernel")
    stage = "// The whole table into shared memory, once per block."
    launch = "// One launch of `kernel` over n_rays"

    def lanes(s):
        s = replace_span(s, stage, launch, SWEEP_LANES)
        smem = "  const int smem = n_rec * kRecord * (int)sizeof(float4);\n"
        return sub(s, smem, "  if (n_rec > 32 * kHeld) return 1;\n" + smem)

    return {
        "new": src,
        "threads128": const(src, "kBlock", 256, 128),
        "threads512": const(src, "kBlock", 256, 512),
        "threads1024": const(src, "kBlock", 256, 1024),
        "persist": persist(src),
        "div": sub(src, "const float inv = __frcp_rn(x.det);",
                   "const float inv = __fdiv_rn(1.0f, x.det);"),
        "branch": sub(sub(src, SWEEP_LOOP, SWEEP_LOOP.replace(
            "      const float inv", "      if (x.det == 0.0f) continue;\n"
            "      const float inv")),
            "      const float s = x.det > 0.0f",
            "      if (x.det == 0.0f) continue;\n"
            "      const float s = x.det > 0.0f"),
        "cull": sub(src, SWEEP_LOOP, SWEEP_CULL),
        "tma": replace_span(src, stage, kernels, SWEEP_TMA + "\n"),
        "unroll4": src.replace("    for (int j = 0; j < n_rec; ++j) {\n",
                               "#pragma unroll 4\n"
                               "    for (int j = 0; j < n_rec; ++j) {\n"),
        "lanes": lanes(src),
    }


def build(name, text):
    """nvcc with native.nvcc_command's flags plus -Xptxas=-v; returns
    (name, library path, ptxas register and spill lines, each after its
    kernel's mangled name)."""
    import subprocess
    path = os.path.join(BUILD, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    out = os.path.join(BUILD, f"lib{name}.so")
    cmd = native.nvcc_command([path], out)
    cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"building {name} failed:\n{res.stderr}")
    lines, entry = [], ""
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln:
            # the mangled kernel name: its template arguments tell the
            # instantiations apart (Lb1E / Lb0E: true / false)
            entry = ln.split("'")[1].split("_cu_")[-1][8:].split("EEv")[0]
        elif "registers" in ln or "spill" in ln:
            lines.append(f"{entry}: {ln.strip()}")
    return name, out, lines


def load(path, mode, new_interface):
    """ctypes bindings of a build's closest and any-hit entry points:
    this interface (SoA box tables, then pair: the ray counter and the
    visit counters, mt: the visit counters) or the older one (cbounds and
    [S, 6] supercluster bounds, no counters)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(path)
    tail = 0 if not new_interface else 2 if mode == "pair" else 1
    fns = [getattr(lib, name) for name in MODES[mode]["fns"]]
    fns[0].argtypes = [p] * 7 + [i] * 4 + [p] * (5 + tail)
    fns[1].argtypes = [p] * 7 + [i] * 4 + [p] * (2 + tail)
    fns[0].restype = fns[1].restype = ctypes.c_int
    return fns


def sweep_load(path):
    """ctypes bindings of a sweep build's closest and any-hit entry
    points (either interface: packed records and their count, or the dense
    kernels' linC and T)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(path)
    fns = [lib.sweep_closest, lib.sweep_occluded]
    fns[0].argtypes = [p] * 5 + [i, i] + [p] * 5
    fns[1].argtypes = [p] * 5 + [i, i] + [p] * 2
    fns[0].restype = fns[1].restype = ctypes.c_int
    return fns


def main_sweep(sources):
    """--kernel sweep: every build held against "new" bit for bit and
    timed in turns on the cbox, soup and render-pass batches; with a
    parent, the cbox render through both."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    log = cs.log
    t0 = time.time()
    built = []
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {name: pool.submit(build, name, text)
                for name, text in sources.items()}
        for name, fut in futs.items():
            try:
                built.append(fut.result())
            except RuntimeError as e:
                if name in ("new", "parent"):
                    raise
                log(f"variant {name} did not build, left out:\n{e}")
    log(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    libs, ptxas = {}, {}
    for name, path, lines in built:
        ptxas[name] = lines
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
        libs[name] = sweep_load(path)

    dev = torch.device("cuda:0")
    packed = {}

    def call(name, any_hit, rays, linC):
        """One launch of build `name`; None where the build does not take
        this table (the lanes variant above 128 records)."""
        N = rays[0].shape[0]
        if name == "parent":
            table, m = linC, linC.shape[1] // 4
        else:
            if id(linC) not in packed:
                packed[id(linC)] = (linC, sweep.pack_linear_mt(linC))
            table = packed[id(linC)][1]
            m = table.shape[0]
        if any_hit:
            outs = [torch.empty(N, dtype=torch.bool, device=dev)]
        else:
            t = torch.empty(N, device=dev)
            outs = [t, torch.empty_like(t), torch.empty_like(t),
                    torch.empty(N, dtype=torch.int32, device=dev)]
        err = libs[name][any_hit](
            *(x.data_ptr() for x in (*rays, table)), N, m,
            *(x.data_ptr() for x in outs),
            torch.cuda.current_stream().cuda_stream)
        if err:
            if name in ("new", "parent"):
                raise RuntimeError(f"{name}: CUDA error {err}")
            return None
        return outs

    scene_np, st = sc.load_scene(cs.CBOX, {
        "width": "256", "height": "256", "spp": "64", "maxDepth": "6",
        "integrator": "gpt"})
    scene = bridge.to_torch(scene_np, dev)
    linC = scene.geom.linC
    cam, shadow = cs.cbox_rays(scene, st, cs.N_TIMED, dev)
    calls, passes = cs.render_calls(scene, st)
    both = (False, True)
    batches = [("cbox camera", both, [(cam, linC)]),
               ("cbox shadow", both, [(shadow, linC)])]
    for T in (36, 130, 2048):
        *rays, table = (torch.from_numpy(a).to(dev) for a in
                        cs.sweep_soups().random_soup(T, cs.N_TIMED, T))
        batches.append((f"soup T={T}", both, [(rays, table)]))
    for any_hit in both:
        batches.append((f"render pass {'any' if any_hit else 'closest'}",
                        (any_hit,), [(r, linC) for a, r in calls
                                     if a == any_hit]))
    names = [n for n in libs if n != "parent"]
    order = (["parent"] if "parent" in libs else []) + names + names[::-1] \
        + (["parent"] if "parent" in libs else [])
    res = {"card": cs.card_line(), "ptxas": ptxas, "kernels": {},
           "render_passes": passes}
    for batch, queries, lst in batches:
        live = sum(int((r[3] > r[2]).sum()) for r, _ in lst)
        lanes = sum(r[0].shape[0] for r, _ in lst)
        for any_hit in queries:
            query = "any" if any_hit else "closest"
            refs = [call("new", any_hit, r, L) for r, L in lst]
            skip = set()
            for name in libs:
                for (r, L), ref in zip(lst, refs):
                    got = call(name, any_hit, r, L)
                    if got is None:
                        skip.add(name)
                        break
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                        cs.fail(f"{name} differs from new on {batch} {query}")
                res["kernels"][f"{batch}/{query}/{name}"] = dict(
                    ms=[], lanes=lanes, live=live, skipped=name in skip)
            for name in order:
                if name in skip:
                    continue
                res["kernels"][f"{batch}/{query}/{name}"]["ms"].append(
                    cs.cuda_ms(lambda: [call(name, any_hit, r, L)
                                        for r, L in lst], iters=10,
                               warmup=2))
            for name in libs:
                r = res["kernels"][f"{batch}/{query}/{name}"]
                log(f"{batch} {query} {name}: " + (
                    "skipped (table too large)" if r["skipped"] else
                    f"ms {', '.join(f'{x:.4f}' for x in r['ms'])}") +
                    f" ({len(lst)} calls, {lanes} lanes, {live} live)")
    if "parent" in libs:
        res["render"] = sweep_render(scene, st, call)
    log(cs.card_line())
    return res


def sweep_render(scene, st, call):
    """The cbox G-PT + L1 render through the parent sweep kernels and the
    new ones, in turns: walls, identical buffers, final and rays, and one
    profiled render of each (the sweeps' device ms inside it)."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    log = cs.log
    real = sweep.SweepKernel.__call__

    def parent_call(k, o, d, mint, maxt, linC):
        k.launches += 1
        out = call("parent", k.any_hit, (o, d, mint, maxt), linC)
        return out[0] if k.any_hit else isec.Hit(*out, valid=out[3] >= 0)

    impl = {"parent": parent_call, "new": real}
    tracer = GPTracer(scene, st)
    tracer.count_rays = True

    def render(name):
        sweep.SweepKernel.__call__ = impl[name]
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            final, bufs = tracer.render_final(scene, 1, st.spp, alpha=0.2,
                                              mode="L1")
            torch.cuda.synchronize()
            return time.time() - t0, final, bufs
        finally:
            sweep.SweepKernel.__call__ = real

    render("new")   # warm-up
    walls = {"parent": [], "new": []}
    outs = {}
    for name in ("parent", "new", "new", "parent") * 5:
        wall, final, bufs = render(name)
        walls[name].append(wall)
        outs[name] = (final, bufs)
    diffs = {k: float((outs["parent"][1][k] - outs["new"][1][k]).abs().max())
             for k in ("primal", "dx", "dy", "very_direct")}
    diffs["final"] = float((outs["parent"][0] - outs["new"][0]).abs().max())
    rays = [int(outs[n][1]["rays"]) for n in ("parent", "new")]
    for name, w in walls.items():
        log(f"cbox render 256x256 64spp maxDepth 6 + L1 through {name}: "
            f"walls (s) {', '.join(f'{x:.4f}' for x in w)}; median "
            f"{sorted(w)[len(w) // 2]:.4f}")
    log(f"  rays {rays}; max |parent - new| {diffs}")
    if rays[0] != rays[1] or any(diffs[k] != 0.0 for k in
                                 ("primal", "dx", "dy", "very_direct")):
        cs.fail("the parent and new renders differ")

    profiled = {}
    for name in ("parent", "new"):
        sweep.SweepKernel.__call__ = impl[name]
        try:
            p = cs.profiled_render(lambda: tracer.render_final(
                scene, 1, st.spp, alpha=0.2, mode="L1"), "sweep_")
        finally:
            sweep.SweepKernel.__call__ = real
        profiled[name] = p
        log(f"  profiled render through {name}: device busy "
            f"{p['busy_ms']:.3f} ms of {p['wall_ms']:.3f} ms wall (idle "
            f"{100 * (1 - p['busy_ms'] / p['wall_ms']):.1f}%), sweeps "
            f"{p['kernel_ms']:.3f} ms over {p['kernel_calls']} launches, "
            f"{p['device_ops']} device ops")
    return dict(walls=walls, rays=rays, max_abs_diff=diffs,
                profiled=profiled)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(MODES), default="pair",
                    help="the kernels to vary: the v7 pair kernels, the "
                    "v4 or v2 block kernels or the sweep kernels")
    ap.add_argument("--parent", help="an unpacked checkout of another "
                    "commit whose kernels to time beside these")
    ap.add_argument("--variants", help="comma-separated names: build only "
                    "these variants besides new (default: all)")
    ap.add_argument("--json", help="a file to write the results to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs an NVIDIA "
                "card")
    log = cs.log
    log(cs.card_line())
    os.makedirs(BUILD, exist_ok=True)
    mode = MODES[args.kernel]
    with open(mode["src"]) as f:
        sources = {"pair": variants, "mt": mt_variants,
                   "tri9": tri9_variants,
                   "sweep": sweep_variants}[args.kernel](f.read())
    if args.variants is not None:
        keep = {"new", *filter(None, args.variants.split(","))}
        if keep - set(sources):
            cs.fail(f"unknown variants {sorted(keep - set(sources))}")
        sources = {n: src for n, src in sources.items() if n in keep}
    if args.parent:
        with open(os.path.join(args.parent, "gradientdomain_mitsuba_tpu_"
                               "torch", "csrc",
                               os.path.basename(mode["src"]))) as f:
            sources["parent"] = f.read()
    if args.kernel == "sweep":
        write_json(args.json, main_sweep(sources))
        return
    new_iface = {name: mode["marker"] in src
                 for name, src in sources.items()}
    t0 = time.time()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda kv: build(*kv), sources.items()))
    log(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    libs = {}
    ptxas = {}
    for name, path, lines in built:
        ptxas[name] = lines
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
        libs[name] = load(path, args.kernel, new_iface[name])

    dev = torch.device("cuda:0")
    scene, st, _ = cs.load_forest(dev)
    g = scene.geom
    W = st.cluster_window
    if args.kernel == "tri9":
        forest = soup_tables(trace.tri9_from_soup(g.tris, W), g.cbounds, W)
    else:
        forest = soup_tables(g.mt_slabs, g.cbounds, W)
    n_counts = len(mode["counts"])

    def call(name, any_hit, rays, soup, stats=None):
        N = rays[0].shape[0]
        if any_hit:
            outs = [torch.empty(N, dtype=torch.bool, device=dev)]
        else:
            t = torch.empty(N, device=dev)
            outs = [t, torch.empty_like(t), torch.empty_like(t),
                    torch.empty(N, dtype=torch.int32, device=dev)]
        fn = libs[name][any_hit]
        stream = torch.cuda.current_stream().cuda_stream
        if new_iface[name]:
            tabs = soup["aos"][::-1] if name == "aos" else soup["soa"]
            extra = [None if stats is None else stats.data_ptr()]
            if args.kernel == "pair":
                extra.insert(0, torch.zeros(1, dtype=torch.int32,
                                            device=dev).data_ptr())
        else:
            tabs, extra = soup["aos"], []
        err = fn(*(x.data_ptr() for x in (*rays, soup["table"], *tabs)),
                 N, soup["K"], soup["S"], soup["W"],
                 *(x.data_ptr() for x in outs), *extra, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return outs

    names = ("camera", "shadow", "bounce")
    batches = [(name, rays, forest) for name, rays in zip(
        names, cs.forest_rays(scene, st, cs.N_TIMED, dev))]
    batches += [(f"{name} raster", rays, forest) for name, rays in zip(
        names, cs.forest_rays(scene, st, cs.N_TIMED, dev, raster=True))]
    if args.kernel == "tri9":
        for w in (128, 256):
            o, d, mint, maxt, _, cb, _, tri9 = (
                torch.from_numpy(a).to(dev)
                for a in trace.random_cluster_soup(300, w, w, cs.N_TIMED))
            batches.append((f"soup K=300 W={w}", (o, d, mint, maxt),
                            soup_tables(tri9, cb, w)))
    names = [n for n in libs if n != "parent"]
    order = (["parent"] if "parent" in libs else []) + names + names[::-1] \
        + (["parent"] if "parent" in libs else [])
    res = {"card": cs.card_line(), "ptxas": ptxas, "kernels": {}}
    for batch, rays, soup in batches:
        live = int((rays[3] > rays[2]).sum())
        for any_hit in (False, True):
            query = "any" if any_hit else "closest"
            ref = call("new", any_hit, rays, soup)
            for name in libs:
                got = call(name, any_hit, rays, soup)
                stats = torch.zeros(n_counts, dtype=torch.int64, device=dev)
                probe = name.startswith("probe_")
                if new_iface[name] and not probe:
                    call(name, any_hit, rays, soup, stats)
                torch.cuda.synchronize()
                if not probe and not all(torch.equal(a, b)
                                         for a, b in zip(got, ref)):
                    cs.fail(f"{name} differs from new on {batch} {query}")
                res["kernels"][f"{batch}/{query}/{name}"] = dict(
                    zip(mode["counts"], (x / live for x in stats.tolist())),
                    ms=[], sorted_ms=[])
            for name in order:
                res["kernels"][f"{batch}/{query}/{name}"]["ms"].append(
                    cs.cuda_ms(lambda: call(name, any_hit, rays, soup),
                               iters=5, warmup=1))
            if args.kernel == "mt":      # with the GDMT_RAY_SORT sort around
                box = (g.cbounds[:, 0:3].amin(0), g.cbounds[:, 3:6].amax(0))

                def sorted_run(name):
                    def fn(*srt):
                        out = call(name, any_hit, srt, soup)
                        return out[0] if any_hit else isec.Hit(
                            *out, valid=out[3] >= 0)
                    return trace.sorted_call(fn, any_hit, *rays, *box)
                turns = [n for n in ("parent", "new") if n in libs]
                for name in turns + turns[::-1]:
                    got = sorted_run(name)
                    same = (torch.equal(got, ref[0]) if any_hit else all(
                        torch.equal(a, b) for a, b in zip(got, ref)))
                    if not same:
                        cs.fail(f"{name} with the ray sort differs from new "
                                f"on {batch} {query}")
                    res["kernels"][f"{batch}/{query}/{name}"][
                        "sorted_ms"].append(cs.cuda_ms(
                            lambda: sorted_run(name), iters=5, warmup=1))
            for name in libs:
                r = res["kernels"][f"{batch}/{query}/{name}"]
                log(f"{batch} {query} {name}: ms "
                    f"{', '.join(f'{x:.4f}' for x in r['ms'])}; per live "
                    "ray: " + ", ".join(f"{c} {r[c]:.3f}"
                                        for c in mode["counts"])
                    + ("; ray sort on: ms " + ", ".join(
                        f"{x:.4f}" for x in r["sorted_ms"])
                       if r["sorted_ms"] else ""))
    if "parent" in libs and mode["env"]:
        res["render"] = time_render(
            scene, st, lambda name, any_hit, rays: call(name, any_hit, rays,
                                                        forest), mode)
    log(cs.card_line())
    write_json(args.json, res)


def soup_tables(table, cbounds, window):
    """What a launch passes besides the rays: the slab table, the SoA box
    tables, the older interface's [S, 6] supercluster bounds and cbounds
    (padded to whole superclusters for the aos variant, which reads the
    padding members' boxes before it drops them), K, S and W."""
    K = cbounds.shape[0]
    soa = trace.make_pair_intersector(window, K).box_tables(cbounds)
    S = soa[0].shape[1]
    aos = (torch.cat([cbounds, cbounds.new_zeros(
        (S * trace.SUPER_FACTOR - K, 6))]),
        trace._super_bounds(cbounds).contiguous())
    return dict(table=table, soa=soa, aos=aos, K=K, S=S, W=window)


def write_json(path, res):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)


def time_render(scene, st, call, mode):
    """The forest render (under the mode's GDMT_KERNEL) through the parent
    kernels and the new ones, in turns; returns {"walls": {name: [s,
    ...]}, "rays", "identical", "profiled"}."""
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    launch = trace.TraversalKernel._launch

    def parent_launch(k, o, d, mint, maxt, table, cbounds, stats=None):
        k.launches += 1
        out = call("parent", k.any_hit, (o, d, mint, maxt))
        if k.any_hit:
            return out[0]
        return isec.Hit(*out, valid=out[3] >= 0)

    from torch.profiler import ProfilerActivity, profile
    saved = os.environ.get("GDMT_KERNEL")
    if mode["env"]:
        os.environ["GDMT_KERNEL"] = mode["env"]
    try:
        tracer = PathTracer(scene, st)
    finally:
        if mode["env"]:
            if saved is None:
                del os.environ["GDMT_KERNEL"]
            else:
                os.environ["GDMT_KERNEL"] = saved
    if [k.name for k in tracer.kernels] != list(mode["fns"]):
        cs.fail(f"the render runs {[k.name for k in tracer.kernels]}")
    tracer.count_rays = True
    walls = {"parent": [], "new": []}
    images = {}
    busy = {}
    for name in ("parent", "new", "new", "parent") * 5 + ("parent", "new"):
        trace.TraversalKernel._launch = (parent_launch if name == "parent"
                                         else launch)
        try:
            tracer.render(scene, seed=0, spp=16, chunk=16)
            torch.cuda.synchronize()
            if name in images and name not in busy:   # a profiled render
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.time()
                    tracer.render(scene, seed=1, spp=16, chunk=16)
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                rows = [e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                total = sum(e.self_device_time_total for e in rows) / 1e3
                pair = sum(e.self_device_time_total for e in rows
                           if any(k in e.key for k in mode["profile"])) / 1e3
                busy[name] = dict(wall_ms=wall * 1e3, busy_ms=total,
                                  pair_ms=pair)
                cs.log(f"  profiled render through {name}: device busy "
                       f"{total:.3f} ms of {wall * 1e3:.3f} ms wall (idle "
                       f"{100 * (1 - total / (wall * 1e3)):.1f}%), traversal "
                       f"kernels {pair:.3f} ms")
                continue
            t0 = time.time()
            img = tracer.render(scene, seed=1, spp=16, chunk=16)
            torch.cuda.synchronize()
            walls[name].append(time.time() - t0)
            images[name] = (img, tracer.last_ray_count)
        finally:
            trace.TraversalKernel._launch = launch
    same = torch.equal(images["parent"][0], images["new"][0])
    rays = [images[n][1] for n in ("parent", "new")]
    for name, w in walls.items():
        cs.log(f"forest render 256x256 16spp maxDepth 5 through {name}: "
               f"walls (s) {', '.join(f'{x:.4f}' for x in w)}; median "
               f"{sorted(w)[len(w) // 2]:.4f}")
    cs.log(f"  rays {rays}; images identical {same}")
    if not same or rays[0] != rays[1]:
        cs.fail("the parent and new renders differ")
    return dict(walls=walls, rays=rays, identical=same, profiled=busy)


if __name__ == "__main__":
    main()
