"""A/B timings of design variants of the v7 pair kernels or of the v4 block
kernels on one NVIDIA card.

    python3 tools/torch_pair_variants.py [--kernel pair|mt] [--parent DIR]
                                         [--variants A,B] [--json PATH]

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
               marker="launch_mt", counts=("sweeps", "reads", "entered"),
               profile=("mt_kernel", "block_kernel"), env="v4"),
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


SWEEP_CALL = ("      sweep<kAnyHit>(sm, slabs, s * kSuper + m, W, rays, blo, "
              "bhi, n);\n")


def no_reuse(src):
    """Each ray of a member's list loads the slab again: the pointer is
    made opaque to the compiler so the loads stay inside the loop."""
    return sub(src, SWEEP_CALL,
               "      for (unsigned long long one = rays; one; one &= one - 1) "
               "{\n"
               "        const float* again = slabs;\n"
               "        asm volatile(\"\" : \"+l\"(again));\n"
               "        sweep<kAnyHit>(sm, again, s * kSuper + m, W, one & "
               "(~one + 1), blo, bhi, n);\n"
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
               "  kernel<<<all < sms * kBlocksPerSm ? all : sms * kBlocksPerSm, "
               "kThreads, smem,\n")


def mt_variants(src):
    def const(s, name, old, new):
        return sub(s, f"constexpr int {name} = {old};",
                   f"constexpr int {name} = {new};")

    def blocks(s, warps, per_sm):
        """Blocks of `warps` warps, `per_sm` of them an SM (the registers
        a thread may hold follow: 65,536 / (32 * warps * per_sm))."""
        return const(const(s, "kWarps", 2, warps), "kBlocksPerSm", 8, per_sm)
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
        "regs100": blocks(src, 2, 10),
        "regs80": blocks(src, 2, 12),
        "group8": const(src, "kGroup", 64, 8),
        "group16": const(src, "kGroup", 64, 16),
        "probe_sort": sub(src, "  const int n_items = n_entries * kSplit;\n",
                          "  const int n_items = 0;\n"),
        "probe_lists": sub(src, SWEEP_CALL, ""),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(MODES), default="pair",
                    help="the kernels to vary: the v7 pair kernels or the "
                    "v4 block kernels")
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
        sources = (variants if args.kernel == "pair" else mt_variants)(
            f.read())
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
    K, W = g.cbounds.shape[0], st.cluster_window
    tables = trace.make_pair_intersector(W, K).box_tables(g.cbounds)
    S = tables[0].shape[1]
    # the older interface's tables: [S, 6] supercluster bounds and cbounds
    # (padded to whole superclusters for the aos variant, which reads the
    # padding members' boxes before it drops them)
    aos_tables = (torch.cat([g.cbounds, g.cbounds.new_zeros(
        (S * trace.SUPER_FACTOR - K, 6))]),
        trace._super_bounds(g.cbounds).contiguous())
    n_counts = len(mode["counts"])

    def call(name, any_hit, rays, stats=None):
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
            tabs = aos_tables[::-1] if name == "aos" else tables
            extra = [None if stats is None else stats.data_ptr()]
            if args.kernel == "pair":
                extra.insert(0, torch.zeros(1, dtype=torch.int32,
                                            device=dev).data_ptr())
        else:
            tabs, extra = aos_tables, []
        err = fn(*(x.data_ptr() for x in (*rays, g.mt_slabs, *tabs)), N, K,
                 S, W, *(x.data_ptr() for x in outs), *extra, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return outs

    batches = dict(zip(("camera", "shadow", "bounce"),
                       cs.forest_rays(scene, st, cs.N_TIMED, dev)))
    batches.update(zip(("camera raster", "shadow raster", "bounce raster"),
                       cs.forest_rays(scene, st, cs.N_TIMED, dev,
                                      raster=True)))
    names = [n for n in libs if n != "parent"]
    order = (["parent"] if "parent" in libs else []) + names + names[::-1] \
        + (["parent"] if "parent" in libs else [])
    res = {"card": cs.card_line(), "ptxas": ptxas, "kernels": {}}
    for batch, rays in batches.items():
        live = int((rays[3] > rays[2]).sum())
        for any_hit in (False, True):
            query = "any" if any_hit else "closest"
            ref = call("new", any_hit, rays)
            for name in libs:
                got = call(name, any_hit, rays)
                stats = torch.zeros(n_counts, dtype=torch.int64, device=dev)
                probe = name.startswith("probe_")
                if new_iface[name] and not probe:
                    call(name, any_hit, rays, stats)
                torch.cuda.synchronize()
                if not probe and not all(torch.equal(a, b)
                                         for a, b in zip(got, ref)):
                    cs.fail(f"{name} differs from new on {batch} {query}")
                res["kernels"][f"{batch}/{query}/{name}"] = dict(
                    zip(mode["counts"], (x / live for x in stats.tolist())),
                    ms=[], sorted_ms=[])
            for name in order:
                res["kernels"][f"{batch}/{query}/{name}"]["ms"].append(
                    cs.cuda_ms(lambda: call(name, any_hit, rays), iters=5,
                               warmup=1))
            if args.kernel == "mt":      # with the GDMT_RAY_SORT sort around
                box = (g.cbounds[:, 0:3].amin(0), g.cbounds[:, 3:6].amax(0))

                def sorted_run(name):
                    def fn(*srt):
                        out = call(name, any_hit, srt)
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
    if "parent" in libs:
        res["render"] = time_render(scene, st, call, mode)
    log(cs.card_line())
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
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
