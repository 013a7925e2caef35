"""A/B timings of design variants of the v7 pair kernels on one NVIDIA card.

    python3 tools/torch_pair_variants.py [--parent DIR] [--json PATH]

Builds the port's csrc/trace.cu as it is ("new") and variants made from it
by text substitution, one nvcc each, all started together, into the
git-ignored gradientdomain_mitsuba_tpu_torch/_build/variants/:
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
With --parent DIR (an unpacked checkout of another commit, such as one
from `git archive`) it also builds that checkout's csrc/trace.cu
("parent", with this interface or the older one that took cbounds and
[S, 6] supercluster bounds).  On the forest's 1,048,576 camera, shadow
and bounce rays (chip_smoke.forest_rays), in random order and in the
render's raster order, every build is held against "new" bit for bit,
its walk is counted (swept clusters and superclusters whose members were
tested, per live ray, by the kernels' counting instantiation; not for the
parent or the probe), and all are timed in turns (parent, variants,
variants reversed, parent; CUDA events, 5 launches after one warm-up,
through the instantiation the main path launches).  With --parent the
forest render 256x256, 16 spp, maxDepth 5 is then timed through the parent
kernels and the new ones in turns (parent, new, new, parent, five times
over; host clock after a warm-up render, ended by a synchronise), the
images must be identical, and one more render of each runs under
torch.profiler: the device's busy time (the sum of its kernels' times)
against that render's wall, and the pair kernels' share.  Prints the
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
    (name, library path, ptxas register and spill lines)."""
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
    lines = [ln.strip() for ln in res.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return name, out, lines


def load(path, new_interface):
    """ctypes bindings of a build: this interface (SoA box tables, the ray
    counter and the visit counters) or the older one (cbounds and [S, 6]
    supercluster bounds)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(path)
    tail = 2 if new_interface else 0
    lib.pair_closest.argtypes = [p] * 7 + [i] * 4 + [p] * (5 + tail)
    lib.pair_occluded.argtypes = [p] * 7 + [i] * 4 + [p] * (2 + tail)
    lib.pair_closest.restype = lib.pair_occluded.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked checkout of another "
                    "commit whose pair kernels to time beside these")
    ap.add_argument("--json", help="a file to write the results to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs an NVIDIA "
                "card")
    log = cs.log
    log(cs.card_line())
    os.makedirs(BUILD, exist_ok=True)
    with open(trace._SRC) as f:
        sources = variants(f.read())
    if args.parent:
        with open(os.path.join(args.parent, "gradientdomain_mitsuba_tpu_"
                               "torch", "csrc", "trace.cu")) as f:
            sources["parent"] = f.read()
    new_iface = {name: "int* next_ray" in src
                 for name, src in sources.items()}
    t0 = time.time()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda kv: build(*kv), sources.items()))
    log(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    libs = {}
    for name, path, lines in built:
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
        libs[name] = load(path, new_iface[name])

    dev = torch.device("cuda:0")
    scene, st, _ = cs.load_forest(dev)
    g = scene.geom
    K, W = g.cbounds.shape[0], st.cluster_window
    tables = trace.make_pair_intersector(W, K).box_tables(g.cbounds)
    S = tables[0].shape[1]
    aos = trace._super_bounds(g.cbounds).contiguous()

    def call(name, any_hit, rays, stats=None):
        N = rays[0].shape[0]
        if any_hit:
            outs = [torch.empty(N, dtype=torch.bool, device=dev)]
        else:
            t = torch.empty(N, device=dev)
            outs = [t, torch.empty_like(t), torch.empty_like(t),
                    torch.empty(N, dtype=torch.int32, device=dev)]
        lib = libs[name]
        fn = lib.pair_occluded if any_hit else lib.pair_closest
        stream = torch.cuda.current_stream().cuda_stream
        if new_iface[name]:
            tabs, extra = tables, [
                torch.zeros(1, dtype=torch.int32, device=dev).data_ptr(),
                None if stats is None else stats.data_ptr()]
        else:
            tabs, extra = (g.cbounds, aos), []
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
    res = {"card": cs.card_line(), "kernels": {}}
    for batch, rays in batches.items():
        live = int((rays[3] > rays[2]).sum())
        for any_hit in (False, True):
            query = "any" if any_hit else "closest"
            ref = call("new", any_hit, rays)
            for name in libs:
                got = call(name, any_hit, rays)
                stats = torch.zeros(2, dtype=torch.int64, device=dev)
                probe = name.startswith("probe_")
                if new_iface[name] and not probe:
                    call(name, any_hit, rays, stats)
                torch.cuda.synchronize()
                if not probe and not all(torch.equal(a, b)
                                         for a, b in zip(got, ref)):
                    cs.fail(f"{name} differs from new on {batch} {query}")
                swept, supers = (x / live for x in stats.tolist())
                res["kernels"][f"{batch}/{query}/{name}"] = dict(
                    swept=swept, supers=supers, ms=[])
            for name in order:
                res["kernels"][f"{batch}/{query}/{name}"]["ms"].append(
                    cs.cuda_ms(lambda: call(name, any_hit, rays), iters=5,
                               warmup=1))
            for name in libs:
                r = res["kernels"][f"{batch}/{query}/{name}"]
                log(f"{batch} {query} {name}: ms "
                    f"{', '.join(f'{x:.4f}' for x in r['ms'])}; swept "
                    f"{r['swept']:.3f} clusters and tested the members of "
                    f"{r['supers']:.3f} superclusters per live ray")
    if "parent" in libs:
        res["render"] = time_render(scene, st, call)
    log(cs.card_line())
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


def time_render(scene, st, call):
    """The forest render through the parent kernels and the new ones, in
    turns; returns {"walls": {name: [s, ...]}, "rays", "identical"}."""
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    launch = trace.TraversalKernel._launch

    def parent_launch(k, o, d, mint, maxt, table, cbounds, stats=None):
        k.launches += 1
        out = call("parent", k.any_hit, (o, d, mint, maxt))
        if k.any_hit:
            return out[0]
        return isec.Hit(*out, valid=out[3] >= 0)

    from torch.profiler import ProfilerActivity, profile
    tracer = PathTracer(scene, st)
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
                           if "pair_" in e.key) / 1e3
                busy[name] = dict(wall_ms=wall * 1e3, busy_ms=total,
                                  pair_ms=pair)
                cs.log(f"  profiled render through {name}: device busy "
                       f"{total:.3f} ms of {wall * 1e3:.3f} ms wall (idle "
                       f"{100 * (1 - total / (wall * 1e3)):.1f}%), pair "
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
