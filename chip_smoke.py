"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; each prints
its time):
  1. device and build: requires CUDA, prints the card's name and power
     limit (nvidia-smi) and builds the sweep kernels (csrc/sweep.cu), the
     pair kernels (csrc/trace.cu) and the v4 / v2 block kernels
     (csrc/trace_block.cu), one nvcc each, all started together;
  2. sweep kernels vs plain: both sweep kernels against their plain
     PyTorch versions on random soups (T = 3, 36, 130, and 2048, the
     largest table, staged whole), on a windowed soup (300 triangles in
     three 128-column windows), a soup with zero-area triangles and a
     soup of duplicated triangles (equal t: the lowest column must win),
     and on the cbox soup with its own camera and shadow rays (dead lanes,
     N not a multiple of the block size); then both timed at 1,048,576
     cbox rays and on the render's own calls (one pass of the cbox render
     below captured, with the render's dead lanes: 262,144-lane closest
     calls, 1,310,720-lane any-hit calls; CUDA events);
  3. slice 1: cbox 256x256, 64 spp, maxDepth 6, G-PT render + L1
     reconstruction through the package's entry points, timed after a
     warm-up, with the sweep kernels' launch counters reset just before
     it; then one more render under torch.profiler (device busy time,
     idle share, the sweeps' own device time and share of the wall) with
     each sweep launch bracketed by CUDA events (in this host-bound render
     an event span also holds the launch's wait for the host);
  4. cbox kernel render vs plain render at 64x64, 4 spp, same seed, and
     one profile of the kernel render read both ways (the raw device
     events phases 3 and 12 sum, and key_averages' per-op tables): equal
     device op counts and busy times within 0.1%;
  5. pair kernels vs plain: both pair kernels against their plain version
     on random multi-cluster soups (W = 128, 256) and on the full forest
     (3.08M triangles) with camera, shadow and cosine-sampled bounce rays,
     each batch both cut to 65,537 rays (more dead lanes, N not a
     multiple of the block) and whole at 1,048,576 rays, the size of the
     main path's calls (the plain version's time is its 1,048,576-ray
     camera call); bit for bit is required.  Per forest batch it also
     prints the walk: the (ray, cluster) pairs whose member box passes
     against maxt (what an id-order walk may sweep) and against the final
     hit t (what the bound counts), beside the clusters each kernel swept
     and the superclusters whose members it tested (the kernels' optional
     visit counters, PairKernel.count_visits), per live ray, and the boxes
     it tested: S supercluster boxes and 128 member boxes a supercluster
     whose members it tested;
  6. slice 2: forest 256x256, 16 spp, maxDepth 5, PathTracer.render,
     timed after a warm-up, with the pair kernels' launch counters reset
     just before it; then one more render with each kernel launch
     bracketed by CUDA events (the kernels' share of the render);
  7. forest kernel render vs plain render at 64x64, 2 spp, same seed, and
     a G-PT render_final (L2) of the forest at 64x64, 4 spp;
  8. v4 and v2 block kernels vs plain: random soups (W = 128, 256; bit for
     bit); the forest batches of phase 5 (cut and whole), v4 bit for bit
     against phase 5's plain results and against the v7 kernels' outputs,
     with ray sorting off and on, v2 (on tri9 slabs built on the card) bit
     for bit against its plain version tri9_plain and, at the hit-set
     thresholds, against the v7 kernels' outputs (another triangle test:
     the same hits up to rounding);
  9. kernel times at 1,048,576 forest camera, shadow and bounce rays (CUDA
     events): v7, v4 and v2 side by side, each beside the batch's bound
     and the batch's block-union dilution (64 x (block, cluster) pairs
     over (ray, cluster) pairs: what one thread a ray pays), v7 beside its
     swept clusters per ray from phase 5, v4 and v2 beside their own
     counts ((ray, tile) sweeps, (block, cluster) slab reads and worklist
     entries entered, per live ray, from their counting instantiation),
     and v4 with ray sorting on;
 10. slice 3: GDMT_KERNEL=v4, forest 256x256, 16 spp, maxDepth 5,
     PathTracer.render through the v4 kernels, timed after a warm-up with
     their launch counters reset just before it, checked against the v7
     render of phase 6 (same seed), and the kernels' share of one more
     render; then phase 7's G-PT render_final under v4 against the same
     call under v7;
 11. the v2 path: the v2 wrappers (make_tri9_intersector / _occluder) on
     the three whole forest batches, launch counters reset just before;
 12. slice 8: cbox 256x256, 16 spp, maxDepth 6, BDPTracer.render and
     GBDPTracer.render + L1 reconstruct, each timed after a 1-spp warm-up
     with the sweep kernels' launch counters reset just before it (wall,
     rays, Mrays/s, launches), then one more render of each under
     torch.profiler (device busy time, device ops, the sweeps' share);
     G-BDPT primal + very_direct against the BDPT image (rtol 2e-4, atol
     2e-5) and the BDPT mean against a 16-spp PathTracer mean (3%);
 13. every sweep call of one 256x256 pass of BDPT and of G-BDPT (eye and
     light walks, the batched t=1 camera shadow rays, G-BDPT's offset
     primaries; dead lanes included) against the plain versions at phase
     2's tolerances; BDPT and G-BDPT at 64x64, 4 spp through the kernels
     and through the plain versions (phase 4's tolerances and L1
     objective check), and a second kernel render of each, bit for bit
     (the light image's deterministic scatter);
 14. G-BDPT gradients: E[dx] at 64x64, maxDepth 2, 48 spp against the
     finite difference of a 256-spp primal (tests/test_bdpt.py's
     thresholds: rms ratio < 0.55, correlation > 0.85);
 15. step B families through factory.make_integrator: direct, ao, field
     (shNormal), multichannel (path + ao) at 256x256, 16 spp and adaptive
     at 64x64, 4 spp (finite pixels, mean |I| > 1e-5, sweeps launched);
     adaptive once more through the plain versions, same seed: the
     sample maps equal and the images within phase 4's tolerance on >= 99%
     of pixels, means within 1e-3.
Every kernel's bound is the larger of its operations over the H100 SXM's
67 TFLOP/s (f32) and its bytes over 3.35 TB/s, counted from this run's
inputs: a sweep tests every (live ray, packed record) pair and reads each
80-byte record once; a traversal needs
the triangles of every (ray, cluster) pair whose member box passes against
the ray's final hit t (its maxt where it missed; an occluded any-hit ray
needs one cluster), and reads each such cluster's slab once, beside 32
bytes of ray in and 16 bytes (closest) or 1 byte (any hit) out per ray.
No single PyTorch call computes a closest or any hit, so library_ms is
null.  Prints one JSON line describing the kernels, then as the last line
{"ok": true, "device": {...}}.  Imports no jax.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(ROOT, "data", "scenes", "cbox", "cbox.xml")
FOREST = os.path.join(ROOT, "data", "scenes", "forest", "forest.xml")
N_TIMED = 1 << 20
# agreement required of kernel vs plain (sweep tolerances)
PRIM_FRAC, T_RTOL, OCC_FRAC = 0.998, 1e-5, 0.999
# pair kernels vs plain (tests/test_pallas.py's v7 thresholds): valid
# equal on >= 0.998 of lanes, prim equal on >= 0.995 of lanes both hit,
# t rtol 1e-5 where the prims agree, occluded equal on >= 0.998
PAIR_VALID, PAIR_PRIM, PAIR_OCC = 0.998, 0.995, 0.998
# rays of the cut forest comparisons (odd: not a multiple of the 8-ray
# block)
N_PAIR_CMP = 65_537
# render agreement (tests/test_torch_gpt.py): rtol/atol on >= 99% of pixels
IMG_RTOL, IMG_ATOL, IMG_FRAC = 1e-3, 1e-4, 0.99
# cycles the card sleeps before a timed run while the host queues its
# launches (about 10 ms)
QUEUE_SLEEP_CYCLES = 20_000_000
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): f32
# outside the tensor cores, HBM3 bandwidth
F32_PEAK, HBM_PEAK = 67e12, 3.35e12
# f32 flops of one (ray, triangle) test, counted from each kernel's code
FLOPS_SWEEP_CLOSEST = 38   # det, u, v chains of 3, 6, 6 terms and t's 3
#                            terms + constant (18 mul, 15 add: 33), rcp,
#                            3 mul, add
FLOPS_SWEEP_ANY = 40       # the 4 chains (33), 4 sign muls, 2 mul, add
FLOPS_LINEAR_MT = 44       # 3 dots of 6 (1 mul + 5 fma), t dot (1 mul +
#                            2 fma + add), rcp, 3 mul, add
FLOPS_PAIRWISE_MT = 46     # 2 crosses (6 mul + 3 sub), 4 dots (3 mul +
#                            2 add), 3 sub, rcp, 3 mul, add
# floats of a cluster's slab that a traversal reads, per triangle slot
SLAB_FLOATS = {"pair": 22, "mt": 22, "tri9": 9}


def log(msg):
    print(msg, flush=True)


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"--- phase: {self.name}")
        self.t0 = time.time()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"--- phase {self.name}: {time.time() - self.t0:.3f} s")


def sweep_soups():
    """tools/sweep_soups.py (the sweep checks' random soups), loaded from
    its path: tools/ is not a package."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sweep_soups", os.path.join(ROOT, "tools", "sweep_soups.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms over `iters` launches (CUDA
    events, after warm-up).  The card first sleeps while the host queues
    the timed launches, so that the host's launch overhead does not show
    between kernels shorter than it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """fn()'s result and its device time in ms (CUDA events, one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(kernels, args):
    """Kernel vs plain on one ray batch: returns (prim agreement fraction
    over valid lanes, max abs t error where prims agree, max relative t
    error there, occluded agreement fraction, max abs occluded diff)."""
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    closest_k, occl_k = kernels
    got = closest_k(*args)
    ref = isec.intersect_matmul(*args)
    occ = occl_k(*args)
    ref_occ = isec.occluded_matmul(*args)
    torch.cuda.synchronize()
    check(torch.equal(got.valid, ref.valid), "closest: valid differs")
    n_valid = int(ref.valid.sum())
    same = ref.valid & (got.prim == ref.prim)
    prim_frac = int(same.sum()) / max(n_valid, 1)
    terr = (got.t[same] - ref.t[same]).abs()
    max_abs = float(terr.max()) if n_valid else 0.0
    max_rel = float((terr / ref.t[same].abs()).max()) if n_valid else 0.0
    miss = ~got.valid
    check(bool((got.t[miss] == np.float32(3.0e38)).all()) and
          bool((got.prim[miss] == -1).all()), "closest: miss encoding")
    occ_frac = float((occ == ref_occ).float().mean())
    occ_err = float((occ.float() - ref_occ.float()).abs().max())
    return prim_frac, max_abs, max_rel, occ_frac, occ_err


def bound_ms(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time of the work at the
    card's published peaks."""
    ops_ms = flops / F32_PEAK * 1e3
    bytes_ms = nbytes / HBM_PEAK * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def sweep_bound(rays, n_rec, any_hit):
    """A whole-soup sweep: every live ray against every packed record (a
    triangle that can hit); rays in and hits out once, each 80-byte
    record once."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    n = rays[0].shape[0]
    live = int((rays[3] > rays[2]).sum())
    flops = live * n_rec * (FLOPS_SWEEP_ANY if any_hit else
                            FLOPS_SWEEP_CLOSEST)
    return bound_ms(flops, n * (33 if any_hit else 48) +
                    4 * sweep.RECORD_FLOATS * n_rec)


def traversal_bound(rays, hit, occ, cbounds, window, variant):
    """A clustered traversal on this batch: the triangles of every (ray,
    cluster) pair whose member box passes against the ray's final hit t
    (hit: the closest-hit result; maxt where it missed), or with occ (any
    hit) against maxt for the rays not occluded and one cluster for each
    occluded ray; each such cluster's slab read once, rays in and hits out
    once.  Returns (ms, bound_by, pairs, clusters, block pairs): the last
    counts the distinct (64-ray block, cluster) pairs among the pairs: the
    slabs a block kernel reads or stages when it shares them over its 64
    rays (against the final t; the kernels cull with the running t)."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    o, d, mint, maxt = rays
    if occ is None:
        bound = torch.where(hit.valid, hit.t, maxt)
    else:
        bound = torch.where(occ, -1.0, maxt)
    scb = trace._super_bounds(cbounds)
    mb = trace._member_slabs(cbounds)
    seen = torch.zeros(cbounds.shape[0], dtype=torch.bool, device=o.device)
    pairs = block_pairs = 0
    for a in range(0, o.shape[0], trace.RAY_CHUNK):   # whole 64-ray blocks
        sl = slice(a, a + trace.RAY_CHUNK)
        ray, k = trace._candidates(o[sl], d[sl], mint[sl], bound[sl], scb,
                                   mb)
        pairs += k.shape[0]
        seen[k] = True
        block_pairs += torch.unique(ray // 64 * cbounds.shape[0] +
                                    k).shape[0]
    if occ is not None:
        found = occ & hit.valid
        pairs += int(found.sum())
        seen[(hit.prim[found] // window).long()] = True
    n_clusters = int(seen.sum())
    n = o.shape[0]
    flops = pairs * window * (FLOPS_PAIRWISE_MT if variant == "tri9" else
                              FLOPS_LINEAR_MT)
    nbytes = (n * (33 if occ is not None else 48) +
              n_clusters * (SLAB_FLOATS[variant] * window * 4 + 24))
    ms, by = bound_ms(flops, nbytes)
    return ms, by, pairs, n_clusters, block_pairs


def cbox_rays(scene, settings, n, dev, seed=0):
    """n camera rays of the cbox camera (jittered over the film) and n
    shadow rays from their hits toward random points on the light."""
    from gradientdomain_mitsuba_tpu_torch.ops import common
    from gradientdomain_mitsuba_tpu_torch.ops import emitter as em
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    from gradientdomain_mitsuba_tpu_torch.ops import sensor
    g = torch.Generator(device=dev).manual_seed(seed)
    W, H = settings.width, settings.height
    pos = torch.rand((n, 2), generator=g, device=dev) * torch.tensor(
        [W, H], dtype=torch.float32, device=dev)
    o, d = sensor.sample_ray(scene.camera, W, H, pos,
                             torch.zeros((n, 2), device=dev))
    mint = torch.zeros(n, device=dev)
    maxt = torch.full((n,), 3e38, device=dev)
    hit = isec.intersect_matmul(o, d, mint, maxt, scene.geom.linC)
    its = common.fill_intersection(scene, o, d, hit)
    n_area = int((scene.emitters.tri_count > 0).sum())
    ds = em.sample_direct(scene, n_area, 0, its.p,
                          torch.rand(n, generator=g, device=dev),
                          torch.rand((n, 2), generator=g, device=dev))
    so = common.offset_ray_origin(its.p, its.ng, ds.d, scene.ray_eps)
    smaxt = torch.where(its.valid & ds.valid, ds.dist * 0.999, -1.0)
    return (o, d, mint, maxt), (so, ds.d.contiguous(), mint, smaxt)


def render_calls(tracer, scene, n_samples):
    """The sweep calls of one render_chunk of `tracer` (n_samples samples
    a pixel from sample 0, seed 0): [(any_hit, (o, d, mint, maxt))],
    inputs cloned, dead lanes included."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    calls = []
    launch = sweep.SweepKernel._launch

    def capture(k, o, d, mint, maxt, recs):
        calls.append((k.any_hit, tuple(x.clone() for x in (o, d, mint,
                                                           maxt))))
        return launch(k, o, d, mint, maxt, recs)

    sweep.SweepKernel._launch = capture
    try:
        tracer.render_chunk(scene, 0, 0, n_samples)
        torch.cuda.synchronize()
    finally:
        sweep.SweepKernel._launch = launch
    return calls


def check_render_calls(label, calls, linC):
    """Hold every captured sweep call against the plain versions (both
    sweeps on each call's rays, phase 2's tolerances); prints the calls'
    lane counts and how many agree bit for bit."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    n_tris = linC.shape[1] // 4
    ks = (sweep.make_sweep_intersector(n_tris),
          sweep.make_sweep_occluder(n_tris))
    exact, worst = 0, (1.0, 0.0, 1.0)
    for any_hit, rays in calls:
        pf, _, mr, of, _ = compare(ks, (*rays, linC))
        check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
              f"{label}: kernel vs plain disagree on a "
              f"{rays[0].shape[0]}-lane {'any-hit' if any_hit else 'closest'}"
              f" call")
        exact += pf == 1.0 and mr == 0.0 and of == 1.0
        worst = (min(worst[0], pf), max(worst[1], mr), min(worst[2], of))
    for any_hit in (False, True):
        lanes = [int(r[0].shape[0]) for a, r in calls if a == any_hit]
        dead = sum(int((r[3] <= r[2]).sum()) for a, r in calls
                   if a == any_hit) / max(sum(lanes), 1)
        sizes = ", ".join(f"{lanes.count(n)} x {n}"
                          for n in sorted(set(lanes)))
        log(f"  {label} {'any-hit' if any_hit else 'closest'} calls of one "
            f"pass: {sizes} lanes ({dead:.4f} dead)")
    log(f"  {label}: {len(calls)} calls held against plain, {exact} bit "
        f"for bit; worst prim agree {worst[0]:.6f}, t rel {worst[1]:.3e}, "
        f"occluded agree {worst[2]:.6f}")
    check(all(any(a == h for a, _ in calls) for h in (False, True)),
          f"{label}: one pass made no call of a sweep")


def phase_kernels(dev, kernels_rec):
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    log(f"tolerances: identical valid; prim equal on >= {PRIM_FRAC} of "
        f"valid lanes; t rtol {T_RTOL} where prim agrees; occluded flags "
        f"equal on >= {OCC_FRAC} of lanes")
    rs = np.random.RandomState(7)
    for T in (3, 36, 130, 2048):
        v0, e1, e2 = (np.float32(rs.normal(size=(T, 3))) for _ in range(3))
        linC = torch.from_numpy(isec.build_linear_mt(v0, e1, e2)).to(dev)
        n = 100_003   # not a multiple of the 256-thread block
        o = torch.from_numpy(np.float32(rs.normal(size=(n, 3)) * 3)).to(dev)
        d = torch.from_numpy(np.float32(rs.normal(size=(n, 3)))).to(dev)
        d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
        mint = torch.full((n,), 1e-4, device=dev)
        maxt = torch.full((n,), 3e38, device=dev)
        maxt[::7] = -1.0   # dead lanes
        ks = (sweep.make_sweep_intersector(T), sweep.make_sweep_occluder(T))
        pf, ma, mr, of, _ = compare(ks, (o, d, mint, maxt, linC))
        n_rec = ks[0].packed(linC).shape[0]
        log(f"random soup T={T}: prim agree {pf:.6f}, max |dt| {ma:.3e} "
            f"(rel {mr:.3e}), occluded agree {of:.6f}; {n_rec} records, "
            f"{n_rec * 4 * sweep.RECORD_FLOATS} bytes staged a block")
        check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
              f"kernel vs plain disagree on random soup T={T}")
    soups = sweep_soups()
    for kind, T, n_rec in (("windowed", 300, 300), ("zero_area", 96, 64),
                           ("ties", 64, 64)):
        args = [torch.from_numpy(a).to(dev)
                for a in soups.random_soup(T, 100_003, 17, kind)]
        ks = (sweep.make_sweep_intersector(T), sweep.make_sweep_occluder(T))
        pf, ma, mr, of, _ = compare(ks, args)
        hit = ks[0](*args)
        prims = hit.prim[hit.valid]
        log(f"{kind} soup T={T} ({args[4].shape[1] // 4} columns): prim "
            f"agree {pf:.6f}, max |dt| {ma:.3e} (rel {mr:.3e}), occluded "
            f"agree {of:.6f}; {ks[0].packed(args[4]).shape[0]} records, "
            f"hit {float(hit.valid.float().mean()):.4f}, highest prim hit "
            f"{int(prims.max()) if prims.numel() else -1}")
        check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
              f"kernel vs plain disagree on the {kind} soup")
        check(ks[0].packed(args[4]).shape[0] == n_rec,
              f"the {kind} soup packs to the wrong number of records")
        check(kind != "windowed" or bool((prims >= 256).any()),
              "no hit in the windowed soup's third window")
        check(kind != "zero_area" or not bool((prims % 3 == 0).any()),
              "a zero-area triangle was hit")
        check(kind != "ties" or bool((prims < T // 2).all()),
              "a tie went to the higher column")

    scene_np, st = sc.load_scene(CBOX, {
        "width": "256", "height": "256", "spp": "64", "maxDepth": "6",
        "integrator": "gpt"})
    scene = bridge.to_torch(scene_np, dev)
    n_tris = int(scene.geom.indices.shape[0])
    ks = (sweep.make_sweep_intersector(n_tris),
          sweep.make_sweep_occluder(n_tris))
    cam, shadow = cbox_rays(scene, st, N_TIMED, dev)
    linC = scene.geom.linC
    for name, rays in (("camera", cam), ("shadow", shadow)):
        small = [x[:77_777] for x in rays]   # N not a multiple of 256
        small[3] = small[3].clone()
        small[3][::11] = -1.0                # dead lanes
        for label, batch in ((f"{name} 77777", small), (f"{name} 1M", rays)):
            pf, ma, mr, of, oe = compare(ks, (*batch, linC))
            log(f"cbox soup T={n_tris} {label}: prim agree {pf:.6f}, "
                f"max |dt| {ma:.3e} (rel {mr:.3e}), occluded agree {of:.6f}")
            check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
                  f"kernel vs plain disagree on cbox {label}")
        if name == "camera":
            kernels_rec[0]["max_abs_err"] = ma
        else:
            kernels_rec[1]["max_abs_err"] = oe

    # timing at the main-path shape: 1,048,576 rays, cbox soup
    timings = (
        (0, lambda: ks[0](*cam, linC),
         lambda: isec.intersect_matmul(*cam, linC)),
        (1, lambda: ks[1](*shadow, linC),
         lambda: isec.occluded_matmul(*shadow, linC)))
    n_rec = ks[0].packed(linC).shape[0]
    for i, kern, plain in timings:
        kernels_rec[i]["ms"] = cuda_ms(kern)
        kernels_rec[i]["plain_ms"] = cuda_ms(plain, iters=5)
        ms, by = sweep_bound(cam if i == 0 else shadow, n_rec, i == 1)
        kernels_rec[i].update(bound_ms=ms, bound_by=by)
        log(f"{kernels_rec[i]['name']} at {N_TIMED} rays: kernel "
            f"{kernels_rec[i]['ms']:.4f} ms, plain "
            f"{kernels_rec[i]['plain_ms']:.4f} ms, bound {ms:.4f} ms "
            f"({by}; {n_rec} records of {linC.shape[1] // 4} columns)")

    # the render's own calls: one pass of the cbox render (4 of its 64
    # spp, 256x256, five lockstep paths a lane), captured
    tracer = GPTracer(scene, st)
    spb = tracer.samples_per_batch(st.spp)
    calls = render_calls(tracer, scene, spb)
    passes = st.spp // spb
    for i, k in enumerate(ks):
        mine = [rays for any_hit, rays in calls if any_hit == k.any_hit]
        check(len(mine) > 0, f"one render pass made no {k.name} call")
        rays = mine[0]
        pf, ma, mr, of, _ = compare(ks, (*rays, linC))
        check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
              f"kernel vs plain disagree on a render call of {k.name}")
        per = [cuda_ms(lambda: k(*r, linC), iters=5, warmup=1) for r in mine]
        dead = sum(int((r[3] <= r[2]).sum()) for r in mine) / sum(
            r[0].shape[0] for r in mine)
        b_ms = sum(sweep_bound(r, n_rec, k.any_hit)[0] for r in mine)
        lanes = [int(r[0].shape[0]) for r in mine]
        kernels_rec[i].update(render_call_ms=per, render_call_lanes=lanes,
                              render_dead_share=dead)
        log(f"{k.name} on one render pass's {len(mine)} calls of "
            f"{', '.join(map(str, lanes))} lanes ({dead:.4f} dead): "
            f"{', '.join(f'{x:.4f}' for x in per)} ms, sum {sum(per):.4f} ms "
            f"a pass (bound {b_ms:.4f} ms), x {passes} passes = "
            f"{sum(per) * passes:.3f} ms a render")


def use_plain(tracer):
    """Swap a tracer's intersectors for the sweep kernels' plain versions
    (for the kernel-vs-plain comparisons only)."""
    from gradientdomain_mitsuba_tpu_torch.ops import common
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    tracer.closest, tracer.occluded = common.instrument_intersectors(
        tracer,
        lambda o, d, mn, mx, g: isec.intersect_matmul(o, d, mn, mx, g.linC),
        lambda o, d, mn, mx, g: isec.occluded_matmul(o, d, mn, mx, g.linC))
    return tracer


def render(scene, st, seed, spp, mode="L1", plain=False):
    """One render_final through the package's entry points.  plain=True
    swaps the tracer's intersectors for the plain versions (for the
    kernel-vs-plain comparison only)."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    tracer = GPTracer(scene, st)
    tracer.count_rays = True
    if plain:
        use_plain(tracer)
    final, bufs = tracer.render_final(scene, seed, spp, alpha=0.2,
                                      mode=mode)
    return tracer, final, bufs


def phase_slice(dev, kernels_rec):
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    W = H = 256
    spp, depth = 64, 6
    t0 = time.time()
    scene_np, st = sc.load_scene(CBOX, {
        "width": str(W), "height": str(H), "spp": str(spp),
        "maxDepth": str(depth), "integrator": "gpt"})
    scene = bridge.to_torch(scene_np, dev)
    torch.cuda.synchronize()
    log(f"slice: cbox {W}x{H} {spp}spp maxDepth {depth} L1; scene load + "
        f"upload {time.time() - t0:.3f} s")
    tracer = GPTracer(scene, st)
    tracer.count_rays = True
    t0 = time.time()
    tracer.render_final(scene, 0, spp, alpha=0.2, mode="L1")
    torch.cuda.synchronize()
    log(f"warm-up render {time.time() - t0:.3f} s")

    for k in tracer.kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    final, bufs = tracer.render_final(scene, 1, spp, alpha=0.2, mode="L1")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = [k.launches for k in tracer.kernels]
    rays = int(bufs["rays"])
    for rec, n in zip(kernels_rec, launches):
        rec["launches"] = n
    log(f"timed render+reconstruct: wall {wall:.4f} s, measured rays "
        f"{rays}, {rays / wall / 1e6:.3f} Mrays/s, kernel launches "
        f"closest {launches[0]} occluded {launches[1]}")
    check(all(n > 0 for n in launches),
          f"a sweep kernel was not launched by the main path: {launches}")
    img = final
    check(tuple(img.shape) == (H, W, 3), f"final shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "final image not finite")
    mean_abs = float(img.abs().mean())
    check(mean_abs > 0, "final image is black")
    band = slice(H // 4, 3 * H // 4)
    left = img[band, 2:10].mean((0, 1)).tolist()
    right = img[band, W - 10:W - 2].mean((0, 1)).tolist()
    log(f"final mean |I| {mean_abs:.5f}; left wall rgb "
        f"{[round(c, 4) for c in left]}, right wall rgb "
        f"{[round(c, 4) for c in right]}")
    check(left[0] > left[1], "left (red) wall is not redder than green")
    check(right[1] > right[0], "right (green) wall is not greener than red")

    # one more render, under torch.profiler (the sweeps' own device time)
    # with each sweep launch bracketed by CUDA events (spans that also hold
    # each launch's wait for the host in this host-bound render)
    spans = {}

    def run():
        _, spans["per"] = kernel_time_render(
            sweep.SweepKernel,
            lambda: tracer.render_final(scene, 2, spp, alpha=0.2, mode="L1"),
            "sweep launches' CUDA-event spans (seed 2, profiled)")

    prof = profiled_render(run, "sweep_")
    log(f"  profiled render (seed 2): device busy {prof['busy_ms']:.3f} ms "
        f"of {prof['wall_ms']:.3f} ms wall (idle "
        f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%), "
        f"{prof['device_ops']} device ops; sweep kernels' device time "
        f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} launches "
        f"({100 * prof['kernel_ms'] / prof['wall_ms']:.2f}% of the wall)")
    return dict(wall_s=wall, rays=rays, mrays_per_s=rays / wall / 1e6,
                final_mean=mean_abs, event_span_ms=spans["per"],
                profiled=prof)


def profiled_render(run, key, both_readers=False):
    """run() (one render) under torch.profiler (device activity only):
    its wall, the device's busy time (the sum of its kernels' times), the
    number of device ops, and the device time and launches of the kernels
    whose name holds `key`.  It sums the profiler's raw device events:
    building its per-op tables (key_averages) takes about a minute for a
    render of 400,000 device ops.  both_readers=True also sums the same
    profile's key_averages() rows, as busy_ms_table and
    device_ops_table, so the two readers can be compared."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    t0 = time.time()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    mine = [e for e in events if key in e.name()]
    out = dict(wall_ms=wall * 1e3,
               busy_ms=sum(e.duration_ns() for e in events) / 1e6,
               device_ops=len(events),
               kernel_ms=sum(e.duration_ns() for e in mine) / 1e6,
               kernel_calls=len(mine))
    log(f"  (profile read in {time.time() - t0:.3f} s)")
    if both_readers:
        t0 = time.time()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out.update(
            busy_ms_table=sum(e.self_device_time_total for e in rows) / 1e3,
            device_ops_table=sum(e.count for e in rows))
        log(f"  (key_averages read in {time.time() - t0:.3f} s)")
    return out


def _l1_energy(x, p, gx, gy, alpha=0.2):
    gx = gx.clone()
    gy = gy.clone()
    gx[:, -1] = 0.0
    gy[-1] = 0.0
    dx = torch.nn.functional.pad(x[:, 1:] - x[:, :-1], (0, 0, 0, 1))
    dy = torch.nn.functional.pad(x[1:] - x[:-1], (0, 0, 0, 0, 0, 1))
    return float((dx - gx).abs().sum() + (dy - gy).abs().sum() +
                 alpha * (x - p).abs().sum())


def phase_render_vs_plain(dev):
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    scene_np, st = sc.load_scene(CBOX, {
        "width": "64", "height": "64", "spp": "4", "maxDepth": "6",
        "integrator": "gpt"})
    scene = bridge.to_torch(scene_np, dev)
    _, fk, bk = render(scene, st, 5, 4)
    _, fp, bp = render(scene, st, 5, 4, plain=True)
    # one profile of the kernel render read both ways: the raw device
    # events (phases 3 and 12) and the per-op tables
    prof = profiled_render(lambda: render(scene, st, 5, 4), "sweep_",
                           both_readers=True)
    log(f"  profiled 64x64 render, raw events vs key_averages: busy "
        f"{prof['busy_ms']:.6f} vs {prof['busy_ms_table']:.6f} ms, device "
        f"ops {prof['device_ops']} vs {prof['device_ops_table']}; wall "
        f"{prof['wall_ms']:.3f} ms")
    check(prof["device_ops"] == prof["device_ops_table"] and
          abs(prof["busy_ms"] - prof["busy_ms_table"]) <=
          1e-3 * prof["busy_ms_table"],
          "the two profile readers disagree")
    torch.cuda.synchronize()
    rk, rp = int(bk["rays"]), int(bp["rays"])
    log(f"64x64 4spp kernel vs plain: rays {rk} vs {rp}")
    check(abs(rk - rp) <= 1e-3 * rp, "ray counts differ")
    for k in ("primal", "very_direct", "dx", "dy"):
        a, b = bk[k], bp[k]
        frac = float(torch.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL)
                     .all(-1).float().mean())
        rel = abs(float(a.mean()) - float(b.mean())) / max(
            abs(float(b.mean())), 1e-12)
        log(f"  {k}: {frac:.5f} of pixels within rtol {IMG_RTOL} atol "
            f"{IMG_ATOL}; mean rel diff {rel:.2e}")
        check(frac >= IMG_FRAC, f"{k} differs between kernel and plain")
        check(rel < 1e-4 or abs(float(a.mean()) - float(b.mean())) < 1e-6,
              f"{k} mean differs")
    # L2 reconstruction of both buffer sets: elementwise
    l2k = poisson.solve_l2(bk["primal"], bk["dx"], bk["dy"])
    l2p = poisson.solve_l2(bp["primal"], bp["dx"], bp["dy"])
    frac = float(torch.isclose(l2k, l2p, rtol=IMG_RTOL, atol=IMG_ATOL)
                 .all(-1).float().mean())
    log(f"  L2 final: {frac:.5f} of pixels within tolerance")
    check(frac >= IMG_FRAC, "L2 reconstruction differs")
    # L1 final: objective and mean (the L1 IRLS is chaotic at f32 under
    # ulp-level input changes; see tests/test_torch_poisson.py)
    ek = _l1_energy(fk - bk["very_direct"], bp["primal"], bp["dx"], bp["dy"])
    ep = _l1_energy(fp - bp["very_direct"], bp["primal"], bp["dx"], bp["dy"])
    rel = abs(float(fk.mean()) - float(fp.mean())) / abs(float(fp.mean()))
    log(f"  L1 final: objective {ek:.4f} vs {ep:.4f}; mean rel diff "
        f"{rel:.2e}")
    check(abs(ek - ep) <= 0.01 * ep and rel < 5e-3, "L1 final differs")
    check(bool(torch.isfinite(fk).all()), "L1 final not finite")

# ---------------------------------------------------------------------------
# slice 2: the forest through the pair kernels

def load_forest(dev):
    """forest.xml at 256x256, 16 spp, maxDepth 5, uploaded to the card."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    scene_np, st = sc.load_scene(FOREST, {
        "width": "256", "height": "256", "spp": "16", "maxDepth": "5"})
    t_load = time.time() - t0
    scene = bridge.to_torch(scene_np, dev)
    torch.cuda.synchronize()
    t_all = time.time() - t0
    nbytes = torch.cuda.memory_allocated(dev) - base
    g = scene.geom
    log(f"forest: {g.indices.shape[0]} triangles, K = "
        f"{g.cbounds.shape[0]} clusters of W = {st.cluster_window}, "
        f"mt_slabs {tuple(g.mt_slabs.shape)}, tri_shade "
        f"{tuple(g.tri_shade.shape)}; load {t_load:.3f} s, load + upload "
        f"{t_all:.3f} s, scene tables on the card {nbytes} bytes")
    return scene, st, dict(load_s=t_load, load_upload_s=t_all,
                           scene_bytes=nbytes)


def forest_rays(scene, st, n, dev, seed=0, raster=False):
    """n forest camera rays (jittered over the film, in random order; with
    raster, in the render's own order: pixels in raster order, one
    jittered sample each, n / (W*H) passes), shadow rays from their hits
    toward the light, and cosine-sampled bounce rays from the hits
    (incoherent).  Lanes whose camera ray missed are dead (maxt = -1) in
    the shadow and bounce batches.  Hits come from the pair kernel."""
    from gradientdomain_mitsuba_tpu_torch.core import math as m
    from gradientdomain_mitsuba_tpu_torch.core import warp
    from gradientdomain_mitsuba_tpu_torch.ops import common
    from gradientdomain_mitsuba_tpu_torch.ops import emitter as em
    from gradientdomain_mitsuba_tpu_torch.ops import sensor
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    g = torch.Generator(device=dev).manual_seed(seed)
    geom = scene.geom
    W, H = st.width, st.height
    pos = torch.rand((n, 2), generator=g, device=dev)
    if raster:
        ids = torch.arange(n, device=dev) % (W * H)
        pos = pos + torch.stack([ids % W, ids // W], 1)
    else:
        pos = pos * torch.tensor([W, H], dtype=torch.float32, device=dev)
    o, d = sensor.sample_ray(scene.camera, W, H, pos,
                             torch.zeros((n, 2), device=dev))
    o, d = o.contiguous(), d.contiguous()
    mint = torch.zeros(n, device=dev)
    maxt = torch.full((n,), 3e38, device=dev)
    ck = trace.make_pair_intersector(st.cluster_window,
                                     geom.cbounds.shape[0])
    hit = ck(o, d, mint, maxt, geom.mt_slabs, geom.cbounds)
    its = common.fill_intersection(scene, o, d, hit)
    n_area = int((scene.emitters.tri_count > 0).sum())
    ds = em.sample_direct(scene, n_area, 0, its.p,
                          torch.rand(n, generator=g, device=dev),
                          torch.rand((n, 2), generator=g, device=dev))
    eps = scene.ray_eps
    so = common.offset_ray_origin(its.p, its.ng, ds.d, eps).contiguous()
    smaxt = torch.where(
        its.valid & ds.valid,
        ds.dist - 2.0 * eps / torch.clamp_min(torch.abs(m.dot(ds.d, ds.n)),
                                              1e-3), -1.0)
    s_, t_ = m.build_frame(its.ns)
    local = warp.square_to_cosine_hemisphere(
        torch.rand((n, 2), generator=g, device=dev))
    # bounce toward the side the camera ray came from
    side = torch.sign(m.dot(its.ns, -d))[..., None]
    bd = m.to_world(local, s_, t_, its.ns * side).contiguous()
    bd = bd / torch.linalg.norm(bd, dim=-1, keepdim=True)
    bo = common.offset_ray_origin(its.p, its.ng, bd, eps).contiguous()
    bmaxt = torch.where(its.valid, 3e38, -1.0)
    return ((o, d, mint, maxt), (so, ds.d.contiguous(), mint, smaxt),
            (bo, bd, mint, bmaxt))


def agreement(got, occ, ref, ref_occ, rays, label):
    """Kernel outputs (got Hit, occ) vs reference outputs on one ray
    batch.  Checks the miss encoding and dead lanes; returns (valid
    agreement, prim agreement over lanes both hit, max |dt| and max
    relative dt where prims agree, occluded agreement, max |occluded
    diff|, fraction of lanes hit, bit-for-bit equal)."""
    valid_frac = float((got.valid == ref.valid).float().mean())
    both = got.valid & ref.valid
    same = both & (got.prim == ref.prim)
    prim_frac = int(same.sum()) / max(int(both.sum()), 1)
    terr = (got.t[same] - ref.t[same]).abs()
    max_abs = float(terr.max()) if bool(same.any()) else 0.0
    max_rel = (float((terr / ref.t[same].abs()).max())
               if bool(same.any()) else 0.0)
    miss = ~got.valid
    check(bool((got.t[miss] == np.float32(3.0e38)).all()) and
          bool((got.prim[miss] == -1).all()), f"{label}: miss encoding")
    dead = rays[3] <= rays[2]
    check(not bool(got.valid[dead].any()) and not bool(occ[dead].any()),
          f"{label}: a dead lane came back hit")
    occ_frac = float((occ == ref_occ).float().mean())
    occ_err = float((occ.float() - ref_occ.float()).abs().max())
    exact = (all(torch.equal(a, b) for a, b in zip(got, ref)) and
             torch.equal(occ, ref_occ))
    return (valid_frac, prim_frac, max_abs, max_rel, occ_frac, occ_err,
            float(ref.valid.float().mean()), exact)


def compare_pairs(ks, rays, table, cb, label):
    """Traversal kernels (closest, any hit) vs their plain version on one
    ray batch.  Returns (agreement(...), (kernel Hit, kernel occluded,
    plain Hit, plain occluded), device ms of the plain closest and any
    hit calls (CUDA events, one call each))."""
    closest_k, occl_k = ks
    got = closest_k(*rays, table, cb)
    occ = occl_k(*rays, table, cb)
    ref, ms_c = timed_call(lambda: closest_k.plain(*rays, table, cb))
    ref_occ, ms_o = timed_call(lambda: occl_k.plain(*rays, table, cb))
    return (agreement(got, occ, ref, ref_occ, rays, label),
            (got, occ, ref, ref_occ), (ms_c, ms_o))


def check_pairs(label, res, plain_ms=None):
    vf, pf, ma, mr, of, _, hf, exact = res
    log(f"{label}: valid agree {vf:.6f}, prim agree {pf:.6f}, max |dt| "
        f"{ma:.3e} (rel {mr:.3e}), occluded agree {of:.6f}, hit {hf:.4f}, "
        f"bit for bit {exact}" + ("" if plain_ms is None else
                                  f"; plain closest {plain_ms[0]:.1f} ms, "
                                  f"any hit {plain_ms[1]:.1f} ms"))
    check(vf >= PAIR_VALID and pf >= PAIR_PRIM and mr <= T_RTOL and
          of >= PAIR_OCC, f"kernels vs reference disagree on {label}")


def candidate_pairs(rays, bound, cbounds):
    """(ray, cluster) pairs whose member box passes against `bound` [N]
    (pair_plain's super -> member test, chunked as it chunks)."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    o, d, mint, _ = rays
    scb = trace._super_bounds(cbounds)
    mb = trace._member_slabs(cbounds)
    return sum(trace._candidates(o[a:a + trace.RAY_CHUNK],
                                 d[a:a + trace.RAY_CHUNK],
                                 mint[a:a + trace.RAY_CHUNK],
                                 bound[a:a + trace.RAY_CHUNK], scb,
                                 mb)[0].shape[0]
               for a in range(0, o.shape[0], trace.RAY_CHUNK))


def walk_counts(ks, rays, table, cbounds, ref, ref_occ):
    """What the pair kernels' walk did on one batch, per live ray: prints
    the (ray, cluster) pairs against maxt and against the final hit t
    (closest: the plain hit's t where it hit; any hit: maxt for the rays
    not occluded and one cluster for each occluded ray) beside the
    clusters each kernel swept, the superclusters whose members it tested
    and the boxes it tested (all S supercluster boxes, then 128 member
    boxes for each such supercluster).  Returns {kernel name: (swept,
    superclusters, needed) per live ray}."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    live = max(int((rays[3] > rays[2]).sum()), 1)
    at_maxt = candidate_pairs(rays, rays[3], cbounds) / live
    needed = {
        "pair_closest": candidate_pairs(
            rays, torch.where(ref.valid, ref.t, rays[3]), cbounds) / live,
        "pair_occluded": (candidate_pairs(
            rays, torch.where(ref_occ, -1.0, rays[3]), cbounds) +
            int(ref_occ.sum())) / live}
    out = {}
    for k in ks:
        got, swept, supers = k.count_visits(*rays, table, cbounds)
        same = (torch.equal(got, ref_occ) if k.any_hit else
                all(torch.equal(a, b) for a, b in zip(got, ref)))
        check(same, f"{k.name}: the counting launch differs from pair_plain")
        out[k.name] = (swept / live, supers / live, needed[k.name])
    S = -(-cbounds.shape[0] // trace.SUPER_FACTOR)
    log(f"  walk per live ray ({live} live): pairs against maxt "
        f"{at_maxt:.3f}; " + "; ".join(
            f"{name} swept {sw:.3f} clusters (needed {nd:.3f}), tested the "
            f"members of {su:.3f} superclusters "
            f"({S + trace.SUPER_FACTOR * su:.1f} boxes)"
            for name, (sw, su, nd) in out.items()))
    return out


def forest_batches(rays_by_name):
    """(name, n, rays): each forest batch cut to N_PAIR_CMP rays with more
    dead lanes, then whole, at the 1,048,576 rays of the main path's
    calls."""
    for name, rays in rays_by_name:
        sub = [x[:N_PAIR_CMP] for x in rays]
        sub[3] = sub[3].clone()
        sub[3][::13] = -1.0                  # more dead lanes
        for n, batch in ((N_PAIR_CMP, sub), (N_TIMED, rays)):
            yield name, n, batch


def phase_pair_kernels(dev, kernels_rec, forest):
    """Returns {(batch name, n): (rays, v7 Hit, v7 occluded, plain Hit,
    plain occluded, plain ms)} for the later phases."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    scene, st, _ = forest
    log(f"tolerances: valid equal on >= {PAIR_VALID} of lanes; prim equal "
        f"on >= {PAIR_PRIM} of lanes both hit; t rtol {T_RTOL} where prim "
        f"agrees; occluded equal on >= {PAIR_OCC} of lanes")
    for W in (128, 256):
        o, d, mint, maxt, slabs, cb, _, _ = (
            torch.from_numpy(a).to(dev)
            for a in trace.random_cluster_soup(300, W, W, 100_003))
        ks = (trace.make_pair_intersector(W, 300),
              trace.make_pair_occluder(W, 300))
        label = f"random soup K=300 W={W} N={o.shape[0]}"
        res, _, ms = compare_pairs(ks, (o, d, mint, maxt), slabs, cb, label)
        check_pairs(label, res, ms)
        check(res[-1], f"{label}: the pair kernels differ from pair_plain")

    g = scene.geom
    K, W = g.cbounds.shape[0], st.cluster_window
    ks = (trace.make_pair_intersector(W, K), trace.make_pair_occluder(W, K))
    cam, shadow, bounce = forest_rays(scene, st, N_TIMED, dev)
    out = {}
    for name, n, batch in forest_batches((("camera", cam), ("shadow", shadow),
                                          ("bounce", bounce))):
        label = f"forest {name} rays N={n}"
        res, outs, ms = compare_pairs(ks, batch, g.mt_slabs, g.cbounds, label)
        check_pairs(label, res, ms)
        check(res[-1], f"{label}: the pair kernels differ from pair_plain")
        walk = walk_counts(ks, batch, g.mt_slabs, g.cbounds, outs[2],
                           outs[3])
        for k in ks:
            kernels_rec[2 + k.any_hit].setdefault("swept_per_ray", {})[
                f"{name}_{n}"] = walk[k.name][0]
        out[(name, n)] = (batch, *outs, ms, res)
    kernels_rec[2]["max_abs_err"] = max(r[-1][2] for r in out.values())
    kernels_rec[3]["max_abs_err"] = max(r[-1][5] for r in out.values())
    log(f"(comparison launches, not counted as the main path's: "
        f"{[k.launches for k in ks]})")
    return out


def phase_block_kernels(dev, recs, forest, pair_out):
    """v4 and v2 kernels vs their plain versions; v4 also vs v7.  Returns
    (tri9 of the forest, {(batch name, n): (v2 Hit, v2 occluded, plain
    Hit, plain occluded, plain ms)})."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    scene, st, _ = forest
    makers = {"mt": (trace.make_mt_intersector, trace.make_mt_occluder),
              "tri9": (trace.make_tri9_intersector, trace.make_tri9_occluder)}
    for W in (128, 256):
        o, d, mint, maxt, slabs, cb, _, tri9 = (
            torch.from_numpy(a).to(dev)
            for a in trace.random_cluster_soup(300, W, W + 2, 100_003))
        for variant, table in (("mt", slabs), ("tri9", tri9)):
            ks = tuple(m(W, 300) for m in makers[variant])
            label = f"{variant} random soup K=300 W={W} N={o.shape[0]}"
            res, _, ms = compare_pairs(ks, (o, d, mint, maxt), table, cb,
                                       label)
            check_pairs(label, res, ms)
            check(res[-1], f"{label}: the {variant} kernels differ from "
                  "their plain version")

    g = scene.geom
    K, W = g.cbounds.shape[0], st.cluster_window
    t0 = time.time()
    tri9 = trace.tri9_from_soup(g.tris, W)
    torch.cuda.synchronize()
    log(f"forest tri9 {tuple(tri9.shape)} built on the card in "
        f"{time.time() - t0:.3f} s ({tri9.numel() * 4} bytes)")
    mt = tuple(m(W, K, ray_sort=False) for m in makers["mt"])
    mt_sorted = tuple(m(W, K, ray_sort=True) for m in makers["mt"])
    v2 = tuple(m(W, K) for m in makers["tri9"])
    v2_out = {}
    err = {"mt": [0.0, 0.0], "tri9": [0.0, 0.0]}
    for (name, n), (batch, v7h, v7o, ref, ref_occ, _, _) in pair_out.items():
        label = f"mt forest {name} rays N={n}"
        hit = mt[0](*batch, g.mt_slabs, g.cbounds)
        occ = mt[1](*batch, g.mt_slabs, g.cbounds)
        res = agreement(hit, occ, ref, ref_occ, batch, label)
        check_pairs(label + " vs plain", res)
        same_v7 = agreement(hit, occ, v7h, v7o, batch, label)
        srt_hit = mt_sorted[0](*batch, g.mt_slabs, g.cbounds)
        srt_occ = mt_sorted[1](*batch, g.mt_slabs, g.cbounds)
        same_sorted = (all(torch.equal(x, y) for x, y in zip(hit, srt_hit))
                       and torch.equal(occ, srt_occ))
        log(f"{label} vs v7 kernels: bit for bit {same_v7[-1]}, prim agree "
            f"{same_v7[1]:.6f}; ray sort on vs off: identical {same_sorted}")
        check(res[-1] and same_v7[-1],
              f"{label}: v4 differs from pair_plain or from v7")
        check(same_sorted, f"{label}: ray sorting changed the results")
        err["mt"] = [max(err["mt"][0], res[2]), max(err["mt"][1], res[5])]

        label = f"tri9 forest {name} rays N={n}"
        res, outs, ms = compare_pairs(v2, batch, tri9, g.cbounds, label)
        check_pairs(label, res, ms)
        check(res[-1], f"{label}: v2 differs from tri9_plain")
        vf, pf, _, mr, of, _, _, _ = agreement(outs[0], outs[1], v7h, v7o,
                                               batch, label)
        log(f"{label} vs v7 kernels: valid agree {vf:.6f}, prim agree "
            f"{pf:.6f} (max rel dt {mr:.3e}), occluded agree {of:.6f}")
        check(vf >= PAIR_VALID and pf >= PAIR_PRIM and of >= PAIR_OCC,
              f"{label}: v2 and v7 find different hits")
        v2_out[(name, n)] = (*outs, ms)
        err["tri9"] = [max(err["tri9"][0], res[2]),
                       max(err["tri9"][1], res[5])]
    for variant, (e_c, e_o) in err.items():
        recs[f"{variant}_closest"]["max_abs_err"] = e_c
        recs[f"{variant}_occluded"]["max_abs_err"] = e_o

    log(f"(comparison launches, not counted as the main path's: "
        f"{[k.launches for k in mt + mt_sorted + v2]})")
    return tri9, v2_out


def phase_kernel_times(recs, forest, pair_out, tri9, v2_out):
    """All six traversal kernels at 1,048,576 forest camera, shadow and
    bounce rays, each beside the batch's bound."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    scene, st, _ = forest
    g = scene.geom
    K, W = g.cbounds.shape[0], st.cluster_window
    kernels = {
        "pair": (trace.make_pair_intersector(W, K),
                 trace.make_pair_occluder(W, K), g.mt_slabs),
        "mt": (trace.make_mt_intersector(W, K, ray_sort=False),
               trace.make_mt_occluder(W, K, ray_sort=False), g.mt_slabs),
        "tri9": (trace.make_tri9_intersector(W, K),
                 trace.make_tri9_occluder(W, K), tri9)}
    for name in ("camera", "shadow", "bounce"):
        batch, _, _, ref, ref_occ, _, _ = pair_out[(name, N_TIMED)]
        v2_ref, v2_occ = v2_out[(name, N_TIMED)][2:4]
        for variant, (ck, ok, table) in kernels.items():
            hit, occ = (v2_ref, v2_occ) if variant == "tri9" else (ref,
                                                                   ref_occ)
            for k, occl in ((ck, None), (ok, occ)):
                ms = cuda_ms(lambda: k(*batch, table, g.cbounds), iters=5,
                             warmup=1)
                b_ms, by, pairs, clusters, blocks = traversal_bound(
                    batch, hit, occl, g.cbounds, W, variant)
                rec = recs[k.name]
                rec[f"ms_{name}"] = ms
                rec[f"bound_ms_{name}"] = b_ms
                if name == "camera":
                    rec.update(ms=ms, bound_ms=b_ms, bound_by=by, n=N_TIMED)
                swept = rec.get("swept_per_ray", {}).get(f"{name}_{N_TIMED}")
                walk = "" if swept is None else (f"; swept {swept:.3f} "
                                                 f"clusters per live ray")
                if variant != "pair":
                    live = max(int((batch[3] > batch[2]).sum()), 1)
                    got, *counts = k.count_visits(*batch, table, g.cbounds)
                    same = (torch.equal(got, occ) if k.any_hit else
                            all(torch.equal(a, b) for a, b in zip(got, hit)))
                    check(same, f"{k.name}: the counting launch differs from "
                          f"its plain version on {name} rays")
                    sweeps, reads, entered = (c / live for c in counts)
                    rec.setdefault("walk_per_ray", {})[name] = dict(
                        sweeps=sweeps, slab_reads=reads, entered=entered)
                    walk = (f"; per live ray {sweeps:.3f} (ray, tile) sweeps, "
                            f"{reads:.3f} (block, cluster) slab reads, "
                            f"{entered:.3f} worklist entries entered")
                log(f"{k.name} at {N_TIMED} forest {name} rays: kernel "
                    f"{ms:.4f} ms; bound {b_ms:.4f} ms ({by}: {pairs} (ray, "
                    f"cluster) pairs, {clusters} clusters; {blocks} (64-ray "
                    f"block, cluster) pairs, {blocks * 64 / max(pairs, 1):.2f}"
                    f"x the ray pairs)" + walk)
        # v4 with GDMT_RAY_SORT's coherence sort around it
        for k in kernels["mt"][:2]:
            srt = trace.BlockKernel("mt", k.any_hit, W, K, ray_sort=True)
            ms = cuda_ms(lambda: srt(*batch, g.mt_slabs, g.cbounds), iters=5,
                         warmup=1)
            recs[k.name][f"ms_{name}_sorted"] = ms
            log(f"{k.name} at {N_TIMED} forest {name} rays, ray sort on "
                f"(sort and unsort included): {ms:.4f} ms")
    # the plain versions' times: their 1,048,576-ray camera comparison
    # calls (pair_plain serves v7 and v4)
    cam_ms = pair_out[("camera", N_TIMED)][5]
    v2_ms = v2_out[("camera", N_TIMED)][4]
    for variant, (c_ms, o_ms) in (("pair", cam_ms), ("mt", cam_ms),
                                  ("tri9", v2_ms)):
        recs[f"{variant}_closest"].update(plain_ms=c_ms, plain_n=N_TIMED)
        recs[f"{variant}_occluded"].update(plain_ms=o_ms, plain_n=N_TIMED)


def kernel_time_render(wrapper, run, label):
    """run() (one more render) with every launch of the kernel wrapper
    class `wrapper` (its _launch) bracketed by CUDA events: returns (wall
    s, {kernel name: (device ms, calls)}).  The events' own launches make
    the wall a little longer than the timed render's."""
    marks = []
    launch = wrapper._launch

    def timed_launch(k, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(k, *args, **kw)
        end.record()
        marks.append((k.name, start, end))
        return out

    wrapper._launch = timed_launch
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        wrapper._launch = launch
    per = {}
    for name, start, end in marks:
        ms, n = per.get(name, (0.0, 0))
        per[name] = (ms + start.elapsed_time(end), n + 1)
    total = sum(ms for ms, _ in per.values())
    log(f"  {label} inside one more render: "
        + ", ".join(f"{n} {ms:.3f} ms over {c} calls"
                    for n, (ms, c) in per.items())
        + f"; {total:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"({100 * total / (wall * 1e3):.1f}%)")
    return wall, per


def forest_kernel_time_render(tracer, scene, seed):
    """kernel_time_render of one more forest render (16 spp) through the
    traversal kernels."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    return kernel_time_render(
        trace.TraversalKernel,
        lambda: tracer.render(scene, seed=seed, spp=16, chunk=16),
        f"traversal kernels (seed {seed})")


def phase_forest_slice(dev, kernels_rec, forest):
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    scene, st, info = forest
    tracer = PathTracer(scene, st)
    tracer.count_rays = True
    t0 = time.time()
    tracer.render(scene, seed=0, spp=16, chunk=16)
    torch.cuda.synchronize()
    log(f"forest warm-up render {time.time() - t0:.3f} s")

    for k in tracer.kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    img = tracer.render(scene, seed=1, spp=16, chunk=16)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = [k.launches for k in tracer.kernels]
    peak = torch.cuda.max_memory_allocated(dev)
    rays = tracer.last_ray_count
    for rec, n in zip(kernels_rec[2:], launches):
        rec["launches"] = n
    log(f"forest PathTracer.render 256x256 16spp maxDepth 5: wall "
        f"{wall:.4f} s, measured rays {rays}, {rays / wall / 1e6:.3f} "
        f"Mrays/s, kernel launches pair_closest {launches[0]} "
        f"pair_occluded {launches[1]}, peak device memory {peak} bytes")
    check(all(n > 0 for n in launches),
          f"a pair kernel was not launched by the forest path: {launches}")
    check(tuple(img.shape) == (256, 256, 3), f"image shape "
          f"{tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "forest image not finite")
    lit = float((img > 0).any(-1).float().mean())
    mean = float(img.mean())
    log(f"forest image mean {mean:.5f}, lit pixels {lit:.4f}")
    check(mean > 0 and lit > 0.1, "forest image is black")
    _, per = forest_kernel_time_render(tracer, scene, 2)
    return dict(wall_s=wall, rays=rays, mrays_per_s=rays / wall / 1e6,
                peak_bytes=peak, image_mean=mean, lit_frac=lit,
                kernel_ms=per, **info), img


def phase_forest_vs_plain(dev, forest):
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.ops import common
    scene, st, _ = forest
    small = dataclasses.replace(st, width=64, height=64, spp=2)
    out = {}
    for plain in (False, True):
        tracer = PathTracer(scene, small)
        tracer.count_rays = True
        if plain:
            ck, ok = tracer.kernels
            tracer.closest, tracer.occluded = common.instrument_intersectors(
                tracer,
                lambda o, d, mn, mx, g: ck.plain(o, d, mn, mx, g.mt_slabs,
                                                 g.cbounds),
                lambda o, d, mn, mx, g: ok.plain(o, d, mn, mx, g.mt_slabs,
                                                 g.cbounds))
        t0 = time.time()
        img = tracer.render(scene, seed=5, spp=2, chunk=2)
        torch.cuda.synchronize()
        out[plain] = (img, tracer.last_ray_count, time.time() - t0,
                      [k.launches for k in tracer.kernels])
    (ik, rk, tk, lk), (ip, rp, tp, lp) = out[False], out[True]
    log(f"forest 64x64 2spp kernel vs plain: rays {rk} vs {rp}, wall "
        f"{tk:.3f} s vs {tp:.3f} s, launches {lk} vs {lp}")
    check(all(n > 0 for n in lk) and lp == [0, 0],
          "kernel render did not launch, or plain render launched")
    check(abs(rk - rp) <= 1e-3 * rp, "forest ray counts differ")
    frac = float(torch.isclose(ik, ip, rtol=IMG_RTOL, atol=IMG_ATOL)
                 .all(-1).float().mean())
    log(f"  image: {frac:.5f} of pixels within rtol {IMG_RTOL} atol "
        f"{IMG_ATOL}; means {float(ik.mean()):.6f} vs {float(ip.mean()):.6f}")
    check(frac >= IMG_FRAC, "forest kernel and plain images differ")

    # G-PT on the forest: the shift paths' shadow queries on the pair
    # kernels
    gst = dataclasses.replace(st, width=64, height=64, spp=4,
                              integrator="gpt")
    tracer = GPTracer(scene, gst)
    tracer.count_rays = True
    t0 = time.time()
    final, bufs = tracer.render_final(scene, 2, 4, alpha=0.2, mode="L2")
    torch.cuda.synchronize()
    launches = [k.launches for k in tracer.kernels]
    log(f"forest G-PT 64x64 4spp L2: {time.time() - t0:.3f} s, rays "
        f"{int(bufs['rays'])}, launches {launches}, final mean "
        f"{float(final.mean()):.5f}")
    check(all(n > 0 for n in launches), "G-PT did not launch both pair "
          "kernels")
    check(bool(torch.isfinite(final).all()), "forest G-PT final not finite")
    check(all(bool(torch.isfinite(bufs[k]).all())
              for k in ("primal", "dx", "dy", "very_direct")),
          "forest G-PT buffers not finite")
    return final, int(bufs["rays"])


def phase_v4_slice(dev, recs, forest, v7_img, v7_rays, v7_gpt):
    """Slice 3: the forest render with GDMT_KERNEL=v4, through
    choose_intersector and PathTracer.render, against the v7 render of
    phase 6 (same seed); then G-PT render_final under v4 against the same
    call under v7 (phase 7)."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    scene, st, _ = forest
    saved = os.environ.get("GDMT_KERNEL")
    os.environ["GDMT_KERNEL"] = "v4"
    try:
        tracer = PathTracer(scene, st)
        gst = dataclasses.replace(st, width=64, height=64, spp=4,
                                  integrator="gpt")
        gpt = GPTracer(scene, gst)
    finally:
        if saved is None:
            del os.environ["GDMT_KERNEL"]
        else:
            os.environ["GDMT_KERNEL"] = saved
    names = [k.name for k in tracer.kernels + gpt.kernels]
    check(names == ["mt_closest", "mt_occluded"] * 2,
          f"GDMT_KERNEL=v4 chose {names}")
    tracer.count_rays = True
    t0 = time.time()
    tracer.render(scene, seed=0, spp=16, chunk=16)
    torch.cuda.synchronize()
    log(f"v4 forest warm-up render {time.time() - t0:.3f} s")

    # a v7 launch would load csrc/trace.cu's library: count those loads
    v7_loads = [0]
    load_v7 = trace.load_library

    def counting_load():
        v7_loads[0] += 1
        return load_v7()

    trace.load_library = counting_load
    try:
        for k in tracer.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        img = tracer.render(scene, seed=1, spp=16, chunk=16)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [k.launches for k in tracer.kernels]
    finally:
        trace.load_library = load_v7
    peak = torch.cuda.max_memory_allocated(dev)
    rays = tracer.last_ray_count
    for k, n in zip(tracer.kernels, launches):
        recs[k.name]["launches"] = n
    log(f"forest PathTracer.render 256x256 16spp maxDepth 5, GDMT_KERNEL=v4: "
        f"wall {wall:.4f} s, measured rays {rays}, "
        f"{rays / wall / 1e6:.3f} Mrays/s, kernel launches mt_closest "
        f"{launches[0]} mt_occluded {launches[1]}, v7 launches "
        f"{v7_loads[0]}, peak device memory {peak} bytes")
    check(all(n > 0 for n in launches) and v7_loads[0] == 0,
          f"the v4 render launched v4 {launches} and v7 {v7_loads[0]} times")
    check(bool(torch.isfinite(img).all()), "v4 forest image not finite")
    diff = float((img - v7_img).abs().max())
    frac = float(torch.isclose(img, v7_img, rtol=IMG_RTOL, atol=IMG_ATOL)
                 .all(-1).float().mean())
    log(f"  vs the v7 render (seed 1): rays {rays} vs {v7_rays}, max |diff| "
        f"{diff:.3e}, {frac:.5f} of pixels within rtol {IMG_RTOL} atol "
        f"{IMG_ATOL}")
    check(rays == v7_rays, "v4 and v7 forest renders traced different rays")
    check(frac >= IMG_FRAC, "v4 and v7 forest images differ")
    _, per = forest_kernel_time_render(tracer, scene, 2)

    t0 = time.time()
    gpt.count_rays = True
    final, bufs = gpt.render_final(scene, 2, 4, alpha=0.2, mode="L2")
    torch.cuda.synchronize()
    g_launches = [k.launches for k in gpt.kernels]
    g_frac = float(torch.isclose(final, v7_gpt[0], rtol=IMG_RTOL,
                                 atol=IMG_ATOL).all(-1).float().mean())
    log(f"forest G-PT 64x64 4spp L2 under v4: {time.time() - t0:.3f} s, "
        f"rays {int(bufs['rays'])} vs {v7_gpt[1]} under v7, launches "
        f"{g_launches}, {g_frac:.5f} of pixels within tolerance of v7's "
        f"final (max |diff| {float((final - v7_gpt[0]).abs().max()):.3e})")
    check(all(n > 0 for n in g_launches), "G-PT under v4 did not launch "
          "both v4 kernels")
    check(int(bufs["rays"]) == v7_gpt[1] and g_frac >= IMG_FRAC,
          "G-PT finals under v4 and v7 differ")
    return dict(wall_s=wall, rays=rays, mrays_per_s=rays / wall / 1e6,
                peak_bytes=peak, launches=launches, max_abs_diff_vs_v7=diff,
                kernel_ms=per)


def phase_v2_path(recs, forest, pair_out, tri9):
    """The v2 entry point (make_tri9_intersector / make_tri9_occluder)
    on the whole forest batches: closest hits of the camera and bounce
    rays, any hits of the shadow rays, counters reset just before."""
    from gradientdomain_mitsuba_tpu_torch.ops import trace
    scene, st, _ = forest
    g = scene.geom
    K, W = g.cbounds.shape[0], st.cluster_window
    ck, ok = trace.make_tri9_intersector(W, K), trace.make_tri9_occluder(W, K)
    t0 = time.time()
    hits = [ck(*pair_out[(name, N_TIMED)][0], tri9, g.cbounds)
            for name in ("camera", "bounce")]
    occ = ok(*pair_out[("shadow", N_TIMED)][0], tri9, g.cbounds)
    torch.cuda.synchronize()
    for k in (ck, ok):
        recs[k.name]["launches"] = k.launches
    log(f"v2 path on {N_TIMED} camera, bounce (closest) and shadow (any "
        f"hit) forest rays: {time.time() - t0:.3f} s, hit fractions "
        f"{[round(float(h.valid.float().mean()), 4) for h in hits]}, "
        f"occluded {float(occ.float().mean()):.4f}, launches "
        f"{ck.launches} / {ok.launches}")
    check(ck.launches == 2 and ok.launches == 1, "v2 path launch counts")


# ---------------------------------------------------------------------------
# slice 8: the bidirectional family (BDPT, G-BDPT + reconstruction) and the
# step-B integrators (direct, ao, field, multichannel, adaptive) on cbox

def load_cbox(dev, size, spp, depth, integrator):
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    scene_np, st = sc.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth), "integrator": integrator})
    return bridge.to_torch(scene_np, dev), st


def bidir_render(tracer, scene, seed, spp):
    """BDPT: the image.  G-BDPT: (L1 final via poisson.reconstruct, the
    buffers render returns)."""
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    out = tracer.render(scene, seed=seed, spp=spp)
    if isinstance(out, dict):
        return poisson.reconstruct(out, mode="L1"), out
    return out


def phase_bidir_slice(dev):
    """BDPT and G-BDPT (+ L1) on cbox 256^2, 16 spp, maxDepth 6."""
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    size, spp, depth = 256, 16, 6
    t0 = time.time()
    scene, st = load_cbox(dev, size, spp, depth, "bdpt")
    torch.cuda.synchronize()
    log(f"cbox {size}x{size} {spp}spp maxDepth {depth}; scene load + upload "
        f"{time.time() - t0:.3f} s")
    summary, images = {}, {}
    for name, cls in (("bdpt", BDPTracer), ("gbdpt", GBDPTracer)):
        tracer = cls(scene, st)
        tracer.count_rays = True
        t0 = time.time()
        bidir_render(tracer, scene, 0, 1)
        torch.cuda.synchronize()
        log(f"{name}: warm-up render (1 spp) {time.time() - t0:.3f} s")
        for k in tracer.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = bidir_render(tracer, scene, 1, spp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [k.launches for k in tracer.kernels]
        rays = tracer.last_ray_count
        img = out[0] if name == "gbdpt" else out
        images[name] = out
        mean = float(img.abs().mean())
        log(f"{name} timed render{' + L1' if name == 'gbdpt' else ''}: wall "
            f"{wall:.4f} s, measured rays {rays}, "
            f"{rays / wall / 1e6:.3f} Mrays/s, kernel launches closest "
            f"{launches[0]} occluded {launches[1]}, mean |I| {mean:.5f}")
        check(all(n > 0 for n in launches),
              f"{name}: a sweep kernel was not launched: {launches}")
        check(tuple(img.shape) == (size, size, 3), f"{name} image shape")
        check(bool(torch.isfinite(img).all()), f"{name} image not finite")
        check(mean > 0, f"{name} image is black")

        def run(tracer=tracer):
            bidir_render(tracer, scene, 2, spp)

        prof = profiled_render(run, "sweep_")
        log(f"  profiled {name} render (seed 2): device busy "
            f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
            f"(idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%), "
            f"{prof['device_ops']} device ops; sweep kernels' device time "
            f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} "
            f"launches")
        summary[name] = dict(wall_s=wall, rays=rays,
                             mrays_per_s=rays / wall / 1e6,
                             launches=launches, mean=mean, profiled=prof)

    # the reference's identity: G-BDPT primal + very_direct == BDPT
    bufs = images["gbdpt"][1]
    comb = bufs["primal"] + bufs["very_direct"]
    close = torch.isclose(comb, images["bdpt"], rtol=2e-4, atol=2e-5)
    err = float((comb - images["bdpt"]).abs().max())
    log(f"G-BDPT primal + very_direct vs BDPT (seed 1): "
        f"{float(close.float().mean()):.6f} of values within rtol 2e-4 "
        f"atol 2e-5, max abs diff {err:.3e}")
    check(bool(close.all()), "G-BDPT primal + very_direct != BDPT")

    # BDPT and the path tracer estimate the same integral
    pt = PathTracer(scene, st)
    t0 = time.time()
    ref = pt.render(scene, seed=9, spp=spp)
    torch.cuda.synchronize()
    ratio = float(images["bdpt"].mean()) / float(ref.mean())
    log(f"BDPT mean / PathTracer mean ({spp} spp, {time.time() - t0:.3f} "
        f"s): {ratio:.5f}")
    check(abs(ratio - 1) < 0.03, f"BDPT mean off the path tracer's: {ratio}")
    summary["bdpt_over_path_mean"] = ratio
    return summary


def _buffers_agree(label, a, b):
    frac = float(torch.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL)
                 .all(-1).float().mean())
    rel = abs(float(a.mean()) - float(b.mean())) / max(
        abs(float(b.mean())), 1e-12)
    log(f"  {label}: {frac:.5f} of pixels within rtol {IMG_RTOL} atol "
        f"{IMG_ATOL}; mean rel diff {rel:.2e}")
    check(frac >= IMG_FRAC, f"{label} differs between kernel and plain")
    check(rel < 1e-4 or abs(float(a.mean()) - float(b.mean())) < 1e-6,
          f"{label} mean differs")


def phase_bidir_vs_plain(dev):
    """Every sweep call of one 256^2 pass of BDPT and of G-BDPT against
    the plain versions; BDPT and G-BDPT at 64^2, 4 spp through the
    kernels and through the plain versions (same seed), and two kernel
    renders bit for bit."""
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    # every sweep call of one pass at the main path's shape (256^2), dead
    # lanes included, against the plain versions
    scene, st = load_cbox(dev, 256, 16, 6, "gbdpt")
    for name, cls in (("bdpt", BDPTracer), ("gbdpt", GBDPTracer)):
        check_render_calls(f"{name} 256x256", render_calls(
            cls(scene, st), scene, 1), scene.geom.linC)
    scene, st = load_cbox(dev, 64, 4, 6, "gbdpt")
    for name, cls in (("bdpt", BDPTracer), ("gbdpt", GBDPTracer)):
        outs = {}
        for mode in ("kernel", "plain", "kernel again"):
            tracer = cls(scene, st)
            if mode == "plain":
                use_plain(tracer)
            tracer.count_rays = True
            outs[mode] = (tracer.render(scene, seed=5, spp=4),
                          tracer.last_ray_count)
        (ok, rk), (op, rp), (oa, _) = (outs[m] for m in
                                       ("kernel", "plain", "kernel again"))
        log(f"{name} 64x64 4spp kernel vs plain: rays {rk} vs {rp}")
        check(abs(rk - rp) <= 1e-3 * rp, f"{name} ray counts differ")
        if name == "bdpt":
            _buffers_agree("bdpt image", ok, op)
            same = torch.equal(ok, oa)
        else:
            for k in ("primal", "very_direct", "dx", "dy"):
                _buffers_agree(f"gbdpt {k}", ok[k], op[k])
            l2k = poisson.reconstruct(ok, mode="L2")
            l2p = poisson.reconstruct(op, mode="L2")
            _buffers_agree("gbdpt L2 final", l2k, l2p)
            fk = poisson.reconstruct(ok, mode="L1")
            fp = poisson.reconstruct(op, mode="L1")
            ek = _l1_energy(fk - ok["very_direct"], op["primal"], op["dx"],
                            op["dy"])
            ep = _l1_energy(fp - op["very_direct"], op["primal"], op["dx"],
                            op["dy"])
            rel = abs(float(fk.mean()) - float(fp.mean())) / abs(
                float(fp.mean()))
            log(f"  gbdpt L1 final: objective {ek:.4f} vs {ep:.4f}; mean "
                f"rel diff {rel:.2e}")
            check(abs(ek - ep) <= 0.01 * ep and rel < 5e-3,
                  "G-BDPT L1 final differs")
            check(bool(torch.isfinite(fk).all()), "G-BDPT L1 not finite")
            same = all(torch.equal(ok[k], oa[k]) for k in ok)
        log(f"  {name}: two kernel renders bit-identical: {same}")
        check(same, f"{name}: two kernel renders differ")


def phase_gbdpt_gradients(dev):
    """E[dx] of G-BDPT against the finite difference of a high-spp primal
    (tests/test_bdpt.py's consistency check) at 64^2, maxDepth 2."""
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    scene, st = load_cbox(dev, 64, 8, 2, "gbdpt")
    g = GBDPTracer(scene, st)
    t0 = time.time()
    out = g.render(scene, seed=0, spp=48)
    ref = g.render(scene, seed=555, spp=256)
    torch.cuda.synchronize()
    fd_x = ref["primal"][:, 1:] - ref["primal"][:, :-1]
    dx = out["dx"][:, :-1]
    vd = out["very_direct"].sum(-1)
    mx = (vd[:, 1:] + vd[:, :-1]) == 0  # mask light-edge pixels
    a, b = dx[mx].flatten(), fd_x[mx].flatten()
    rms_fd = float(torch.sqrt((b ** 2).mean()))
    rms_err = float(torch.sqrt(((a - b) ** 2).mean()))
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    log(f"G-BDPT 64x64 maxDepth 2, 48 vs 256 spp ({time.time() - t0:.3f} s): "
        f"rms(dx - fd) / rms(fd) {rms_err / rms_fd:.4f} (< 0.55), "
        f"corr {corr:.4f} (> 0.85)")
    check(rms_err / rms_fd < 0.55, "G-BDPT E[dx] off the finite difference")
    check(corr > 0.85, "G-BDPT dx uncorrelated with the finite difference")
    return dict(rms_ratio=rms_err / rms_fd, corr=corr)


def phase_step_b(dev):
    """direct, ao, field (shNormal), multichannel (path + ao) at 256^2,
    16 spp and adaptive at 64^2, 4 spp, through factory.make_integrator
    (tools/tpu_zoo.py's check: finite pixels, mean |I| > 1e-5); adaptive
    also against its render through the plain versions (sample map and
    image)."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    summary = {}
    for name, size, spp, props in (
            ("direct", 256, 16, {}), ("ao", 256, 16, {}),
            ("field", 256, 16, {"field": "shNormal"}),
            ("multichannel", 256, 16, {}), ("adaptive", 64, 4, {})):
        scene, st = load_cbox(dev, size, spp, 5, name)
        st.integrator_props.update(props)
        if name == "multichannel":
            st.integrator_children = [("path", {}), ("ao", {})]
        tracer = factory.make_integrator(scene, st)
        kernels = ([k for _, c in tracer.children for k in c.kernels]
                   if name == "multichannel" else list(tracer.kernels))
        if name != "adaptive":
            # adaptive's first rounds warm the path tracer's ops; a
            # warm-up render would cost its host-paced rounds twice
            tracer.render(scene, seed=0, spp=1)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = tracer.render(scene, seed=1, spp=spp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        imgs = out if isinstance(out, dict) else {name: out}
        for ch, img in imgs.items():
            finite = bool(torch.isfinite(img).all())
            mean = float(img.abs().mean())
            log(f"{ch:14s} {size}x{size} {spp}spp: wall {wall:.4f} s, "
                f"finite {finite}, mean |I| {mean:.5f}, sweep launches "
                f"{[k.launches for k in kernels]}")
            check(finite and mean > 1e-5, f"{ch}: not finite or black")
            summary[ch] = dict(wall_s=wall, mean=mean)
        # field traces camera rays only: no any-hit query
        need = kernels[:1] if name == "field" else kernels
        check(all(k.launches > 0 for k in need),
              f"{name}: a sweep kernel was not launched")
        if name == "adaptive":
            smap = tracer.last_sample_map
            log(f"  adaptive samples per pixel: min {int(smap.min())} max "
                f"{int(smap.max())} mean {float(smap.mean()):.2f}; "
                f"{int(smap.sum()) - spp * size * size} refine lanes over "
                f"its rounds")
            # the same render through the plain versions: the sample map
            # and the image
            plain = factory.make_integrator(scene, st)
            use_plain(plain.inner)
            t0 = time.time()
            img_p = plain.render(scene, seed=1, spp=spp)
            torch.cuda.synchronize()
            same = float((plain.last_sample_map == smap).float().mean())
            frac = float(torch.isclose(out, img_p, rtol=IMG_RTOL,
                                       atol=IMG_ATOL).all(-1).float().mean())
            rel = abs(float(out.mean()) - float(img_p.mean())) / float(
                img_p.mean())
            log(f"  adaptive kernel vs plain ({time.time() - t0:.3f} s): "
                f"sample map equal on {same:.5f} of pixels, image "
                f"{frac:.5f} within rtol {IMG_RTOL} atol {IMG_ATOL}, mean "
                f"rel diff {rel:.2e}")
            check(same >= IMG_FRAC and frac >= IMG_FRAC and rel < 1e-3,
                  "adaptive: kernel and plain renders differ")
    return summary


def build_kernels():
    """Build the three kernel libraries, one nvcc each, all started
    together; prints how much the overlap saves against building them
    one after another (the sum of the per-source times)."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep, trace

    def timed(load):
        t0 = time.time()
        load()
        return time.time() - t0

    sources = (("sweep.cu", sweep.load_library),
               ("trace.cu", trace.load_library),
               ("trace_block.cu", trace.load_block_library))
    t0 = time.time()
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {name: pool.submit(timed, load) for name, load in sources}
        each = {name: fut.result() for name, fut in futs.items()}
    wall = time.time() - t0
    for name, sec in each.items():
        log(f"kernel build+load {name}: {sec:.3f} s")
    log(f"parallel build wall {wall:.3f} s against {sum(each.values()):.3f} "
        f"s of per-source time: the overlap saves "
        f"{sum(each.values()) - wall:.3f} s")


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA card")
    from gradientdomain_mitsuba_tpu_torch import config
    dev = config.get_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(card_line())
    with Phase("build"):
        build_kernels()

    csrc = "gradientdomain_mitsuba_tpu_torch/csrc/"
    ref_sweep = "gradientdomain_mitsuba_tpu/ops/pallas_sweep.py:"
    ref_trace = "gradientdomain_mitsuba_tpu/ops/pallas_trace.py:"
    kernels_rec = [
        dict(name=name, route="cuda", source=csrc + src, replaces=replaces,
             launches=0, max_abs_err=None, ms=None, plain_ms=None,
             bound_ms=None, bound_by=None, library_ms=None)
        for name, src, replaces in (
            ("sweep_closest", "sweep.cu", ref_sweep + "91"),
            ("sweep_occluded", "sweep.cu", ref_sweep + "131"),
            ("pair_closest", "trace.cu", ref_trace + "919"),
            ("pair_occluded", "trace.cu", ref_trace + "919"),
            ("mt_closest", "trace_block.cu", ref_trace + "324"),
            ("mt_occluded", "trace_block.cu", ref_trace + "324"),
            ("tri9_closest", "trace_block.cu", ref_trace + "62"),
            ("tri9_occluded", "trace_block.cu", ref_trace + "62"))]
    recs = {r["name"]: r for r in kernels_rec}
    with Phase("sweep kernels vs plain"):
        phase_kernels(dev, kernels_rec)
    with Phase("slice 1: cbox G-PT + L1"):
        summary = phase_slice(dev, kernels_rec)
    with Phase("cbox kernel render vs plain render"):
        phase_render_vs_plain(dev)
    with Phase("forest load"):
        forest = load_forest(dev)
    with Phase("pair kernels vs plain"):
        pair_out = phase_pair_kernels(dev, kernels_rec, forest)
    with Phase("slice 2: forest PathTracer"):
        forest_summary, v7_img = phase_forest_slice(dev, kernels_rec, forest)
    with Phase("forest kernel render vs plain render, forest G-PT"):
        v7_gpt = phase_forest_vs_plain(dev, forest)
    with Phase("v4 and v2 kernels vs plain"):
        tri9, v2_out = phase_block_kernels(dev, recs, forest, pair_out)
    with Phase("kernel times at 1M forest rays"):
        phase_kernel_times(recs, forest, pair_out, tri9, v2_out)
    with Phase("slice 3: forest PathTracer with GDMT_KERNEL=v4"):
        v4_summary = phase_v4_slice(dev, recs, forest, v7_img,
                                    forest_summary["rays"], v7_gpt)
    with Phase("v2 path"):
        phase_v2_path(recs, forest, pair_out, tri9)
    with Phase("slice 8: cbox BDPT and G-BDPT"):
        bidir_summary = phase_bidir_slice(dev)
    with Phase("bidirectional kernel render vs plain render"):
        phase_bidir_vs_plain(dev)
    with Phase("G-BDPT gradients"):
        grad_summary = phase_gbdpt_gradients(dev)
    with Phase("step B families"):
        step_b = phase_step_b(dev)
    log(json.dumps({"slice": summary, "forest": forest_summary,
                    "forest_v4": v4_summary, "bidir": bidir_summary,
                    "gbdpt_gradients": grad_summary, "step_b": step_b}))
    log(f"total {time.time() - t_start:.3f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
