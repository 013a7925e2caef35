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
 12. slice 8: cbox 256x256, 16 spp, maxDepth 4, BDPTracer.render and
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
     thresholds: rms ratio < 0.55, correlation > 0.85), 16 samples a
     pixel a pass;
 15. step B families through factory.make_integrator: direct, ao, field
     (shNormal), multichannel (path + ao) at 256x256, 16 spp, maxDepth 5,
     and adaptive at 64x64, 4 spp, maxDepth 3 (finite pixels, mean |I| >
     1e-5, sweeps launched; adaptive's refine rounds as wide as the
     film, refineFraction 1);
     adaptive once more through the plain versions, same seed: the
     sample maps equal and the images within phase 4's tolerance on >= 99%
     of pixels, means within 1e-3;
 16. step D families through factory.make_integrator: volpath, vpl
     (vplCount 1024, vplChunk 256), irrcache (resolution 4, gatherSamples
     64) and sppm (photonCount 65,536) on cbox 256x256, 16 spp, maxDepth
     5, and volpath on the HG slab and its heterogeneous twin of
     tools/media_scenes.py, each after a 1-spp warm-up with the sweeps'
     launch counters reset just before it (wall, rays from the
     intersectors' device tallies, Mrays/s, launches, finite pixels,
     mean |I| > 1e-5); volpath against path on cbox at unlimited depth
     (64x64, 4 spp: rtol 5e-3 on >= 99.9% of pixels; the maxDepth-5
     comparison with phase 15's path render printed);
     one profiled render of vpl and of the heterogeneous slab; VPL's
     first 16,777,216-lane any-hit call against the plain version at
     phase 2's tolerance, timed beside its bound; all six at 64x64, 4 spp
     through the kernels and the plain versions (phase 4's tolerance),
     sppm and vpl twice bit for bit;
 17. step E on caustics.xml (analytic glass and Ag spheres, ldsampler,
     gaussian filter) through factory.make_integrator at the scene's
     256x256, maxDepth 8: path, bdpt, sppm, pssmlt, erpt at 16 spp
     (mutations a pixel for the chains) and mlt at 1, each after a
     warm-up with the sweeps' launch counters reset just before it (wall,
     rays, launches, finite pixels, mean |I| > 1e-5); one profiled pssmlt
     render; all six at 64x64, 4 spp through the kernels and the plain
     versions (phase 4's tolerance; for the chains the share of
     acceptance decisions that agree); pssmlt's mean against path's
     (64x64, 1,024 samples and mutations a pixel) and mlt's against the
     timed bdpt render's (256x256, 16), each within 5%;
 18. step F on envmap.xml (envmap emitter, thin lens, gaussian filter,
     checkerboard-textured roughplastic ground, analytic roughconductor,
     roughdielectric and plastic spheres) through factory.make_integrator
     at the scene's own 128x96, 32 spp, maxDepth 5: G-PT + L1
     reconstruction and path, each after a 1-spp warm-up with the sweeps'
     launch counters reset just before it (wall, rays from the device
     tallies, Mrays/s, launches, added to the sweep kernels' records,
     finite pixels), then one more render of each under torch.profiler
     (device busy time and idle share, device ops); both at the zoo's
     64x64, 4 spp, seed 1 through the kernels and through the plain
     versions (the four G-PT buffers and the path image within rtol
     1e-3 / atol 1e-4 on >= 99% of pixels, means within 1e-3 relative);
     the G-PT primal's mean |I| there against ZOO_r05.json's
     envmap-gpt 0.12644, within 5%;
 19. step 7a (G-PT's half-vector shift, G-BDPT's specular prefix replay)
     through factory.make_integrator: G-BDPT + L1 on caustics.xml at
     128x128, 16 spp, maxDepth 8 (CONFIGS_r05.json #3), G-PT + L1 on
     caustics.xml and on cbox-mats.xml at 128x128, 32 spp, maxDepth 8,
     each after a 1-spp warm-up with the sweeps' launch counters reset
     just before it (wall, rays, launches, added to the sweep kernels'
     records), then one profiled render of each (device idle share;
     G-BDPT's at 4 spp);
     the three at 64x64, 4 spp through the kernels and the plain
     versions (the buffers, G-BDPT's light image and one pass's t=1
     gradient pairs within phase 4's tolerance on >= 99%, means within
     1e-3 relative, rays within 1e-3);
     G-PT primal + very_direct against PathTracer on caustics at maxDepth
     5 (rtol 3e-4, atol 3e-5; deeper, G-PT's Russian roulette starts one
     bounce before the path tracer's, as in the reference) and G-BDPT's
     against BDPTracer at maxDepth 8 (phase 12's check); E[dx] through the
     reference tests' glass sphere against finite differences at their
     thresholds (tests/test_gpt_specular.py, test_gbdpt_specular.py).
 20. step G1 through factory.make_integrator: door.xml (BASELINE config
     #2, CONFIGS_r05.json: diffuse, roughconductor, roughplastic and
     thindielectric rows, three two-sided) with G-PT + L1 and path at
     128x128, 32 spp, maxDepth 8, BDPT and G-BDPT + L1 at 16 spp,
     maxDepth 5; G-BDPT + L1 on cbox-mats.xml (textured floor,
     roughconductor) at 128x128, 16 spp, maxDepth 5;
     tools/materials_board.py's board (one
     analytic sphere per new kind: roughdiffuse, difftrans, phong, ward,
     hk, mask, blend, coating, roughcoating) with path and G-PT + L1 at
     128x128, 16 spp, maxDepth 6; each after a 1-spp warm-up with the
     sweeps' launch counters reset just before it (wall, rays,
     launches, added to the sweep kernels' records), then one profiled
     render of each (idle share; one pass); G-BDPT primal + very_direct
     against the BDPT image on door at full width; door G-PT, door and
     cbox-mats G-BDPT and the board at 64x64, 4 spp through the kernels
     and the plain versions (phase 4's tolerance, rays within 1e-3);
     G-BDPT against BDPTracer on cbox-mats there, G-PT primal +
     very_direct against PathTracer on door at maxDepth 5;
     each new kind's sample against its own pdf by chi^2 at 1,048,576
     lanes (thin glass: the reflection's share against its pdf, the rest
     passing straight through); door's E[dx] against the finite
     difference of a 2,048-spp path render, recorded (the reference's
     half-vector copy refracts a thin-glass offset: ROADMAP Queue 3).
 21. step G2a through factory.make_integrator on tools/cloth_board.py's
     board (written at run time: woven cloth, denim and charmeuse at two
     repeats; a bumpmap, a normalmap, a mask with a textured opacity, a
     blendbsdf with a textured weight, vertexcolors and wireframe on
     triangle quads; an EWA-filtered striped floor): path and G-PT + L1
     at 128x128, 32 spp, BDPT and G-BDPT + L1 at 16 spp, maxDepth 8,
     each as in phase 20 (warm-up, launch counters reset just before
     it, rays, launches, wall, one profiled render for the idle share);
     G-BDPT primal + very_direct against the BDPT image at full width;
     all four at 64x64, 4 spp through the kernels and the plain versions
     (the bidirectional pair at maxDepth 5; phase 4's tolerance on every
     buffer, rays within 1e-3); G-PT primal
     + very_direct against PathTracer at maxDepth 5 there; the woven
     cloth's sample against its pdf by chi^2 at 1,048,576 lanes.
 22. step G2b through factory.make_integrator: envmap.xml (BASELINE
     config #4) at its own 128x96 with BDPT and G-BDPT + L1 (16 spp,
     maxDepth 5: the eye walk's environment NEE, the aux-only G-PT
     pass); tools/lights_board.py's board (written at run time: an area,
     a point, a spot and a directional light, a constant environment, a
     roughconductor and a dielectric sphere) at 128^2 with path and G-PT
     + L1 (32 spp, maxDepth 8), BDPT and G-BDPT + L1 (16 spp, maxDepth
     5), SPPM (65,536 photons) and VPL (1,024 walks, chunks of 256) at 16
     spp, maxDepth 5, and its sunsky variant with path and G-PT + L1;
     each as in phase 20 (warm-up, launch counters reset just before it,
     rays, launches, wall, one profiled render for the idle share);
     G-BDPT primal + very_direct against the BDPT image on envmap and the
     board at full width; every family and volpath, irrcache and pssmlt
     on the board at 64x64, 4 spp through the kernels and the plain
     versions (phase 4's tolerance, rays within 1e-3, pssmlt's acceptance
     decisions); G-PT = path at maxDepth 5; E[BDPT] against E[path] on
     tests/test_bdpt_env.py's open boxes (environment + area light 3%,
     point light at maxDepth 2 1%) and on envmap (3%), and G-BDPT's
     E[dx] on its constant-environment box (0.3 < slope < 1.7, corr >
     0.45, 0.5 < rms ratio < 1.7), the bidirectional samples traced
     several a pass; path on tools/sensor_scenes.py's orthographic,
     telecentric, spherical, rdist (128^2) and meter (1x1, 256 spp)
     scenes and BDPT on the orthographic, spherical and rdist ones (64^2)
     through the kernels and the plain versions, with the reference
     tests' readings (spherical 2 on >= 95% of pixels, radiancemeter
     (3, 2, 1), fluencemeter 2 within 2%, rdist at kc 0 = perspective);
     every sweep call of one pass on the new ray families against the
     plain versions (the board's NEE with the directional light's 1e7
     shadow rays, the board seen by orthographic, spherical and
     fluencemeter sensors, SPPM's photon walks from the delta lights);
     the collimated beam's spot under SPPM (centre > 20x border); the
     uniform sphere and cone warps' chi^2 at 1,048,576 lanes.
 23. steps G2b-2 and G2c through factory.make_integrator: volpath,
     irrcache, SPPM (65,536 photons), VPL (1,024 walks, chunks of 256),
     PSSMLT and ERPT on tools/cloth_board.py's board lifted off the axis
     planes (every texture path) at 128x128, maxDepth 5, 16 spp (one
     mutation a pixel for the chains), each as in phase 16 (warm-up,
     launch counters reset just before it, rays, launches, wall, one
     profiled pass for the idle share); volpath against path (at the
     finest texture level, where volpath reads) at maxDepth -1, 64x64,
     4 spp; all six at 64x64, 4 spp through the kernels and the plain
     versions (phase 4's tolerance, rays within 1e-3, the chains'
     acceptance decisions all equal); then tools/sss_scene.py's dipole
     scene (tests/test_sss.py's: 32,258 triangles, the pair kernels) at
     256x256, 16 spp, maxDepth 4, with the cache at the reference's 2,048
     points and 16 rays each: the cache build's wall and rays, the
     render's wall, rays and pair launches, eval_mo's device time in one
     profiled render (CUDA events around each call), the sphere brighter
     than the same scene without the dipole term and than a black
     absorber of its shape, the same render under GDMT_KERNEL=v4 (rays
     equal, phase 4's tolerance), and the one- and two-sphere scenes at
     64x64, 4 spp through the kernels and the pair kernels' plain
     version;
 24. steps H1 and H2: the port's front ends and parallel/.  The CLI
     (utils/cli.main, in process, so the built kernels are reused) on
     cbox 256x256, 64 spp, maxDepth 6 with G-PT: the fused route (no
     stats) and the chunked route (--stats-json -v), every EXR finite,
     the fused -final.exr equal to GPTracer.render_final called directly
     at the same seed, the chunked buffers equal to the fused ones (rtol
     1e-5), the stats' counted rays equal to that render's device count;
     G-BDPT at 128x128, 4 spp and path to .npy through the CLI (finite,
     rays counted); tpuutil-torch diff on the two finals; each route's
     wall, Mrays/s and sweep launches.  Then parallel/ on a world of one
     over NCCL (multihost.init): G-PT, G-BDPT and path row-sharded tiles
     at 128x128, 4 spp, maxDepth 5 against their tracers' renders (rtol
     1e-4, atol 1e-5), the sharded Poisson solve against
     poisson.solve_l2 (atol 2e-3, rtol 1e-3), and the tile queue with a
     fault injected on tile 1's first attempt, bit-identical to a run
     without faults; the sweep launches of each.
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

import contextlib
import dataclasses
import io
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


def load_tool(name):
    """tools/<name>.py (sweep_soups: the sweep checks' random soups;
    media_scenes: the volumetric slab scenes), loaded from its path:
    tools/ is not a package."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
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
    # a batch that hits nothing (valid equal, checked above) agrees
    prim_frac = int(same.sum()) / n_valid if n_valid else 1.0
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
    o, d = sensor.sample_ray(sensor.describe(scene.camera), W, H, pos,
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


def render_calls(tracer, scene, n_samples, run=None):
    """The sweep calls of one render_chunk of `tracer` (n_samples samples
    a pixel from sample 0, seed 0), or of run() if given: [(any_hit, (o,
    d, mint, maxt))], inputs cloned, dead lanes included."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    calls = []
    launch = sweep.SweepKernel._launch

    def capture(k, o, d, mint, maxt, recs):
        calls.append((k.any_hit, tuple(x.clone() for x in (o, d, mint,
                                                           maxt))))
        return launch(k, o, d, mint, maxt, recs)

    sweep.SweepKernel._launch = capture
    try:
        if run is None:
            tracer.render_chunk(scene, 0, 0, n_samples)
        else:
            run()
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
              f" call (prim agree {pf:.6f}, t rel {mr:.3e}, occluded "
              f"agree {of:.6f})")
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
    soups = load_tool("sweep_soups")
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
    """Swap a tracer's intersectors for its kernels' plain versions (the
    sweeps', or on a clustered scene the traversal kernels' own plain
    version), analytic spheres merged as in the package (for the
    kernel-vs-plain comparisons only)."""
    from gradientdomain_mitsuba_tpu_torch.ops import common
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    ck, ok = tracer.kernels
    if ck.name.startswith("sweep"):
        tri = (lambda o, d, mn, mx, g: isec.intersect_matmul(o, d, mn, mx,
                                                             g.linC),
               lambda o, d, mn, mx, g: isec.occluded_matmul(o, d, mn, mx,
                                                            g.linC))
    else:
        tri = (lambda o, d, mn, mx, g: ck.plain(o, d, mn, mx, g.mt_slabs,
                                                g.cbounds),
               lambda o, d, mn, mx, g: ok.plain(o, d, mn, mx, g.mt_slabs,
                                                g.cbounds))
    tracer.closest, tracer.occluded = common.instrument_intersectors(
        tracer, *common.add_sphere_intersections(*tri))
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
    o, d = sensor.sample_ray(sensor.describe(scene.camera), W, H, pos,
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

def bidir_render(tracer, scene, seed, spp):
    """BDPT: the image.  G-BDPT: (L1 final via poisson.reconstruct, the
    buffers render returns)."""
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    out = tracer.render(scene, seed=seed, spp=spp)
    if isinstance(out, dict):
        return poisson.reconstruct(out, mode="L1"), out
    return out


def phase_bidir_slice(dev):
    """BDPT and G-BDPT (+ L1) on cbox 256^2, 16 spp, maxDepth 4 (the
    walls are host dispatch, which grows with the strategies, ~depth^2
    / 2, and the script has a time limit)."""
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    size, spp, depth = 256, 16, 4
    t0 = time.time()
    scene, st = load_scene_at(CBOX, dev, size, spp, depth, "bdpt")
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


def _buffers_agree(label, a, b, mean_rtol=1e-4):
    frac = float(torch.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL)
                 .all(-1).float().mean())
    rel = abs(float(a.mean()) - float(b.mean())) / max(
        abs(float(b.mean())), 1e-12)
    log(f"  {label}: {frac:.5f} of pixels within rtol {IMG_RTOL} atol "
        f"{IMG_ATOL}; mean rel diff {rel:.2e}")
    check(frac >= IMG_FRAC, f"{label} differs between kernel and plain")
    check(rel < mean_rtol or abs(float(a.mean()) - float(b.mean())) < 1e-6,
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
    scene, st = load_scene_at(CBOX, dev, 256, 16, 6, "gbdpt")
    for name, cls in (("bdpt", BDPTracer), ("gbdpt", GBDPTracer)):
        check_render_calls(f"{name} 256x256", render_calls(
            cls(scene, st), scene, 1), scene.geom.linC)
    scene, st = load_scene_at(CBOX, dev, 64, 4, 6, "gbdpt")
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
    (tests/test_bdpt.py's consistency check) at 64^2, maxDepth 2: the
    48 and 256 samples a pixel of render's, 16 a pass (gbdpt_batched)."""
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    scene, st = load_scene_at(CBOX, dev, 64, 8, 2, "gbdpt")
    g = GBDPTracer(scene, st)
    t0 = time.time()
    out = gbdpt_batched(g, scene, 0, 48, 16)
    ref = gbdpt_batched(g, scene, 555, 256, 16)
    torch.cuda.synchronize()
    return gradient_check(
        f"G-BDPT 64x64 maxDepth 2, 48 vs 256 spp, 16 a pass "
        f"({time.time() - t0:.3f} s)", out["dx"], ref["primal"],
        out["very_direct"], (0.55, 0.85, None))


def phase_step_b(dev):
    """direct, ao, field (shNormal), multichannel (path + ao) at 256^2,
    16 spp, maxDepth 5, and adaptive at 64^2, 4 spp, maxDepth 3, through
    factory.make_integrator
    (tools/tpu_zoo.py's check: finite pixels, mean |I| > 1e-5); adaptive
    also against its render through the plain versions (sample map and
    image)."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    summary, images = {}, {}
    # adaptive's rounds are host-paced and run twice (kernels, plain):
    # maxDepth 3 and rounds as wide as the film (refineFraction 1: every
    # unconverged pixel refines each round, 124 rounds at most instead
    # of 496) keep the whole script inside its time limit
    for name, size, spp, depth, props in (
            ("direct", 256, 16, 5, {}), ("ao", 256, 16, 5, {}),
            ("field", 256, 16, 5, {"field": "shNormal"}),
            ("multichannel", 256, 16, 5, {}),
            ("adaptive", 64, 4, 3, {"refineFraction": 1.0})):
        scene, st = load_scene_at(CBOX, dev, size, spp, depth, name)
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
            images[ch] = img
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
    return summary, images


# ---------------------------------------------------------------------------
# slice 9: ROADMAP step D (volpath with ops/medium, vpl, irrcache, sppm)
# through factory.make_integrator, on cbox and two media scenes

STEP_D = ("volpath", "vpl", "irrcache", "sppm")
# the photon-mapping walks' defaults, spelled out (vplCount, vplChunk 256)
STEP_D_PROPS = {"sppm": {"photonCount": 65536}}


def load_scene_at(path, dev, size, spp, depth, integrator, props=None,
                  variables=None):
    """A scene loaded with the loader's variables (cbox.xml takes its
    integrator type from $integrator; `variables` adds more) at size^2
    (None: its own film) and moved to the card; the settings' integrator
    type and properties set as given."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    over = {"spp": str(spp), "maxDepth": str(depth),
            "integrator": integrator, **(variables or {})}
    if size is not None:
        over.update(width=str(size), height=str(size))
    scene_np, st = sc.load_scene(path, over)
    st.integrator = integrator
    st.integrator_props.update(props or {})
    return bridge.to_torch(scene_np, dev), st


def tracers_of(tracer):
    """The tracers that trace for `tracer`: itself and an irradiance
    cache's direct-light path tracer, or a Markov-chain tracer's inner
    path or BDPT tracer alone."""
    if hasattr(tracer, "inner"):
        return [tracer.inner]
    inner = getattr(tracer, "_direct", None)
    return [tracer] + ([inner] if inner is not None else [])


def counted_render(tracer, scene, seed, spp):
    """One render with the intersectors' device ray counters on:
    (image, rays).  The path, BDPT and volumetric path tracers count
    through count_rays (their render_chunk resets the tally each pass;
    the dipole tracer's passes, not its cache build);
    the photon-mapping, cache and chain tracers leave ray_tally alone, so
    it is set on each tracer that traces and read once at the end."""
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
    from gradientdomain_mitsuba_tpu_torch.models.volpath import VolPathTracer
    if type(tracer) in (PathTracer, BDPTracer, VolPathTracer, DipoleTracer):
        tracer.count_rays = True
        return tracer.render(scene, seed=seed, spp=spp), \
            tracer.last_ray_count
    ts = tracers_of(tracer)
    for t in ts:
        t.ray_tally = torch.zeros((), dtype=torch.int64, device=t.device)
    try:
        img = tracer.render(scene, seed=seed, spp=spp)
        rays = sum(int(t.ray_tally) for t in ts)
    finally:
        for t in ts:
            t.ray_tally = None
    return img, rays


def factory_render(label, scene, st):
    """A warm-up (a 1-spp render; for a chain tracer one evaluation of
    mutated states at its chain count), then one render timed with the
    sweeps' launch counters reset just before it: wall, rays, Mrays/s,
    launches, finite pixels and mean |I| > 1e-5."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    size, spp = st.width, st.spp
    tracer = factory.make_integrator(scene, st)
    t0 = time.time()
    if hasattr(tracer, "_mstep"):
        u = tracer._fresh(0, 0, tracer.n_chains)
        tracer._eval(scene, tracer._mutate_small(0, 0, u))
        warm = "one chain evaluation"
    else:
        tracer.render(scene, seed=0, spp=1)
        warm = "1 spp"
    torch.cuda.synchronize()
    log(f"{label}: warm-up ({warm}) {time.time() - t0:.3f} s")
    kernels = [t.kernels for t in tracers_of(tracer)]
    for k in (k for ks in kernels for k in ks):
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img, rays = counted_render(tracer, scene, 1, spp)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = [sum(ks[i].launches for ks in kernels) for i in (0, 1)]
    finite = bool(torch.isfinite(img).all())
    mean = float(img.abs().mean())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label:9s} {size}x{size} {spp}spp: wall {wall:.4f} s, rays "
        f"{rays}, {rays / wall / 1e6:.3f} Mrays/s, sweep launches "
        f"closest {launches[0]} occluded {launches[1]}, finite {finite}, "
        f"mean |I| {mean:.5f}, peak device memory {peak:.2f} GiB")
    check(tuple(img.shape) == (size, size, 3), f"{label}: image shape")
    check(finite and mean > 1e-5, f"{label}: not finite or black")
    # sppm's gather tests no visibility, and volpath's shadow rays in a
    # scene with media walk their null crossings by closest hits: no
    # any-hit query
    need = (launches[:1] if st.integrator == "sppm" or st.has_media
            else launches)
    check(all(n > 0 for n in need),
          f"{label}: a sweep kernel was not launched: {launches}")
    return tracer, img, dict(wall_s=wall, rays=rays,
                             mrays_per_s=rays / wall / 1e6,
                             launches=launches, mean=mean, peak_gib=peak)


def first_call(tracer, scene, any_hit, lanes):
    """Inputs of the first sweep call of `lanes` lanes (any hit or
    closest) of a 1-spp render of `tracer`, cloned."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    got = []
    launch = sweep.SweepKernel._launch

    def capture(k, o, d, mint, maxt, recs):
        if not got and k.any_hit == any_hit and o.shape[0] == lanes:
            got.append(tuple(x.clone() for x in (o, d, mint, maxt)))
        return launch(k, o, d, mint, maxt, recs)

    sweep.SweepKernel._launch = capture
    try:
        tracer.render(scene, seed=0, spp=1)
        torch.cuda.synchronize()
    finally:
        sweep.SweepKernel._launch = launch
    check(bool(got), f"no {lanes}-lane sweep call was made")
    return got[0]


def check_big_shadow_call(rays, linC, rec):
    """VPL's N*K-lane any-hit call against the plain version (in 2^21-ray
    slices, which the plain version treats row by row): occluded flags
    equal on >= OCC_FRAC of lanes (phase 2's tolerance); the kernel timed
    on the whole call beside its bound."""
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    n = rays[0].shape[0]
    k = sweep.make_sweep_occluder(linC.shape[1] // 4)
    occ = k(*rays, linC)
    step = 1 << 21
    t0 = time.time()
    ref = torch.cat([isec.occluded_matmul(*(x[i:i + step] for x in rays),
                                          linC) for i in range(0, n, step)])
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    agree = float((occ == ref).float().mean())
    n_rec = k.packed(linC).shape[0]
    ms = cuda_ms(lambda: k(*rays, linC), iters=5, warmup=1)
    b_ms, by = sweep_bound(rays, n_rec, True)
    dead = float((rays[3] <= rays[2]).float().mean())
    log(f"vpl shadow call of {n} lanes ({dead:.4f} dead, "
        f"{float(occ.float().mean()):.4f} occluded): kernel vs plain "
        f"occluded agree {agree:.7f} ({int((occ != ref).sum())} lanes "
        f"differ); kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({by}), plain "
        f"{plain_s * 1e3:.1f} ms in {-(-n // step)} slices")
    check(agree >= OCC_FRAC, "vpl shadow call: kernel vs plain disagree")
    rec["vpl_shadow_call"] = dict(lanes=n, ms=ms, bound_ms=b_ms,
                                  bound_by=by, agree=agree,
                                  plain_ms=plain_s * 1e3)
    return agree


def _close_frac(a, b, rtol, atol):
    return float(torch.isclose(a, b, rtol=rtol, atol=atol).all(-1)
                 .float().mean())


def volpath_vs_path(dev, vol_img, path_img):
    """volpath on cbox (no medium) against the path tracer.  At maxDepth
    5 (phase 15's path render, same seed and size) the two differ as the
    reference's do: volpath still samples an emitter at the vertex where
    maxDepth ends the path, path does not, so it is printed only.  At
    unlimited depth both estimate the same paths with the same numbers:
    at 64x64, 4 spp (one pass; at 256x256, 16 spp the two host-paced
    44- and 40-bounce loops take ~19 s) within tests/test_volpath.py's
    rtol 5e-3 / atol 5e-4 on >= 99.9% of pixels (the loops' bounce caps
    may end a rare path differently)."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    frac = _close_frac(vol_img, path_img, 5e-3, 5e-4)
    ratio = float(vol_img.mean()) / float(path_img.mean())
    log(f"  volpath vs phase 15's path render (maxDepth 5, seed 1): "
        f"{frac:.5f} of pixels within rtol 5e-3 atol 5e-4, mean ratio "
        f"{ratio:.5f} (volpath adds emitter samples at depth 5)")
    imgs = {}
    t0 = time.time()
    for integrator in ("path", "volpath"):
        scene, st = load_scene_at(CBOX, dev, 64, 4, -1, integrator)
        imgs[integrator] = factory.make_integrator(scene, st).render(
            scene, seed=1, spp=4)
    frac_u = _close_frac(imgs["volpath"], imgs["path"], 5e-3, 5e-4)
    rel = abs(float(imgs["volpath"].mean()) / float(imgs["path"].mean())
              - 1)
    log(f"  volpath vs path at maxDepth -1, 64x64 4spp (seed 1; "
        f"{time.time() - t0:.3f} s): {frac_u:.5f} of pixels within rtol "
        f"5e-3 atol 5e-4, mean rel diff {rel:.2e}")
    check(frac_u >= 0.999 and rel < 1e-3,
          "volpath differs from path on cbox at unlimited depth")
    return dict(depth5_close=frac, depth5_mean_ratio=ratio,
                unlimited_close=frac_u, unlimited_mean_rel=rel)


def phase_step_d(dev, recs, path_img):
    """volpath, vpl, irrcache and sppm on cbox 256^2, 16 spp, maxDepth 5,
    and volpath on the HG slab and on its heterogeneous twin, through
    factory.make_integrator (tools/tpu_zoo.py's check: finite pixels,
    mean |I| > 1e-5); volpath on cbox against path (volpath_vs_path);
    one profiled render of vpl and of the heterogeneous slab; VPL's
    2^24-lane shadow call against the plain version; every scene at
    64^2, 4 spp through the kernels and through the plain versions, and
    sppm and vpl rendered twice bit for bit."""
    import tempfile

    from gradientdomain_mitsuba_tpu_torch.models import factory
    size, spp, depth = 256, 16, 5
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        slabs = load_tool("media_scenes").write_slab_scenes(tmp)
        cases = [(name, CBOX, name) for name in STEP_D] + [
            (f"volpath {k}", path, "volpath") for k, path in slabs.items()]
        tracers = {}
        for label, path, integrator in cases:
            scene, st = load_scene_at(path, dev, size, spp, depth,
                                      integrator,
                                      STEP_D_PROPS.get(integrator))
            tracer, img, summary[label] = factory_render(label, scene, st)
            tracers[label] = (tracer, scene)
            if label == "volpath":
                summary[label]["vs_path"] = volpath_vs_path(dev, img,
                                                            path_img)

        # the device's share of two renders (raw device events); the
        # heterogeneous slab's at 4 of its 16 spp: four passes of the
        # same 65,536 lanes, each pass the same work (1.7M device events
        # at 16 spp take ~45 s to record and ~25 s to read)
        for label, prof_spp in (("vpl", spp), ("volpath het_slab", 4)):
            tracer, scene = tracers[label]
            prof = profiled_render(lambda: tracer.render(
                scene, seed=2, spp=prof_spp), "sweep_")
            log(f"  profiled {label} render ({prof_spp} spp, seed 2): "
                f"device busy "
                f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
                f"(idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}"
                f"%), {prof['device_ops']} device ops; sweeps "
                f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} "
                f"launches")
            summary[label]["profiled"] = prof

        # VPL's shadow batch: N*K = 65,536 x 256 lanes in one any-hit call
        tracer, scene = tracers["vpl"]
        st = tracer.settings
        n_big = st.width * st.height * tracer.vpl_chunk
        t0 = time.time()
        check_big_shadow_call(first_call(tracer, scene, True, n_big),
                              scene.geom.linC, summary["vpl"])
        log(f"  (shadow call capture and check {time.time() - t0:.3f} s)")
        del tracers

        # kernels vs plain at 64^2, 4 spp (same seed); sppm and vpl twice
        for label, path, integrator in cases:
            scene, st = load_scene_at(path, dev, 64, 4, depth, integrator,
                                      STEP_D_PROPS.get(integrator))
            t0 = time.time()
            outs = {}
            modes = (("kernel", "plain", "kernel again")
                     if integrator in ("sppm", "vpl") else
                     ("kernel", "plain"))
            for mode in modes:
                tracer = factory.make_integrator(scene, st)
                if mode == "plain":
                    for t in tracers_of(tracer):
                        use_plain(t)
                outs[mode] = counted_render(tracer, scene, 5, 4)
            (ok, rk), (op, rp) = outs["kernel"], outs["plain"]
            log(f"{label} 64x64 4spp kernel vs plain ({len(outs)} renders, "
                f"{time.time() - t0:.3f} s): rays {rk} vs {rp}")
            check(abs(rk - rp) <= 1e-3 * rp, f"{label}: ray counts differ")
            _buffers_agree(f"{label} image", ok, op)
            if "kernel again" in outs:
                same = torch.equal(ok, outs["kernel again"][0])
                log(f"  {label}: two kernel renders bit-identical: {same}")
                check(same, f"{label}: two kernel renders differ")
    return summary


# ---------------------------------------------------------------------------
# slice 10: ROADMAP step E on caustics.xml (analytic spheres, dielectric and
# conductor, ldsampler, the gaussian filter) through factory.make_integrator

CAUSTICS = os.path.join(ROOT, "data", "scenes", "caustics", "caustics.xml")
STEP_E = ("path", "bdpt", "sppm", "pssmlt", "erpt", "mlt")
CHAIN_FAMILIES = ("pssmlt", "erpt", "mlt")
# mutations a pixel of the timed 256^2 MLT render (16 for the others): a
# mutation of its 4,096 chains is a whole 4,096-lane BDPT pass
STEP_E_SPP = {"mlt": 1}
# the expectation checks (the reference's tests/test_pssmlt.py:55 and
# tests/test_mlt.py:93 on caustics): the means within 5% at equal
# samples and mutations.  A chain image's mean is its b, a plain Monte
# Carlo estimate over luminanceSamples fresh states; caustic paths
# through the glass make the integrand heavy-tailed, so each side takes
# 1-4M samples.  The host's cost is per pass, so each side runs 262,144
# lanes a pass (chains; the path reference through GDMT_LANES): 4x fewer
# passes than at 65,536 for the same samples
EXPECT_CHAINS = 1 << 18


@contextlib.contextmanager
def wide_passes(lanes):
    """GDMT_LANES set to `lanes` inside the block: the path and G-PT
    tracers then trace up to that many lanes a pass (within a render's
    chunk), the same samples in fewer host-paced passes (only the film's
    summation order changes)."""
    old = os.environ.get("GDMT_LANES")
    os.environ["GDMT_LANES"] = str(lanes)
    try:
        yield
    finally:
        if old is None:
            del os.environ["GDMT_LANES"]
        else:
            os.environ["GDMT_LANES"] = old


def record_takes(tracer):
    """Record a chain tracer's acceptance decisions: returns the list its
    _mstep appends each step's [C] bool tensor to (a chain accepted where
    its state changed: a proposal always differs from the state)."""
    takes = []
    step = tracer._mstep

    def mstep(scene, seed, it, state, b, fb):
        new, fb = step(scene, seed, it, state, b, fb)
        takes.append((new[0] != state[0]).any(1))
        return new, fb

    tracer._mstep = mstep
    return takes


def expectation_check(dev, label, ref, family, size, mutations,
                      bootstrap):
    """`family`'s image mean at size^2 and `mutations` a pixel (chains of
    EXPECT_CHAINS lanes, `bootstrap` luminance samples) against
    ref = (family, size, spp, image or None to render it at seed 3),
    within 5%."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    t0 = time.time()
    ref_family, ref_size, ref_spp, ref_img = ref
    if ref_img is None:
        scene, st = load_scene_at(CAUSTICS, dev, ref_size, ref_spp, 8,
                                  ref_family)
        with wide_passes(EXPECT_CHAINS):
            ref_img = factory.make_integrator(scene, st).render(
                scene, seed=3, spp=ref_spp)
    n = size * size * mutations
    scene, st = load_scene_at(CAUSTICS, dev, size, mutations, 8, family, {
        "chains": EXPECT_CHAINS, "luminanceSamples": bootstrap})
    tracer = factory.make_integrator(scene, st)
    img = tracer.render(scene, seed=1, spp=mutations)
    rm, gm = float(ref_img.mean()), float(img.mean())
    log(f"  {label}: {family} {size}x{size} {mutations} mutations a pixel "
        f"({n} mutations, {bootstrap} bootstrap samples, b "
        f"{tracer.last_b:.5f}) mean {gm:.5f} vs {ref_family} "
        f"{ref_size}x{ref_size} {ref_spp} spp "
        f"({ref_size * ref_size * ref_spp} samples) mean {rm:.5f}: ratio "
        f"{gm / rm:.4f} ({time.time() - t0:.3f} s)")
    check(bool(torch.isfinite(img).all()), f"{label}: not finite")
    check(abs(gm / rm - 1) <= 0.05, f"{label}: means differ by > 5%")
    return dict(mean=gm, ref_mean=rm, ratio=gm / rm)


def phase_step_e(dev):
    """path, bdpt, sppm, pssmlt, erpt and mlt on caustics.xml at its own
    size (256^2, maxDepth 8, gaussian filter, ldsampler) through
    factory.make_integrator: 16 spp (mutations a pixel for the chains;
    mlt STEP_E_SPP), each after a warm-up with the sweeps' launch
    counters reset just before it (factory_render: wall, rays from the
    device tallies, launches, finite pixels, mean |I| > 1e-5); one
    profiled pssmlt render (4 mutations a pixel); every family at 64^2,
    4 spp through the kernels and through the plain versions (phase 4's
    tolerance; for the chains the share of acceptance decisions that
    agree); the pssmlt / path and mlt / bdpt expectation checks."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    size, depth = 256, 8
    summary = {}
    tracers = {}
    for fam in STEP_E:
        scene, st = load_scene_at(CAUSTICS, dev, size,
                                  STEP_E_SPP.get(fam, 16), depth, fam)
        check(st.sampler == "ldsampler" and st.rfilter == "gaussian",
              f"caustics settings: {st.sampler}, {st.rfilter}")
        tracer, img, summary[fam] = factory_render(fam, scene, st)
        tracers[fam] = (tracer, scene, img)

    tracer, scene, _ = tracers["pssmlt"]
    prof = profiled_render(lambda: tracer.render(scene, seed=2, spp=4),
                           "sweep_")
    log(f"  profiled pssmlt render (4 mutations a pixel, seed 2): device "
        f"busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
        f"(idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%), "
        f"{prof['device_ops']} device ops; sweeps {prof['kernel_ms']:.3f} "
        f"ms over {prof['kernel_calls']} launches")
    summary["pssmlt"]["profiled"] = prof
    bdpt_img = tracers["bdpt"][2]
    del tracers

    # kernels vs plain at 64^2, 4 spp (same seed); ERPT's round sized to
    # the 16,384 mutations (chainLength 2 of its 8,192 chains)
    for fam in STEP_E:
        scene, st = load_scene_at(CAUSTICS, dev, 64, 4, depth, fam,
                                  {"chainLength": 2} if fam == "erpt"
                                  else None)
        t0 = time.time()
        outs, takes = {}, {}
        for mode in ("kernel", "plain"):
            tracer = factory.make_integrator(scene, st)
            if mode == "plain":
                for t in tracers_of(tracer):
                    use_plain(t)
            if fam in CHAIN_FAMILIES:
                takes[mode] = record_takes(tracer)
            if fam == "bdpt":
                img, _, rays = bidir_batched(tracer, scene, 5, 4)
                outs[mode] = img, rays
            else:
                outs[mode] = counted_render(tracer, scene, 5, 4)
        (ok, rk), (op, rp) = outs["kernel"], outs["plain"]
        log(f"{fam} 64x64 4spp kernel vs plain ({time.time() - t0:.3f} s): "
            f"rays {rk} vs {rp}")
        check(abs(rk - rp) <= 1e-3 * rp, f"{fam}: ray counts differ")
        _buffers_agree(f"{fam} image", ok, op)
        if fam in CHAIN_FAMILIES:
            a = torch.stack(takes["kernel"])
            b = torch.stack(takes["plain"])
            share = float((a == b).float().mean())
            chains = float((a == b).all(0).float().mean())
            log(f"  {fam}: acceptance decisions agree {share:.6f} "
                f"({a.shape[0]} steps x {a.shape[1]} chains; chains whose "
                f"every decision agrees {chains:.6f}; accepted "
                f"{float(a.float().mean()):.4f})")
            summary[fam]["acceptance_agree"] = share
            summary[fam]["chains_agree"] = chains

    # pssmlt against a 4M-sample path render at 64^2; mlt against the
    # timed 256^2 bdpt render (1M ldsampler samples) with 1M mutations
    # and 2M bootstrap samples
    summary["pssmlt"]["vs_path"] = expectation_check(
        dev, "pssmlt vs path", ("path", 64, 1024, None), "pssmlt", 64, 1024,
        64 * 64 * 1024)
    summary["mlt"]["vs_bdpt"] = expectation_check(
        dev, "mlt vs bdpt", ("bdpt", size, 16, bdpt_img), "mlt", size, 16,
        2 * size * size * 16)
    return summary


ENVMAP = os.path.join(ROOT, "data", "scenes", "envmap", "envmap.xml")
# ZOO_r05.json, envmap-gpt: mean |primal| of the reference's G-PT at
# 64x64, 4 spp, maxDepth 5, seed 1 (tools/tpu_zoo.py); an image
# statistic, not a speed
ZOO_ENVMAP_MEAN = 0.12644


def load_envmap(dev, integrator, size=None, spp=None):
    """envmap.xml on the card at its own size (128x96, 32 spp, maxDepth
    5), or square at `size` with `spp` (maxDepth 5, the zoo's)."""
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    over = {"integrator": integrator, "maxDepth": "5"}
    if size is not None:
        over.update(width=str(size), height=str(size), spp=str(spp))
    scene_np, st = sc.load_scene(ENVMAP, over)
    return bridge.to_torch(scene_np, dev), st


def envmap_render(tracer, scene, seed, spp):
    """(image, buffers or None, rays) of one render: G-PT's render_final
    (L1) and its buffers, or the path tracer's counted render."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    if isinstance(tracer, GPTracer):
        tracer.count_rays = True
        final, bufs = tracer.render_final(scene, seed, spp, alpha=0.2,
                                          mode="L1")
        return final, bufs, int(bufs.pop("rays"))
    img, rays = counted_render(tracer, scene, seed, spp)
    return img, None, rays


def phase_step_f(dev, recs):
    """G-PT + L1 and path on envmap.xml through factory.make_integrator at
    the scene's own size, each after a 1-spp warm-up with the sweeps'
    launch counters reset just before it (the counts are added to the
    sweep kernels' records), then one profiled render of each; both at
    the zoo's 64^2, 4 spp, seed 1
    through the kernels and through the plain versions; the G-PT
    primal's mean against the zoo's."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    summary = {}
    for fam, cls in (("gpt", GPTracer), ("path", PathTracer)):
        scene, st = load_envmap(dev, fam)
        check((st.width, st.height, st.spp, st.max_depth) == (128, 96, 32, 5)
              and st.env_kind == 2 and st.has_textures == 1 and
              float(scene.camera.aperture_radius) > 0,
              f"envmap settings: {st.width}x{st.height} {st.spp}spp "
              f"maxDepth {st.max_depth} env {st.env_kind} textures "
              f"{st.has_textures}")
        tracer = factory.make_integrator(scene, st)
        check(type(tracer) is cls, f"factory built {type(tracer).__name__}")
        t0 = time.time()
        envmap_render(tracer, scene, 0, 1)
        torch.cuda.synchronize()
        log(f"envmap {fam}: warm-up (1 spp) {time.time() - t0:.3f} s")
        for k in tracer.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        img, _, rays = envmap_render(tracer, scene, 1, st.spp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [k.launches for k in tracer.kernels]
        for k, n in zip(tracer.kernels, launches):
            recs[k.name]["launches"] += n
        finite = bool(torch.isfinite(img).all())
        mean = float(img.abs().mean())
        log(f"envmap {fam} {st.width}x{st.height} {st.spp}spp"
            f"{' + L1' if fam == 'gpt' else ''}: wall {wall:.4f} s, rays "
            f"{rays}, {rays / wall / 1e6:.3f} Mrays/s, sweep launches "
            f"closest {launches[0]} occluded {launches[1]}, finite "
            f"{finite}, mean |I| {mean:.5f}")
        check(tuple(img.shape) == (96, 128, 3), f"envmap {fam}: shape")
        check(finite and mean > 1e-5, f"envmap {fam}: not finite or black")
        check(all(n > 0 for n in launches),
              f"envmap {fam}: a sweep kernel was not launched: {launches}")
        prof = profiled_render(
            lambda: envmap_render(tracer, scene, 2, st.spp), "sweep_")
        log(f"  profiled render (seed 2): device busy {prof['busy_ms']:.3f} "
            f"ms of {prof['wall_ms']:.3f} ms wall (idle "
            f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%), "
            f"{prof['device_ops']} device ops; sweeps "
            f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} "
            "launches")
        summary[fam] = dict(wall_s=wall, rays=rays,
                            mrays_per_s=rays / wall / 1e6,
                            launches=launches, mean=mean, profiled=prof)

    # kernels vs plain at the zoo's settings (same seed)
    for fam in ("gpt", "path"):
        scene, st = load_envmap(dev, fam, 64, 4)
        outs = {}
        for mode in ("kernel", "plain"):
            tracer = factory.make_integrator(scene, st)
            if mode == "plain":
                use_plain(tracer)
            img, bufs, rays = envmap_render(tracer, scene, 1, 4)
            outs[mode] = (bufs if bufs is not None else {"image": img}), rays
        (k_bufs, k_rays), (p_bufs, p_rays) = outs["kernel"], outs["plain"]
        log(f"envmap {fam} 64x64 4spp kernel vs plain: rays {k_rays} vs "
            f"{p_rays}")
        check(abs(k_rays - p_rays) <= 1e-3 * p_rays,
              f"envmap {fam}: ray counts differ")
        for name in (("primal", "very_direct", "dx", "dy") if fam == "gpt"
                     else ("image",)):
            a, b = k_bufs[name], p_bufs[name]
            frac = float(torch.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL)
                         .all(-1).float().mean())
            rel = abs(float(a.mean()) - float(b.mean())) / max(
                abs(float(b.mean())), 1e-12)
            log(f"  {name}: {frac:.5f} of pixels within rtol {IMG_RTOL} "
                f"atol {IMG_ATOL}; mean rel diff {rel:.2e}")
            check(bool(torch.isfinite(a).all()), f"envmap {name} not finite")
            check(frac >= IMG_FRAC, f"envmap {fam} {name}: kernel != plain")
            check(rel < 1e-3 or abs(float(a.mean()) - float(b.mean())) < 1e-6,
                  f"envmap {fam} {name}: means differ")
        if fam == "gpt":
            zoo = float(k_bufs["primal"].abs().mean())
            rel = abs(zoo - ZOO_ENVMAP_MEAN) / ZOO_ENVMAP_MEAN
            log(f"  G-PT primal mean |I| at the zoo's settings {zoo:.5f} "
                f"beside ZOO_r05.json's {ZOO_ENVMAP_MEAN} (rel diff "
                f"{rel:.4f}; an image statistic)")
            check(rel <= 0.05, "envmap G-PT primal mean is not within 5% of "
                  "the zoo's")
            summary["gpt"]["zoo_primal_mean"] = zoo
    return summary


CAUSTICS = os.path.join(ROOT, "data", "scenes", "caustics", "caustics.xml")
CBOX_MATS = os.path.join(ROOT, "data", "scenes", "cbox-mats", "cbox-mats.xml")
# the glass-sphere Cornell box of tests/test_gpt_specular.py and
# tests/test_gbdpt_specular.py (their E[dx] checks); MESH is filled in
GLASS_XML = """<scene version="0.5.0">
  <integrator type="$integrator"><integer name="maxDepth" value="4"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="39.3077"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$width"/>
      <integer name="height" value="$height"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf>
  <shape type="obj"><string name="filename" value="MESH/cbox_floor.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="MESH/cbox_ceiling.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="MESH/cbox_back.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="MESH/cbox_greenwall.obj"/><ref id="white"/></shape>
  <shape type="obj"><string name="filename" value="MESH/cbox_redwall.obj"/><ref id="white"/></shape>
  <shape type="sphere">
    <point name="center" x="278" y="150" z="250"/>
    <float name="radius" value="120"/>
    <integer name="nTheta" value="12"/><integer name="nPhi" value="24"/>
    <bsdf type="dielectric"><float name="intIOR" value="1.5"/></bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="MESH/cbox_luminaire.obj"/>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance" value="17, 12, 4"/></emitter>
  </shape>
</scene>
"""


def step_7a_render(tracer, scene, seed, spp):
    """(L1 final, buffers, rays) of one render through the entry points:
    G-PT's render_final; G-BDPT's render + poisson.reconstruct."""
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    tracer.count_rays = True
    if isinstance(tracer, GPTracer):
        final, bufs = tracer.render_final(scene, seed, spp, alpha=0.2,
                                          mode="L1")
        return final, bufs, int(bufs.pop("rays"))
    bufs = tracer.render(scene, seed=seed, spp=spp)
    return poisson.reconstruct(bufs, mode="L1"), bufs, tracer.last_ray_count


STEP_7A = (("gbdpt caustics", CAUSTICS, "gbdpt", 16),
           ("gpt caustics", CAUSTICS, "gpt", 32),
           ("gpt cbox-mats", CBOX_MATS, "gpt", 32))


def gradient_check(label, dx, primal_ref, very, limits):
    """E[dx] against the finite difference of a long run's primal, away
    from pixel pairs that see the light directly: rms(dx - fd) / rms(fd),
    correlation and regression slope against `limits` (rms ratio, min
    correlation, slope range or None; limits None: logged, not
    checked)."""
    fd_x = primal_ref[:, 1:] - primal_ref[:, :-1]
    vd = very.sum(-1)
    mx = (vd[:, 1:] + vd[:, :-1]) == 0
    a, b = dx[:, :-1][mx].flatten(), fd_x[mx].flatten()
    ratio = float(torch.sqrt(((a - b) ** 2).mean()) /
                  torch.sqrt((b ** 2).mean()))
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    slope = float((a * b).sum() / (b * b).sum())
    if limits is None:
        log(f"  {label}: rms(dx - fd) / rms(fd) {ratio:.4f}, corr "
            f"{corr:.4f}, slope {slope:.4f} (recorded, not checked)")
        return dict(rms_ratio=ratio, corr=corr, slope=slope)
    max_ratio, min_corr, slopes = limits
    log(f"  {label}: rms(dx - fd) / rms(fd) {ratio:.4f} (< {max_ratio}), "
        f"corr {corr:.4f} (> {min_corr}), slope {slope:.4f}"
        + (f" (in {slopes})" if slopes else ""))
    check(ratio < max_ratio, f"{label}: E[dx] off the finite difference")
    check(corr > min_corr, f"{label}: dx uncorrelated with the difference")
    if slopes:
        check(slopes[0] < slope < slopes[1], f"{label}: slope {slope}")
    return dict(rms_ratio=ratio, corr=corr, slope=slope)


def gbdpt_batched(tracer, scene, seed, spp, per_pass):
    """G-BDPT buffers {primal (with the light image), very_direct, dx,
    dy}, normalized as finalize does, of `spp` samples a pixel traced
    `per_pass` samples a pass: the same lanes, sample indices and
    arithmetic as render's one sample a pass (trace_pass takes a sample
    index a lane), without the host cost of a pass a sample."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import OFFSETS
    from gradientdomain_mitsuba_tpu_torch.ops import film as film_ops
    st = tracer.settings
    H, W = st.height, st.width
    N = H * W
    dev = tracer.device
    fb = torch.zeros((H, W, 3), device=dev)
    vb = torch.zeros_like(fb)
    dx = torch.zeros_like(fb)
    dy = torch.zeros_like(fb)
    li = torch.zeros_like(fb)
    wb = torch.zeros((H, W), device=dev)
    off_x = torch.tensor(OFFSETS[1], device=dev)
    off_y = torch.tensor(OFFSETS[3], device=dev)
    ids = torch.arange(N, device=dev).repeat(per_pass)
    for start in range(0, spp, per_pass):
        sidx = start + torch.arange(per_pass, device=dev).repeat_interleave(N)
        (pos, primal, very, grad, spos, sval, t1p,
         t1g) = tracer.trace_pass(scene, seed, sidx, pixel_id=ids)
        jit = (pos % 1.0).reshape(per_pass, N, 2)
        fb, wb = film_ops.splat_grid(fb, wb, jit,
                                     primal.reshape(per_pass, N, 3),
                                     tracer.filter_kind)
        vb, _ = film_ops.splat_grid(vb, torch.zeros_like(wb), jit,
                                    very.reshape(per_pass, N, 3),
                                    tracer.filter_kind)
        g = grad.reshape(4, per_pass, N, 3)
        dx = film_ops.add_grid_shifted(dx, g[0], 0, 0)
        dx = film_ops.add_grid_shifted(dx, -g[1], -1, 0)
        dy = film_ops.add_grid_shifted(dy, g[2], 0, 0)
        dy = film_ops.add_grid_shifted(dy, -g[3], 0, -1)
        li = film_ops.splat_unfiltered(li, spos, sval)
        dx = film_ops.splat_unfiltered(dx, torch.cat([t1p, t1p + off_x]),
                                       torch.cat([t1g[0], -t1g[1]]))
        dy = film_ops.splat_unfiltered(dy, torch.cat([t1p, t1p + off_y]),
                                       torch.cat([t1g[2], -t1g[3]]))
    w = torch.clamp_min(wb, 1e-12)[..., None]
    return dict(primal=fb / w + li / spp, very_direct=vb / w, dx=dx / spp,
                dy=dy / spp)


def phase_step_7a(dev, recs):
    """Step 7a through factory.make_integrator: the three full-width
    renders (timed after a 1-spp warm-up with the sweeps' launch counters
    reset just before each; the counts are added to the sweep kernels'
    records), one profiled render of each; the three at 64^2, 4 spp
    through the kernels and the plain versions; the primal identities;
    E[dx] through the glass sphere."""
    import tempfile
    from gradientdomain_mitsuba_tpu_torch.models import factory
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    summary = {}
    for label, path, fam, spp in STEP_7A:
        scene, st = load_scene_at(path, dev, 128, spp, 8, fam)
        tracer = factory.make_integrator(scene, st)
        check(type(tracer) is (GBDPTracer if fam == "gbdpt" else GPTracer)
              and tracer.any_specular, f"{label}: factory built "
              f"{type(tracer).__name__} without the half-vector shift")
        t0 = time.time()
        step_7a_render(tracer, scene, 0, 1)
        torch.cuda.synchronize()
        log(f"{label}: warm-up (1 spp) {time.time() - t0:.3f} s")
        for k in tracer.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        final, _, rays = step_7a_render(tracer, scene, 1, spp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [k.launches for k in tracer.kernels]
        for k, n in zip(tracer.kernels, launches):
            recs[k.name]["launches"] += n
        finite = bool(torch.isfinite(final).all())
        mean = float(final.abs().mean())
        log(f"{label} 128x128 {spp}spp maxDepth 8 + L1: wall {wall:.4f} s, "
            f"rays {rays}, {rays / wall / 1e6:.3f} Mrays/s, sweep launches "
            f"closest {launches[0]} occluded {launches[1]}, finite "
            f"{finite}, mean |I| {mean:.5f}")
        check(tuple(final.shape) == (128, 128, 3), f"{label}: shape")
        check(finite and mean > 1e-5, f"{label}: not finite or black")
        check(all(n > 0 for n in launches),
              f"{label}: a sweep kernel was not launched: {launches}")
        # G-BDPT's 16 passes are alike: 4 of them give its idle share
        prof_spp = 4 if fam == "gbdpt" else spp
        prof = profiled_render(
            lambda: step_7a_render(tracer, scene, 2, prof_spp), "sweep_")
        idle = 1 - prof["busy_ms"] / prof["wall_ms"]
        log(f"  profiled render (seed 2, {prof_spp} spp): device busy "
            f"{prof['busy_ms']:.3f} "
            f"ms of {prof['wall_ms']:.3f} ms wall (idle {100 * idle:.1f}%), "
            f"{prof['device_ops']} device ops; sweeps "
            f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} "
            "launches")
        summary[label] = dict(wall_s=wall, rays=rays,
                              mrays_per_s=rays / wall / 1e6,
                              launches=launches, mean=mean, idle=idle,
                              profiled=prof)

    # kernels vs plain at 64^2, 4 spp (same seed); the primal identities
    for label, path, fam, _ in STEP_7A:
        scene, st = load_scene_at(path, dev, 64, 4, 8, fam)
        outs = {}
        for mode in ("kernel", "plain"):
            tracer = factory.make_integrator(scene, st)
            if mode == "plain":
                use_plain(tracer)
            if fam == "gbdpt":
                tracer.count_rays = True
                raw = tracer.render_chunk(scene, 3, 0, 4)
                rays = int(raw.pop("rays"))
                bufs = dict(raw, **tracer.finalize(raw, 4))
                # one pass's t=1 image-space gradient pairs, lane by lane
                bufs["t1_grad"] = tracer.trace_pass(scene, 3, 0)[7]
            else:
                _, bufs, rays = step_7a_render(tracer, scene, 3, 4)
            outs[mode] = bufs, rays
        (kb, kr), (pb, pr) = outs["kernel"], outs["plain"]
        log(f"{label} 64x64 4spp kernel vs plain: rays {kr} vs {pr}")
        check(abs(kr - pr) <= 1e-3 * pr, f"{label}: ray counts differ")
        names = ["primal", "very_direct", "dx", "dy"]
        if fam == "gbdpt":
            names += ["light_img", "t1_grad"]
        for name in names:
            a, b = kb[name], pb[name]
            if name == "t1_grad":
                a, b = a.reshape(-1, 3), b.reshape(-1, 3)
            _buffers_agree(f"{label} {name}", a, b, mean_rtol=1e-3)
            check(bool(torch.isfinite(a).all()), f"{label} {name}")
        if fam == "gbdpt":
            img = BDPTracer(scene, st).render(scene, seed=3, spp=4)
            comb = kb["primal"] + kb["very_direct"]
            err = float((comb - img).abs().max())
            log(f"  G-BDPT primal + very_direct vs BDPT: max |diff| "
                f"{err:.3e}")
            check(bool(torch.allclose(comb, img, rtol=2e-4, atol=2e-5)),
                  "G-BDPT primal != BDPT on caustics")
    scene, st = load_scene_at(CAUSTICS, dev, 64, 4, 5, "gpt")
    _, bufs, _ = step_7a_render(GPTracer(scene, st), scene, 3, 4)
    img = PathTracer(scene, st).render(scene, seed=3, spp=4)
    comb = bufs["primal"] + bufs["very_direct"]
    err = float((comb - img).abs().max())
    log(f"gpt caustics 64x64 4spp maxDepth 5: primal + very_direct vs "
        f"PathTracer max |diff| {err:.3e}")
    check(bool(torch.allclose(comb, img, rtol=3e-4, atol=3e-5)),
          "G-PT primal != PathTracer on caustics")

    # E[dx] through the glass sphere (the reference tests' scene, sizes,
    # sample counts, seeds and thresholds)
    tmp = tempfile.mkdtemp()
    try:
        xml = os.path.join(tmp, "glass.xml")
        with open(xml, "w") as f:
            f.write(GLASS_XML.replace("MESH", os.path.join(
                ROOT, "data", "scenes", "cbox", "meshes")))
        t0 = time.time()
        scene, st = load_scene_at(xml, dev, 20, 8, 4, "gpt")
        out = GPTracer(scene, st).render(scene, seed=0, spp=128)
        with wide_passes(20 * 20 * 3072):
            ref = PathTracer(scene, st).render(scene, seed=777, spp=3072,
                                               chunk=3072)
        summary["gpt_glass_dx"] = gradient_check(
            f"G-PT glass 20x20 128 vs 3072 spp ({time.time() - t0:.3f} s)",
            out["dx"], ref - out["very_direct"], out["very_direct"],
            (0.7, 0.8, None))
        t0 = time.time()
        scene, st = load_scene_at(xml, dev, 16, 8, 4, "gbdpt",
                                  {"lightImage": False})
        g = GBDPTracer(scene, st)
        out = gbdpt_batched(g, scene, 0, 256, 128)
        ref = gbdpt_batched(g, scene, 555, 384, 128)
        summary["gbdpt_glass_dx"] = gradient_check(
            f"G-BDPT glass 16x16 lightImage false, 256 vs 384 spp "
            f"({time.time() - t0:.3f} s)", out["dx"], ref["primal"],
            out["very_direct"], (0.85, 0.7, (0.8, 1.2)))
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


DOOR = os.path.join(ROOT, "data", "scenes", "door", "door.xml")
# step G1's full-width renders: (label, scene, integrator, spp, maxDepth);
# BOARD stands for tools/materials_board.py's XML, written at run time
BOARD = "materials board"
# The bidirectional ones run at maxDepth 5: their walls are host
# dispatch, which grows with the strategies (~depth^2 / 2), and the
# script has a time limit; their checks hold at any depth.
G1_BIDIR_DEPTH = 5
STEP_G1 = (("gpt door", DOOR, "gpt", 32, 8),
           ("path door", DOOR, "path", 32, 8),
           ("bdpt door", DOOR, "bdpt", 16, G1_BIDIR_DEPTH),
           ("gbdpt door", DOOR, "gbdpt", 16, G1_BIDIR_DEPTH),
           ("gbdpt cbox-mats", CBOX_MATS, "gbdpt", 16, G1_BIDIR_DEPTH),
           ("path board", BOARD, "path", 16, 6),
           ("gpt board", BOARD, "gpt", 16, 6))
# samples a pixel of the profiled render that reads a render's idle
# share: one pass of each tracer (G-PT 16 samples a pixel a pass, path
# 4 at 128^2, the bidirectional tracers 1)
G1_PROFILE_SPP = {"gpt": 16, "path": 4, "bdpt": 1, "gbdpt": 1, "sppm": 1,
                  "vpl": 1}
N_CHI2 = 1 << 20
CHI2_CT, CHI2_PHI, CHI2_SUB = 12, 24, 24


def g1_render(tracer, scene, seed, spp):
    """(image or L1 final, buffers or None, rays) of one render through
    the entry points."""
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    if isinstance(tracer, (GPTracer, GBDPTracer)):
        return step_7a_render(tracer, scene, seed, spp)
    img, rays = counted_render(tracer, scene, seed, spp)
    return img, None, int(rays)


def chi2_on_card(label, params, kinds, wi, dev):
    """The port's sample() against its own pdf() at N_CHI2 lanes on the
    card (tests/test_torch_bsdf_rest.py's test, 16x the lanes): a
    histogram of the smooth samples' wo over the sphere against the pdf
    integrated over each bin (CHI2_SUB^2 midpoints a bin), chi^2 below
    dof + 5.5 sqrt(2 dof), the pdf's integral within 0.03 of the smooth
    share.  `params(n)` gives the row's MatParams for n lanes."""
    from gradientdomain_mitsuba_tpu_torch.ops import bsdf
    n = N_CHI2
    wi = torch.tensor(wi, dtype=torch.float32, device=dev)
    wi = wi / wi.norm()
    g = torch.Generator(device=dev).manual_seed(7)
    u2 = torch.rand((n, 2), generator=g, device=dev)
    uc = torch.rand((n,), generator=g, device=dev)
    bs = bsdf.sample(params(n), wi.expand(n, 3), u2, uc, kinds)
    keep = bs.valid & ~bs.is_delta
    wo = bs.wo[keep]
    ct = torch.clamp(wo[:, 2], -1.0, 1.0)
    phi = torch.remainder(torch.atan2(wo[:, 1], wo[:, 0]), 2 * np.pi)
    i_ct = torch.clamp(((ct + 1) / 2 * CHI2_CT).long(), 0, CHI2_CT - 1)
    i_ph = torch.clamp((phi / (2 * np.pi) * CHI2_PHI).long(), 0,
                       CHI2_PHI - 1)
    counts = torch.bincount(i_ct * CHI2_PHI + i_ph,
                            minlength=CHI2_CT * CHI2_PHI).double()
    nct, nph = CHI2_CT * CHI2_SUB, CHI2_PHI * CHI2_SUB
    cts = -1 + 2 * (torch.arange(nct, device=dev) + 0.5) / nct
    phs = 2 * np.pi * (torch.arange(nph, device=dev) + 0.5) / nph
    CT, PH = torch.meshgrid(cts, phs, indexing="ij")
    ST = torch.sqrt(torch.clamp_min(1 - CT ** 2, 0.0))
    dirs = torch.stack([ST * torch.cos(PH), ST * torch.sin(PH), CT],
                       -1).reshape(-1, 3).float()
    K = dirs.shape[0]
    vals = bsdf.pdf(params(K), wi.expand(K, 3), dirs, kinds).double()
    dA = (2.0 / nct) * (2 * np.pi / nph)
    probs = vals.reshape(CHI2_CT, CHI2_SUB, CHI2_PHI, CHI2_SUB).sum(
        (1, 3)).reshape(-1) * dA
    total = float(probs.sum())
    n_keep = int(keep.sum())
    expected = probs * n_keep / max(total, 1e-9)
    mask = expected > 8
    chi2 = float(((counts[mask] - expected[mask]) ** 2 /
                  expected[mask]).sum())
    dof = int(mask.sum()) - 1
    limit = dof + 5.5 * np.sqrt(2.0 * max(dof, 1))
    share = n_keep / n
    log(f"  chi2 {label}: {chi2:.1f} (dof {dof}, limit {limit:.1f}); pdf "
        f"integral {total:.4f} vs smooth share {share:.4f}")
    check(abs(total - share) < 0.03, f"chi2 {label}: pdf integral")
    check(chi2 < limit, f"chi2 {label}: sample does not follow pdf")
    return dict(chi2=chi2, dof=dof, limit=limit, integral=total,
                share=share)


FACTORY_CLASS = {"gpt": "GPTracer", "path": "PathTracer",
                 "bdpt": "BDPTracer", "gbdpt": "GBDPTracer",
                 "sppm": "SPPMTracer", "vpl": "VPLTracer"}


def full_width_renders(dev, recs, renders, load=None):
    """renders [(label, scene path, integrator, spp, maxDepth)] at 128^2
    (or as load(label, path, integrator, spp, maxDepth) loads them)
    through factory.make_integrator, each after a 1-spp warm-up with the
    sweeps' launch counters reset just before it (wall, rays, launches,
    added to the sweep kernels' records; every sweep must launch, sppm's
    closest-hit one), then one profiled render (idle share;
    G1_PROFILE_SPP).  Returns (summary, {label: image or G-PT / G-BDPT
    buffers})."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    summary, full = {}, {}
    for label, path, fam, spp, depth in renders:
        if load is None:
            scene, st = load_scene_at(path, dev, 128, spp, depth, fam)
        else:
            scene, st = load(label, path, fam, spp, depth)
        tracer = factory.make_integrator(scene, st)
        check(type(tracer).__name__ == FACTORY_CLASS[fam],
              f"{label}: factory built {type(tracer).__name__}")
        t0 = time.time()
        g1_render(tracer, scene, 0, 1)
        torch.cuda.synchronize()
        log(f"{label}: warm-up (1 spp) {time.time() - t0:.3f} s")
        for k in tracer.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        img, bufs, rays = g1_render(tracer, scene, 1, spp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        full[label] = img if bufs is None else bufs
        launches = [k.launches for k in tracer.kernels]
        for k, n in zip(tracer.kernels, launches):
            recs[k.name]["launches"] += n
        finite = bool(torch.isfinite(img).all())
        mean = float(img.abs().mean())
        log(f"{label} {st.width}x{st.height} {spp}spp maxDepth {depth}"
            f"{' + L1' if fam in ('gpt', 'gbdpt') else ''}: wall "
            f"{wall:.4f} s, rays {rays}, {rays / wall / 1e6:.3f} "
            f"Mrays/s, sweep launches closest {launches[0]} occluded "
            f"{launches[1]}, finite {finite}, mean |I| {mean:.5f}")
        check(tuple(img.shape) == (st.height, st.width, 3),
              f"{label}: shape")
        check(finite and mean > 1e-5, f"{label}: not finite or black")
        # sppm's gather tests no visibility: no any-hit query
        check(all(n > 0 for n in (launches[:1] if fam == "sppm"
                                  else launches)),
              f"{label}: a sweep kernel was not launched: {launches}")
        prof_spp = G1_PROFILE_SPP[fam]
        prof = profiled_render(
            lambda: g1_render(tracer, scene, 2, prof_spp), "sweep_")
        idle = 1 - prof["busy_ms"] / prof["wall_ms"]
        log(f"  profiled render (seed 2, {prof_spp} spp): device busy "
            f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
            f"wall (idle {100 * idle:.1f}%), {prof['device_ops']} "
            f"device ops; sweeps {prof['kernel_ms']:.3f} ms over "
            f"{prof['kernel_calls']} launches")
        summary[label] = dict(wall_s=wall, rays=rays,
                              mrays_per_s=rays / wall / 1e6,
                              launches=launches, mean=mean, idle=idle,
                              profiled=prof)
    return summary, full


def kernel_vs_plain(dev, label, path, fam, depth, size=64, spp=4,
                    props=None, variables=None, all_takes=False):
    """`fam` at size^2 (None: the scene's own film), spp through the
    kernels and through the plain
    versions (same seed; every tracer that traces for it, tracers_of):
    rays within 1e-3, every buffer within phase 4's tolerance (means
    within 1e-3), finite; for a chain family also the share of
    acceptance decisions that agree (>= IMG_FRAC; all of them with
    all_takes).  `variables`: more loader variables.  Returns the kernel
    render's buffers and the scene and settings.  BDPT and G-BDPT trace
    all `spp` samples in one pass (bidir_batched)."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    scene, st = load_scene_at(path, dev, size, spp, depth, fam, props,
                              variables)
    outs, takes = {}, {}
    for mode in ("kernel", "plain"):
        tracer = factory.make_integrator(scene, st)
        if mode == "plain":
            for t in tracers_of(tracer):
                use_plain(t)
        if fam in CHAIN_FAMILIES:
            takes[mode] = record_takes(tracer)
        if fam in ("bdpt", "gbdpt"):
            img, bufs, rays = bidir_batched(tracer, scene, 3, spp)
        else:
            img, bufs, rays = g1_render(tracer, scene, 3, spp)
        outs[mode] = (bufs if bufs is not None else {"image": img}), rays
    (kb, kr), (pb, pr) = outs["kernel"], outs["plain"]
    log(f"{label} {st.width}x{st.height} {spp}spp kernel vs plain: rays "
        f"{kr} vs {pr}")
    check(abs(kr - pr) <= 1e-3 * pr, f"{label}: ray counts differ")
    if takes:
        share = float((torch.stack(takes["kernel"]) ==
                       torch.stack(takes["plain"])).float().mean())
        log(f"  {label}: acceptance decisions agree {share:.6f}")
        check(share >= (1.0 if all_takes else IMG_FRAC),
              f"{label}: acceptance decisions differ")
    for name in kb:
        _buffers_agree(f"{label} {name}", kb[name], pb[name],
                       mean_rtol=1e-3)
        check(bool(torch.isfinite(kb[name]).all()), f"{label} {name}")
    return kb, scene, st


def phase_step_g1(dev, recs):
    """Step G1 through factory.make_integrator: door.xml (BASELINE config
    #2) with gpt + L1 and path at 128^2, 32 spp, maxDepth 8, bdpt and
    gbdpt + L1 at 16 spp, maxDepth 5 (G1_BIDIR_DEPTH); gbdpt + L1 on
    cbox-mats.xml at 16 spp, maxDepth 5; the
    materials board with path and gpt + L1 at 16 spp, maxDepth 6; each
    after a 1-spp warm-up with the sweeps' launch counters reset just
    before it (wall, rays, launches, added to the sweep kernels' records),
    then one profiled render (idle share); G-BDPT = BDPT on door at full
    width; door gpt, door and cbox-mats gbdpt and the board (path, gpt)
    at 64^2, 4 spp through the kernels and the plain versions; G-BDPT =
    BDPT on cbox-mats there, G-PT = path on door at maxDepth 5; each new
    kind's sample against its pdf at 1M lanes; door's E[dx] against a
    finite difference (recorded)."""
    import shutil
    import tempfile
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common
    from gradientdomain_mitsuba_tpu_torch.scene import materials as M
    tmp = tempfile.mkdtemp()
    try:
        board = load_tool("materials_board").write_board(tmp)
        paths = {BOARD: board}
        summary, full = full_width_renders(
            dev, recs, [(label, paths.get(path, path), fam, spp, depth)
                        for label, path, fam, spp, depth in STEP_G1])

        # G-BDPT = BDPT on door at full width (both seed 1, 16 spp)
        comb = (full["gbdpt door"]["primal"] +
                full["gbdpt door"]["very_direct"])
        err = float((comb - full["bdpt door"]).abs().max())
        log(f"gbdpt door 128x128 16spp: primal + very_direct vs BDPT max "
            f"|diff| {err:.3e}")
        check(bool(torch.allclose(comb, full["bdpt door"], rtol=2e-4,
                                  atol=2e-5)),
              "gbdpt door: G-BDPT primal != BDPT")
        del full
        # kernels vs plain at 64^2, 4 spp (same seed); the identities
        for label, path, fam in (("gpt door", DOOR, "gpt"),
                                 ("gbdpt door", DOOR, "gbdpt"),
                                 ("gbdpt cbox-mats", CBOX_MATS, "gbdpt"),
                                 ("path board", board, "path"),
                                 ("gpt board", board, "gpt")):
            depth = (6 if path == board else 8 if fam == "gpt"
                     else G1_BIDIR_DEPTH)
            kb, scene, st = kernel_vs_plain(dev, label, path, fam, depth)
            if label == "gbdpt cbox-mats":
                img = BDPTracer(scene, st).render(scene, seed=3, spp=4)
                comb = kb["primal"] + kb["very_direct"]
                err = float((comb - img).abs().max())
                log(f"  G-BDPT primal + very_direct vs BDPT: max |diff| "
                    f"{err:.3e}")
                check(bool(torch.allclose(comb, img, rtol=2e-4,
                                          atol=2e-5)),
                      f"{label}: G-BDPT primal != BDPT")
        scene, st = load_scene_at(DOOR, dev, 64, 4, 5, "gpt")
        _, bufs, _ = step_7a_render(GPTracer(scene, st), scene, 3, 4)
        img = PathTracer(scene, st).render(scene, seed=3, spp=4)
        comb = bufs["primal"] + bufs["very_direct"]
        err = float((comb - img).abs().max())
        log(f"gpt door 64x64 4spp maxDepth 5: primal + very_direct vs "
            f"PathTracer max |diff| {err:.3e}")
        check(bool(torch.allclose(comb, img, rtol=3e-4, atol=3e-5)),
              "G-PT primal != PathTracer on door")

        # each new kind's sample against its pdf, at 1M lanes: the
        # board's rows (by kind; the wrappers resolved as the tracers
        # resolve them) and door's thin glass (delta: the reflection's
        # share against its pdf)
        scene, st = load_scene_at(board, dev, 8, 1, 6, "path")
        kinds = bsdf.scene_kinds(scene)
        packed = scene.materials.packed
        kind = packed[:, 0].long()
        rows = {"roughdiffuse": kind == M.ROUGH_DIFFUSE,
                "difftrans": kind == M.DIFFTRANS, "phong": kind == M.PHONG,
                "ward": kind == M.WARD, "hk": kind == M.HK,
                "mask": packed[:, 22] < 1.0, "blend": kind == M.BLEND,
                "coating": (kind == M.COATING) & (packed[:, 21] == 0),
                "roughcoating": (kind == M.COATING) & (packed[:, 21] > 0)}
        chi2 = {}
        for name, sel in rows.items():
            check(int(sel.sum()) == 1, f"board: {name} rows {sel.sum()}")
            row = int(torch.nonzero(sel)[0])

            def params(n, row=row):
                return common.material_params(
                    scene, st.has_textures,
                    torch.full((n,), row, dtype=torch.int32, device=dev),
                    torch.zeros((n, 2), device=dev))
            sides = ([(0.4, -0.2, 0.89), (0.3, 0.5, -0.81)]
                     if name in ("difftrans", "hk") else [(0.4, -0.2, 0.89)])
            for wi in sides:
                key = name + ("" if wi[2] > 0 else " from below")
                chi2[key] = chi2_on_card(key, params, kinds, wi, dev)
        scene, st = load_scene_at(DOOR, dev, 8, 1, 8, "path")
        kinds = bsdf.scene_kinds(scene)
        row = int(torch.nonzero(scene.materials.packed[:, 0] ==
                                M.THIN_DIELECTRIC)[0])
        n = N_CHI2
        p = common.material_params(
            scene, st.has_textures,
            torch.full((n,), row, dtype=torch.int32, device=dev),
            torch.zeros((n, 2), device=dev))
        wi = torch.tensor([0.6, 0.3, -0.74], device=dev)
        wi = (wi / wi.norm()).expand(n, 3)
        g = torch.Generator(device=dev).manual_seed(7)
        bs = bsdf.sample(p, wi, torch.rand((n, 2), generator=g, device=dev),
                         torch.rand((n,), generator=g, device=dev), kinds)
        refl = bs.wo[:, 2] * wi[:, 2] > 0
        p_refl = float(bs.pdf[refl][0])
        sd = np.sqrt(n * p_refl * (1 - p_refl))
        dev_sd = abs(int(refl.sum()) - n * p_refl) / sd
        through = bool(torch.equal(bs.wo[~refl], -wi[~refl]))
        log(f"  thin glass: reflection share {float(refl.float().mean()):.5f}"
            f" vs its pdf {p_refl:.5f} ({dev_sd:.2f} sd); the rest passes "
            f"straight through: {through}")
        check(dev_sd < 5 and through and bool(bs.is_delta.all()),
              "thin glass: sample does not follow its pdf")
        chi2["thindielectric"] = dict(share=float(refl.float().mean()),
                                      pdf=p_refl, sd=dev_sd)
        summary["chi2"] = chi2

        # door's E[dx] through the thin glass against a finite difference
        # of a long path render (recorded: the reference's copy refracts
        # a thin-glass offset, ROADMAP Queue 3)
        t0 = time.time()
        scene, st = load_scene_at(DOOR, dev, 32, 8, 8, "gpt")
        out = GPTracer(scene, st).render(scene, seed=0, spp=256)
        with wide_passes(32 * 32 * 2048):
            ref = PathTracer(scene, st).render(scene, seed=777, spp=2048,
                                               chunk=2048)
        summary["gpt_door_dx"] = gradient_check(
            f"G-PT door 32x32 256 vs path 2048 spp "
            f"({time.time() - t0:.3f} s)", out["dx"],
            ref - out["very_direct"], out["very_direct"], None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


# step G2a's full-width renders on the cloth board: (label, integrator,
# spp), all at 128^2, maxDepth 8, as CONFIGS_r05.json #2 and #3 render
STEP_G2A = (("path cloth board", "path", 32),
            ("gpt cloth board", "gpt", 32),
            ("bdpt cloth board", "bdpt", 16),
            ("gbdpt cloth board", "gbdpt", 16))


def phase_step_g2a(dev, recs):
    """Step G2a through factory.make_integrator on the cloth board: the
    four STEP_G2A renders (full_width_renders: launches added to the
    sweep kernels' records); G-BDPT = BDPT at full width; all four at
    64^2, 4 spp through the kernels and the plain versions (BDPT and
    G-BDPT at maxDepth 5); G-PT = path
    at maxDepth 5 there; woven cloth's sample against its pdf at 1M
    lanes (the denim row, its yarn features resolved at a fixed uv and
    azimuth)."""
    import shutil
    import tempfile
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import synth_bary_from_az
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common
    from gradientdomain_mitsuba_tpu_torch.scene import materials as M
    tmp = tempfile.mkdtemp()
    try:
        board = load_tool("cloth_board").write_board(tmp)
        summary, full = full_width_renders(
            dev, recs, [(label, board, fam, spp, 8)
                        for label, fam, spp in STEP_G2A])

        # G-BDPT = BDPT at full width (both seed 1, 16 spp)
        comb = (full["gbdpt cloth board"]["primal"] +
                full["gbdpt cloth board"]["very_direct"])
        err = float((comb - full["bdpt cloth board"]).abs().max())
        log(f"gbdpt cloth board 128x128 16spp: primal + very_direct vs "
            f"BDPT max |diff| {err:.3e}")
        check(bool(torch.allclose(comb, full["bdpt cloth board"],
                                  rtol=2e-4, atol=2e-5)),
              "gbdpt cloth board: G-BDPT primal != BDPT")
        summary["gbdpt_vs_bdpt_max_diff"] = err
        del full

        # kernels vs plain at 64^2, 4 spp (same seed; the bidirectional
        # tracers at phase 20's maxDepth 5: a pass a sample, all host
        # dispatch); G-PT = path
        for _, fam, _ in STEP_G2A:
            kernel_vs_plain(dev, f"{fam} cloth board", board, fam,
                            G1_BIDIR_DEPTH if "bdpt" in fam else 8)
        scene, st = load_scene_at(board, dev, 64, 4, 5, "gpt")
        _, bufs, _ = step_7a_render(GPTracer(scene, st), scene, 3, 4)
        img = PathTracer(scene, st).render(scene, seed=3, spp=4)
        comb = bufs["primal"] + bufs["very_direct"]
        err = float((comb - img).abs().max())
        log(f"gpt cloth board 64x64 4spp maxDepth 5: primal + very_direct "
            f"vs PathTracer max |diff| {err:.3e}")
        check(bool(torch.allclose(comb, img, rtol=3e-4, atol=3e-5)),
              "G-PT primal != PathTracer on the cloth board")
        summary["gpt_vs_path_max_diff"] = err

        # woven cloth's sample against its pdf at 1M lanes
        kinds = bsdf.scene_kinds(scene)
        row = int(torch.nonzero(scene.materials.packed[:, 0] ==
                                M.IRAWAN)[0])
        az = torch.tensor([0.6, 0.8], device=dev)

        def params(n):
            return common.material_params(
                scene, st.has_textures,
                torch.full((n,), row, dtype=torch.int32, device=dev),
                torch.tensor([0.37, 0.61], device=dev).expand(n, 2),
                bary=synth_bary_from_az(az.expand(n, 2)))
        check(params(1).cloth is not None, "irawan: no yarn features")
        summary["chi2_irawan"] = chi2_on_card(
            "irawan (denim)", params, kinds, (0.4, -0.2, 0.89), dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# step G2b: every emitter and sensor of the reference (delta lights, the
# constant and sunsky environments, BDPT's aux NEE and G-BDPT's aux-only
# G-PT pass, the other sensors) through factory.make_integrator

# LIGHTS / SUNSKY stand for tools/lights_board.py's two XMLs, written at
# run time; envmap.xml renders at its own 128x96
LIGHTS, SUNSKY = "lights board", "sunsky board"
STEP_G2B_PROPS = {"sppm": {"photonCount": 65536},
                  "vpl": {"vplCount": 1024, "vplChunk": 256}}
# (label, scene, integrator, spp, maxDepth)
STEP_G2B = (("bdpt envmap", ENVMAP, "bdpt", 16, G1_BIDIR_DEPTH),
            ("gbdpt envmap", ENVMAP, "gbdpt", 16, G1_BIDIR_DEPTH),
            ("path lights board", LIGHTS, "path", 32, 8),
            ("gpt lights board", LIGHTS, "gpt", 32, 8),
            ("bdpt lights board", LIGHTS, "bdpt", 16, G1_BIDIR_DEPTH),
            ("gbdpt lights board", LIGHTS, "gbdpt", 16, G1_BIDIR_DEPTH),
            ("path sunsky board", SUNSKY, "path", 32, 8),
            ("gpt sunsky board", SUNSKY, "gpt", 32, 8),
            ("sppm lights board", LIGHTS, "sppm", 16, 5),
            ("vpl lights board", LIGHTS, "vpl", 16, 5))
# the new sensors through path at 128^2 (the meters at their 1x1, 256
# spp) and BDPT on three of them at 64^2: (scene, integrator)
G2B_SENSORS = (("spherical", "path"), ("orthographic", "path"),
               ("telecentric", "path"), ("radiancemeter", "path"),
               ("fluencemeter", "path"), ("rdist", "path"),
               ("orthographic", "bdpt"), ("spherical", "bdpt"),
               ("rdist", "bdpt"))


def bidir_batched(tracer, scene, seed, spp):
    """(image, buffers or None, rays) of a BDPT or G-BDPT render of `spp`
    samples a pixel traced in one pass (bdpt_batched / gbdpt_batched),
    rays from the intersectors' device tally."""
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    tracer.ray_tally = torch.zeros((), dtype=torch.int64,
                                   device=tracer.device)
    try:
        if isinstance(tracer, GBDPTracer):
            bufs = gbdpt_batched(tracer, scene, seed, spp, spp)
            img = bufs["primal"]
        else:
            bufs, img = None, bdpt_batched(tracer, scene, seed, spp, spp)
        rays = int(tracer.ray_tally)
    finally:
        tracer.ray_tally = None
    return img, bufs, rays


def bdpt_batched(tracer, scene, seed, spp, per_pass):
    """A BDPT image (eye image and light image / spp, as render makes it)
    of `spp` samples a pixel traced `per_pass` samples a pass: the same
    lanes, sample indices and arithmetic as render's one sample a pass."""
    from gradientdomain_mitsuba_tpu_torch.ops import film as film_ops
    st = tracer.settings
    H, W = st.height, st.width
    N = H * W
    dev = tracer.device
    fb = torch.zeros((H, W, 3), device=dev)
    li = torch.zeros_like(fb)
    wb = torch.zeros((H, W), device=dev)
    ids = torch.arange(N, device=dev).repeat(per_pass)
    for start in range(0, spp, per_pass):
        sidx = start + torch.arange(per_pass, device=dev).repeat_interleave(N)
        pos, L, spos, sval = tracer.trace_pass(scene, seed, sidx,
                                               pixel_id=ids)
        fb, wb = film_ops.splat_grid(fb, wb,
                                     (pos % 1.0).reshape(per_pass, N, 2),
                                     L.reshape(per_pass, N, 3),
                                     tracer.filter_kind)
        li = film_ops.splat_unfiltered(li, spos, sval)
    return film_ops.develop(fb, wb) + li / spp


def bdpt_vs_path(dev, label, path, over, spp, tol):
    """tests/test_bdpt_env.py's _compare on the card: BDPT (seed 3) and
    path (seed 11) at `spp` each, finite, means within `tol` relative,
    the median per-pixel residual |b - p| / (p + 0.05 mean) below 3 tol
    where the path image is lit.  BDPT traces all its samples in one
    pass (bdpt_batched)."""
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    t0 = time.time()
    scene_np, st = sc.load_scene(path, over.get("vars"), over.get("over"))
    scene = bridge.to_torch(scene_np, dev)
    b = bdpt_batched(BDPTracer(scene, st), scene, 3, spp, spp)
    p = PathTracer(scene, st).render(scene, seed=11, spp=spp)
    check(bool(torch.isfinite(b).all() and torch.isfinite(p).all()),
          f"{label}: not finite")
    denom = max(float(p.mean()), 1e-9)
    rel = abs(float(b.mean()) - float(p.mean())) / denom
    lit = p.sum(-1) > 1e-4
    rr = float(((b[lit] - p[lit]).abs() / (p[lit] + 0.05 * denom))
               .median())
    log(f"  E[BDPT] vs E[path] {label} {st.width}x{st.height} maxDepth "
        f"{st.max_depth}, {spp} spp each: means {float(b.mean()):.5f} vs "
        f"{float(p.mean()):.5f} (rel {rel:.4f} < {tol}), median residual "
        f"{rr:.4f} (< {3 * tol}) ({time.time() - t0:.3f} s)")
    check(rel < tol, f"{label}: E[BDPT] != E[path]")
    check(rr < 3 * tol, f"{label}: per-pixel residual")
    return dict(rel=rel, median_residual=rr)


def env_gradient_check(dev, path):
    """tests/test_bdpt_env.py's G-BDPT E[dx] check on the constant-env
    open box with the small box (maxDepth 2): 64 spp (seed 0) against the
    finite difference of a 256-spp primal (seed 777), interior pixels;
    slope in (0.3, 1.7), correlation > 0.45, rms ratio in (0.5, 1.7);
    primal + very_direct against a 32-spp BDPT mean within 5%.  Traced 64
    samples a pass (gbdpt_batched, bdpt_batched)."""
    from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    t0 = time.time()
    scene_np, st = sc.load_scene(path, None, {"max_depth": 2})
    scene = bridge.to_torch(scene_np, dev)
    g = GBDPTracer(scene, st)
    check(g.aux_via_gpt, "env box: G-BDPT without its aux-only G-PT")
    out = gbdpt_batched(g, scene, 0, 64, 64)
    primal, very, dx = out["primal"], out["very_direct"], out["dx"]
    ref = gbdpt_batched(g, scene, 777, 256, 64)["primal"]
    fd_x = (ref[:, 1:] - ref[:, :-1]).sum(-1)
    d = dx[:, :-1].sum(-1)
    vd = very.sum(-1)
    mx = (vd[:, 1:] + vd[:, :-1]) == 0
    a, b = d[mx].double(), fd_x[mx].double()
    slope = float((a * b).sum() / (b * b).sum().clamp_min(1e-12))
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    rms = float(torch.sqrt((a * a).mean() / (b * b).mean().clamp_min(
        1e-12)))
    bd = bdpt_batched(BDPTracer(scene, st), scene, 5, 32, 32)
    rel = abs(float((primal + very).mean()) - float(bd.mean())) / float(
        bd.mean())
    log(f"  G-BDPT env box E[dx] ({int(mx.sum())} pixel pairs): slope "
        f"{slope:.4f} (0.3-1.7), corr {corr:.4f} (> 0.45), rms ratio "
        f"{rms:.4f} (0.5-1.7); primal + very_direct vs BDPT mean rel "
        f"{rel:.4f} (< 0.05) ({time.time() - t0:.3f} s)")
    check(int(mx.sum()) >= 32, "env box: too few interior pixels")
    check(0.3 < slope < 1.7 and corr > 0.45 and 0.5 < rms < 1.7,
          "env box: G-BDPT E[dx] off the finite difference")
    check(rel < 0.05, "env box: G-BDPT != BDPT in expectation")
    return dict(slope=slope, corr=corr, rms_ratio=rms, vs_bdpt=rel)


def warp_chi2(dev):
    """The uniform sphere and cone (cos 0.6) warps' samples against their
    own pdfs at N_CHI2 lanes: uniform in (z, phi) over 8 x 16 bins,
    chi^2 below dof + 5.5 sqrt(2 dof) as chi2_on_card."""
    from gradientdomain_mitsuba_tpu_torch.core import warp
    g = torch.Generator(device=dev).manual_seed(11)
    u = torch.rand((N_CHI2, 2), generator=g, device=dev)
    out = {}
    for name, d, lo in (
            ("sphere", warp.square_to_uniform_sphere(u), -1.0),
            ("cone", warp.square_to_uniform_cone(u, 0.6), 0.6)):
        iz = torch.clamp(((d[:, 2] - lo) / (1 - lo) * 8).long(), 0, 7)
        phi = torch.remainder(torch.atan2(d[:, 1], d[:, 0]), 2 * np.pi)
        ip = torch.clamp((phi / (2 * np.pi) * 16).long(), 0, 15)
        counts = torch.bincount(iz * 16 + ip, minlength=128).double()
        expect = N_CHI2 / 128
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        limit = 127 + 5.5 * np.sqrt(2.0 * 127)
        norm = float((d.norm(dim=-1) - 1).abs().max())
        log(f"  chi2 uniform {name}: {chi2:.1f} (dof 127, limit "
            f"{limit:.1f}); max |norm - 1| {norm:.2e}")
        check(chi2 < limit and norm < 1e-5,
              f"uniform {name}: sample does not follow its pdf")
        out[name] = chi2
    return out


def phase_step_g2b(dev, recs):
    """Step G2b through factory.make_integrator: the STEP_G2B renders
    (full_width_renders; envmap.xml at its own 128x96, the boards at
    128^2; launches added to the sweep kernels' records); G-BDPT = BDPT
    on envmap and the lights board at full width; every STEP_G2B family
    and volpath, irrcache and pssmlt on the lights board at 64^2, 4 spp
    through the kernels and the plain versions; G-PT = path at maxDepth
    5; E[BDPT] = E[path] on the env-plus-area and point-light open boxes
    and on envmap; G-BDPT's E[dx] on the constant-env box; the sensors
    through path (and BDPT) against plain, with their expectations; the
    sweeps against plain on the new ray families; the collimated beam
    under SPPM; the uniform warps' chi^2."""
    import shutil
    import tempfile
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.models.sppm import SPPMTracer
    tmp = tempfile.mkdtemp()
    try:
        lb = load_tool("lights_board")
        ss = load_tool("sensor_scenes")
        paths = {LIGHTS: lb.write_board(tmp, "constant"),
                 SUNSKY: lb.write_board(tmp, "sunsky")}
        board = paths[LIGHTS]

        def load(label, path, fam, spp, depth):
            return load_scene_at(path, dev, None if path == ENVMAP else 128,
                                 spp, depth, fam, STEP_G2B_PROPS.get(fam))
        summary, full = full_width_renders(
            dev, recs, [(label, paths.get(path, path), fam, spp, depth)
                        for label, path, fam, spp, depth in STEP_G2B],
            load)

        # G-BDPT = BDPT at full width (both seed 1, 16 spp)
        for name in ("envmap", "lights board"):
            comb = (full[f"gbdpt {name}"]["primal"] +
                    full[f"gbdpt {name}"]["very_direct"])
            err = float((comb - full[f"bdpt {name}"]).abs().max())
            log(f"gbdpt {name} 16spp: primal + very_direct vs BDPT max "
                f"|diff| {err:.3e}")
            check(bool(torch.allclose(comb, full[f"bdpt {name}"],
                                      rtol=2e-4, atol=2e-5)),
                  f"gbdpt {name}: G-BDPT primal != BDPT")
            summary[f"gbdpt_vs_bdpt_{name}"] = err
        del full

        # kernels vs plain at 64^2, 4 spp (same seed)
        for label, path, fam, _, depth in STEP_G2B + (
                ("volpath lights board", LIGHTS, "volpath", 4, 5),
                ("irrcache lights board", LIGHTS, "irrcache", 4, 5),
                ("pssmlt lights board", LIGHTS, "pssmlt", 4, 5)):
            props = dict(STEP_G2B_PROPS.get(fam, {}))
            if fam == "pssmlt":
                props.update(chains=4096, luminanceSamples=16384)
            kernel_vs_plain(dev, label, paths.get(path, path), fam, depth,
                            props=props)
        scene, st = load_scene_at(board, dev, 64, 4, 5, "gpt")
        _, bufs, _ = step_7a_render(GPTracer(scene, st), scene, 3, 4)
        img = PathTracer(scene, st).render(scene, seed=3, spp=4)
        comb = bufs["primal"] + bufs["very_direct"]
        err = float((comb - img).abs().max())
        log(f"gpt lights board 64x64 4spp maxDepth 5: primal + "
            f"very_direct vs PathTracer max |diff| {err:.3e}")
        check(bool(torch.allclose(comb, img, rtol=3e-4, atol=3e-5)),
              "G-PT primal != PathTracer on the lights board")
        summary["gpt_vs_path_max_diff"] = err

        # E[BDPT] = E[path] (tests/test_bdpt_env.py's scenes, sample
        # counts and tolerances); G-BDPT's gradients of the env family
        summary["bdpt_vs_path"] = {
            "env_area": bdpt_vs_path(
                dev, "env + area box", lb.write_open_box(tmp, "env_area"),
                {}, 128, 0.03),
            "point": bdpt_vs_path(
                dev, "point-light box", lb.write_open_box(tmp, "point"),
                {"over": {"max_depth": 2}}, 64, 0.01),
            "envmap": bdpt_vs_path(
                dev, "envmap", ENVMAP, {"vars": {
                    "width": "24", "height": "24", "spp": "8",
                    "maxDepth": "3"}}, 64, 0.03)}
        summary["env_box_dx"] = env_gradient_check(
            dev, lb.write_open_box(tmp, "env_smallbox"))

        # the sensors: path at 128^2 (meters 1x1, 256 spp) and BDPT at
        # 64^2 through kernels and plain, with the reference tests'
        # expectations
        sens = {}
        for name, fam in G2B_SENSORS:
            path = ss.write_scene(tmp, name)
            meter = name in ss.METERS
            size = None if meter else (128 if fam == "path" else 64)
            spp = 256 if meter else 4
            kb, _, st = kernel_vs_plain(dev, f"{fam} {name}", path, fam,
                                        3, size=size, spp=spp)
            img = kb["image"]
            if fam != "path":
                continue
            if name == "spherical":
                frac = float(((img - 2.0).abs() < 1e-4).all(-1).float()
                             .mean())
                check(frac > 0.95, f"spherical: {frac} of pixels read 2")
                sens[name] = frac
            elif name == "radiancemeter":
                check(bool(torch.allclose(img[0, 0], torch.tensor(
                    [3.0, 2.0, 1.0], device=dev), rtol=1e-5)),
                      f"radiancemeter reads {img[0, 0].tolist()}")
                sens[name] = img[0, 0].tolist()
            elif name == "fluencemeter":
                check(bool(((img[0, 0] - 2.0).abs() < 0.04).all()),
                      f"fluencemeter reads {img[0, 0].tolist()}")
                sens[name] = img[0, 0].tolist()
        imgs = []
        for name in ("rdist0", "perspective"):
            scene, st = load_scene_at(ss.write_scene(tmp, name), dev, 128,
                                      4, 2, "path")
            imgs.append(PathTracer(scene, st).render(scene, seed=1, spp=4))
        same = bool(torch.equal(*imgs))
        log(f"  rdist kc 0 vs perspective 128x128 4spp: equal {same}")
        check(same, "rdist with kc 0 != perspective")
        for name, v in sens.items():
            log(f"  {name}: {v}")
        summary["sensors"] = sens

        # the sweeps against plain on the new ray families: the
        # directional light's 1e7 shadow rays (one path pass on the
        # board), the orthographic camera's parallel rays, the spherical
        # and fluencemeter rays from inside the box (the board under those
        # sensors), and SPPM's photon walks from the delta lights
        for sensor, size, spp in (("perspective", 64, 1),
                                  ("orthographic", 64, 1),
                                  ("spherical", 64, 1),
                                  ("fluencemeter", 1, 4096)):
            path = lb.write_board(tmp, "constant", sensor)
            scene, st = load_scene_at(path, dev, size, spp, 5, "path")
            tracer = PathTracer(scene, st)
            check_render_calls(f"path lights board, {sensor}",
                               render_calls(tracer, scene, spp),
                               scene.geom.linC)
        scene, st = load_scene_at(board, dev, 64, 1, 5, "sppm",
                                  STEP_G2B_PROPS["sppm"])
        tracer = SPPMTracer(scene, st)
        calls = render_calls(tracer, scene, 1, run=lambda: (
            tracer._emit_photons(scene, 0, 0)))
        calls.append((True, calls[0][1]))   # any hit on the photon rays
        check_render_calls("sppm photons lights board", calls,
                           scene.geom.linC)

        # the collimated beam under SPPM (tests/test_sensors.py)
        scene, st = load_scene_at(lb.write_collimated(tmp), dev, None, 4, 3,
                                  "sppm")
        img = SPPMTracer(scene, st).render(scene, seed=0, spp=4)
        center, border = lb.beam_spot(img)
        log(f"  collimated beam under SPPM: centre {center:.5f}, border "
            f"{border:.3e}")
        check(center > 0.05 and center > 20 * max(border, 1e-9),
              "collimated beam: no spot")
        summary["collimated"] = dict(center=center, border=border)
        summary["chi2"] = warp_chi2(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# steps G2b-2 and G2c: textured materials in the tracers with their own
# loops (the lifted cloth board) and dipole subsurface scattering
# (tools/sss_scene.py) through factory.make_integrator

STEP_G2C_FAMILIES = ("volpath", "irrcache", "sppm", "vpl", "pssmlt", "erpt")
# the chains at one mutation a pixel; ERPT's round sized to it (chainLength
# 2 of its 8,192 chains), PSSMLT's 64^2 comparison at phase 22's chains
STEP_G2C_PROPS = {"sppm": {"photonCount": 65536},
                  "vpl": {"vplCount": 1024, "vplChunk": 256},
                  "erpt": {"chainLength": 2}}
STEP_G2C_SPP = {"pssmlt": 1, "erpt": 1}
STEP_G2C_SMALL_PROPS = {"pssmlt": {"chains": 4096,
                                   "luminanceSamples": 16384}}
# samples a pixel of the profiled pass that reads a render's idle share
# (at 128^2 a pass of the path-type tracers holds 4 samples a pixel)
STEP_G2C_PROFILE_SPP = {"volpath": 4, "irrcache": 4, "sppm": 1, "vpl": 1,
                        "pssmlt": 1, "erpt": 1}
# the subsurface renders: tests/test_sss.py's scene at 256^2, 16 spp,
# maxDepth 4, with the cache at the reference's defaults
SSS_VARS = {"samples": "2048", "irrSamples": "16"}


def timed_eval_mo():
    """Wraps ops/sss.eval_mo so that each outermost call (not its calls
    on its own lane blocks) is bracketed by CUDA events; returns (the
    list of event pairs, a function restoring eval_mo)."""
    from gradientdomain_mitsuba_tpu_torch.ops import sss
    spans, orig, depth = [], sss.eval_mo, [0]

    def timed(*a, **k):
        depth[0] += 1
        if depth[0] > 1:
            try:
                return orig(*a, **k)
            finally:
                depth[0] -= 1
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        try:
            out = orig(*a, **k)
        finally:
            depth[0] -= 1
        e1.record()
        spans.append((e0, e1))
        return out
    sss.eval_mo = timed

    def restore():
        sss.eval_mo = orig
    return spans, restore


def sss_phase(dev, recs, tmp):
    """The subsurface half of phase 23 (see phase_step_g2c)."""
    from gradientdomain_mitsuba_tpu_torch.models import factory
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    ss = load_tool("sss_scene")
    paths = {v: ss.write_scene(tmp, v) for v in ("one", "two", "absorber")}
    out = {}
    scene, st = load_scene_at(paths["one"], dev, 256, 16, 4, "path",
                              variables=SSS_VARS)
    tracer = factory.make_integrator(scene, st)
    names = [k.name for k in tracer.kernels]
    check(type(tracer).__name__ == "DipoleTracer" and
          names == ["pair_closest", "pair_occluded"],
          f"subsurface scene: {type(tracer).__name__} on {names}")
    check((tracer.n_points, tracer.irr_samples) == (2048, 16),
          "subsurface cache size")
    log(f"subsurface scene: {int(scene.geom.indices.shape[0])} triangles "
        f"in {int(scene.geom.clusters.offset.shape[0])} clusters")
    t0 = time.time()
    tracer.render(scene, seed=0, spp=1)
    torch.cuda.synchronize()
    log(f"dipole warm-up (1 spp, cache included) {time.time() - t0:.3f} s")

    # the cache build, rays through the tally
    tracer.ray_tally = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    cache = tracer._build_cache(scene, 1)
    torch.cuda.synchronize()
    cache_wall = time.time() - t0
    cache_rays = int(tracer.ray_tally)
    tracer.ray_tally = None
    E = cache["E"]
    log(f"dipole cache build ({tracer.n_points} points x "
        f"{tracer.irr_samples} rays): wall {cache_wall:.4f} s, rays "
        f"{cache_rays}, E finite {bool(torch.isfinite(E).all())}, mean E "
        f"{float(E.mean()):.5f}")
    check(bool(torch.isfinite(E).all()) and float(E.mean()) > 0,
          "dipole cache: E not finite or zero")

    # the render (cache built again inside, as a user's call does)
    for k in tracer.kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img, rays = counted_render(tracer, scene, 1, 16)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = [k.launches for k in tracer.kernels]
    for k, n in zip(tracer.kernels, launches):
        recs[k.name]["launches"] += n
    log(f"dipole 256x256 16spp maxDepth 4: wall {wall:.4f} s (cache "
        f"included), pass rays {rays}, {rays / wall / 1e6:.3f} Mrays/s, "
        f"pair launches closest {launches[0]} occluded {launches[1]}")
    check(all(n > 0 for n in launches), f"dipole launches {launches}")
    spans, restore = timed_eval_mo()
    try:
        prof = profiled_render(
            lambda: tracer.render(scene, seed=2, spp=16), "pair_")
        torch.cuda.synchronize()
        mo_ms = sum(a.elapsed_time(b) for a, b in spans)
    finally:
        restore()
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    log(f"  profiled dipole render (seed 2, 16 spp: the cache and one "
        f"pass): device busy {prof['busy_ms']:.3f} ms of "
        f"{prof['wall_ms']:.3f} ms wall (idle {100 * idle:.1f}%), "
        f"{prof['device_ops']} device ops; pair kernels "
        f"{prof['kernel_ms']:.3f} ms over {prof['kernel_calls']} "
        f"launches; eval_mo {mo_ms:.3f} ms over {len(spans)} calls "
        f"(CUDA events)")
    out["dipole"] = dict(cache_wall_s=cache_wall, cache_rays=cache_rays,
                         wall_s=wall, rays=rays, launches=launches,
                         idle=idle, profiled=prof, eval_mo_ms=mo_ms,
                         eval_mo_calls=len(spans))

    # the oracle (tests/test_sss.py): finite, the sphere lit; brighter
    # than the same shape as a pure absorber, and than the same scene
    # without the dipole term (PathTracer has no cache)
    check(bool(torch.isfinite(img).all()), "dipole image not finite")
    c = float(img[96:160, 96:160].mean())
    plain = PathTracer(scene, st).render(scene, seed=1, spp=16)
    c_plain = float(plain[96:160, 96:160].mean())
    ascene, ast = load_scene_at(paths["absorber"], dev, 256, 16, 4, "path")
    black = factory.make_integrator(ascene, ast).render(ascene, seed=1,
                                                        spp=16)
    c_black = float(black[96:160, 96:160].mean())
    log(f"  sphere centre mean |I|: dipole {c:.5f}, no dipole term "
        f"{c_plain:.5f}, absorber {c_black:.5f}")
    check(c > 1e-3 and c > 1.05 * c_plain and c > 2 * c_black,
          "dipole sphere not brighter than without the term / absorber")
    out["oracle"] = dict(centre=c, no_dipole=c_plain, absorber=c_black)

    # v4 = v7 on the same render (GDMT_KERNEL=v4: the block kernels)
    saved = os.environ.get("GDMT_KERNEL")
    os.environ["GDMT_KERNEL"] = "v4"
    try:
        t4 = factory.make_integrator(scene, st)
    finally:
        if saved is None:
            del os.environ["GDMT_KERNEL"]
        else:
            os.environ["GDMT_KERNEL"] = saved
    names = [k.name for k in t4.kernels]
    check(names == ["mt_closest", "mt_occluded"],
          f"GDMT_KERNEL=v4 chose {names}")
    for k in t4.kernels:
        k.launches = 0
    t0 = time.time()
    img4, rays4 = counted_render(t4, scene, 1, 16)
    torch.cuda.synchronize()
    wall4 = time.time() - t0
    launches4 = [k.launches for k in t4.kernels]
    for k, n in zip(t4.kernels, launches4):
        recs[k.name]["launches"] += n
    frac = _close_frac(img4, img, IMG_RTOL, IMG_ATOL)
    log(f"dipole under GDMT_KERNEL=v4: wall {wall4:.4f} s, rays {rays4} vs "
        f"{rays}, launches {launches4}, {frac:.5f} of pixels within rtol "
        f"{IMG_RTOL} atol {IMG_ATOL}, max |diff| "
        f"{float((img4 - img).abs().max()):.3e}")
    check(rays4 == rays and frac >= IMG_FRAC and all(launches4),
          "dipole: v4 render differs from v7")
    out["v4"] = dict(wall_s=wall4, rays=rays4, launches=launches4,
                     close=frac)

    # kernels vs plain at 64^2, 4 spp on both scenes (equal rays)
    for v in ("one", "two"):
        kernel_vs_plain(dev, f"dipole {v}", paths[v], "path", 4,
                        variables=SSS_VARS)
    return out


def phase_step_g2c(dev, recs):
    """Steps G2b-2 and G2c through factory.make_integrator: the
    STEP_G2C_FAMILIES on tools/cloth_board.py's board lifted off the axis
    planes at 128^2, maxDepth 5 (16 spp; one mutation a pixel for the
    chains), each after a warm-up with the sweeps' launch counters reset
    just before it (factory_render: wall, rays, launches, added to the
    sweep kernels' records) and one profiled pass (idle share); volpath
    = path on the board at maxDepth -1 (path at the finest texture
    level, where volpath reads); all six at 64^2, 4 spp through
    the kernels and the plain versions (the chains' decisions all
    equal).  Then the subsurface scene (sss_phase): the cache build and
    the 256^2 render (wall, rays, pair launches, eval_mo's device ms in
    one profiled render), the oracle, v4 = v7, and kernel vs plain at
    64^2, 4 spp on both subsurface scenes."""
    import shutil
    import tempfile
    from gradientdomain_mitsuba_tpu_torch.models import factory
    tmp = tempfile.mkdtemp()
    summary = {}
    try:
        board = load_tool("cloth_board").write_board(tmp, lift=True)
        for fam in STEP_G2C_FAMILIES:
            label = f"{fam} cloth board"
            scene, st = load_scene_at(board, dev, 128,
                                      STEP_G2C_SPP.get(fam, 16), 5, fam,
                                      STEP_G2C_PROPS.get(fam))
            check(st.has_textures == 31, f"board texture bits "
                  f"{st.has_textures}")
            tracer, _, summary[label] = factory_render(label, scene, st)
            for name, n in zip(("sweep_closest", "sweep_occluded"),
                               summary[label]["launches"]):
                recs[name]["launches"] += n
            prof_spp = STEP_G2C_PROFILE_SPP[fam]
            prof = profiled_render(lambda: tracer.render(
                scene, seed=2, spp=prof_spp), "sweep_")
            idle = 1 - prof["busy_ms"] / prof["wall_ms"]
            log(f"  profiled {label} ({prof_spp} spp, seed 2): device busy "
                f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
                f"(idle {100 * idle:.1f}%), {prof['device_ops']} device "
                f"ops; sweeps {prof['kernel_ms']:.3f} ms over "
                f"{prof['kernel_calls']} launches")
            summary[label].update(idle=idle, profiled=prof)
            del tracer

        # volpath = path on the board at unlimited depth.  volpath reads
        # every texture at its finest level, as the reference's does; the
        # path tracer reads the primary hits at their footprint's level,
        # so here it is held to the finest level too
        from gradientdomain_mitsuba_tpu_torch.models import path as path_mod
        imgs = {}
        footprint = path_mod.primary_footprint
        path_mod.primary_footprint = lambda *a: None
        try:
            for fam in ("path", "volpath"):
                scene, st = load_scene_at(board, dev, 64, 4, -1, fam)
                imgs[fam] = factory.make_integrator(scene, st).render(
                    scene, seed=1, spp=4)
        finally:
            path_mod.primary_footprint = footprint
        frac = _close_frac(imgs["volpath"], imgs["path"], 5e-3, 5e-4)
        rel = abs(float(imgs["volpath"].mean()) /
                  float(imgs["path"].mean()) - 1)
        log(f"volpath vs path (finest texture level) on the board at "
            f"maxDepth -1, 64x64 4spp: "
            f"{frac:.5f} of pixels within rtol 5e-3 atol 5e-4, mean rel "
            f"diff {rel:.2e}")
        check(frac >= 0.999 and rel < 1e-3,
              "volpath differs from path on the board at unlimited depth")
        summary["volpath_vs_path"] = dict(close=frac, mean_rel=rel)

        # kernels vs plain at 64^2, 4 spp (same seed)
        for fam in STEP_G2C_FAMILIES:
            props = dict(STEP_G2C_PROPS.get(fam, {}))
            props.update(STEP_G2C_SMALL_PROPS.get(fam, {}))
            kernel_vs_plain(dev, f"{fam} cloth board", board, fam, 5,
                            props=props, all_takes=True)
        summary["subsurface"] = sss_phase(dev, recs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


@contextlib.contextmanager
def launch_tally():
    """Counts every sweep kernel launch inside the block, whatever tracer
    the entry point builds (the SweepKernel wrappers' own counts rise
    with it): yields {kernel name: launches}."""
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    launch = sweep.SweepKernel._launch
    tally = {"sweep_closest": 0, "sweep_occluded": 0}

    def counted(k, *args, **kw):
        out = launch(k, *args, **kw)
        tally[k.name] += 1
        return out

    sweep.SweepKernel._launch = counted
    try:
        yield tally
    finally:
        sweep.SweepKernel._launch = launch


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_h_cli(dev, recs, tmp):
    """Phase 24a: the CLI's routes on the card (see the module
    docstring)."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.utils import cli, exr, mtsutil
    out = {}
    dev_arg = ["--device", str(dev)]
    gpt_args = [CBOX, "-D", "integrator=gpt", "-D", "width=256", "-D",
                "height=256", "-D", "maxDepth=6", "-s", "64", "-z",
                "1"] + dev_arg

    def run(label, argv):
        with launch_tally() as tally:
            torch.cuda.synchronize()
            t0 = time.time()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
        check(rc == 0, f"CLI {label}: rc {rc}")
        for name, n in tally.items():
            recs[name]["launches"] += n
        check(all(n > 0 for n in tally.values()),
              f"CLI {label}: a sweep kernel was not launched: {tally}")
        return wall, dict(tally)

    def read(path):
        img = exr.read_rgb(path)
        check(bool(np.isfinite(img).all()), f"{path}: not finite")
        return img

    # warm-up: one small CLI render (first-use costs out of the walls)
    run("warm-up", [CBOX, "-D", "integrator=gpt", "-D", "width=64", "-D",
                    "height=64", "-s", "1", "-q", "-o",
                    os.path.join(tmp, "warm.exr")] + dev_arg)
    imgs = {}
    for route, extra in (("fused", []),
                         ("chunked", ["-v", "--stats-json",
                                      os.path.join(tmp, "chunked.json")])):
        o = os.path.join(tmp, route + ".exr")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wall, tally = run(route, gpt_args + ["-o", o] + extra)
        imgs[route] = {k: read(os.path.join(tmp, f"{route}-{k}.exr"))
                       for k in ("primal", "dx", "dy", "direct", "final")}
        check(tuple(imgs[route]["final"].shape) == (256, 256, 3),
              f"{route}: final shape")
        out[route] = dict(wall_s=wall, launches=tally)
        if route == "chunked":
            log(buf.getvalue().rstrip())
    # the API's render at the same seed, rays counted on the device
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    scene_np, st = sc.load_scene(CBOX, {"integrator": "gpt", "width": "256",
                                        "height": "256", "maxDepth": "6"})
    st.spp = 64
    scene = bridge.to_torch(scene_np, dev)
    tracer = GPTracer(scene, st)
    tracer.count_rays = True
    final, bufs = tracer.render_final(scene, 1, 64)
    rays = int(bufs["rays"])
    half = final.cpu().numpy().astype(np.float16).astype(np.float32)
    check(np.array_equal(imgs["fused"]["final"], half),
          "CLI fused -final.exr differs from GPTracer.render_final")
    for k in ("primal", "dx", "dy", "direct"):
        check(np.allclose(imgs["chunked"][k], imgs["fused"][k], rtol=1e-5,
                          atol=0), f"CLI chunked {k} differs from fused")
    with open(os.path.join(tmp, "chunked.json")) as f:
        stats = json.load(f)
    check(stats["rays_measured"] and stats["rays"] == rays,
          f"CLI counted rays {stats['rays']} != render_final's {rays}")
    out["rays"] = rays
    out["chunked"].update(render_s=stats["render_s"],
                          reconstruct_s=stats["reconstruct_s"],
                          cg_residual_final=stats["cg_residual_final"])
    for route in ("fused", "chunked"):
        r = out[route]
        log(f"CLI G-PT {route}: wall {r['wall_s']:.4f} s (load, render, "
            f"reconstruct, EXR writes), {rays / r['wall_s'] / 1e6:.3f} "
            f"Mrays/s over the wall, sweep launches {r['launches']}")
    log(f"CLI G-PT chunked: render {stats['render_s']:.4f} s "
        f"({rays / stats['render_s'] / 1e6:.3f} Mrays/s), reconstruct "
        f"{stats['reconstruct_s']:.4f} s; {rays} rays = render_final's "
        f"device count")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mtsutil.main(["diff", os.path.join(tmp, "fused-final.exr"),
                           os.path.join(tmp, "chunked-final.exr"),
                           "--fail-above", "1e-6"])
    log(f"tpuutil-torch diff fused-final chunked-final: "
        f"{buf.getvalue().strip()} (rc {rc})")
    check(rc == 0, "tpuutil-torch diff: the finals differ")
    out["diff"] = buf.getvalue().strip()

    for label, extra, o in (
            ("gbdpt", ["--integrator", "gbdpt", "-D", "width=128", "-D",
                       "height=128", "-s", "4"], "gbdpt.exr"),
            ("path", ["--integrator", "path", "-s", "16"], "path.npy")):
        js = os.path.join(tmp, label + ".json")
        argv = [CBOX, "-D", "maxDepth=6", "-z", "1", "-q", "-v",
                "--stats-json", js, "-o", os.path.join(tmp, o)] + extra + \
            dev_arg
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wall, tally = run(label, argv)
        with open(js) as f:
            st_j = json.load(f)
        img = (np.load(os.path.join(tmp, o)) if o.endswith(".npy") else
               read(os.path.join(tmp, "gbdpt-final.exr")))
        check(bool(np.isfinite(img).all()) and float(np.abs(img).mean()) > 0,
              f"CLI {label}: output not finite or black")
        check(st_j["rays_measured"] and st_j["rays"] > 0,
              f"CLI {label}: rays not counted")
        out[label] = dict(wall_s=wall, render_s=st_j["render_s"],
                          rays=st_j["rays"], launches=tally,
                          size=[st_j["width"], st_j["height"]],
                          spp=st_j["spp"])
        log(f"CLI {label} {st_j['width']}x{st_j['height']} {st_j['spp']} "
            f"spp: wall {wall:.4f} s, render {st_j['render_s']:.4f} s, "
            f"{st_j['rays']} rays counted, "
            f"{st_j['rays'] / st_j['render_s'] / 1e6:.3f} Mrays/s, sweep "
            f"launches {tally}")
    return out


def step_h_parallel(dev, recs):
    """Phase 24b: parallel/ on a world of one over NCCL (see the module
    docstring)."""
    import torch.distributed as dist
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
    from gradientdomain_mitsuba_tpu_torch.parallel import (
        dist_poisson, multihost, tile_queue, tiles)
    out = {}
    rank_dev = multihost.init(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        check(dist.get_backend() == "nccl" and rank_dev == dev,
              f"multihost.init: backend {dist.get_backend()} on {rank_dev}")
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        check(float(one) == 1.0, "NCCL all_reduce on a world of one")
        mesh = multihost.global_mesh()
        check((mesh.size, mesh.rank, mesh.device) == (1, 0, dev),
              f"global mesh {mesh}")

        def timed(label, fn):
            with launch_tally() as tally:
                torch.cuda.synchronize()
                t0 = time.time()
                res = fn()
                torch.cuda.synchronize()
                wall = time.time() - t0
            for name, n in tally.items():
                recs[name]["launches"] += n
            check(all(n > 0 for n in tally.values()),
                  f"{label}: a sweep kernel was not launched: {tally}")
            out[label] = dict(wall_s=wall, launches=dict(tally))
            log(f"{label}: wall {wall:.4f} s, sweep launches {tally}")
            return res

        def close(label, got, ref, rtol=1e-4, atol=1e-5):
            ref = ref.cpu().numpy() if torch.is_tensor(ref) else ref
            err = float(np.abs(got - ref).max())
            check(bool(np.isfinite(got).all()) and
                  np.allclose(got, ref, rtol=rtol, atol=atol),
                  f"{label}: max |diff| {err}")
            return err

        for fam, cls in (("gpt", GPTracer), ("gbdpt", GBDPTracer),
                         ("path", PathTracer)):
            scene, st = load_scene_at(CBOX, dev, 128, 4, 5, fam)
            tracer = cls(scene, st)
            single = tracer.render(scene, seed=2, spp=4)
            if fam == "gpt":
                multi = timed("tiles gpt (render_gpt_multihost)",
                              lambda: multihost.render_gpt_multihost(
                                  tracer, scene, 2, 4))
                gpt_single, gpt_tracer, gpt_scene = single, tracer, scene
            elif fam == "gbdpt":
                multi = timed("tiles gbdpt (render_tiles_gbdpt)",
                              lambda: tiles.render_tiles_gbdpt(
                                  tracer, scene, mesh, 2, 4))
            else:
                multi = {"image": timed(
                    "tiles path (render_path_multihost)",
                    lambda: multihost.render_path_multihost(
                        tracer, scene, 2, 4))}
                single = {"image": single}
            errs = {k: close(f"tiles {fam} {k}", multi[k], single[k])
                    for k in single}
            out[f"tiles {fam}"] = errs
            log(f"tiles {fam} 128x128 4spp vs {cls.__name__}.render: "
                f"max |diff| {errs}")

        bufs = {k: v for k, v in gpt_single.items()}
        t0 = time.time()
        rec = dist_poisson.reconstruct_sharded(mesh, bufs, alpha=0.2,
                                               iters=100)
        sharded_s = time.time() - t0
        local = poisson.solve_l2(bufs["primal"], bufs["dx"], bufs["dy"],
                                 alpha=0.2, iters=100) + bufs["very_direct"]
        err = close("reconstruct_sharded", rec, local, rtol=1e-3, atol=2e-3)
        out["reconstruct_sharded"] = dict(wall_s=sharded_s, max_abs=err)
        log(f"reconstruct_sharded (L2, 100 CG iterations) {sharded_s:.4f} s "
            f"vs poisson.solve_l2: max |diff| {err:.3e}")

        faults = []

        def hook(idx, attempt):
            if idx == 1 and attempt == 0:
                faults.append(idx)
                raise RuntimeError("injected: tile 1 lost")

        clean = timed("tile queue", lambda: tile_queue.render_tiles_queued(
            gpt_tracer, gpt_scene, 3, 4, tile_rows=32))
        faulty = timed("tile queue, tile 1 failed once",
                       lambda: tile_queue.render_tiles_queued(
                           gpt_tracer, gpt_scene, 3, 4, tile_rows=32,
                           fail_hook=hook))
        check(faults == [1], f"fault hook calls {faults}")
        for k in clean:
            check(np.array_equal(clean[k], faulty[k]),
                  f"tile queue {k}: a retried tile changed the film")
        log("tile queue: a retry of tile 1 gives the same bits")
    finally:
        dist.destroy_process_group()
    return out


def phase_step_h(dev, recs):
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    try:
        return {"cli": step_h_cli(dev, recs, tmp),
                "parallel": step_h_parallel(dev, recs)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("step-e", "step-f", "step-7a",
                                        "step-g1", "step-g2a", "step-g2b",
                                        "step-g2c", "step-h"),
                    help="build the kernels and run one phase that needs "
                         "no earlier one (step-e: phase 17, step-f: phase "
                         "18, step-7a: phase 19, step-g1: phase 20, "
                         "step-g2a: phase 21, step-g2b: phase 22, "
                         "step-g2c: phase 23, step-h: phase 24), without "
                         "the result line")
    args = ap.parse_args()
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
    if args.only == "step-e":
        with Phase("step E on caustics"):
            log(json.dumps({"step_e": phase_step_e(dev)}))
    if args.only == "step-f":
        with Phase("step F on envmap"):
            log(json.dumps({"step_f": phase_step_f(dev, recs)}))
    if args.only == "step-7a":
        with Phase("step 7a: specular and glossy shifts"):
            log(json.dumps({"step_7a": phase_step_7a(dev, recs)}))
    if args.only == "step-g1":
        with Phase("step G1: door, glossy G-BDPT, the materials board"):
            log(json.dumps({"step_g1": phase_step_g1(dev, recs)}))
    if args.only == "step-g2a":
        with Phase("step G2a: the cloth board"):
            log(json.dumps({"step_g2a": phase_step_g2a(dev, recs)}))
    if args.only == "step-g2b":
        with Phase("step G2b: every emitter and sensor"):
            log(json.dumps({"step_g2b": phase_step_g2b(dev, recs)}))
    if args.only == "step-g2c":
        with Phase("steps G2b-2 and G2c: own-loop textures, subsurface"):
            log(json.dumps({"step_g2c": phase_step_g2c(dev, recs)}))
    if args.only == "step-h":
        with Phase("steps H1 and H2: the CLI and parallel/"):
            log(json.dumps({"step_h": phase_step_h(dev, recs)}))
    if args.only:
        log(f"total {time.time() - t_start:.3f} s")
        log(card_line())
        return
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
        step_b, step_b_images = phase_step_b(dev)
    with Phase("step D families"):
        step_d = phase_step_d(dev, recs, step_b_images["path"])
    with Phase("step E on caustics"):
        step_e = phase_step_e(dev)
    with Phase("step F on envmap"):
        step_f = phase_step_f(dev, recs)
    with Phase("step 7a: specular and glossy shifts"):
        step_7a = phase_step_7a(dev, recs)
    with Phase("step G1: door, glossy G-BDPT, the materials board"):
        step_g1 = phase_step_g1(dev, recs)
    with Phase("step G2a: the cloth board"):
        step_g2a = phase_step_g2a(dev, recs)
    with Phase("step G2b: every emitter and sensor"):
        step_g2b = phase_step_g2b(dev, recs)
    with Phase("steps G2b-2 and G2c: own-loop textures, subsurface"):
        step_g2c = phase_step_g2c(dev, recs)
    with Phase("steps H1 and H2: the CLI and parallel/"):
        step_h = phase_step_h(dev, recs)
    log(json.dumps({"slice": summary, "forest": forest_summary,
                    "forest_v4": v4_summary, "bidir": bidir_summary,
                    "gbdpt_gradients": grad_summary, "step_b": step_b,
                    "step_d": step_d, "step_e": step_e, "step_f": step_f,
                    "step_7a": step_7a, "step_g1": step_g1,
                    "step_g2a": step_g2a, "step_g2b": step_g2b,
                    "step_g2c": step_g2c, "step_h": step_h}))
    log(f"total {time.time() - t_start:.3f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
