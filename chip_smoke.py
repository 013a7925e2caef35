"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device and build: requires CUDA, prints the card's name and power
     limit (nvidia-smi) and builds the sweep kernels from csrc/sweep.cu;
  2. kernel vs plain: both sweep kernels against their plain PyTorch
     versions on random soups (T = 3, 36, 130, 2048) and on the cbox soup
     with its own camera and shadow rays (dead lanes, N not a multiple of
     the block size), then both timed at 1,048,576 cbox rays (CUDA events);
  3. the slice: cbox 256x256, 64 spp, maxDepth 6, G-PT render + L1
     reconstruction through the package's entry points, timed after a
     warm-up, with the kernels' launch counters reset just before it;
  4. kernel render vs plain render at 64x64, 4 spp, same seed.
Prints one JSON line describing the kernels, then as the last line
{"ok": true, "device": {...}}.  Imports no jax.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(ROOT, "data", "scenes", "cbox", "cbox.xml")
N_TIMED = 1 << 20
# agreement required of kernel vs plain (ISSUE: sweep tolerances)
PRIM_FRAC, T_RTOL, OCC_FRAC = 0.998, 1e-5, 0.999
# render agreement (tests/test_torch_gpt.py): rtol/atol on >= 99% of pixels
IMG_RTOL, IMG_ATOL, IMG_FRAC = 1e-3, 1e-4, 0.99


def log(msg):
    print(msg, flush=True)


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
    events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernels(dev, kernels_rec):
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
        log(f"random soup T={T}: prim agree {pf:.6f}, max |dt| {ma:.3e} "
            f"(rel {mr:.3e}), occluded agree {of:.6f}")
        check(pf >= PRIM_FRAC and mr <= T_RTOL and of >= OCC_FRAC,
              f"kernel vs plain disagree on random soup T={T}")

    scene_np, st = sc.load_scene(CBOX, {"width": "256", "height": "256"})
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
    for i, kern, plain in timings:
        kernels_rec[i]["ms"] = cuda_ms(kern)
        kernels_rec[i]["plain_ms"] = cuda_ms(plain, iters=5)
        log(f"{kernels_rec[i]['name']} at {N_TIMED} rays: kernel "
            f"{kernels_rec[i]['ms']:.4f} ms, plain {kernels_rec[i]['plain_ms']:.4f} ms")


def render(scene, st, seed, spp, mode="L1", plain=False):
    """One render_final through the package's entry points.  plain=True
    swaps the tracer's intersectors for the plain versions (for the
    kernel-vs-plain comparison only)."""
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.ops import common
    from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
    tracer = GPTracer(scene, st)
    tracer.count_rays = True
    if plain:
        tracer.closest, tracer.occluded = common.instrument_intersectors(
            tracer,
            lambda o, d, mn, mx, g: isec.intersect_matmul(o, d, mn, mx,
                                                          g.linC),
            lambda o, d, mn, mx, g: isec.occluded_matmul(o, d, mn, mx,
                                                         g.linC))
    final, bufs = tracer.render_final(scene, seed, spp, alpha=0.2,
                                      mode=mode)
    return tracer, final, bufs


def phase_slice(dev, kernels_rec):
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
    return dict(wall_s=wall, rays=rays, mrays_per_s=rays / wall / 1e6,
                final_mean=mean_abs)


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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA card")
    from gradientdomain_mitsuba_tpu_torch import config
    from gradientdomain_mitsuba_tpu_torch.ops import sweep
    dev = config.get_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(card_line())
    t0 = time.time()
    sweep.load_library()
    log(f"kernel build+load {time.time() - t0:.3f} s")

    src = "gradientdomain_mitsuba_tpu_torch/csrc/sweep.cu"
    kernels_rec = [
        dict(name="sweep_closest", route="cuda", source=src,
             replaces="gradientdomain_mitsuba_tpu/ops/pallas_sweep.py:91",
             launches=0, max_abs_err=None, ms=None, plain_ms=None),
        dict(name="sweep_occluded", route="cuda", source=src,
             replaces="gradientdomain_mitsuba_tpu/ops/pallas_sweep.py:131",
             launches=0, max_abs_err=None, ms=None, plain_ms=None),
    ]
    phase_kernels(dev, kernels_rec)
    summary = phase_slice(dev, kernels_rec)
    phase_render_vs_plain(dev)
    log(json.dumps({"slice": summary}))
    log(card_line())
    log(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
