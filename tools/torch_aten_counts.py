"""Top-level aten calls of one pass of each render family of the port on
the CPU: the host-dispatch count that bounds a host-paced render on the
card (each call costs the host a few microseconds whatever its size).

    python tools/torch_aten_counts.py [--scene data/scenes/caustics/caustics.xml]
        [--size 16] [--spp 16] [--depth 8] [--families path,bdpt,...]
        [--vars samples=2048,irrSamples=16] [--props photonCount=65536,...]

One pass is one sample a pixel (path, bdpt: one trace_pass; sppm: one
camera pass + photon wavefront + gather) or one mutation of every chain
(pssmlt, erpt, mlt: one _mstep), after one unprofiled pass of the same
kind.  A tracer with a per-render cache (irrcache, the dipole tracer
of a subsurface scene) builds it first, and its build is counted on a
line of its own.  --vars gives the loader more variables, --props the
integrator properties (numbers).  The sampler is the scene's at --spp
(ldsampler for caustics).
Counts are of torch.profiler's CPU events without a parent whose name
starts with aten::; rays are the pass's lanes with maxt > 0 over its
intersector calls (the device tally), a lane being a pixel sample or a
chain (photons included in sppm's); intersector calls are the pass's
closest-hit and any-hit queries (on the card: the sweep or traversal
kernels' launches).  gpt and gbdpt take one trace_pass too.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = ("path", "bdpt", "sppm", "pssmlt", "erpt", "mlt", "gpt", "gbdpt")


def one_pass(tracer, scene, st):
    """A callable running one pass of `tracer` (see the module doc)."""
    if hasattr(tracer, "_mstep"):
        b, state = tracer._bootstrap(scene, 0)
        fb = torch.zeros((st.height, st.width, 3))
        return lambda: tracer._mstep(scene, 0, 1, state, b, fb)
    if hasattr(tracer, "_vpl_table"):
        table = tracer._vpl_table(scene, 0)
        return lambda: tracer._one_pass(scene, 0, 0, table)
    if hasattr(tracer, "_one_pass"):
        r = torch.tensor(tracer.r0, dtype=torch.float32)
        return lambda: tracer._one_pass(scene, 0, 0, r)
    if getattr(tracer, "_build_cache", None) and tracer._cache is None:
        tracer._cache = tracer._build_cache(scene, 0)
    return lambda: tracer.trace_pass(scene, 0, 0)


def count(tracer, fn):
    """(top-level aten calls of fn(), rays it traced: lanes with maxt > 0
    over its intersector calls, counted by the tracer's device tally,
    [closest-hit calls, any-hit calls])."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    calls = sum(1 for e in prof.events()
                if e.cpu_parent is None and e.name.startswith("aten::"))
    walker = getattr(tracer, "inner", tracer)
    queries = [0, 0]

    def counted(i, f):
        def call(*a):
            queries[i] += 1
            return f(*a)
        return call

    closest, occluded = walker.closest, walker.occluded
    walker.closest, walker.occluded = counted(0, closest), counted(1, occluded)
    walker.ray_tally = torch.zeros((), dtype=torch.int64)
    try:
        fn()
        rays = int(walker.ray_tally)
    finally:
        walker.ray_tally = None
        walker.closest, walker.occluded = closest, occluded
    return calls, rays, queries


def main():
    from gradientdomain_mitsuba_tpu_torch.models import factory
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=os.path.join(
        ROOT, "data/scenes/caustics/caustics.xml"))
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--vars", default="")
    ap.add_argument("--props", default="")
    args = ap.parse_args()

    def pairs(text):
        return dict(kv.split("=") for kv in text.split(",") if kv)
    torch.set_num_threads(1)
    for fam in args.families.split(","):
        scene_np, st = sc.load_scene(args.scene, {
            "width": str(args.size), "height": str(args.size),
            "spp": str(args.spp), "maxDepth": str(args.depth),
            **pairs(args.vars)})
        st.integrator = fam
        if fam in ("pssmlt", "erpt", "mlt"):
            st.integrator_props.update(chains=64, luminanceSamples=64)
        st.integrator_props.update(
            {k: float(v) for k, v in pairs(args.props).items()})
        scene = bridge.to_torch(scene_np, "cpu")
        tracer = factory.make_integrator(scene, st)
        if getattr(tracer, "_build_cache", None):
            calls, rays, queries = count(
                tracer, lambda: tracer._build_cache(scene, 0))
            print(f"{fam:7s} {calls:8d} top-level aten calls to build its "
                  f"cache, {rays} rays, intersector calls {queries[0]} "
                  f"closest / {queries[1]} any hit", flush=True)
        lanes = (tracer.n_chains if hasattr(tracer, "n_chains")
                 else args.size * args.size)
        calls, rays, queries = count(tracer, one_pass(tracer, scene, st))
        print(f"{fam:7s} {calls:8d} top-level aten calls a pass, "
              f"{rays / lanes:.3f} rays a lane, intersector calls "
              f"{queries[0]} closest / {queries[1]} any hit ({lanes} lanes; "
              f"{args.size}x{args.size}, sampler {st.sampler} at "
              f"{args.spp} spp, maxDepth {args.depth})", flush=True)


if __name__ == "__main__":
    main()
