"""Worker process of tests/test_torch_frame_loop.py.  Imports the port and
torch only, never jax.

Usage: python torch_frame_worker.py <host:port> <nprocs> <rank> <outdir>
           <jobs>

Joins a gloo process group through parallel/multihost.init (device
"cpu"), runs the comma-separated jobs and writes every result to
<outdir>/rank<rank>.npz:
  cache  a cold geometry cache entry (cbox, the cache's size floor
         lowered to 1 triangle) under <outdir>/cache: keys cache_builds
         (this rank's geometry and shading-table builds), cache_hit
         (1 where both came from the disk) and cache_v0 (the geometry);
  frame  render_final_sharded of cbox at SIZE^2, maxDepth 2, 2 spp, seed
         2, with the L1 and with the L2 solve: on rank 0 the final images
         and the L1 frame's buffers (frame_final, frame_final_l2,
         frame_<buffer>); on every rank the collective calls the L1
         frame made (frame_collectives);
  loop   a FrameLoop on the same tracer: ray counting and the followers'
         trace on, frames of seeds 5 and 6, seed 5 again, the trace
         collected on rank 0, stop (rank 0: loop_5, loop_6, loop_5again,
         loop_rays, loop_spans [rank, frame] of the shard_render spans
         collected; the others: loop_followed = 1 once follow returned);
  die    a FrameLoop whose leader exits at once (exit code 3); a follower
         writes die_released_s, the seconds follow() took to raise, and
         exits 0.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
SIZE = 16
DIE_TIMEOUT_S = 20.0


def load(size=SIZE):
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    scene, st = sc.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": "2",
        "maxDepth": "2", "integrator": "gpt"})
    return bridge.to_torch(scene, "cpu"), st


def cold_cache(outdir):
    from gradientdomain_mitsuba_tpu_torch.scene import prep_cache
    builds = []
    build = prep_cache.build_geometry
    floor = prep_cache.CACHE_MIN_TRIS

    def counted(*a, **k):
        builds.append(1)
        return build(*a, **k)

    os.environ["GDMT_GEOM_CACHE"] = os.path.join(outdir, "cache")
    prep_cache.build_geometry, prep_cache.CACHE_MIN_TRIS = counted, 1
    try:
        scene, st = load()
    finally:
        prep_cache.build_geometry, prep_cache.CACHE_MIN_TRIS = build, floor
        del os.environ["GDMT_GEOM_CACHE"]
    t = st.prep_times
    return dict(cache_builds=len(builds) + (t["shade_cache"] == "miss"),
                cache_hit=int(t["cache"] == "hit" and
                              t["shade_cache"] == "hit"),
                cache_v0=scene.geom.tris.v0.numpy())


def main():
    addr, nprocs, rank, outdir, jobs = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5].split(","))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.parallel import multihost, tiles
    from gradientdomain_mitsuba_tpu_torch.utils import stats
    timeout = DIE_TIMEOUT_S if "die" in jobs else multihost.TIMEOUT_S
    multihost.init(addr, nprocs, rank, device="cpu", timeout_s=timeout)
    mesh = multihost.global_mesh()
    out = {}
    if "die" in jobs:
        scene, st = load()
        loop = multihost.FrameLoop(GPTracer(scene, st), scene,
                                   timeout_s=timeout)
        if loop.leader:
            os._exit(3)
        t0 = time.time()
        try:
            loop.follow()
        except Exception:  # noqa: BLE001 — the leader's loss, as raised
            out["die_released_s"] = time.time() - t0
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
        os._exit(0)
    try:
        if "cache" in jobs:
            out.update(cold_cache(outdir))
        if "frame" in jobs or "loop" in jobs:
            scene, st = load()
            tracer = GPTracer(scene, st)
        if "frame" in jobs:
            stats.tracing(True)
            got = tiles.render_final_sharded(tracer, scene, mesh, 2, 2)
            out["frame_collectives"] = stats.collect()["counters"][
                "collectives"]
            stats.tracing(False)
            stats.reset()
            l2 = tiles.render_final_sharded(tracer, scene, mesh, 2, 2,
                                            mode="L2")
            if got is not None:
                out["frame_final"] = got[0].numpy()
                out["frame_final_l2"] = l2[0].numpy()
                for k, v in got[1].items():
                    out[f"frame_{k}"] = v.numpy()
        if "loop" in jobs:
            loop = multihost.FrameLoop(tracer, scene)
            if loop.leader:
                stats.tracing(True)
                loop.count_rays(True, tracing=True)
                frames = {}
                for name, seed in (("5", 5), ("6", 6), ("5again", 5)):
                    final, bufs = loop.render_final(seed, 2)
                    frames[name] = final.numpy()
                    out["loop_rays"] = int(bufs["rays"])
                loop.count_rays(False)
                spans = [s for s in stats.collect()["spans"]
                         if s["name"] == "shard_render"]
                stats.tracing(False)
                loop.stop()
                out.update({f"loop_{k}": v for k, v in frames.items()})
                out["loop_spans"] = np.array(
                    [[s["attrs"]["rank"], s["frame"]] for s in spans])
            else:
                loop.follow()
                out["loop_followed"] = 1
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
