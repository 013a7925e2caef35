"""Worker process of the port's multi-process tests
(tests/test_torch_parallel.py).  Imports the port and torch only, never
jax.

Usage: python torch_parallel_worker.py <host:port> <nprocs> <rank>
           <outdir> <jobs> [sizes] [maxDepth]

Joins a gloo process group through parallel/multihost.init (device
"cpu"), runs the comma-separated jobs and writes every result to
<outdir>/rank<rank>.npz:
  renders  cbox at size^2 for each of the comma-separated sizes
           (default 16), maxDepth (default 2), 2 spp, seed 2 through
           render_path_multihost, render_gpt_multihost and
           tiles.render_tiles_gbdpt (keys <size>_path, <size>_gpt_<buf>,
           <size>_gbdpt_<buf>);
  final    with renders: the G-PT and G-BDPT buffers through
           reconstruct_sharded (L2, alpha 0.2, 20 CG iterations; keys
           <size>_gpt_final, <size>_gbdpt_final);
  poisson  solve_l2_sharded on test_dist_poisson_matches_local's inputs
           (H = 25, W = 16, alpha 0.25, 150 iterations; key poisson);
  dryrun   the MULTICHIP dry run: cbox 64^2, maxDepth 4, 1 spp, seed 0,
           G-PT and G-BDPT tiles each followed by reconstruct_sharded
           with 20 CG iterations (keys dry_final, dry_gfinal).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")


def poisson_inputs():
    """test_dist_poisson_matches_local's inputs (tests/test_parallel.py)."""
    import numpy as np
    rs = np.random.RandomState(0)
    H, W = 25, 16
    P = rs.gamma(2.0, 0.5, (H, W, 3)).astype(np.float32)
    gx = rs.normal(0, 0.2, (H, W, 3)).astype(np.float32)
    gy = rs.normal(0, 0.2, (H, W, 3)).astype(np.float32)
    return P, gx, gy


def load(size, depth, integrator, spp=2):
    from gradientdomain_mitsuba_tpu_torch.scene import bridge
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    scene, st = sc.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth), "integrator": integrator})
    st.integrator = integrator
    return bridge.to_torch(scene, "cpu"), st


def dry_run(mesh):
    """The MULTICHIP_r05.json pipeline (__graft_entry__.dryrun_multichip)
    on the port: (G-PT final, G-BDPT final)."""
    from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu_torch.parallel import dist_poisson, tiles
    scene, st = load(64, 4, "gpt")
    bufs = tiles.render_tiles_gpt(GPTracer(scene, st), scene, mesh, 0, 1)
    final = dist_poisson.reconstruct_sharded(mesh, bufs, alpha=0.2,
                                             iters=20)
    scene, st = load(64, 4, "gbdpt")
    gbufs = tiles.render_tiles_gbdpt(GBDPTracer(scene, st), scene, mesh, 0,
                                     1)
    gfinal = dist_poisson.reconstruct_sharded(mesh, gbufs, alpha=0.2,
                                              iters=20)
    return final, gfinal


def main():
    addr, nprocs, rank, outdir, jobs = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5].split(","))
    sizes = [int(x) for x in sys.argv[6].split(",")] if len(sys.argv) > 6 \
        else [16]
    depth = int(sys.argv[7]) if len(sys.argv) > 7 else 2
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from gradientdomain_mitsuba_tpu_torch.parallel import multihost, tiles
    multihost.init(addr, nprocs, rank, device="cpu")
    out = {}
    try:
        mesh = multihost.global_mesh()
        assert (mesh.size, mesh.rank) == (nprocs, rank), mesh
        for size in sizes if "renders" in jobs else ():
            from gradientdomain_mitsuba_tpu_torch.models.gbdpt import \
                GBDPTracer
            from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
            from gradientdomain_mitsuba_tpu_torch.models.path import \
                PathTracer
            scene, st = load(size, depth, "path")
            out[f"{size}_path"] = multihost.render_path_multihost(
                PathTracer(scene, st), scene, 2, 2)
            scene, st = load(size, depth, "gpt")
            bufs = {"gpt": multihost.render_gpt_multihost(
                GPTracer(scene, st), scene, 2, 2)}
            scene, st = load(size, depth, "gbdpt")
            bufs["gbdpt"] = tiles.render_tiles_gbdpt(
                GBDPTracer(scene, st), scene, mesh, 2, 2)
            for family, b in bufs.items():
                for k, v in b.items():
                    out[f"{size}_{family}_{k}"] = v
                if "final" in jobs:
                    from gradientdomain_mitsuba_tpu_torch.parallel import \
                        dist_poisson
                    out[f"{size}_{family}_final"] = \
                        dist_poisson.reconstruct_sharded(mesh, b, alpha=0.2,
                                                         iters=20)
        if "poisson" in jobs:
            from gradientdomain_mitsuba_tpu_torch.parallel import \
                dist_poisson
            P, gx, gy = poisson_inputs()
            out["poisson"] = dist_poisson.solve_l2_sharded(
                mesh, P, gx, gy, alpha=0.25, iters=150)
        if "dryrun" in jobs:
            out["dry_final"], out["dry_gfinal"] = dry_run(mesh)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
