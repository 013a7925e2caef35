"""tpurender-torch — batch rendering CLI of the PyTorch port.

Counterpart of gradientdomain_mitsuba_tpu/utils/cli.py (`tpurender`, the
analog of the `mitsuba` command-line front end, src/mitsuba/mitsuba.cpp):
loads Mitsuba XML scenes, renders each with the scene's integrator (or an
override) on one device, runs screened-Poisson reconstruction for the
gradient-domain integrators, and writes EXR outputs
(<out>-primal/-dx/-dy/-direct/-final.exr for gpt/gbdpt, <out>.exr others).

Flags are the reference's:
  -o <file>      output EXR path (single scene only)
  -D key=value   scene parameter ($key substitution)
  -s <spp>       override sample count
  -z <seed>      RNG seed (deterministic)
  -r <sec>       flush a partial image every <sec> seconds
  -L <level>     log level (trace/debug/info/warn/error)
  -q             quiet
plus --device (default cuda; "cpu" renders on the host).  Accepted for
command-line compatibility but inert (the device owns its parallelism;
there is no thread pool or block scheduler):
  -p <threads>, -b <blockSize>, -j <scenes>, -c/-S <nodes>.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from . import stats as trace


def _np(x):
    """A tensor or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def linear_to_srgb(c):
    """The sRGB transfer curve on float32 numpy values."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.0031308, np.float32(12.92) * c,
                    np.float32(1.055) * c ** np.float32(1.0 / 2.4) -
                    np.float32(0.055))


def write_image(exr_mod, path, img):
    """EXR by default; .png/.jpg get sRGB-tonemapped 8-bit output (the
    ldrfilm analog); .m/.npy get raw float dumps (the mfilm analog,
    src/films/mfilm.cpp — matlab text / numpy binary).  `img` is a numpy
    array or a tensor on any device."""
    img = _np(img)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".jpg", ".jpeg"):
        from PIL import Image
        ldr = np.clip(linear_to_srgb(np.clip(img, 0, 1)), 0, 1)
        Image.fromarray((ldr * 255 + 0.5).astype("uint8")).save(path)
    elif ext == ".npy":
        np.save(path, np.asarray(img, dtype=np.float32))
    elif ext == ".m":
        a = np.asarray(img, dtype=np.float32)
        with open(path, "w") as f:
            for c, name in enumerate("rgb"[:a.shape[-1]]):
                f.write(f"{name} = [\n")
                for row in a[..., c]:
                    f.write(" ".join(f"{v:.8g}" for v in row) + ";\n")
                f.write("];\n")
    else:
        exr_mod.write(path, img)


def relmse(img, ref, eps_scale=1e-2):
    """mean((I-R)^2 / (R^2 + eps)), eps = 1e-2 * mean(R)^2 per BASELINE.md."""
    img = np.asarray(_np(img), np.float64)
    ref = np.asarray(_np(ref), np.float64)
    eps = eps_scale * float(ref.mean()) ** 2 + 1e-12
    return float(np.mean((img - ref) ** 2 / (ref ** 2 + eps)))


def build_parser():
    p = argparse.ArgumentParser(
        prog="tpurender-torch",
        description="Gradient-domain renderer (PyTorch port)")
    p.add_argument("scenes", nargs="+", metavar="scene.xml",
                   help="Mitsuba XML scene file(s)")
    p.add_argument("-o", "--output", default=None, help="output EXR path")
    p.add_argument("-D", action="append", default=[], metavar="key=value",
                   help="scene parameter override (repeatable)")
    p.add_argument("-s", "--spp", type=int, default=None)
    p.add_argument("-z", "--seed", type=int, default=0)
    p.add_argument("--integrator", default=None,
                   help="override the scene's integrator type")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-r", "--refresh", type=float, default=0, metavar="SEC",
                   help="write the partial image every SEC seconds")
    p.add_argument("-L", "--log-level", default="info",
                   choices=("trace", "debug", "info", "warn", "error"),
                   help="log verbosity (warn/error imply -q)")
    p.add_argument("--stats-json", default=None,
                   help="write render statistics JSON to this path")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="write a resumable checkpoint after every chunk")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the statistics table after rendering")
    p.add_argument("--relmse", default=None, metavar="REF.exr",
                   help="compute relMSE of the final image against a "
                        "reference EXR (BASELINE.md protocol)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "into DIR (view in chrome://tracing or Perfetto)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    # Reference-CLI compatibility; the device owns its parallelism.
    p.add_argument("-p", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-b", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-j", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-c", default=None, help=argparse.SUPPRESS)
    p.add_argument("-S", default=None, help=argparse.SUPPRESS)
    return p


@contextlib.contextmanager
def _profile(directory, device):
    """torch.profiler over the block; its Chrome trace is written to
    DIR/trace.json when the block ends."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def _render_scene(args, scene_path, variables, log, device):
    """Render one scene file on `device`; returns its stats dict."""
    t_start = time.time()
    from ..scene import bridge
    from ..scene import scene as sc
    from . import exr

    scene_np, st = sc.load_scene(scene_path, variables)
    scene = bridge.to_torch(scene_np, device)
    if args.integrator:
        st.integrator = args.integrator
    if args.spp:
        st.spp = args.spp
    out = args.output or os.path.splitext(scene_path)[0] + ".exr"
    base, ext = os.path.splitext(out)

    log(f"[tpurender] {scene_path}: {st.width}x{st.height} @ {st.spp} spp, "
        f"integrator={st.integrator}, maxDepth={st.max_depth}")
    t_load = time.time()
    stats = {"scene": scene_path, "width": st.width, "height": st.height,
             "spp": st.spp, "integrator": st.integrator,
             "load_s": t_load - t_start}

    def make_flusher(tracer, is_gd):
        """-r SEC: periodic partial-image flush (mitsuba.cpp -r)."""
        if args.refresh <= 0:
            return None
        last = [time.time()]

        def flush(state, done):
            now = time.time()
            if now - last[0] < args.refresh:
                return
            last[0] = now
            part = tracer.finalize(state, done)
            img = (part["primal"] + part["very_direct"]) if is_gd else part
            write_image(exr, out, img)
            log(f"[tpurender] partial flush at {done}/{st.spp} spp -> {out}")
        return flush

    profile_cm = contextlib.nullcontext()
    if args.profile:
        profile_cm = _profile(args.profile, device)

    want_stats = bool(args.verbose or args.stats_json)
    if st.integrator in ("gpt", "gbdpt"):
        if st.integrator == "gpt":
            from ..models.gpt import GPTracer
            tracer = GPTracer(scene, st)
        else:
            from ..models.gbdpt import GBDPTracer
            tracer = GBDPTracer(scene, st)
        # measured device-side ray counter (set before the render)
        tracer.count_rays = want_stats
        p = st.integrator_props
        mode = "L2" if bool(p.get("reconstructL2", False)) and not bool(
            p.get("reconstructL1", True)) else "L1"
        alpha = float(p.get("reconstructAlpha", 0.2))
        if (st.integrator == "gpt" and not args.checkpoint
                and not args.refresh and not want_stats):
            # fused render + reconstruction with no host round trip in
            # between; checkpoint/flush/observability runs take the
            # chunked path below
            with profile_cm:
                final_d, bufs_d = tracer.render_final(
                    scene, args.seed, st.spp, alpha=alpha, mode=mode)
                final = _np(final_d)
            bufs = {k: _np(v) for k, v in bufs_d.items()}
            bufs.pop("rays", None)
            t_render = t_rec = time.time()
        else:
            from ..models import poisson
            with profile_cm:
                bufs_d = tracer.render(scene, seed=args.seed, spp=st.spp,
                                       checkpoint_path=args.checkpoint,
                                       resume=args.resume,
                                       progress=make_flusher(tracer, True))
                bufs = {k: _np(v) for k, v in bufs_d.items()}
                t_render = time.time()
                rec = poisson.reconstruct(bufs_d, alpha=alpha, mode=mode,
                                          return_stats=want_stats)
                if want_stats:
                    final_d, solver_stats = rec
                    final = _np(final_d)
                    res = solver_stats["cg_residuals"]
                    stats["cg_residual_final"] = float(res[-1])
                    stats["cg_residuals"] = [float(x) for x in res]
                else:
                    final = _np(rec)
            t_rec = time.time()
        aux_ext = ext if ext.lower() == ".exr" else ".exr"
        exr.write(base + "-primal" + aux_ext,
                  bufs["primal"] + bufs["very_direct"])
        exr.write(base + "-dx" + aux_ext, bufs["dx"])
        exr.write(base + "-dy" + aux_ext, bufs["dy"])
        exr.write(base + "-direct" + aux_ext, bufs["very_direct"])
        write_image(exr, base + "-final" + ext, final)
        write_image(exr, out, final)
        log(f"[tpurender] render {t_render - t_load:.2f}s, "
            f"reconstruct({mode}) {t_rec - t_render:.2f}s -> {out}")
        stats.update(render_s=t_render - t_load,
                     reconstruct_s=t_rec - t_render, mode=mode)
    else:
        from ..models.factory import KNOWN, make_integrator
        if st.integrator not in KNOWN:
            log(f"[tpurender] integrator '{st.integrator}' not available; "
                f"falling back to 'path'")
        tracer = make_integrator(scene, st)
        if hasattr(tracer, "count_rays"):
            tracer.count_rays = want_stats
        with profile_cm:
            img = tracer.render(scene, seed=args.seed, spp=st.spp,
                                checkpoint_path=args.checkpoint,
                                resume=args.resume,
                                progress=make_flusher(tracer, False))
            img = ({k: _np(v) for k, v in img.items()}
                   if isinstance(img, dict) else _np(img))
        t_render = time.time()
        if isinstance(img, dict):
            # multichannel: one image per named channel
            for name, ch in img.items():
                write_image(exr, base + "-" + name + ext, ch)
            final = next(iter(img.values()))
            write_image(exr, out, final)
            log(f"[tpurender] render {t_render - t_load:.2f}s -> "
                f"{len(img)} channels at {base}-<channel>{ext}")
        else:
            final = img
            write_image(exr, out, img)
            log(f"[tpurender] render {t_render - t_load:.2f}s -> {out}")
        stats.update(render_s=t_render - t_load)

    if args.relmse:
        ref = exr.read_rgb(args.relmse)
        err = relmse(final, ref)
        log(f"[tpurender] relMSE vs {args.relmse}: {err:.6g}")
        stats["relmse"] = err
    if args.verbose:
        from .stats import RenderStats
        rs = RenderStats()
        rs.phases["scene load"] = stats["load_s"]
        rs.phases["render"] = stats["render_s"]
        if "reconstruct_s" in stats:
            rs.phases["reconstruct"] = stats["reconstruct_s"]
        measured = getattr(tracer, "last_ray_count", None)
        if measured is not None:
            # the intersectors' int64 device tally of traced lanes with
            # positive extent (ops/common.instrument_intersectors)
            rays = measured
            rs.set("rays traced (counted)", rays)
        else:
            rays_fn = {"gpt": RenderStats.rays_gpt,
                       "gbdpt": RenderStats.rays_bdpt,
                       "bdpt": RenderStats.rays_bdpt}.get(
                st.integrator, RenderStats.rays_path)
            depth = st.max_depth if st.max_depth > 0 else 8
            rays = rays_fn(st.width, st.height, st.spp, depth)
            rs.set("rays traced (approx)", rays)
        rs.set("Mrays/sec", rays / max(stats["render_s"], 1e-9) / 1e6)
        if "cg_residual_final" in stats:
            rs.set("CG residual (final)", stats["cg_residual_final"])
        log(rs.table())
        stats["rays"] = rays
        stats["rays_measured"] = measured is not None
    if want_stats:
        # the program's trace of this scene: load, render, reconstruction
        got = trace.collect()
        counters = {"kernel_builds": 0, "host_syncs": 0, **got["counters"]}
        lanes = counters.get("lanes", 0)
        rays = getattr(tracer, "last_ray_count", None)
        stats["trace"] = dict(
            spans=trace.summarize(got), counters=counters,
            live_share=rays / lanes if rays is not None and lanes else None)
        if args.verbose:
            log(trace.table(dict(got, counters=counters)))
            if stats["trace"]["live_share"] is not None:
                log(f"    {'live share of traversal lanes':<52s} "
                    f"{stats['trace']['live_share']:12.4f}")
    return stats


def main(argv=None):
    args = build_parser().parse_args(argv)
    quiet = args.quiet or args.log_level in ("warn", "error")
    log = (lambda *a: None) if quiet else print

    variables = {}
    for d in args.D:
        if "=" not in d:
            print(f"error: bad -D argument '{d}'", file=sys.stderr)
            return 1
        k, v = d.split("=", 1)
        variables[k] = v

    if args.output and len(args.scenes) > 1:
        print("error: -o is only valid with a single scene",
              file=sys.stderr)
        return 1
    if args.checkpoint and len(args.scenes) > 1:
        print("error: --checkpoint is only valid with a single scene",
              file=sys.stderr)
        return 1

    from ..config import get_device
    device = get_device(args.device)

    all_stats = []
    for scene_path in args.scenes:
        # -v, --stats-json and --profile trace the program (spans, host
        # syncs, lanes); --profile also names its layers in the profile
        trace.reset()
        trace.tracing(bool(args.verbose or args.stats_json or args.profile),
                      annotate=bool(args.profile))
        try:
            all_stats.append(_render_scene(args, scene_path, variables,
                                           log, device))
        finally:
            trace.tracing(False)
            trace.reset()

    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(all_stats[0] if len(all_stats) == 1 else all_stats, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
