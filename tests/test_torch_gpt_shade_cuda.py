"""The G-PT shading kernels (csrc/gpt_shade.cu, ops/gpt_shade.GPTShade) on
the card, against their plain version (GPTShade.plain_*, the eager
bounce's ops on the same card) and the eager tracer.  Imports no jax, so
the card's machine (which has none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_gpt_shade_cuda.py -m cuda -q

Without a card every case skips.  The scene is the benchmark's forest
(data/scenes/forest/forest.xml, 3,082,116 triangles) at 256 x 256, one
sample: 65,536 lanes x 5 paths through the pair kernels.

Agreement.  Every stage, the kernel and the plain version take the same
inputs (the kernel's own lane state and the traversal kernels' answers
to its rays).  Each output is compared lane by lane with the benchmark
route's tolerance (gdbench/routes/path.py mismatch_share: off by more
than 1e-3 of the value plus 1e-3 of the mean magnitude; a flag or an
int is off where it differs), and the share of lanes not bit-identical
is reported.  The kernel writes every expression in the eager ops' order
of rounding (the note in csrc/shade.cu), so both shares are expected to
be 0."""
import os

import pytest
import torch

from gdbench.routes.path import mismatch_share
from gradientdomain_mitsuba_tpu_torch.core.rng import DimAllocator as DA
from gradientdomain_mitsuba_tpu_torch.models.gpt import OFFSETS, GPTracer
from gradientdomain_mitsuba_tpu_torch.ops import gpt_shade as gs
from gradientdomain_mitsuba_tpu_torch.ops import sensor as sensor_ops
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(ROOT, "data/scenes/forest/forest.xml")
SIZE = 256
SEED = 1234567
# share of lanes (of pixel buffers, for the frame) off by the route's
# tolerance: the kernels round as the eager ops do, so none should be; a
# frame may differ where a last-bit difference moves a ray across a
# triangle edge, and the benchmark's own limit on a G-PT frame is 0.006
LIMIT = 0.0

# the state fields each stage writes (the bounce stage: _written)
_WRITES = {
    gs.START: ("very", "shadow", "ray"),
    gs.CONNECT: ("primal", "grad", "recon_o", "recon_d", "recon_maxt"),
    gs.SHIFT: ("grad", "tp", "alive", "o_tp", "o_r", "o_conn", "o_alive",
               "o_wi", "shadow", "ray"),
}


def _written(stage, b, n):
    if stage != gs.BOUNCE:
        out = list(_WRITES[stage])
        if stage == gs.SHIFT and n <= 1:
            out = [k for k in out if k not in ("shadow", "ray")]
        return out
    out = ["tp", "alive", "rest" if b > 1 or n > 2 else None]
    if b == 1:
        out += ["primal", "grad", "o_tp", "o_r", "o_conn", "o_alive", "o_wi"]
        if n > 2:
            out.append("coeff")
    elif b == n - 1:
        out += ["primal", "grad"]
    if b + 1 < n:
        out += ["shadow", "ray"]
    return [k for k in out if k is not None]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the shading kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def forest(cuda_device, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # the geometry disk cache in the test's own directory, not the tree's
    mp.setenv("GDMT_GEOM_CACHE", str(tmp_path_factory.mktemp("geom")))
    try:
        scene_np, st = port_scene.load_scene(FOREST, {
            "width": str(SIZE), "height": str(SIZE), "spp": "1",
            "maxDepth": "5", "integrator": "gpt"})
    finally:
        mp.undo()
    return bridge.to_torch(scene_np, cuda_device), st


def _camera(tracer, scene, pix, sidx):
    """A pass's camera rays and hits, as GPTracer.trace_pass makes them."""
    W, H = tracer.settings.width, tracer.settings.height
    dev = pix.device
    N = pix.shape[0]
    jit = tracer._u2(SEED, pix, sidx, DA.PIXEL_JITTER)
    pos = torch.stack([(pix % W).float(), (pix // W).float()], -1) + jit
    u_ap = tracer._u2(SEED, pix, sidx, DA.APERTURE)
    o, d = sensor_ops.sample_ray(tracer.sensor, W, H, pos, u_ap)
    offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev)
    o4, d4 = sensor_ops.sample_ray(
        tracer.sensor, W, H, (pos[None] + offs[:, None, :]).reshape(4 * N, 2),
        u_ap.repeat(4, 1))
    z = torch.zeros(N, device=dev)
    hit = tracer.closest(o, d, z, torch.full((N,), 3e38, device=dev),
                         scene.geom)
    hit4 = tracer.closest(o4, d4, torch.zeros(4 * N, device=dev),
                          torch.full((4 * N,), 3e38, device=dev), scene.geom)
    return gs.Camera(o, d, hit, o4, d4, hit4)


def _shares(got, ref):
    """(share off by the route's tolerance, share not bit-identical) of
    lanes; flags and ints are off where they differ."""
    if got.dtype in (torch.bool, torch.int32):
        off = float((got != ref).float().mean())
        return off, off
    g, r = got.float(), ref.float()
    if g.shape[-1] != 3 or g.dim() == 1:
        g, r = g[..., None], r[..., None]
    g, r = g.reshape(-1, 3 if g.shape[-1] == 3 else 1), r.reshape(
        -1, 3 if r.shape[-1] == 3 else 1)
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    return mismatch_share(g, r), float((~same.all(-1)).float().mean())


def _fields(st, k, N):
    if k == "shadow":
        return dict(zip(("shadow_o", "shadow_d", "shadow_maxt"),
                        st.shadow(N)))
    if k == "ray":
        return dict(ray_o=st.ray_o, ray_d=st.ray_d, ray_maxt=st.ray_maxt)
    return {k: getattr(st, k)}


def _clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def _stages(scene, tracer, pix, sidx):
    """Each stage of one pass through the kernel and through the plain
    version on the same inputs: {(stage, bounce, field): shares}."""
    shade = tracer.shade
    dev = pix.device
    N = pix.shape[0]
    rng = (SEED, pix, sidx)
    geom = scene.geom
    z, z4 = torch.zeros(N, device=dev), torch.zeros(4 * N, device=dev)
    cam = _camera(tracer, scene, pix, sidx)
    report = {}

    def check(stage, b, got, want):
        torch.cuda.synchronize()
        for k in _written(stage, b, shade.n_bounces):
            for name, x in _fields(got, k, N).items():
                report[(stage, b, name)] = _shares(
                    x, _fields(want, k, N)[name])

    want = shade.plain_start(scene, cam, rng)
    s = shade.start(scene, cam, rng)
    check(gs.START, 0, s, want)
    occ = tracer.occluded(s.shadow_o, s.shadow_d,
                          torch.zeros(5 * N, device=dev), s.shadow_maxt, geom)
    hit = tracer.closest(s.ray_o, s.ray_d, z, s.ray_maxt, geom)
    want = shade.plain_connect(scene, cam, rng, _clone(s), occ, hit)
    s = shade.connect(scene, cam, rng, s, occ, hit)
    check(gs.CONNECT, 0, s, want)
    occ = tracer.occluded(s.recon_o, s.recon_d, z4, s.recon_maxt, geom)
    want = shade.plain_shift(scene, cam, rng, _clone(s), hit, occ)
    s = shade.shift(scene, cam, rng, s, hit, occ)
    check(gs.SHIFT, 0, s, want)
    for b in range(1, shade.n_bounces):
        sh_o, sh_d, sh_maxt = s.shadow(N)
        occ = tracer.occluded(sh_o, sh_d, z, sh_maxt, geom)
        hit_v = hit
        hit = tracer.closest(s.ray_o, s.ray_d, z, s.ray_maxt, geom)
        want = shade.plain_bounce(scene, b, rng, _clone(s), hit_v, occ, hit)
        s = shade.bounce(scene, b, rng, s, hit_v, occ, hit)
        check(gs.BOUNCE, b, s, want)
    assert shade.launches == shade.n_bounces + 2
    return report


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "rows"])
def test_stages_match_plain(forest, case):
    """Every stage's outputs against the plain version: the whole frame
    with a sample index a lane, and a tiles-style subset (every other
    row block of 16, one Python int sample index)."""
    scene, st = forest
    dev = scene.geom.linC.device
    tracer = GPTracer(scene, st)
    assert tracer.shade is not None
    N = SIZE * SIZE
    pix = torch.arange(N, dtype=torch.int64, device=dev)
    sidx = torch.zeros(N, dtype=torch.int64, device=dev)
    if case == "rows":
        pix = pix[(pix // SIZE // 16) % 2 == 0]
        sidx = 3
    report = _stages(scene, tracer, pix, sidx)
    print(f"{case}: share of lanes (off by the route's tolerance, not "
          f"bit-identical) a stage, bounce and output:",
          {k: v for k, v in report.items() if v != (0.0, 0.0)} or "all 0")
    for k, (off, _) in report.items():
        assert off <= LIMIT, (k, off)
    assert max(nb for _, nb in report.values()) <= LIMIT


@pytest.mark.cuda
def test_frame_matches_eager(forest):
    """A 256 x 256, 2-spp G-PT + L1 frame (render_final: the buffers
    primal, very_direct, dx, dy and the final image) through the kernels
    and through the eager bounce, the ray counts of both, and the
    kernels' launches: the bounces + 2 a pass."""
    scene, st = forest
    fused = GPTracer(scene, st)
    eager = GPTracer(scene, st)
    eager.shade = None
    fused.count_rays = eager.count_rays = True
    fa, a = fused.render_final(scene, SEED, 2)
    fb, b = eager.render_final(scene, SEED, 2)
    torch.cuda.synchronize()
    passes = 2 // fused.samples_per_batch(2)
    assert fused.shade.launches == passes * (fused.n_bounces + 2)
    report = {k: _shares(a[k].reshape(-1, 3), b[k].reshape(-1, 3))
              for k in ("primal", "very_direct", "dx", "dy")}
    report["final"] = _shares(fa.reshape(-1, 3), fb.reshape(-1, 3))
    print(f"frame: share of pixels (off by the route's tolerance, not "
          f"bit-identical) a buffer: {report}; rays {int(a['rays'])} "
          f"against {int(b['rays'])}")
    assert max(off for off, _ in report.values()) <= LIMIT
    assert int(a["rays"]) == int(b["rays"]) > 0


@pytest.mark.cuda
def test_launch_checks(forest):
    """What a launch refuses: a scene table off the lanes' device, a hit
    of the wrong shape, prims of the wrong type, shadow answers of the
    wrong type."""
    scene, st = forest
    dev = scene.geom.linC.device
    tracer = GPTracer(scene, st)
    shade = tracer.shade
    pix = torch.arange(1000, dtype=torch.int64, device=dev)
    cam = _camera(tracer, scene, pix, 0)
    rng = (SEED, pix, 0)
    on_cpu = scene._replace(geom=scene.geom._replace(
        tri_shade=scene.geom.tri_shade.cpu()))
    with pytest.raises(ValueError, match="tri_shade is on cpu"):
        shade.start(on_cpu, cam, rng)
    with pytest.raises(ValueError, match="cam.t has shape"):
        shade.start(scene, cam._replace(hit=cam.hit._replace(
            t=cam.hit.t[:-1])), rng)
    with pytest.raises(TypeError, match="off.prim must be"):
        shade.start(scene, cam._replace(hit_off=cam.hit_off._replace(
            prim=cam.hit_off.prim.long())), rng)
    s = shade.start(scene, cam, rng)
    hit = tracer.closest(s.ray_o, s.ray_d, torch.zeros(1000, device=dev),
                         s.ray_maxt, scene.geom)
    with pytest.raises(TypeError, match="occl must be"):
        shade.connect(scene, cam, rng, s, s.shadow_maxt, hit)
    assert shade.launches == 1
