"""The shading kernel (csrc/shade.cu, ops/shade.PathShade) on the card,
against its plain version (PathShade.plain, the eager bounce's ops on the
same card) and the eager tracer.  Imports no jax, so the card's machine
(which has none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_shade_cuda.py -m cuda -q

Without a card every case skips.  The scene is the benchmark's forest
(data/scenes/forest/forest.xml, 3,082,116 triangles) at 256 x 256, one
sample: 65,536 lanes through the pair kernels.

Agreement.  Every bounce, the kernel and the plain version take the same
inputs (the kernel's own lane state and the traversal kernels' answers
to its rays).  Flags (alive, the delta flag, which rays are live) must be
the same; every float output is compared lane by lane with the benchmark
route's tolerance (gdbench/routes/path.py mismatch_share: off by more than
1e-3 of the value plus 1e-3 of the mean magnitude), and the share of lanes
not bit-identical is reported.  The kernel writes every expression in the
eager ops' order of rounding (the note in csrc/shade.cu), so both shares
are expected to be 0."""
import os

import pytest
import torch

from gdbench.routes.path import mismatch_share
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.ops import shade as shade_ops
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(ROOT, "data/scenes/forest/forest.xml")
SIZE = 256
SEED = 1234567
# share of lanes (of pixels, for the frame) off by the route's tolerance:
# the kernel rounds as the eager ops do, so none should be; a frame may
# differ where a last-bit difference moves a ray across a triangle edge,
# and the benchmark's own limit on a frame is 0.004
LIMIT = 0.0


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the shading kernel runs only on "
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
            "maxDepth": "5"})
    finally:
        mp.undo()
    return bridge.to_torch(scene_np, cuda_device), st


def _camera(tracer, dev):
    N = SIZE * SIZE
    pix = torch.arange(N, dtype=torch.int64, device=dev)
    sidx = torch.zeros(N, dtype=torch.int64, device=dev)
    from gradientdomain_mitsuba_tpu_torch.core.rng import DimAllocator as DA
    from gradientdomain_mitsuba_tpu_torch.ops import sensor as sensor_ops
    jit = tracer._u2(SEED, pix, sidx, DA.PIXEL_JITTER)
    pos = torch.stack([(pix % SIZE).float(), (pix // SIZE).float()], -1)
    o, d = sensor_ops.sample_ray(tracer.sensor, SIZE, SIZE, pos + jit,
                                 tracer._u2(SEED, pix, sidx, DA.APERTURE))
    return (SEED, pix, sidx), o, d


def _shares(got, ref):
    """(share off by the route's tolerance, share not bit-identical) of
    lanes."""
    g, r = got.float(), ref.float()
    if g.dim() == 1:
        g, r = g[:, None], r[:, None]
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    return mismatch_share(g, r), float((~same.all(-1)).float().mean())


@pytest.mark.cuda
def test_bounces_match_plain(forest):
    scene, st = forest
    dev = scene.geom.linC.device
    tracer = PathTracer(scene, st)
    assert tracer.shade is not None
    shade = tracer.shade
    rng, o, d = _camera(tracer, dev)
    N = o.shape[0]
    zeros = torch.zeros(N, device=dev)
    hit = tracer.closest(o, d, zeros, torch.full((N,), 3e38, device=dev),
                         scene.geom)
    s = occl = None
    report = {}
    for b in range(tracer.n_bounces + 1):
        final = b == tracer.n_bounces
        ref = shade.plain(scene, hit, b, rng, st=s, occl=occl, ray=(o, d),
                          final=final)
        s = shade(scene, hit, b, rng, st=s, occl=occl, ray=(o, d),
                  final=final)
        torch.cuda.synchronize()
        fields = ("L",) if final else shade_ops.ShadeState._fields
        for k in fields:
            got, want = getattr(s, k), getattr(ref, k)
            if want.dtype == torch.bool or k == "maxt":
                assert torch.equal(got, want), (b, k)
                continue
            off, not_bits = _shares(got, want)
            report[(b, k)] = (off, not_bits)
            assert off <= LIMIT, (b, k, off, not_bits)
        if not final:
            occl = tracer.occluded(s.shadow_o, s.shadow_d, zeros,
                                   s.shadow_maxt, scene.geom)
            hit = tracer.closest(s.o, s.d, zeros, s.maxt, scene.geom)
    assert shade.launches == tracer.n_bounces + 1
    print("share of lanes (off by the route's tolerance, not bit-identical) "
          "a bounce and output:", report)
    assert max(nb for _, nb in report.values()) <= LIMIT


@pytest.mark.cuda
def test_frame_matches_eager(forest):
    """A 256 x 256 frame through the kernel and through the eager bounce;
    the kernel's launch count: one a bounce and one more."""
    scene, st = forest
    fused = PathTracer(scene, st)
    eager = PathTracer(scene, st)
    eager.shade = None
    fused.count_rays = eager.count_rays = True
    a = fused.render(scene, seed=SEED, spp=1)
    b = eager.render(scene, seed=SEED, spp=1)
    torch.cuda.synchronize()
    assert fused.shade.launches == fused.n_bounces + 1
    off, not_bits = _shares(a.reshape(-1, 3), b.reshape(-1, 3))
    print(f"frame: {off} of pixels off by the route's tolerance, "
          f"{not_bits} not bit-identical; rays {fused.last_ray_count} "
          f"against {eager.last_ray_count}")
    assert off <= LIMIT
    assert fused.last_ray_count == eager.last_ray_count


@pytest.mark.cuda
def test_launch_checks(forest):
    """What the launch refuses: a scene table off the lanes' device, a
    hit of the wrong shape, prims of the wrong type, shadow answers of
    the wrong type."""
    scene, st = forest
    dev = scene.geom.linC.device
    tracer = PathTracer(scene, st)
    rng, o, d = _camera(tracer, dev)
    o, d = o[:1000].contiguous(), d[:1000].contiguous()
    rng = (rng[0], rng[1][:1000], rng[2][:1000])
    N = o.shape[0]
    zeros = torch.zeros(N, device=dev)
    hit = tracer.closest(o, d, zeros, torch.full((N,), 3e38, device=dev),
                         scene.geom)
    shade = tracer.shade
    on_cpu = scene._replace(geom=scene.geom._replace(
        tri_shade=scene.geom.tri_shade.cpu()))
    with pytest.raises(ValueError, match="tri_shade is on cpu"):
        shade(on_cpu, hit, 0, rng, ray=(o, d))
    with pytest.raises(ValueError, match="hit.t has shape"):
        shade(scene, hit._replace(t=hit.t[:-1]), 0, rng, ray=(o, d))
    with pytest.raises(TypeError, match="hit.prim must be"):
        shade(scene, hit._replace(prim=hit.prim.long()), 0, rng, ray=(o, d))
    s = shade(scene, hit, 0, rng, ray=(o, d))
    with pytest.raises(TypeError, match="occl must be"):
        shade(scene, hit, 1, rng, st=s, occl=zeros)
    assert shade.launches == 1
