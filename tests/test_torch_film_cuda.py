"""The film's deterministic scatter (ops/film.scatter_add: a stable sort by
flat pixel index and a segment sum, no atomics) on the card, where an
atomic scatter-add would change its bits from run to run.  Imports no
jax, so the card's machine (which has none) runs it without the repo's
conftest:

    python -m pytest --noconftest tests/test_torch_film_cuda.py -m cuda -q

Without a card every case skips."""
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.ops import film

H, W = 61, 83


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the scatter's determinism is a "
                    "property of the card's kernels)")
    return torch.device("cuda")


def _samples(kind, n, seed):
    """(pos [n,2], value [n,3]) as numpy: random positions over and
    around the film, every sample on one pixel, or a skewed mix."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        pos = rs.uniform(-0.2, 1.2, (n, 2)) * [W, H]
    elif kind == "one_pixel":
        pos = np.tile([[17.3, 40.9]], (n, 1))
    else:  # skewed: half the samples on 3 pixels, the rest anywhere
        pos = rs.uniform(0, 1, (n, 2)) * [W, H]
        pos[: n // 2] = rs.choice(3, n // 2)[:, None] * 7.0 + 0.5
    val = rs.lognormal(0.0, 2.0, (n, 3)) * rs.choice([-1.0, 1.0], (n, 3))
    return np.float32(pos), np.float32(val)


def _plain(fb, pos, val):
    """The plain version on the CPU: a sequential accumulate at the
    reference's clipped, truncated pixels, out-of-film samples times 0."""
    px = torch.clamp(pos[:, 0].to(torch.int32), 0, W - 1).long()
    py = torch.clamp(pos[:, 1].to(torch.int32), 0, H - 1).long()
    inside = ((pos[:, 0] >= 0) & (pos[:, 0] < W) & (pos[:, 1] >= 0) &
              (pos[:, 1] < H))
    out = fb.clone()
    out.index_put_((py, px), val * inside[:, None], accumulate=True)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "one_pixel", "skewed"])
@pytest.mark.parametrize("n", [1, 1000, 262_147])
def test_splat_unfiltered_is_deterministic_and_right(cuda_device, kind, n):
    pos, val = _samples(kind, n, seed=n)
    fb = torch.zeros((H, W, 3))
    p_d = torch.from_numpy(pos).to(cuda_device)
    v_d = torch.from_numpy(val).to(cuda_device)
    a = film.splat_unfiltered(fb.to(cuda_device), p_d, v_d)
    b = film.splat_unfiltered(fb.to(cuda_device), p_d, v_d)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = _plain(fb.double(), torch.from_numpy(pos),
                 torch.from_numpy(val).double())
    # f32 summation tolerance: the per-pixel sum's rounding grows with
    # the sum of magnitudes landing on the pixel
    mag = _plain(fb.double(), torch.from_numpy(pos),
                 torch.from_numpy(np.abs(val)).double())
    err = (a.cpu().double() - ref).abs()
    assert bool((err <= 1e-6 * mag + 1e-6).all()), float(err.max())
    if kind == "random" and n > 1:
        inside = ((pos >= 0) & (pos < [W, H])).all(-1)
        assert 0 < inside.sum() < n     # some samples do leave the film


@pytest.mark.cuda
def test_splat_unfiltered_drops_out_of_film(cuda_device):
    pos = torch.tensor([[-0.5, 3.0], [W + 0.1, 3.0], [4.0, -1e-3],
                        [4.0, H], [W - 1e-3, H - 1e-3]], device=cuda_device)
    val = torch.ones((5, 3), device=cuda_device)
    out = film.splat_unfiltered(torch.zeros((H, W, 3), device=cuda_device),
                                pos, val)
    assert float(out.sum()) == 3.0
    assert float(out[H - 1, W - 1, 0]) == 1.0
