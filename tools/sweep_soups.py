"""Random triangle soups and rays for checking the sweep kernels
(gradientdomain_mitsuba_tpu_torch/csrc/sweep.cu) against their plain
versions, shared by chip_smoke.py, tools/torch_pair_variants.py --kernel
sweep and the sweep tests, which load it from its path (tools/ is not a
package)."""
import numpy as np

from gradientdomain_mitsuba_tpu_torch.ops.intersect import build_linear_mt


def random_soup(T, n, seed, kind="random"):
    """A soup of T random triangles as a linC table, and n random rays
    (every 5th dead: maxt = -1), from a seed; numpy arrays (o, d, mint,
    maxt, linC) for the kernels' checks.  kind "windowed": the loader's
    cluster-major layout, windows of 128 columns holding 100 triangles
    each, so triangles sit past round_up(T, 64); "zero_area": every third
    triangle degenerate (e2 = 2 e1: all-zero det coefficients); "ties":
    the first half repeated in the second, so a ray that hits one of them
    meets an equal t at a higher column, and the lower must win."""
    rs = np.random.RandomState(seed)
    v0, e1, e2 = (np.float32(rs.normal(size=(T, 3))) for _ in range(3))
    if kind == "zero_area":
        e2[::3] = e1[::3] * np.float32(2.0)
    elif kind == "ties":
        h = (T + 1) // 2
        v0, e1, e2 = (np.concatenate([a[:h], a[:T - h]])
                      for a in (v0, e1, e2))
    elif kind not in ("random", "windowed"):
        raise ValueError(f"unknown soup kind {kind!r}")
    linC = build_linear_mt(v0, e1, e2)
    if kind == "windowed":
        per, window = 100, 128
        K = -(-T // per)
        out = np.zeros((10, 4 * K * window), np.float32)
        for g in range(4):
            for k in range(K):
                m = min(per, T - k * per)
                dst = g * K * window + k * window
                out[:, dst:dst + m] = linC[:, g * T + k * per:
                                           g * T + k * per + m]
        linC = out
    o = np.float32(rs.normal(size=(n, 3)) * 3)
    d = np.float32(rs.normal(size=(n, 3)))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 3e38, np.float32)
    maxt[::5] = -1.0
    return o, d, mint, maxt, linC
