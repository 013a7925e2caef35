"""The port's utilities against the reference's on the CPU: `tpuutil-torch`
(utils/mtsutil.py) mirrors tests/test_mtsutil.py's cases plus tonemap,
and each subcommand's output file is byte for byte the reference
`tpuutil`'s on the same inputs; RenderStats (utils/stats.py) gives the
reference's ray formulas and table; exr.write writes the reference
writer's bytes."""
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.utils import exr as ref_exr
from gradientdomain_mitsuba_tpu.utils import mtsutil as ref_mtsutil
from gradientdomain_mitsuba_tpu.utils.stats import RenderStats as RefStats
from gradientdomain_mitsuba_tpu_torch.utils import exr
from gradientdomain_mitsuba_tpu_torch.utils.mtsutil import main
from gradientdomain_mitsuba_tpu_torch.utils.stats import RenderStats


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _both(tmp_path, argv_of):
    """Run `argv_of(out)` through both mains; returns (port rc, reference
    rc, port output path, reference output path)."""
    a, b = argv_of(str(tmp_path / "port")), argv_of(str(tmp_path / "ref"))
    return main(a), ref_mtsutil.main(b), a[-1], b[-1]


def test_addimages(tmp_path):
    a = np.random.default_rng(0).random((8, 6, 3)).astype(np.float32)
    b = np.random.default_rng(1).random((8, 6, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    exr.write(pa, a)
    exr.write(pb, b)
    rc, ref_rc, po, ref_po = _both(tmp_path, lambda o: [
        "addimages", "-m", "0.25", "-M", "0.75", pa, pb, o + ".exr"])
    assert rc == ref_rc == 0
    np.testing.assert_allclose(exr.read_rgb(po), 0.25 * a + 0.75 * b,
                               atol=1e-3)
    assert _bytes(po) == _bytes(ref_po)


def test_joinrgb(tmp_path):
    imgs = [np.random.default_rng(i).random((5, 4, 3)).astype(np.float32)
            for i in range(3)]
    paths = [str(tmp_path / f"{c}.exr") for c in "rgb"]
    for p, im in zip(paths, imgs):
        exr.write(p, im)
    rc, ref_rc, po, ref_po = _both(
        tmp_path, lambda o: ["joinrgb", *paths, o + ".exr"])
    assert rc == ref_rc == 0
    want = np.stack([imgs[0][..., 0], imgs[1][..., 1], imgs[2][..., 2]], -1)
    np.testing.assert_allclose(exr.read_rgb(po), want, atol=1e-3)
    assert _bytes(po) == _bytes(ref_po)


def test_diff_gate(tmp_path, capsys):
    a = np.full((4, 4, 3), 0.5, np.float32)
    pa = str(tmp_path / "a.exr")
    pb = str(tmp_path / "b.exr")
    exr.write(pa, a)
    exr.write(pb, a * 1.5)
    assert main(["diff", pa, pa]) == 0
    assert main(["diff", pa, pb, "--fail-above", "1e-6"]) == 1
    port_out = capsys.readouterr().out
    assert ref_mtsutil.main(["diff", pa, pa]) == 0
    assert ref_mtsutil.main(["diff", pa, pb, "--fail-above", "1e-6"]) == 1
    assert port_out == capsys.readouterr().out


@pytest.mark.parametrize("args,ext", [
    (["-m", "2.0"], ".exr"),
    (["-m", "0.5"], ".npy"),
    ([], ".png"),
    (["-g", "1.8", "-m", "1.5"], ".png"),
])
def test_tonemap(tmp_path, args, ext):
    """tonemap to EXR / .npy (the same bytes as the reference's), to PNG
    through the sRGB curve and through an explicit gamma (the same
    decoded pixels)."""
    img = np.random.default_rng(2).gamma(1.0, 0.4, (7, 9, 3)).astype(
        np.float32)
    src = str(tmp_path / "in.exr")
    exr.write(src, img)
    rc, ref_rc, po, ref_po = _both(
        tmp_path, lambda o: ["tonemap", *args, src, o + ext])
    assert rc == ref_rc == 0
    if ext == ".png":
        from PIL import Image
        got = np.asarray(Image.open(po))
        assert got.shape == (7, 9, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(ref_po)))
    else:
        assert _bytes(po) == _bytes(ref_po)


def test_render_stats_formulas():
    for w, h, spp, d in [(1, 1, 1, 1), (16, 16, 2, 3), (256, 256, 64, 6),
                         (320, 240, 16, 8), (7, 5, 3, 0), (64, 64, 4, -1),
                         (128, 96, 32, 12)]:
        for name in ("rays_path", "rays_gpt", "rays_bdpt"):
            assert getattr(RenderStats, name)(w, h, spp, d) == \
                getattr(RefStats, name)(w, h, spp, d), (name, w, h, spp, d)


def test_render_stats_table():
    tables = []
    for cls in (RenderStats, RefStats):
        rs = cls()
        rs.phases["scene load"] = 0.125
        rs.start("render")
        rs.stop("render")
        rs.phases["render"] = 2.5
        rs.add("rays traced (counted)", 1234567)
        rs.add("rays traced (counted)", 1)
        rs.set("Mrays/sec", 12.3456)
        rs.set("CG residual (final)", 1e-3)
        tables.append(rs.table())
    assert tables[0] == tables[1]
    assert "rays traced (counted)" in tables[0]
    assert "1,234,568" in tables[0]


@pytest.mark.parametrize("kw", [
    {}, {"half": False}, {"compression": exr.C_NONE},
    {"compression": exr.C_ZIPS, "half": False},
    {"channels": ("Y",), "half": False},
])
def test_exr_write_bytes(tmp_path, kw):
    rs = np.random.RandomState(0)
    shape = (37, 65, 1) if "channels" in kw else (37, 65, 3)
    img = rs.gamma(1.0, 1.0, shape).astype(np.float32)
    if "channels" in kw:
        img = img[..., 0]
    exr.write(str(tmp_path / "port.exr"), img, **kw)
    ref_exr.write(str(tmp_path / "ref.exr"), img, **kw)
    assert _bytes(tmp_path / "port.exr") == _bytes(tmp_path / "ref.exr")
    got, _ = exr.read(str(tmp_path / "port.exr"))
    ref, _ = ref_exr.read(str(tmp_path / "ref.exr"))
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
