"""The port's command-line front end (utils/cli.py, `tpurender-torch`)
against the reference's (`tpurender`) on the CPU: cbox at 16^2, 2 spp,
maxDepth 3, seed 3, the same flags through both mains, the port on
--device cpu and the reference's intersectors pinned to the linear-MT
matmul sweeps (torch_parity.pinned_matmul).

Buffers (primal, dx, dy, direct and the non-gradient images) agree at
rtol 1e-3 / atol 1e-4 on >= 99% of pixels with means within 1e-4
relative; the L1 final by its objective and mean
(torch_parity.assert_l1_final_close).  Log lines, stats-JSON keys, the
counted rays and the error exits are the reference's.  Each reference
route runs once a module (`_route`)."""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.utils import cli as ref_cli
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.parallel import checkpoint
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import cli, exr

import torch_parity
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
BASE = ["-D", "integrator=gpt", "-D", "width=16", "-D", "height=16",
        "-D", "maxDepth=3", "-s", "2", "-z", "3"]
GD_OUTS = ("primal", "dx", "dy", "direct")
# the routes: (extra flags, output name, whether the reference's CLI
# runs it too).  G-BDPT runs at maxDepth 2: the reference's compile
# doubles at 3 (about 20 s against 10 cold), and test_torch_gbdpt.py
# holds the tracer at 3.
ROUTES = {
    "fused": ([], "x.exr", True),
    "chunked": (["-v", "--stats-json", "{d}/stats.json"], "x.exr", True),
    "gbdpt": (["--integrator", "gbdpt", "-D", "maxDepth=2", "-v",
               "--stats-json", "{d}/stats.json"], "x.exr", True),
    "path": (["--integrator", "path", "-v", "--stats-json",
              "{d}/stats.json"], "x.npy", True),
    "multichannel": ([], "x.exr", True),
    "matlab": (["--integrator", "path"], "x.m", False),
    "relmse": (["--integrator", "path", "--relmse", "{d}/half.exr",
                "--stats-json", "{d}/stats.json"], "x.exr", False),
    "unknown": (["--integrator", "nosuchintegrator"], "x.exr", False),
}
_RUNS = {}


def _multichannel_scene(directory):
    """cbox with a multichannel integrator (children path and ao)."""
    shutil.copytree(os.path.join(ROOT, "data/scenes/cbox/meshes"),
                    os.path.join(directory, "meshes"))
    with open(CBOX) as f:
        xml = f.read()
    start = xml.index('<integrator type="$integrator">')
    end = xml.index("</integrator>", start) + len("</integrator>")
    xml = xml[:start] + (
        '<integrator type="multichannel">'
        '<integrator type="path"><integer name="maxDepth" '
        'value="$maxDepth"/></integrator>'
        '<integrator type="ao"/></integrator>') + xml[end:]
    path = os.path.join(directory, "mc.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def _main(pkg, argv):
    """(rc, stdout) of one package's main; the reference pinned."""
    buf = io.StringIO()
    mp = pytest.MonkeyPatch()
    if pkg == "ref":
        mp.setattr(ref_common, "choose_intersector",
                   torch_parity.pinned_matmul)
    try:
        with contextlib.redirect_stdout(buf):
            rc = (ref_cli.main(argv) if pkg == "ref" else
                  cli.main(argv + ["--device", "cpu"]))
    finally:
        mp.undo()
    return rc, buf.getvalue()


def _route(name, tmp_path_factory):
    """Run route `name` through both CLIs once; returns
    {pkg: dict(dir, out, rc, log, stats)}."""
    if name in _RUNS:
        return _RUNS[name]
    res = {}
    extra, out, with_ref = ROUTES[name]
    for pkg in ("ref", "port") if with_ref else ("port",):
        d = str(tmp_path_factory.mktemp(f"{name}_{pkg}"))
        scene = _multichannel_scene(d) if name == "multichannel" else CBOX
        if name == "relmse":
            exr.write(os.path.join(d, "half.exr"),
                      np.full((16, 16, 3), 0.5, np.float32))
        argv = [scene, "-o", os.path.join(d, out)] + BASE + \
            [a.format(d=d) for a in extra]
        rc, log = _main(pkg, argv)
        stats = None
        if os.path.exists(os.path.join(d, "stats.json")):
            with open(os.path.join(d, "stats.json")) as f:
                stats = json.load(f)
        res[pkg] = dict(dir=d, out=os.path.join(d, out), rc=rc, log=log,
                        stats=stats)
    _RUNS[name] = res
    return res


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    yield lambda name: _route(name, tmp_path_factory)
    _RUNS.clear()


def _read(run, suffix=""):
    base = os.path.splitext(run["out"])[0]
    return exr.read_rgb(base + suffix + ".exr")


def _assert_close(got, ref, name):
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    assert torch_parity.frac_close(got, ref) >= 0.99, name
    assert (torch_parity.rel_mean_diff(got, ref) < 1e-4 or
            abs(got.mean() - ref.mean()) < 1e-7), name


def _check_gd_outputs(r):
    """primal, dx, dy, direct elementwise; the L1 final by objective and
    mean against the reference's buffers."""
    bufs = {}
    for k in GD_OUTS:
        _assert_close(_read(r["port"], "-" + k), _read(r["ref"], "-" + k), k)
        bufs[k] = _read(r["ref"], "-" + k)
    ref_bufs = dict(primal=bufs["primal"] - bufs["direct"], dx=bufs["dx"],
                    dy=bufs["dy"], very_direct=bufs["direct"],
                    L1=_read(r["ref"], "-final"))
    final = _read(r["port"], "-final")
    torch_parity.assert_l1_final_close(final, ref_bufs)
    np.testing.assert_array_equal(_read(r["port"]), final)


def _log_lines(log):
    """The log without its timings: the [tpurender] lines up to their
    first number of seconds, and the labels of the statistics table.
    The port's trace table, which the reference does not print, ends
    it."""
    out = []
    for line in log.split("\n  Trace")[0].splitlines():
        if line.startswith("[tpurender] render "):
            out.append("[tpurender] render")
        elif line.startswith("    "):
            out.append(line[:32].rstrip())
        else:
            out.append(line)
    return out


def _ref_keys(stats):
    """The stats-JSON keys but the port's own trace."""
    return sorted(k for k in stats if k != "trace")


def test_gpt_fused_route(route):
    r = route("fused")
    assert r["ref"]["rc"] == r["port"]["rc"] == 0
    _check_gd_outputs(r)
    for pkg in ("ref", "port"):
        r[pkg]["log"] = r[pkg]["log"].replace(r[pkg]["dir"], "D")
    assert _log_lines(r["port"]["log"]) == _log_lines(r["ref"]["log"])


def test_fused_final_is_render_final(route):
    """The fused route's -final.exr is GPTracer.render_final's image at
    the same seed, as the EXR writer stores it (half floats)."""
    r = route("fused")
    scene, st = port_scene.load_scene(CBOX, {
        "integrator": "gpt", "width": "16", "height": "16",
        "maxDepth": "3"})
    st.spp = 2
    ts = bridge.to_torch(scene, "cpu")
    final, _ = GPTracer(ts, st).render_final(ts, 3, 2)
    np.testing.assert_array_equal(
        _read(r["port"], "-final"),
        final.numpy().astype(np.float16).astype(np.float32))


def test_gpt_chunked_route(route):
    """-v --stats-json takes the chunked route (render, then
    poisson.reconstruct with its residuals): the same outputs as the
    reference's, its buffers equal to the fused route's, the same
    stats-JSON keys and the same counted rays."""
    r = route("chunked")
    assert r["ref"]["rc"] == r["port"]["rc"] == 0
    _check_gd_outputs(r)
    fused = route("fused")
    for k in GD_OUTS:
        np.testing.assert_allclose(_read(r["port"], "-" + k),
                                   _read(fused["port"], "-" + k),
                                   rtol=1e-5, err_msg=k)
    ps, rs = r["port"]["stats"], r["ref"]["stats"]
    assert _ref_keys(ps) == sorted(rs)
    assert ps["rays_measured"] is rs["rays_measured"] is True
    assert ps["rays"] == rs["rays"] > 0
    assert len(ps["cg_residuals"]) == len(rs["cg_residuals"]) == 8 * 40
    assert np.isfinite(ps["cg_residual_final"])
    for k in ("width", "height", "spp", "integrator", "mode"):
        assert ps[k] == rs[k], k


def test_verbose_table(route):
    """-v prints the reference's table: the same lines, counted rays
    equal."""
    r = route("chunked")
    for pkg in ("ref", "port"):
        r[pkg]["log"] = r[pkg]["log"].replace(r[pkg]["dir"], "D")
    assert _log_lines(r["port"]["log"]) == _log_lines(r["ref"]["log"])
    assert "    rays traced (counted)" in _log_lines(r["port"]["log"])
    rays = [line for line in r["port"]["log"].splitlines()
            if "rays traced (counted)" in line]
    assert int(rays[0].split()[-1].replace(",", "")) == \
        r["port"]["stats"]["rays"]


@pytest.mark.parametrize("name", ["chunked", "path"])
def test_stats_json_trace(route, name):
    """--stats-json carries the program's trace: its span rows (the
    render, its passes, the reconstruction's solve), the counters and
    the live share of the traversal lanes; -v prints them after the
    reference's table."""
    r = route(name)["port"]
    tr = r["stats"]["trace"]
    rows = {row["path"]: row for row in tr["spans"]}
    assert rows["render"]["calls"] == 1
    assert rows["render/pass"]["calls"] >= 1
    assert {"load_scene", "load_scene/parse", "to_torch"} <= set(rows)
    if name == "path":
        assert rows["make_integrator"]["calls"] == 1
    else:
        assert rows["solve"]["calls"] == 1
        assert rows["solve/irls:7"]["calls"] == 1
    assert tr["counters"]["host_syncs"] == 0     # the CPU has no syncs
    assert tr["counters"]["kernel_builds"] >= 0
    lanes = tr["counters"]["lanes"]
    assert lanes == sum(row["counts"].get("lanes", 0)
                        for row in tr["spans"])
    assert tr["live_share"] == r["stats"]["rays"] / lanes
    assert 0 < tr["live_share"] <= 1
    assert "\n  Trace (calls" in r["log"]
    assert "live share of traversal lanes" in r["log"]


def test_gbdpt_route(route):
    r = route("gbdpt")
    assert r["ref"]["rc"] == r["port"]["rc"] == 0
    _check_gd_outputs(r)
    assert r["port"]["stats"]["rays"] == r["ref"]["stats"]["rays"] > 0
    assert _ref_keys(r["port"]["stats"]) == sorted(r["ref"]["stats"])


def test_path_npy_route(route):
    r = route("path")
    assert r["ref"]["rc"] == r["port"]["rc"] == 0
    _assert_close(np.load(r["port"]["out"]), np.load(r["ref"]["out"]),
                  "path")
    assert r["port"]["stats"]["rays"] == r["ref"]["stats"]["rays"] > 0
    assert _ref_keys(r["port"]["stats"]) == sorted(r["ref"]["stats"])


def test_matlab_output(route):
    """.m output: the mfilm text layout (the writer's bytes are the
    reference's: test_write_image_formats), the values of the path
    route's .npy image (the same render) to %.8g."""
    r = route("matlab")

    def parse(path):
        chans = []
        with open(path) as f:
            for block in f.read().split("];\n")[:-1]:
                head, body = block.split(" = [\n")
                chans.append((head, np.array(
                    [[float(v) for v in row.split()]
                     for row in body.strip().rstrip(";").split(";\n")],
                    np.float32).reshape(16, 16)))
        return chans

    got = parse(r["port"]["out"])
    assert [h for h, _ in got] == ["r", "g", "b"]
    np.testing.assert_allclose(np.stack([c for _, c in got], -1),
                               np.load(route("path")["port"]["out"]),
                               rtol=1e-7, atol=1e-30)


def test_multichannel_route(route):
    r = route("multichannel")
    assert r["ref"]["rc"] == r["port"]["rc"] == 0
    for ch in ("path", "ao"):
        _assert_close(_read(r["port"], "-" + ch), _read(r["ref"], "-" + ch),
                      ch)
    np.testing.assert_array_equal(_read(r["port"]),
                                  _read(r["port"], "-path"))
    assert any("2 channels at" in line
               for line in r["port"]["log"].splitlines())


def test_relmse(route):
    """--relmse against a constant image: the stats' relMSE is the
    reference's formula (its relmse) on the written image; the port's
    relmse is the reference's on arrays and tensors."""
    r = route("relmse")
    half = np.full((16, 16, 3), 0.5, np.float32)
    assert r["port"]["stats"]["relmse"] == pytest.approx(
        ref_cli.relmse(_read(r["port"]), half), rel=1e-3)
    assert any(line.startswith("[tpurender] relMSE vs ")
               for line in r["port"]["log"].splitlines())
    rs = np.random.RandomState(0)
    a, b = rs.rand(2, 5, 4, 3).astype(np.float32)
    assert cli.relmse(a, b) == ref_cli.relmse(a, b)
    assert cli.relmse(torch.from_numpy(a), b) == ref_cli.relmse(a, b)


def test_unknown_integrator_falls_back(route):
    """An integrator outside KNOWN: the reference's message
    (utils/cli.py's fallback line), then the path tracer's image."""
    r = route("unknown")
    msg = ("[tpurender] integrator 'nosuchintegrator' not available; "
           "falling back to 'path'")
    assert msg in r["port"]["log"].splitlines()
    path = np.load(route("path")["port"]["out"])
    np.testing.assert_array_equal(
        _read(r["port"]), path.astype(np.float16).astype(np.float32))


def test_checkpoint_resume_bit_identical(tmp_path, monkeypatch):
    """--checkpoint, a run interrupted after its first sample, then
    --resume: every output bit-identical to an uninterrupted run with
    the same one-sample chunks."""
    acc = checkpoint.render_accumulate
    monkeypatch.setattr(
        checkpoint, "render_accumulate",
        lambda tracer, scene, seed, spp, chunk=64, **kw: acc(
            tracer, scene, seed, spp, 1, **kw))

    def run(d, *extra):
        return cli.main([CBOX, "-o", str(tmp_path / d / "x.exr"), "-q",
                         "--device", "cpu"] + BASE + list(extra))

    for d in ("whole", "cut"):
        (tmp_path / d).mkdir()
    assert run("whole", "--checkpoint", str(tmp_path / "whole.npz")) == 0
    chunk = GPTracer.render_chunk

    def dies_at_second(self, scene, seed, start, n):
        if start == 1:
            raise RuntimeError("killed after the first sample")
        return chunk(self, scene, seed, start, n)

    ck = str(tmp_path / "cut.npz")
    monkeypatch.setattr(GPTracer, "render_chunk", dies_at_second)
    with pytest.raises(RuntimeError, match="killed"):
        run("cut", "--checkpoint", ck)
    assert checkpoint.load(ck)[1] == 1
    monkeypatch.setattr(GPTracer, "render_chunk", chunk)
    assert run("cut", "--checkpoint", ck, "--resume") == 0
    assert checkpoint.load(ck)[1] == 2
    for k in ("", "-primal", "-dx", "-dy", "-direct", "-final"):
        with open(tmp_path / "whole" / f"x{k}.exr", "rb") as a, \
                open(tmp_path / "cut" / f"x{k}.exr", "rb") as b:
            assert a.read() == b.read(), k


def test_refresh_flushes_partial_images(tmp_path):
    """-r: the chunked route with a flush after every chunk."""
    out = str(tmp_path / "x.exr")
    rc, log = _main("port", [CBOX, "-o", out, "-r", "1e-9"] + BASE)
    assert rc == 0
    assert f"[tpurender] partial flush at 2/2 spp -> {out}" in \
        log.splitlines()
    assert np.isfinite(exr.read_rgb(out)).all()


@pytest.mark.parametrize("argv", [
    ["-D", "width", CBOX],
    ["-o", "x.exr", CBOX, CBOX],
    ["--checkpoint", "ck.npz", CBOX, CBOX],
])
def test_error_exits(argv, capsys):
    """rc 1 and the reference's message on a bad -D, and on -o or
    --checkpoint with two scenes; nothing rendered."""
    assert ref_cli.main(argv) == 1
    ref_err = capsys.readouterr().err
    assert cli.main(argv) == 1
    assert capsys.readouterr().err == ref_err
    assert ref_err.startswith("error: ")


def test_main_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([CBOX, "-o", str(tmp_path / "x.exr"), "-q"] + BASE)
    assert not os.path.exists(tmp_path / "x.exr")


def test_profile_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "prof"
    assert cli.main([CBOX, "-o", str(tmp_path / "x.npy"), "-q",
                     "--integrator", "path", "--profile", str(d),
                     "--device", "cpu"] + BASE) == 0
    with open(d / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("ext", [".png", ".jpg", ".npy", ".m", ".exr"])
def test_write_image_formats(ext, tmp_path):
    """write_image's outputs decode to the reference writer's: the same
    bytes for .npy, .m and .exr, 8-bit pixels within one step for PNG
    and JPEG (the sRGB curve's last bit in numpy against XLA)."""
    img = np.random.RandomState(4).gamma(1.0, 0.5, (6, 5, 3)).astype(
        np.float32)
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    cli.write_image(exr, a, torch.from_numpy(img))
    from gradientdomain_mitsuba_tpu.utils import exr as ref_exr
    ref_cli.write_image(ref_exr, b, img)
    if ext in (".png", ".jpg"):
        from PIL import Image
        pa = np.asarray(Image.open(a), np.int32)
        pb = np.asarray(Image.open(b), np.int32)
        assert pa.shape == pb.shape == (6, 5, 3)
        assert np.abs(pa - pb).max() <= 1
        if ext == ".png":
            assert (pa == pb).mean() >= 0.99
    else:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
