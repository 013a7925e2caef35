"""The check that no JAX module is loaded: whole top-level names."""
import subprocess
import sys

from gdbench import nojax, registry


def test_top_level_names_compare_whole():
    assert nojax.loaded({"gradientdomain_mitsuba_tpu_torch": 1,
                         "gradientdomain_mitsuba_tpu_torch.ops.trace": 1,
                         "torch": 1}) == []
    assert nojax.loaded({"gradientdomain_mitsuba_tpu": 1}) == [
        "gradientdomain_mitsuba_tpu"]
    assert nojax.loaded({"gradientdomain_mitsuba_tpu.models.gpt": 1}) == [
        "gradientdomain_mitsuba_tpu"]
    assert nojax.loaded({"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1,
                         "jaxtyping": 1}) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    """The harness, its routes, the reference and the program's modules
    that a run imports load no JAX module."""
    code = (
        "import sys\n"
        "from gdbench import harness, readings, registry, nojax\n"
        "for r in ('path', 'gpt_l1'):\n"
        "    registry.module('routes', r)\n"
        "from gradientdomain_mitsuba_tpu_torch.models.factory import "
        "make_integrator\n"
        "from gradientdomain_mitsuba_tpu_torch.scene import scene, bridge\n"
        "from gradientdomain_mitsuba_tpu_torch.models import gpt, path, "
        "poisson\n"
        "print(nojax.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=registry.ROOT)
    assert out.stdout.strip() == "[]"
