"""PyTorch + CUDA port of the gradient-domain renderer.

Counterpart of ``gradientdomain_mitsuba_tpu`` (the JAX reference, which
stays as it is).  The layout mirrors the reference so each module names
its counterpart one to one:

  core/      math, counter RNG, sampling warps, records
  scene/     numpy-only scene front end + bridge.to_torch
  ops/       intersection (plain torch + hand-written CUDA sweep and
             pair-traversal kernels), BSDF, emitters, sensor, film
  models/    integrators (G-PT, path) and the screened-Poisson solver
  parallel/  checkpointed accumulation (render_accumulate)
  csrc/      CUDA C++ sources, built with nvcc at first use

The package imports torch and numpy, never jax.  Every entry point takes
its device from the scene's tensors (scene/bridge.to_torch) or from
config.get_device.
"""

__version__ = "0.1.0"
