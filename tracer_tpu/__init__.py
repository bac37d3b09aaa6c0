"""tracer_tpu — a spectral path-tracing / LiDAR sensor-simulation framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the reference
Futhark ray tracer (bryal/msc-futhark-ray-tracer): a spectral, physically
based Monte Carlo path tracer with multiple importance sampling that
simulates both a visual camera and a LiDAR sensor (reference README.org:3-6).

Layer map (mirrors SURVEY.md section 1, re-architected for accelerators):

  engine/    public API: the 7 entry points (init/step/render/key/resize/
             sample_points_n/sample_n_frames), engine state pytree,
             wavefront integrator, NEE+MIS direct lighting
  models/    sensor/camera models, lights, scene assembly, built-in
             sensor configurations (visual, visual+flash, LiDAR)
  ops/       device kernels: vec math, counter-based RNG, spectra,
             ray/triangle/AABB intersection (dense chunked form with a
             fused GPU kernel + LBVH),
             Karras radix tree, uber-BSDF materials
  parallel/  multi-chip rendering: jax.sharding Mesh + shard_map tile and
             sample sharding, psum/pmean accumulation
  utils/     host-side IO: OBJ/MTL loader (Python + native C++), PCD and
             PNG writers, profiling helpers
"""

__version__ = "0.1.0"

_API = ("init", "step", "render", "key", "resize",
        "sample_points_n", "sample_n_frames", "step_render")


def __getattr__(name):
    """Lazily expose the 7 entry points (reference src/lib.fut) so importing
    subpackages like tracer_tpu.ops does not pull in the whole engine."""
    if name in _API:
        from tracer_tpu.engine import api
        return getattr(api, name)
    raise AttributeError(name)
