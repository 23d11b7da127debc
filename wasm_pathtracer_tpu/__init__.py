"""wasm_pathtracer_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
``sourcedennis/wasm-pathtracer`` (a Rust->WASM path tracer; see
``/root/reference``).  Nothing here is a port: the reference's
scalar-recursive design (per-ray bounce recursion, pointer-chasing BVH,
mutable shared xorshift RNG, queue-driven adaptive sampler) is replaced
with SoA ray batches, a masked wavefront bounce loop under ``lax.scan``,
flat int32 BVH arrays traversed iteratively, counter-based
``jax.random`` keyed by (pixel, sample), and a jittable variance-guided
sample allocator.  Rays shard over a ``jax.sharding.Mesh``; the scene is
replicated.

Layout
------
- ``config``    — every magic constant of the reference as a named field.
- ``models``    — scene/camera/material data model + built-in scenes.
- ``ops``       — compute kernels: intersection, traversal, integrator,
                  photon-grid NEE, adaptive allocator, accumulators.
- ``parallel``  — device-mesh sharding of the render/grad step.
- ``runtime``   — session API, progressive driver, checkpointing, CLI.
- ``utils``     — vec math, RNG spec, OBJ parser, PNG writer.
"""

from wasm_pathtracer_tpu.config import RenderSettings, RenderType

__version__ = "0.1.0"

__all__ = ["RenderSettings", "RenderType", "__version__"]
