"""Render configuration.

The reference scatters its configuration over three surfaces: GUI magic
numbers (render type 0/1/2, scene ids, adaptive flags; reference
``src/wasm_interface.rs:207-214``, ``src_ts/client/PanelSettings.elm``),
hard-coded constants (reference ``src/tracer.rs:104-107``,
``src/data/photon_tree.rs:29,52-54``, ``src/graphics/scene.rs:60``,
``src/math/mod.rs:11``, ``src/graphics/sampling_strategy.rs:163,199-205``),
and per-scene initial cameras (``src_ts/client/index.ts:153-162``).

Here all of it is one frozen dataclass that participates in jit static
hashing.  Shape-relevant fields (ray batch size, max bounces) are static;
everything numeric that a user may want gradients through lives in the
scene pytree instead (materials, lights, camera).
"""

from __future__ import annotations

import dataclasses
import enum


class RenderType(enum.IntEnum):
    """Estimator selection (reference ``src/tracer.rs:29-33``).

    The integer values match the reference's wire protocol magic numbers
    (``src/wasm_interface.rs:207-214``) so sessions stay drop-in
    compatible.
    """

    NO_NEE = 0      # brute-force path tracing, light found by BSDF sampling
    NORMAL_NEE = 1  # next-event estimation with uniform light selection
    PNEE = 2        # photon-guided NEE (grid CDF light selection)


class DebugView(enum.IntEnum):
    """False-color debug outputs.

    The reference exposes these through worker messages / GUI toggles:
    diffuse vs sampling-density view (``src_ts/worker/worker.ts:158-168``),
    photon-debug render (``src/tracer.rs:45-48,296-299``) and the
    depth / BVH-cost renders (``src/tracer.rs:205-219``).
    """

    NONE = 0
    SAMPLING_DENSITY = 1
    PHOTON_LIGHTS = 2
    DEPTH = 3
    BVH_COST = 4


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (non-traced) configuration for a render instance."""

    # --- Estimator --------------------------------------------------------
    render_type: RenderType = RenderType.NORMAL_NEE
    # The reference's bounce loop is unbounded, terminated only by Russian
    # roulette (``src/tracer.rs:237-329``).  A wavefront loop needs a static
    # trip count; with RR keep-chance clamped to <=0.9 the probability of a
    # path surviving past this cap is < 0.9^16 ~ 1.9e-1 ... in practice
    # diffuse throughput decays far faster; 16 matches converged output to
    # well under 1e-3 per channel.
    max_bounces: int = 16
    # Batch-level early exit of the bounce loop once every path has
    # terminated (lax.while_loop).  Not reverse-differentiable: gradient
    # workloads must set False to get the lax.scan form.
    early_exit: bool = True
    # Rematerialize each bounce in the backward pass (``jax.checkpoint``
    # around the scan body): stores only the (R,)-sized carries instead
    # of every bounce's trace intermediates, ~2x bounce FLOPs for
    # O(max_bounces)x less gradient memory.  Only affects the scan form
    # (``early_exit=False``), i.e. gradient workloads.
    checkpoint_bounces: bool = True
    # Epsilon bias for shadow/bounce ray origins (``src/math/mod.rs:11``).
    epsilon: float = 2e-4
    # Russian roulette keep-chance clamp (``src/tracer.rs:318``).
    rr_clamp_min: float = 0.1
    rr_clamp_max: float = 0.9

    # Edge-aware NEE gradients: warp the area-light sample uniforms so
    # light-GEOMETRY gradients carry the shadow-boundary (visibility)
    # flux past occluders (``ops/edges.py``; the north star's
    # "reparameterized edge-aware sampling").  Value-preserving — the
    # forward render is unchanged — but each NEE sample adds
    # ``edge_nee_aux`` closed-form occluder-clearance probes, so it is
    # a gradient-workload switch, off for production forward rendering.
    edge_aware_nee: bool = False
    edge_nee_aux: int = 6
    edge_nee_radius: float = 0.12

    # --- Photon-guided NEE ------------------------------------------------
    # Photon preprocess budget (``src/tracer.rs:104``) and exchange rate of
    # photons per ray tick (``src/tracer.rs:107``).
    total_photons: int = 300_000
    photons_per_tick: int = 32
    # The reference subdivides octree cells past 1024 photons
    # (``src/data/photon_tree.rs:29``); our flat grid instead has a fixed
    # resolution chosen to give comparable leaf granularity.
    photon_grid_res: int = 32
    # World bounds of the photon structure (``src/data/photon_tree.rs:52-54``
    # hard-codes +-1024).  When ``photon_grid_fit_scene`` is set the grid
    # instead spans the scene's finite AABB — strictly better guidance, and
    # the estimator stays unbiased because the interpolated pdf is exact
    # for whatever cell layout is used.
    photon_world_size: float = 1024.0
    photon_grid_fit_scene: bool = True

    # --- Sampling ---------------------------------------------------------
    adaptive: bool = False
    # First adaptive round is uniform at this many samples per pixel
    # (``src/graphics/sampling_strategy.rs:199-205``).
    adaptive_bootstrap_spp: int = 4
    # spp per refill round is ceil(1 + scaled_err * 32)
    # (``src/graphics/sampling_strategy.rs:163``).
    adaptive_spp_scale: float = 32.0

    # --- Camera -----------------------------------------------------------
    # Virtual screen plane sits at z = +0.8 in camera space
    # (``src/tracer.rs:186``); z points into the screen.
    screen_z: float = 0.8

    # --- BVH --------------------------------------------------------------
    # Binned SAH with this many bins (``src/graphics/scene.rs:60``).
    bvh_num_bins: int = 16
    # Collapse BVH2 into a 4-wide BVH (``src/graphics/bvh4.rs``); the
    # reference default is off (``src/graphics/scene.rs:60``), ours is on
    # because 4-wide nodes test four child boxes in one vector step.
    use_bvh4: bool = True
    # Below this many triangles, brute-force rays x primitives beats
    # traversal (everything stays dense and fused).
    bvh_min_triangles: int = 512

    # --- Batching ---------------------------------------------------------
    # Rays processed per wavefront batch (a static shape).
    ray_batch_size: int = 32768
    # Persistent wavefront with path regeneration
    # (``integrator.render_queue``): lanes that finish a path immediately
    # pull the next sample off the pixel queue, keeping scene traces at
    # ~full occupancy (~2.7x the lockstep loop on the museum).  Applies
    # to forward rendering only (needs ``early_exit``-style while_loop);
    # gradient workloads always take the lockstep scan.
    use_regen: bool = True
    # Wavefront width for the regenerating loop; the queue per step is
    # ``ray_batch_size``, so occupancy stays high while the drain tail
    # costs ~lanes/batch of a step.
    # NOTE: the session driver additionally caps the effective lane
    # count at max(1024, ray_batch_size // 4) — a ONE-SIDED override:
    # an explicit regen_lanes SMALLER than that cap is always honored,
    # but a larger value is clamped (the session queue is one batch, so
    # wider wavefronts pay their whole drain tail every step).  Direct
    # ``render_queue*`` callers (bench.py) get exactly this value.
    regen_lanes: int = 16384
    # Flattened traversal (``ops.wavefront.render_queue_flat``): cluster
    # probe micro-steps interleave with bounces in one persistent loop,
    # so no lane waits lockstep on the slowest ray's probe sequence.
    # None = auto (use it whenever a cluster structure is attached);
    # requires ``use_regen``.
    use_flat_wavefront: bool | None = None

    # --- Debug ------------------------------------------------------------
    debug_view: DebugView = DebugView.NONE
    is_debug_photons: bool = False

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def has_nee(self) -> bool:
        # ``src/tracer.rs:227``
        return self.render_type in (RenderType.NORMAL_NEE, RenderType.PNEE)
