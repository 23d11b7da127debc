"""Render session: the batched replacement for the reference's
WASM session layer + worker runtime (L2-L4).

``Session`` mirrors the 9-function WASM API of
``src/wasm_interface.rs`` one-for-one:

  init                  -> Session(...)
  compute(n)            -> Session.compute(n)           (rs:374-384)
  results(flag)         -> Session.results(...)         (rs:120-134)
  update_scene          -> Session.update_scene         (rs:154-168)
  update_settings       -> Session.update_settings      (rs:173-204)
  update_viewport       -> Session.update_viewport      (rs:219-232)
  update_camera         -> Session.update_camera        (rs:239-248)
  allocate_mesh / mesh_vertices / notify_mesh_loaded
                        -> Session.store_mesh           (rs:259-329)
  allocate_texture / notify_texture_loaded
                        -> Session.store_texture        (rs:335-366)

The reference's scalar-only ABI and raw-pointer mesh protocol
(rs:19-24, 250-256) dissolve: bulk data moves host->device with
``jax.device_put`` inside scene construction.  The two ``RenderInstance``
halves (left/right A/B comparison, rs:53-56, 90-94) survive as a
feature: each half renders its pixel region with its own estimator
settings, mirroring the SPMD-over-disjoint-domains pattern of SURVEY
§2c.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models.camera import Camera, initial_camera
from wasm_pathtracer_tpu.models.scene import SceneData
from wasm_pathtracer_tpu.models import scenes as scene_registry
from wasm_pathtracer_tpu.ops import (accum, adaptive, integrator, photon,
                                     trace, wavefront)
from wasm_pathtracer_tpu.utils import rng as rnglib
from wasm_pathtracer_tpu.utils.png import tonemap_u8


def fold_seed(seed: int, round_: int) -> np.uint32:
    """Derive a per-round seed; pure function of (session seed, round)."""
    with np.errstate(over="ignore"):  # uint32 wrap is the point
        x, _, _ = rnglib._pcg3d(np.uint32(seed), np.uint32(round_),
                                np.uint32(0x9E3779B9), np)
    return x


class RenderInstance:
    """One viewport region with its own estimator settings.

    The analog of ``RenderInstance`` (``src/tracer.rs:35-123``): owns a
    sampling strategy, an optional photon structure, and a BVH-cost
    counter; writes into the session's shared accumulator.
    """

    def __init__(self, session: "Session", x0: int, y0: int,
                 width: int, height: int, settings: RenderSettings):
        self.session = session
        self.x0, self.y0 = x0, y0
        self.width, self.height = width, height
        self.settings = settings
        self.round = 0
        self.num_bvh_hits = 0
        self._rays_traced = 0
        self._sweep = jnp.int32(0)   # adaptive floor-sweep position
        self._pending_cost: list = []
        self._last_density = None
        self.photon_grid: photon.PhotonGrid | None = None
        self._step = None
        self._emit = None
        if settings.render_type == RenderType.PNEE:
            self._init_photons()

    # -- photon preprocessing (``tracer.rs:103-123``) ----------------------
    def _init_photons(self):
        s = self.session
        lo, hi = photon.grid_bounds_for_scene(s.scene, self.settings)
        self.photon_grid = photon.PhotonGrid.create(
            s.scene.num_lights, lo, hi, self.settings.photon_grid_res)

    def _photons_done(self) -> bool:
        if self.photon_grid is None:
            return True
        return int(self.photon_grid.num_photons) >= self.settings.total_photons

    def _emit_fn(self):
        if self._emit is None:
            s = self.session
            batch = self.settings.ray_batch_size

            @jax.jit
            def emit(grid, scene, seed):
                return photon.emit_photons(grid, s.prep, scene,
                                           self.settings, seed, batch)
            self._emit = emit
        return self._emit

    # -- ray compute -------------------------------------------------------
    def _step_fn(self):
        if self._step is None:
            s = self.session
            settings = self.settings
            x0, y0, w, h = self.x0, self.y0, self.width, self.height
            W, H = s.width, s.height
            batch = settings.ray_batch_size
            prep = s.prep
            use_photon = settings.render_type == RenderType.PNEE
            # persistent wavefront with regeneration (forward-only);
            # rid_base decorrelates the halves' RNG streams (both count
            # queue slots from 0 under the same per-round seed)
            use_regen = settings.use_regen and settings.early_exit
            # lane width: regen_lanes capped at a quarter of the
            # per-step queue — the session's queue is only one batch
            # (unlike bench.py's multi-million-path queues), so wider
            # wavefronts pay their whole drain tail every step (at
            # lanes == batch/2 the tail is ~50% of the step).  The
            # 1024 floor applies only to the derived cap; an EXPLICIT
            # smaller regen_lanes (tests, --lanes) is always honored,
            # and lanes never exceeds the batch.
            lanes = min(settings.regen_lanes, batch,
                        max(1024, batch // 4))
            rid_base = (0x40000000 if self.x0 > 0 or self.y0 > 0 else 0)

            # donate the accumulator: it is rebound to the result each
            # step, so the scatter-add updates in place
            @functools.partial(jax.jit, static_argnames=("bootstrap",),
                               donate_argnums=(2,))
            def step(scene, camera, buf, seed, photon_grid, sweep,
                     bootstrap):
                if settings.adaptive:
                    px, py, density, sweep = adaptive.pick_pixels(
                        buf, batch, seed, bootstrap,
                        settings.adaptive_spp_scale, x0, y0, w, h,
                        sweep_pos=sweep)
                else:
                    px, py = adaptive.random_pixels(batch, seed, x0, y0, w, h)
                    density = jnp.zeros((h, w), jnp.float32)
                pg = photon_grid if use_photon else None
                if use_regen:
                    use_flat = settings.use_flat_wavefront
                    if use_flat is None:     # auto: clusters -> flat
                        use_flat = prep.cluster is not None
                    queue_fn = (wavefront.render_queue_flat
                                if use_flat and prep.cluster is not None
                                else integrator.render_queue)
                    pix = (py * W + px).astype(jnp.int32)
                    acc_s, cnt_s, cost = queue_fn(
                        prep, scene, settings, camera, pix, W, H, seed,
                        lanes, photon_grid=pg, rid_base=rid_base)
                    buf = accum.write_sums(buf, acc_s, cnt_s)
                    return buf, density, cost, sweep
                col, cost = integrator.render_pixels(
                    prep, scene, settings, camera, px, py, W, H, seed,
                    photon_grid=pg)
                buf = accum.write_samples(buf, px, py, col)
                return buf, density, jnp.sum(cost), sweep
            self._step = step
        return self._step

    def compute(self, num_ticks: int) -> int:
        """Advance ``num_ticks`` (1 tick ~ 1 path; PNEE spends ticks on
        photons first at 32 photons/tick, ``tracer.rs:103-123``).
        Returns the number of rays actually traced."""
        s = self.session
        settings = self.settings
        ticks_left = num_ticks

        if settings.render_type == RenderType.PNEE and not self._photons_done():
            emit = self._emit_fn()
            batch = settings.ray_batch_size
            while ticks_left > 0 and not self._photons_done():
                seed = fold_seed(s.seed, 0x50000000 + self.round)
                self.photon_grid = emit(self.photon_grid, s.scene,
                                        jnp.uint32(seed))
                self.round += 1
                ticks_left -= max(batch // settings.photons_per_tick, 1)
            if ticks_left <= 0:
                return 0

        step = self._step_fn()
        traced = 0
        batch = settings.ray_batch_size
        while ticks_left > 0:
            seed = fold_seed(s.seed, self.round)
            # bootstrap decision from the host-side ledger (a device
            # read here would sync every batch)
            bootstrap = settings.adaptive and (
                self._rays_traced / max(self.width * self.height, 1)
                < settings.adaptive_bootstrap_spp)
            buf, density, cost, self._sweep = step(
                s.scene, s.camera, s.buffer, jnp.uint32(seed),
                self.photon_grid, self._sweep, bootstrap)
            s.buffer = buf
            self._pending_cost.append(cost)
            if settings.adaptive:
                self._last_density = (density, bootstrap)
            self.round += 1
            traced += batch
            self._rays_traced += batch
            ticks_left -= batch
        if settings.adaptive and self._last_density is not None:
            density, bootstrap = self._last_density
            s.write_density(self.x0, self.y0, density, bootstrap)
            self._last_density = None
        # fold the cost counters once per compute() call, not per batch;
        # regen steps return per-lane int32 vectors — reduce in int64 on
        # the host so the metric stays exact on long renders
        for c in self._pending_cost:
            self.num_bvh_hits += int(np.asarray(c, dtype=np.int64).sum())
        self._pending_cost = []
        return traced

    def round_samples(self) -> float:
        """Mean samples/pixel so far in this region (drives bootstrap)."""
        s = self.session
        c = s.buffer.count[self.y0:self.y0 + self.height,
                           self.x0:self.x0 + self.width]
        return float(jnp.mean(c))

    def reset(self):
        # ``RenderInstance::reset`` (``tracer.rs:84-88``): keeps photons
        self.num_bvh_hits = 0
        self.round = 0
        self._rays_traced = 0
        self._sweep = jnp.int32(0)
        self._pending_cost = []
        self._last_density = None

    def update_scene(self):
        # ``RenderInstance::update_scene`` (``tracer.rs:92-97``)
        self.photon_grid = None
        self._step = None
        self._emit = None
        if self.settings.render_type == RenderType.PNEE:
            self._init_photons()
        self.reset()

    def resize(self, x0, y0, width, height):
        self.x0, self.y0, self.width, self.height = x0, y0, width, height
        self._step = None
        self.reset()


class Session:
    """A rendering session over a width x height viewport."""

    def __init__(self, width: int, height: int, scene_id: int = 100,
                 camera: Camera | None = None,
                 left: RenderSettings | None = None,
                 right: RenderSettings | None = None,
                 seed: int = 0xBABABEBE,
                 use_bvh: bool | None = None):
        self.width, self.height = width, height
        self.scene_id = scene_id
        self.seed = seed
        self.meshes: dict[int, np.ndarray] = {}
        self.textures: dict[int, np.ndarray] = {}
        self.use_bvh = use_bvh
        self.scene: SceneData = scene_registry.select_scene(
            scene_id, self.meshes, self.textures)
        self.prep = self._prepare(self.scene)
        self.camera = camera or initial_camera(scene_id)
        self.buffer = accum.AccumBuffer.create(width, height)
        self.density = np.zeros((height, width, 3), np.float32)
        self.density[..., 2] = 1.0  # "1 sample/pixel" blue baseline

        # defaults mirror init's left=NEE+random, right=PNEE+adaptive
        # (``wasm_interface.rs:90-94``)
        left = left or RenderSettings(render_type=RenderType.NORMAL_NEE)
        right = right or RenderSettings(render_type=RenderType.PNEE,
                                        adaptive=True)
        lw = width // 2
        self.left = RenderInstance(self, 0, 0, lw, height, left)
        self.right = RenderInstance(self, lw, 0, width - lw, height, right)

    # -- plumbing ----------------------------------------------------------
    def _prepare(self, scene: SceneData) -> trace.ScenePrep:
        # trace.prepare makes the platform decision (the Pallas scene
        # kernel on the GPU, XLA elsewhere); the session only renders
        # forward, so the kernel's missing VJP never matters here
        prep = trace.prepare(scene)
        if self.use_bvh is False:
            return prep
        # cluster-dense is the acceleration path over ALL finite
        # primitive families (see ops.cluster); per-family auto
        # threshold unless forced.  The scene kernel still covers
        # whatever stays dense — the two fast paths compose.
        from wasm_pathtracer_tpu.ops import bvh
        min_count = 1 if self.use_bvh else \
            RenderSettings().bvh_min_triangles
        return bvh.attach_clusters(prep, scene, min_count=min_count)

    def write_density(self, x0, y0, density, bootstrap):
        h, w = density.shape
        if bootstrap:
            self.density[y0:y0 + h, x0:x0 + w] = (0.0, 0.0, 1.0)
        else:
            self.density[y0:y0 + h, x0:x0 + w] = np.asarray(
                accum.mix_color(density))

    # -- WASM-API mirror ---------------------------------------------------
    def compute(self, num_samples: int) -> int:
        """``compute`` (``wasm_interface.rs:374-384``): ticks split
        between the halves."""
        n_left = num_samples // 2
        t = self.left.compute(n_left)
        t += self.right.compute(num_samples - n_left)
        return t

    def results(self, show_sampling: bool = False) -> np.ndarray:
        """(H, W, 3) uint8 frame (``wasm_interface.rs:120-134``)."""
        if show_sampling:
            return tonemap_u8(self.density)
        return tonemap_u8(np.asarray(accum.clamped_image(self.buffer)))

    def image(self) -> np.ndarray:
        """Raw mean-radiance float image."""
        return np.asarray(accum.mean_image(self.buffer))

    def reset(self):
        # ``reset`` (``wasm_interface.rs:137-148``)
        self.buffer = self.buffer.clear()
        self.density[:] = (0.0, 0.0, 1.0)
        self.left.reset()
        self.right.reset()

    def update_scene(self, scene_id: int):
        # ``update_scene`` (``wasm_interface.rs:154-168``)
        self.scene_id = scene_id
        self.scene = scene_registry.select_scene(scene_id, self.meshes,
                                                 self.textures)
        self.prep = self._prepare(self.scene)
        self.reset()
        self.left.update_scene()
        self.right.update_scene()

    def update_settings(self, left: RenderSettings, right: RenderSettings):
        # ``update_settings`` (``wasm_interface.rs:173-204``): rebuilds
        # both instances, restart-from-scratch semantics
        lw = self.width // 2
        self.left = RenderInstance(self, 0, 0, lw, self.height, left)
        self.right = RenderInstance(self, lw, 0, self.width - lw,
                                    self.height, right)
        self.buffer = self.buffer.clear()
        self.density[:] = (0.0, 0.0, 1.0)

    def update_viewport(self, width: int, height: int):
        # ``update_viewport`` (``wasm_interface.rs:219-232``)
        self.width, self.height = width, height
        self.buffer = accum.AccumBuffer.create(width, height)
        self.density = np.zeros((height, width, 3), np.float32)
        self.density[..., 2] = 1.0
        lw = width // 2
        self.left.resize(0, 0, lw, height)
        self.right.resize(lw, 0, width - lw, height)
        self.reset()

    def update_camera(self, location, rot_x: float, rot_y: float):
        # ``update_camera`` (``wasm_interface.rs:239-248``)
        self.camera = Camera.create(location, rot_x, rot_y)
        self.reset()

    def store_mesh(self, mesh_id: int, vertices: np.ndarray) -> bool:
        """Mesh upload (3-stage protocol collapsed;
        ``wasm_interface.rs:259-329``).  ``vertices`` is (V, 3) or
        (T, 3, 3).  Returns True when the current scene uses the mesh
        and was rebuilt."""
        v = np.asarray(vertices, np.float32)
        if v.ndim == 2:
            v = v.reshape(-1, 3, 3)
        self.meshes[mesh_id] = v
        # scene 1 uses mesh 0; scene 2 uses mesh 1; scene 3 uses mesh 2
        # (``wasm_interface.rs:316-324``)
        if self.scene_id == mesh_id + 1:
            self.update_scene(self.scene_id)
            return True
        return False

    def store_texture(self, tex_id: int, rgb: np.ndarray) -> bool:
        # ``allocate_texture``/``notify_texture_loaded`` (rs:335-366)
        self.textures[tex_id] = np.asarray(rgb, np.float32)
        return False

    # -- observability -----------------------------------------------------
    @property
    def num_bvh_hits(self) -> int:
        """Total primitive/node tests — the reference's built-in cost
        metric (``tracer.rs:40``, ``scene.rs:137-144``)."""
        return self.left.num_bvh_hits + self.right.num_bvh_hits
