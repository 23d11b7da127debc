"""Data-parallel rendering and differentiable training over a device mesh.

The reference's parallelism is pixel-partition data parallelism: JS
assigns each WASM worker a pixel subset (``src/wasm_interface.rs:26-30``,
partitioner ``src_ts/client/util.ts:15-24``), with the scene replicated
per worker and frames merged through a SharedArrayBuffer.  The JAX
equivalent (SURVEY §2c):

- a 1-D ``jax.sharding.Mesh`` over all devices with one axis, ``rays``
  (plain 1-D suits cards joined all to all, e.g. NVLink);
- ray/pixel batches sharded over ``rays`` via ``shard_map``; the scene
  (shape table, BVH, photon grid, material leaves) **replicated**;
- per-ray counter RNG (no shared state), so results are bit-identical
  under any device count;
- gradients of replicated scene/camera parameters all-reduced with
  ``psum`` — the collective XLA schedules to overlap with the backward
  pass.

Multi-host: the same code runs under ``jax.distributed.initialize``;
``jax.devices()`` then spans hosts and the ``rays`` axis crosses DCN
only at the psum boundary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from wasm_pathtracer_tpu.config import RenderSettings
from wasm_pathtracer_tpu.models.camera import Camera
from wasm_pathtracer_tpu.ops import integrator, trace


def make_ray_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices with axis ``rays``."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=("rays",))


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def render_image_sharded(mesh: Mesh, prep: trace.ScenePrep, scene,
                         settings: RenderSettings, camera: Camera,
                         width: int, height: int, seed, spp: int = 1):
    """Render a full frame with pixels sharded over the mesh.

    Every device traces its pixel shard with the replicated scene; the
    result is the sharded image (no gather needed — the caller reads it
    as a global jax.Array).  Deterministic: per-pixel RNG streams do not
    depend on the device count.
    """
    n_dev = mesh.devices.size
    n_pix = width * height
    n_pad = _pad_to(n_pix, n_dev * 8)

    pix = jnp.arange(n_pad, dtype=jnp.int32)
    px = jnp.minimum(pix % width, width - 1)
    py = jnp.minimum(pix // width, height - 1)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P(), P()),
        out_specs=P("rays"), check_vma=False)
    def shard_render(px_s, py_s, scene_s, camera_s):
        acc = jnp.zeros((px_s.shape[0], 3), jnp.float32)
        for s in range(spp):
            col, _ = integrator.render_pixels(
                prep, scene_s, settings, camera_s, px_s, py_s,
                width, height,
                seed + jnp.uint32((s * 0x9E3779B9) & 0xFFFFFFFF))
            acc = acc + col
        return acc / spp

    col = shard_render(px, py, scene, camera)
    img = col[:n_pix].reshape(height, width, 3)
    return img


def _queue_sharded(renderer, mesh: Mesh, prep: trace.ScenePrep, scene,
                   settings: RenderSettings, camera: Camera,
                   pix_queue, width: int, height: int, seed,
                   lanes_per_device: int, rid_base: int,
                   photon_grid=None):
    """Shared shard_map wrapper for the persistent-wavefront renderers.

    Each device runs the full wavefront over its queue shard with the
    scene replicated; partial frame sums ``psum`` over the mesh.  Path RNG
    is keyed by the GLOBAL queue index (``axis_index * shard +
    rid_base``), so every path's radiance is a pure function of
    (queue, seed) — independent of the device count.  Per-pixel ORDER
    of float accumulation does depend on the partition, so
    cross-device-count agreement is exact in sample counts and
    ~1e-6-relative in radiance (float reassociation), which the
    sharding tests pin down.

    The queue is padded to a device multiple with the out-of-range
    pixel id ``width*height``; the splat scatter drops it (both
    renderers scatter with mode="drop").
    """
    n_dev = mesh.devices.size
    S = pix_queue.shape[0]
    pad = _pad_to(max(S, 1), n_dev) - S
    pixq = jnp.pad(pix_queue, (0, pad), constant_values=width * height)
    shard = pixq.shape[0] // n_dev
    # ONE-SIDED lane clamp: a persistent-wavefront iteration costs
    # ~full lane width regardless of live lanes, so when the
    # per-device shard shrinks (more devices, same queue) a fixed wide
    # wavefront pays its whole drain tail at every device count.  The
    # width is capped near shard/32; explicit SMALLER values are
    # honored; lane width never exceeds max(1024, shard/32).
    lanes_per_device = min(lanes_per_device, max(1024, shard // 32))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("rays"), P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    def run(pix_s, scene_s, camera_s, seed_s):
        base = jnp.uint32(rid_base) + \
            jax.lax.axis_index("rays").astype(jnp.uint32) * jnp.uint32(shard)
        acc, cnt, lane_cost = renderer(
            prep, scene_s, settings, camera_s, pix_s, width, height,
            seed_s, lanes_per_device, rid_base=base,
            photon_grid=photon_grid)
        acc = jax.lax.psum(acc, "rays")
        cnt = jax.lax.psum(cnt, "rays")
        cost = jax.lax.psum(jnp.sum(lane_cost.astype(jnp.float32)), "rays")
        return acc, cnt, cost

    return run(pixq, scene, camera, seed)


def render_queue_sharded(mesh: Mesh, prep: trace.ScenePrep, scene,
                         settings: RenderSettings, camera: Camera,
                         pix_queue, width: int, height: int, seed,
                         lanes_per_device: int, rid_base: int = 0,
                         photon_grid=None):
    """The persistent regenerating wavefront
    (``integrator.render_queue``) under ``shard_map`` — the production
    renderer for dense (non-clustered) scenes.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, cost scalar
    f32) — accumulate as ``accum.write_sums``.
    """
    return _queue_sharded(integrator.render_queue, mesh, prep, scene,
                          settings, camera, pix_queue, width, height,
                          seed, lanes_per_device, rid_base, photon_grid)


def render_queue_flat_sharded(mesh: Mesh, prep: trace.ScenePrep, scene,
                              settings: RenderSettings, camera: Camera,
                              pix_queue, width: int, height: int, seed,
                              lanes_per_device: int, rid_base: int = 0,
                              photon_grid=None):
    """The FLAT persistent wavefront (``wavefront.render_queue_flat``)
    under ``shard_map`` — the production renderer for cluster scenes
    (meshes, clouds), i.e. the device-mesh realization of the reference's
    N-workers-over-pixel-subsets design (``src/wasm_interface.rs:26-30``,
    ``src_ts/client/util.ts:15-24``) for its LARGEST workloads
    (``src_ts/client/index.ts:213-226``).

    Requires ``prep.cluster``.  Same determinism contract as
    :func:`render_queue_sharded`: per-path radiance is bit-identical
    across device counts (global-index RNG keying,
    ``ops/wavefront.py``), only per-pixel float accumulation order
    varies.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, cost scalar
    f32).
    """
    from wasm_pathtracer_tpu.ops import wavefront
    return _queue_sharded(wavefront.render_queue_flat, mesh, prep, scene,
                          settings, camera, pix_queue, width, height,
                          seed, lanes_per_device, rid_base, photon_grid)


def make_train_step(mesh: Mesh, prep: trace.ScenePrep,
                    settings: RenderSettings, width: int, height: int,
                    lr: float = 0.05, spp: int = 1,
                    train_lights: bool = False,
                    train_materials: bool = True,
                    train_camera: bool = True,
                    optimizer=None,
                    photon_grid=None,
                    edge_aware_screen: bool = False) -> Callable:
    """Build the jitted inverse-rendering training step.

    The flagship differentiable workload: render the scene, compare to a
    target image, and descend on the scene's material leaves (albedo,
    emission), the camera pose, and — with ``train_lights`` — the
    area-light GEOMETRY rows (BASELINE config 4: the NEE solid-angle
    estimator ``area * cos_o / d^2 * cos_i`` is differentiable in the
    light vertices).  Discrete path decisions (light pick, RR, BVH hit
    selection) consume RNG that does not depend on the optimized
    parameters, so the per-sample radiance is differentiable w.r.t.
    shading/pdf terms — the detach-discrete/differentiate-shading
    decomposition of BASELINE.json's north star.

    With ``spp >= 2`` the loss is the unbiased squared-bias (two-sample
    cross) estimator — see the comment in ``loss_fn``; with ``spp == 1``
    it degrades to a plain MSE whose gradient also carries the
    estimator-variance term.

    ``train_materials`` / ``train_camera`` / ``train_lights`` select the
    descent leaves.  Joint optimization of emission and light geometry
    is ill-posed from brightness alone (emission x 1/d^2 ambiguity);
    geometry-recovery workloads should freeze the materials.

    ``optimizer``: ``None`` for plain SGD at ``lr`` (the returned step
    is ``(loss, scene, camera) = step(scene, camera, target, seed)``),
    or any ``optax.GradientTransformation`` — geometry losses are
    strongly anisotropic (light-vertex x/z gradients dominate y), so
    noisy-gradient recovery workloads want Adam.  With an optimizer the
    step signature gains the optimizer state:
    ``(loss, scene, camera, opt_state) = step(scene, camera, target,
    seed, opt_state)`` and ``step.init(scene, camera)`` builds the
    initial state.

    ``photon_grid``: enables PNEE-mode training (settings.render_type
    == PNEE); the grid is a detached importance distribution
    (``ops.photon.sample`` stop-gradients the selection pdf, which is
    exactly unbiased — see its docstring).

    ``edge_aware_screen``: route the loss through
    :func:`ops.edges.render_pixels_edgeaware` — the screen-space
    silhouette warp — so camera- and occluder-GEOMETRY gradients carry
    primary-visibility boundary flux (a silhouette sweeping across
    pixels when the camera or geometry moves).  Interior-only
    gradients demonstrably stall on pose-from-image workloads (the
    silhouette problem, SURVEY §7(b)); with the warp the same descent
    recovers the pose.  Requires a dense differentiable prep (same
    contract as ``edges.py``); composes with ``edge_aware_nee`` (which
    rides ``settings``) and with PNEE.

    Per-device gradients over the ray shard are ``psum``-ed over the
    ``rays`` axis inside shard_map; XLA overlaps the all-reduce with the
    backward computation.
    """
    # gradients take the differentiable XLA trace: the forward-only
    # Pallas scene kernel (ScenePrep.use_fused) has no VJP
    prep = dataclasses.replace(prep, use_fused=False)
    if edge_aware_screen and (prep.cluster is not None or prep.has_bvh):
        raise ValueError("edge_aware_screen=True requires the dense "
                         "differentiable trace path (no BVH/cluster "
                         "prep)")
    if train_lights and prep.has_bvh:
        # A BVH prep carries BAKED triangle geometry (bvh_tri_rows):
        # intersections and occlusion would silently use stale light
        # positions while the NEE estimator uses the updated rows.
        raise ValueError("train_lights=True requires a dense or "
                         "cluster ScenePrep (no attached BVH)")
    if train_lights and prep.cluster is not None \
            and prep.cluster.has_baked_lights:
        # Same staleness hazard when the LIGHTS themselves are baked
        # into cluster.blocks.  Mesh-scale light training works when
        # the structure was built with the lights kept in the live
        # dense remainder: attach_clusters(..., exclude_lights=True).
        # The frozen mesh stays baked; the cluster walk's pruning
        # bound is detached (ops/trace.py::_merge_cluster), so the
        # non-reverse-differentiable while_loop stays off the AD path.
        raise ValueError(
            "train_lights=True with a cluster prep requires the lights "
            "OUT of the baked tables — rebuild with "
            "bvh.attach_clusters(..., exclude_lights=True)")
    if train_camera and prep.cluster is not None:
        # camera tangents ride the ray origins/directions INTO the
        # cluster walk's while_loop, which has no reverse-mode rule;
        # pose training keeps the dense prep (where the whole trace is
        # a reverse-differentiable scan)
        raise ValueError("train_camera=True requires a dense ScenePrep "
                         "(the cluster traversal while_loop is not "
                         "reverse-differentiable); pass "
                         "train_camera=False for mesh-scale light/"
                         "material training")
    n_dev = mesh.devices.size
    n_pix = width * height
    n_pad = _pad_to(n_pix, n_dev * 8)
    pix = jnp.arange(n_pad, dtype=jnp.int32)
    px_all = jnp.minimum(pix % width, width - 1)
    py_all = jnp.minimum(pix // width, height - 1)
    valid_all = (pix < n_pix).astype(jnp.float32)
    inv_n = 1.0 / n_pix
    # reverse-mode AD needs the scan-form bounce loop
    settings = settings.replace(early_exit=False)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P(), P(), P("rays"), P("rays"), P()),
        out_specs=(P(), P(), P()),
        check_vma=False)
    def step(px_s, py_s, scene_s, camera_s, target_s, valid_s, seed):
        grid_s = photon_grid   # replicated closure capture (like prep)

        def loss_fn(leaves, camera):
            sc = scene_s
            if train_materials:
                sc = sc.with_materials(albedo=leaves["albedo"],
                                       emission=leaves["emission"])
            if train_lights:
                sc = sc.with_light_rows(leaves["light_rows"])
            if edge_aware_screen:
                from wasm_pathtracer_tpu.ops import edges
                render = edges.render_pixels_edgeaware
            else:
                render = integrator.render_pixels
            cols = []
            for k in range(spp):
                col, _ = render(
                    prep, sc, settings, camera, px_s, py_s, width, height,
                    seed + jnp.uint32((k * 0x9E3779B9) & 0xFFFFFFFF),
                    photon_grid=grid_s)
                cols.append(col)
            # mean over ALL real pixels (pad rows masked): local sum *
            # global 1/N, so psum of grads reconstructs the global gradient
            if spp >= 2:
                # Unbiased squared-bias loss via the two-sample CROSS
                # estimator: with A, B averaged over independent halves,
                # E[(A - t)(B - t)] = (E[col] - t)^2 exactly — the
                # estimator-variance term of a plain MSE cancels between
                # the halves.  A plain single-render MSE rewards
                # VARIANCE reduction as much as bias reduction, so at
                # low spp gradient descent chases whatever dims the
                # image (e.g. pushing a light AWAY); the cross form
                # keeps descent pointed at the true parameters.
                nA = spp // 2
                colA = sum(cols[:nA]) / nA
                colB = sum(cols[nA:]) / (spp - nA)
                err = (colA - target_s) * (colB - target_s)
            else:
                col = cols[0]
                err = (col - target_s) ** 2
            return jnp.sum(valid_s[:, None] * err) * inv_n

        leaves = {}
        if train_materials:
            leaves["albedo"] = scene_s.albedo
            leaves["emission"] = scene_s.emission
        if train_lights:
            leaves["light_rows"] = scene_s.params[scene_s.light_shape]
        if train_camera:
            loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
                leaves, camera_s)
            g_leaves, g_cam = grads
        else:
            # do NOT differentiate w.r.t. the camera when pose is
            # frozen: camera tangents would ride the ray origins into
            # the (non-reverse-differentiable) cluster walk even
            # though the gradient is discarded
            loss, g_leaves = jax.value_and_grad(loss_fn, argnums=0)(
                leaves, camera_s)
            g_cam = jax.tree.map(jnp.zeros_like, camera_s)
        # gradient all-reduce over the ray shards (psum)
        g_leaves = jax.tree.map(lambda g: jax.lax.psum(g, "rays"), g_leaves)
        g_cam = jax.tree.map(lambda g: jax.lax.psum(g, "rays"), g_cam)
        loss = jax.lax.psum(loss, "rays")
        return loss, g_leaves, g_cam

    def _params(scene, camera):
        leaves = {}
        if train_materials:
            leaves["albedo"] = scene.albedo
            leaves["emission"] = scene.emission
        if train_lights:
            leaves["light_rows"] = scene.params[scene.light_shape]
        if train_camera:
            leaves["camera"] = camera
        return leaves

    def _apply(scene, camera, leaves):
        if train_materials:
            scene = scene.with_materials(
                albedo=jnp.clip(leaves["albedo"], 0.0, 1.0),
                emission=jnp.maximum(leaves["emission"], 0.0))
        if train_lights:
            scene = scene.with_light_rows(leaves["light_rows"])
        if train_camera:
            camera = leaves["camera"]
        return scene, camera

    def _grads(scene, camera, target, seed):
        t = target.reshape(-1, 3)
        t = jnp.pad(t, ((0, n_pad - n_pix), (0, 0)))
        loss, g_leaves, g_cam = step(px_all, py_all, scene, camera, t,
                                     valid_all, seed)
        g = dict(g_leaves)
        if train_camera:
            g["camera"] = g_cam
        return loss, g

    if optimizer is None:
        @jax.jit
        def train_step(scene, camera, target, seed):
            loss, g = _grads(scene, camera, target, seed)
            leaves = jax.tree.map(lambda p, gg: p - lr * gg,
                                  _params(scene, camera), g)
            scene, camera = _apply(scene, camera, leaves)
            return loss, scene, camera

        return train_step

    @jax.jit
    def _step_opt(scene, camera, target, seed, opt_state):
        loss, g = _grads(scene, camera, target, seed)
        params = _params(scene, camera)
        updates, opt_state = optimizer.update(g, opt_state, params)
        leaves = jax.tree.map(lambda p, u: p + u, params, updates)
        scene, camera = _apply(scene, camera, leaves)
        return loss, scene, camera, opt_state

    def train_step_opt(scene, camera, target, seed, opt_state):
        return _step_opt(scene, camera, target, seed, opt_state)

    train_step_opt.init = lambda scene, camera: optimizer.init(
        _params(scene, camera))
    return train_step_opt
