"""The wavefront path-tracing integrator.

Re-design of ``RenderInstance::trace_original_color``
(``src/tracer.rs:224-330``).  The reference traces one ray at a time
through an unbounded ``loop`` with early returns; here an entire ray
batch advances bounce-by-bounce under ``lax.scan`` with a static trip
count and an ``alive`` mask — terminated lanes simply stop
contributing, so every bounce is one batched, branch-free step.

The estimator math is identical (each step cites its source):
  - emissive hits add ``throughput * intensity`` only when NEE is off or
    no diffuse bounce happened yet (``tracer.rs:244-254``);
  - cosine-weighted hemisphere sampling with pdf cos/pi
    (``material.rs:97-118``) and brdf albedo/pi (``material.rs:120-126``);
  - area-light NEE with the solid-angle estimator
    ``area * cos_o / d^2 * cos_i / light_chance`` (``tracer.rs:285-311``);
  - Russian roulette on clamped max throughput (``tracer.rs:317-324``);
  - miss adds ``throughput * background`` (``tracer.rs:325-328``).

Extended materials (REFLECT / REFRACT with Fresnel + Beer absorption)
restore the reference's documented pre-conversion capability as masked
branches of the same loop.

Randomness is counter-based: every draw is ``uniform*(seed, ray_id,
slot)`` with one slot per (bounce, purpose) — no mutable RNG state, no
cross-lane coupling, reproducible under any sharding.

Two drivers share the per-bounce body ``_bounce_step``:

- :func:`trace_paths` — fixed batch, all lanes start at bounce 0 and
  the batch advances in lockstep (scan for gradients, while_loop with
  batch early-exit for forward).
- :func:`render_queue` — **persistent wavefront with path
  regeneration**: Russian roulette kills most paths within 2-3 bounces
  (measured museum occupancy: 1.0, 0.52, 0.16, 0.09, ... per bounce),
  so a lockstep loop wastes ~75% of its scene traces on dead lanes.
  Here a lane whose path terminates immediately splats its radiance
  into the frame accumulator and pulls the next sample off a pixel
  queue, keeping every lane of the scene trace live until the
  queue drains.  This is the batched analog of the reference's per-ray
  early return (``tracer.rs:237``): the hardware never idles on a
  finished path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu.models.scene import MatKind, SceneData
from wasm_pathtracer_tpu.models.scene import (
    EXTRA_REFLECTIVITY, EXTRA_IOR, EXTRA_ABSORB_R, EXTRA_ABSORB_B,
)
from wasm_pathtracer_tpu.ops import intersect as isx
from wasm_pathtracer_tpu.ops import trace as tr
from wasm_pathtracer_tpu.utils import rng as rnglib
from wasm_pathtracer_tpu.utils import vecmath as vm

# RNG slot layout: slots [b*8, b*8+8) belong to bounce b; slot 0xFFFF000+
# is reserved for pixel jitter in the driver.
SLOT_JITTER = 0x7FFF0000
_SLOTS_PER_BOUNCE = 8
_SLOT_HEMI = 0
_SLOT_RR = 1
_SLOT_LIGHT_PICK = 2
_SLOT_LIGHT_POINT = 3
_SLOT_PNEE = 4
_SLOT_MAT = 5


def sample_cosine_hemisphere(n, r1, r2):
    """Cosine-weighted hemisphere sample around ``n``
    (``material.rs:97-118``).  Returns (wi, pdf)."""
    two_pi_r1 = 2.0 * jnp.pi * r1
    s = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    x = jnp.cos(two_pi_r1) * s
    y = jnp.sqrt(r2)
    z = jnp.sin(two_pi_r1) * s
    t, b = vm.tangent_frame(n)
    wi = vm.normalize(x[..., None] * t + y[..., None] * n + z[..., None] * b)
    pdf = vm.dot(wi, n) / jnp.pi
    return wi, pdf


def _refract_dir(d, n, eta):
    """Snell refraction of incoming direction ``d`` about ``n``
    (eta = n1/n2).  Returns (dir, total_internal_reflection mask)."""
    cos_i = -vm.dot(d, n)
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.where(sin2_t < 1.0, 1.0 - sin2_t, 1.0))
    cos_t = jnp.where(tir, 0.0, cos_t)
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return vm.normalize(refr, eps=1e-12), tir


def _schlick(cos_i, n1, n2):
    """Schlick's Fresnel approximation."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _light_table(scene: SceneData):
    """Area-light table, gathered per call so gradients reach the
    scene params (``scene.rs:47-66`` registers emissive shapes).

    Packed as ONE (L, 16) row — vertices 0:9, intensity 9:12, shape id
    12 — so the per-lane NEE lookup is a single gather op."""
    lrows = scene.params[scene.light_shape]          # (L, 9)
    lint = scene.emission[scene.light_shape]         # (L, 3)
    lpack = jnp.concatenate(
        [lrows, lint, scene.light_shape[:, None].astype(jnp.float32),
         jnp.zeros((lrows.shape[0], 3), jnp.float32)], axis=1)
    return lpack, max(scene.num_lights, 1)


def _shade_core(prep: tr.ScenePrep, scene: SceneData,
                settings: RenderSettings, light_tab, photon_grid,
                o, d, throughput, color, alive, hdb, absorb,
                slot0, ray_id, seed, t, sid, hit, packed_rows=None):
    """Everything :func:`_bounce_step` does AFTER the scene trace,
    except resolving the NEE occlusion query.

    Shared verbatim by the lockstep drivers (which trace + shade + cast
    the shadow ray in one step) and by :mod:`ops.wavefront` (whose
    flattened loop interleaves per-lane traversal micro-steps with
    shading, so the shadow trace must be *deferred*): factoring it out
    keeps the estimator math in one place and the drivers identical
    per path.

    ``slot0`` is the RNG slot base — a scalar ``b * _SLOTS_PER_BOUNCE``
    under :func:`trace_paths`'s lockstep loop, or a per-lane vector
    where lanes sit at different depths.

    Returns ``(carry', shadow_req)`` where ``carry'`` is the updated
    ``(o, d, throughput, color, alive, hdb, absorb)`` and
    ``shadow_req`` describes the pending NEE occlusion query
    (``None`` when this settings/scene combination casts no shadow
    rays): ``need`` (lanes that must resolve it), ``p_from`` /
    ``p_to`` (surface point / light point), ``light_sid`` (target
    shape, non-occluding) and ``contrib`` (the RGB to add when
    unoccluded, already weighted — ``tracer.rs:303-311``; zero on
    ``~need`` lanes).  Resolve with :func:`_apply_shadow`.
    """
    R = o.shape[0]
    has_nee = settings.has_nee
    use_pnee = settings.render_type == RenderType.PNEE and photon_grid is not None
    eps = settings.epsilon
    lpack, n_lights = light_tab

    shadow_req = None
    sid_c = jnp.maximum(sid, 0)
    # t is +inf on miss; every downstream use takes the sanitized
    # value so no inf/NaN ever enters a masked lane (masked NaNs
    # poison gradients through the 0 * NaN VJP of jnp.where)
    t_safe = jnp.where(hit, t, 1.0)
    info = tr.hit_info(scene, o, d, t_safe, sid_c, packed=packed_rows)

    # Beer-Lambert absorption through the current medium
    # (restored refract capability; no-op when absorb == 0)
    seg = jnp.where(hit, t, 0.0)
    throughput = throughput * jnp.exp(-absorb * seg[..., None])

    hit_point = o + d * t_safe[..., None]
    kind = info["kind"]
    n = info["n"]

    is_emissive = kind == int(MatKind.EMISSIVE)
    is_refract = kind == int(MatKind.REFRACT)
    is_reflect = kind == int(MatKind.REFLECT)

    # --- miss: background, path dies (``tracer.rs:325-328``) ---------
    miss = alive & ~hit
    color = color + jnp.where(miss[..., None],
                              throughput * scene.background[None, :], 0.0)

    # --- emissive hit (``tracer.rs:244-254``) -------------------------
    emis_hit = alive & hit & is_emissive
    if settings.is_debug_photons or has_nee:
        add_emis = emis_hit & ~hdb
    else:
        add_emis = emis_hit
    color = color + jnp.where(add_emis[..., None],
                              throughput * info["emission"], 0.0)

    # --- scatter (non-emissive hits) ----------------------------------
    scat = alive & hit & ~is_emissive
    wo = -d

    r1, r2, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_HEMI)
    um, ur, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_MAT)

    # diffuse branch (``tracer.rs:256-263``)
    wi_d, pdf_d = sample_cosine_hemisphere(n, r1, r2)
    cos_d = vm.dot(wi_d, n)
    f_d = info["albedo"] / jnp.pi
    contrib_d = f_d * (cos_d / jnp.maximum(pdf_d, 1e-12))[..., None]

    # mirror branch
    wi_m = vm.reflect(wo, n)
    contrib_m = info["albedo"]

    # refract branch: Fresnel-weighted reflect/transmit + Beer
    ent = info["is_entering"]
    ior = info["extra"][:, EXTRA_IOR]
    n1 = jnp.where(ent, 1.0, ior)
    n2 = jnp.where(ent, ior, 1.0)
    eta = n1 / jnp.maximum(n2, 1e-12)
    cos_i = jnp.clip(-vm.dot(d, n), 0.0, 1.0)
    wi_t, tir = _refract_dir(d, n, eta)
    fres = jnp.where(tir, 1.0, _schlick(cos_i, n1, n2))
    take_refl_r = ur < fres
    wi_r = jnp.where(take_refl_r[..., None], wi_m, wi_t)
    contrib_r = jnp.ones_like(contrib_m)   # energy split by the sampling

    # choose branch per material kind
    mirror_now = (is_reflect & (um < info["extra"][:, EXTRA_REFLECTIVITY]))
    specular = mirror_now | is_refract
    wi = jnp.where(is_refract[..., None], wi_r,
                   jnp.where(mirror_now[..., None], wi_m, wi_d))
    contrib = jnp.where(is_refract[..., None], contrib_r,
                        jnp.where(mirror_now[..., None], contrib_m,
                                  contrib_d))

    new_tp = throughput * contrib
    # medium tracking for refraction
    absorb_in = info["extra"][:, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1]
    entering_medium = is_refract & ~take_refl_r & ent
    exiting_medium = is_refract & ~take_refl_r & ~ent
    new_absorb = jnp.where(entering_medium[..., None], absorb_in,
                           jnp.where(exiting_medium[..., None], 0.0, absorb))

    diffuse_now = scat & ~specular
    new_hdb = hdb | diffuse_now

    # --- NEE from diffuse scatters (``tracer.rs:267-313``) ------------
    if has_nee and scene.num_lights > 0:
        u_pick = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_PICK)
        if use_pnee:
            from wasm_pathtracer_tpu.ops import photon as ph
            lid, light_chance = ph.sample(photon_grid, hit_point, seed,
                                          ray_id, slot0 + _SLOT_PNEE)
        else:
            lid = jnp.minimum((u_pick[0] * n_lights).astype(jnp.int32),
                              n_lights - 1)
            light_chance = jnp.full((R,), 1.0 / n_lights, jnp.float32)

        lrow = lpack[lid]                         # (R, 16) — ONE gather
        lv = lrow[:, 0:9]
        intensity = lrow[:, 9:12]
        lsid_g = lrow[:, 12].astype(jnp.int32)
        l0, l1, l2 = lv[:, 0:3], lv[:, 3:6], lv[:, 6:9]
        s1, s2, s3 = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_POINT)
        j_nee = None
        if settings.edge_aware_nee:
            # warped-area reparameterization of the light-sample
            # uniforms: light-geometry gradients gain the
            # shadow-boundary (occluder visibility) flux — see
            # ops/edges.py.  Values are preserved (s1/s2 unchanged,
            # j_nee == 1); only theta-derivatives change.
            from wasm_pathtracer_tpu.ops import edges
            s1, s2, j_nee = edges.nee_warp(
                prep, scene, lv, lsid_g, hit_point,
                s1, s2, n_aux=settings.edge_nee_aux,
                radius=settings.edge_nee_radius)
        p_l, n_l = isx.triangle_pick_random(l0, l1, l2, s1, s2, s3)

        to_l = p_l - hit_point
        dis_sq = jnp.maximum(vm.length_sq(to_l), 1e-12)
        to_l = to_l / jnp.sqrt(dis_sq)[..., None]
        cos_i_l = vm.dot(to_l, n)
        cos_o_l = vm.dot(-to_l, n_l)
        front = (cos_i_l > 0.0) & (cos_o_l > 0.0)

        nee_mask = diffuse_now & front
        if settings.is_debug_photons:
            # light-selection debug render (``tracer.rs:297-299``)
            color = color + jnp.where(nee_mask[..., None],
                                      new_tp * intensity, 0.0)
        else:
            light_sid = lsid_g
            area = isx.triangle_area(l0, l1, l2)
            solid_angle = area * cos_o_l / dis_sq
            w = solid_angle * cos_i_l / jnp.maximum(light_chance, 1e-12)
            if j_nee is not None:
                # warp Jacobian (value 1): completes the warped-area
                # estimator d/dtheta [f(T(u)) * |dT/du|]
                w = w * j_nee
            # double-where: zero w on masked lanes BEFORE the
            # multiply so the VJP never sees 0 * non-finite
            w = jnp.where(nee_mask, w, 0.0)
            shadow_req = dict(
                need=nee_mask,
                p_from=hit_point,
                p_to=p_l,
                light_sid=light_sid,
                contrib=new_tp * intensity * w[..., None],
            )

    # --- Russian roulette (``tracer.rs:317-324``) ----------------------
    u_rr = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_RR)[0]
    keep = jnp.clip(jnp.max(new_tp, axis=-1),
                    settings.rr_clamp_min, settings.rr_clamp_max)
    survive = u_rr < keep
    new_tp = new_tp / keep[..., None]

    new_alive = scat & survive
    o2 = hit_point + wi * eps
    # keep rays unchanged on dead lanes (their values are masked anyway)
    o = jnp.where(scat[..., None], o2, o)
    d = jnp.where(scat[..., None], wi, d)
    throughput = jnp.where(scat[..., None], new_tp, throughput)
    absorb = jnp.where(scat[..., None], new_absorb, absorb)
    hdb = jnp.where(scat, new_hdb, hdb)
    alive = new_alive

    return (o, d, throughput, color, alive, hdb, absorb), shadow_req


def _apply_shadow(color, shadow_req, occluded):
    """Fold a resolved NEE occlusion query into the radiance
    (``tracer.rs:303-311``: add only when the shadow ray is clear)."""
    add = shadow_req["need"] & ~occluded
    return color + jnp.where(add[..., None], shadow_req["contrib"], 0.0)


def _bounce_step(prep: tr.ScenePrep, scene: SceneData,
                 settings: RenderSettings, light_tab, photon_grid,
                 o, d, throughput, color, alive, hdb, absorb,
                 slot0, ray_id, seed, packed_rows=None):
    """One lockstep wavefront bounce over a ray batch: scene trace,
    :func:`_shade_core`, and the NEE shadow ray resolved inline.

    Returns the updated ``(o, d, throughput, color, alive, hdb,
    absorb)`` carry plus this step's per-lane test count (already
    masked by ``alive``).
    """
    t, sid, hit, c = tr.trace_scene(prep, scene, o, d)
    step_cost = jnp.where(alive, c, 0)
    carry, shadow_req = _shade_core(
        prep, scene, settings, light_tab, photon_grid,
        o, d, throughput, color, alive, hdb, absorb,
        slot0, ray_id, seed, t, sid, hit, packed_rows=packed_rows)
    if shadow_req is not None:
        o2, d2, tp2, color2, alive2, hdb2, absorb2 = carry
        occluded, sc = tr.shadow_ray(prep, scene, shadow_req["p_from"],
                                     shadow_req["p_to"],
                                     shadow_req["light_sid"],
                                     settings.epsilon)
        step_cost = step_cost + jnp.where(shadow_req["need"], sc, 0)
        color2 = _apply_shadow(color2, shadow_req, occluded)
        carry = (o2, d2, tp2, color2, alive2, hdb2, absorb2)
    return carry, step_cost


def trace_paths(prep: tr.ScenePrep, scene: SceneData,
                settings: RenderSettings, o, d, ray_id, seed,
                photon_grid=None):
    """Trace a batch of paths to radiance.

    Args:
      o, d: (R,3) primary ray origins/directions.
      ray_id: (R,) uint32 unique path ids (pixel id is fine).
      seed: scalar uint32 folding session seed + sample round.
      photon_grid: optional ``ops.photon.PhotonGrid`` for PNEE.

    Returns (color (R,3), cost (R,) int32 primitive/node tests).
    """
    R = o.shape[0]
    light_tab = _light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)    # loop-invariant, built once

    def bounce(carry, b):
        o, d, throughput, color, alive, hdb, absorb, cost = carry
        slot0 = b * _SLOTS_PER_BOUNCE
        (o, d, throughput, color, alive, hdb, absorb), step_cost = \
            _bounce_step(prep, scene, settings, light_tab, photon_grid,
                         o, d, throughput, color, alive, hdb, absorb,
                         slot0, ray_id, seed, packed_rows=packed_rows)
        cost = cost + step_cost
        return (o, d, throughput, color, alive, hdb, absorb, cost), None

    init = (
        o, d,
        jnp.ones((R, 3), jnp.float32),    # throughput
        jnp.zeros((R, 3), jnp.float32),   # color
        jnp.ones((R,), bool),             # alive
        jnp.zeros((R,), bool),            # has_diffuse_bounced
        jnp.zeros((R, 3), jnp.float32),   # medium absorption
        jnp.zeros((R,), jnp.int32),       # cost
    )

    if settings.early_exit:
        # while_loop, not scan: RR kills most paths within a few
        # bounces, so the batch usually terminates long before
        # max_bounces — the early exit skips whole scene traces (the
        # dominant cost).  The reference's per-ray loop exits per ray
        # (``tracer.rs:237``); in lockstep the batch exits when its
        # last path dies.  while_loop is not reverse-differentiable, so
        # gradient workloads set early_exit=False and take the scan.
        def w_cond(state):
            b, carry = state
            alive = carry[4]
            return (b < jnp.uint32(settings.max_bounces)) & jnp.any(alive)

        def w_body(state):
            b, carry = state
            carry, _ = bounce(carry, b)
            return b + jnp.uint32(1), carry

        _, carry = jax.lax.while_loop(w_cond, w_body, (jnp.uint32(0), init))
    else:
        body = bounce
        if settings.checkpoint_bounces:
            # remat each bounce in the backward pass: the scan's saved
            # residuals otherwise hold every bounce's full trace
            # intermediates (O(max_bounces * R * scene) memory); with
            # checkpointing only the (R,)-sized carries are stored and
            # each bounce recomputes its forward during the VJP —
            # trading ~2x bounce FLOPs for O(max_bounces)x less HBM
            body = jax.checkpoint(bounce)
        carry, _ = jax.lax.scan(body, init,
                                jnp.arange(settings.max_bounces,
                                           dtype=jnp.uint32))
    _, _, _, color, _, _, _, cost = carry
    return color, cost


def render_pixels(prep, scene, settings: RenderSettings, camera: Camera,
                  px, py, width: int, height: int, seed,
                  photon_grid=None):
    """One radiance sample for each pixel in (px, py).

    Jittered within the pixel (``tracer.rs:181-183``), then path-traced.
    Returns (color (R,3), cost (R,)).
    """
    ray_id = (py * width + px).astype(jnp.uint32)
    jx, jy, _ = rnglib.uniform3(seed, ray_id, SLOT_JITTER)
    o, d = primary_rays(camera, px, py, jx, jy, width, height,
                        settings.screen_z)
    return trace_paths(prep, scene, settings, o, d, ray_id, seed,
                       photon_grid=photon_grid)


def render_queue(prep, scene, settings: RenderSettings, camera: Camera,
                 pix_queue, width: int, height: int, seed, n_lanes: int,
                 photon_grid=None, rid_base=0, return_iters=False):
    """Persistent wavefront: path-trace every sample in ``pix_queue``.

    Each of ``n_lanes`` SPMD lanes owns one in-flight path; the moment a
    path terminates (miss / emissive absorption / Russian roulette /
    bounce cap) the lane splats its radiance into the frame accumulator
    and **regenerates**: it claims the next queue slot and shoots that
    pixel's primary ray in the very next iteration.  Every scene trace
    therefore runs at ~full lane occupancy, vs ~25% for the lockstep
    batch loop on the museum workload (per-bounce survival 1.0 / 0.52 /
    0.16 / 0.09 / ...).

    Path ``i``'s random stream is keyed by ``ray_id = i`` (its queue
    index), so the result is a pure function of (queue, seed) —
    independent of lane count, iteration order, or device layout.

    Forward-only (uses ``lax.while_loop``); gradient workloads keep
    :func:`trace_paths` under scan.

    Args:
      pix_queue: (S,) int32 pixel ids (y * width + x) — the sample list,
        e.g. from the adaptive sampler or a uniform sweep.
      n_lanes: wavefront width (static).
      rid_base: offset added to the queue index when keying each path's
        RNG stream — lets concurrent renderers over the same seed (the
        session's left/right halves) draw decorrelated streams.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, lane_cost
    (n_lanes,) int32 per-lane primitive-test counts) — accumulate the
    image as ``accum.write_sums(color_sum, n_samples)`` and the cost
    metric as a host-side int64 sum of ``lane_cost`` (keeping the
    counter exact on long renders, where a float accumulator would
    round past 2^24).
    """
    S = pix_queue.shape[0]
    B = n_lanes
    HW = width * height

    def _ret(acc, cnt, cost, its):
        if return_iters:
            return acc, cnt, cost, its
        return acc, cnt, cost

    if S == 0:
        # empty queue: nothing to trace (the gather in gen() would
        # otherwise index a zero-length array)
        return _ret(jnp.zeros((HW, 3), jnp.float32),
                    jnp.zeros((HW,), jnp.int32),
                    jnp.zeros((B,), jnp.int32), jnp.int32(0))
    if settings.max_bounces == 0:
        # degenerate cap: zero bounces contribute nothing (trace_paths'
        # scan runs zero steps and returns black); the queue driver's
        # post-increment done-check would otherwise run one full bounce
        counts = jnp.zeros((HW,), jnp.int32).at[pix_queue].add(1)
        return _ret(jnp.zeros((HW, 3), jnp.float32), counts,
                    jnp.zeros((B,), jnp.int32), jnp.int32(0))
    light_tab = _light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)    # loop-invariant, built once
    # lane ring capacity: ceil(S/B) guarantees no stranded queue slot
    # (all lanes capped implies B*K >= S paths recorded); slack covers
    # lane imbalance.  See the deferred-accumulation note below.
    K = -(-S // B)
    K += max(2, K // 2)

    def _ray_of(pid, sidx):
        """Primary ray for pixel ``pid`` / queue slot ``sidx``."""
        rid = jnp.uint32(rid_base) + sidx.astype(jnp.uint32)
        px = pid % width
        py = pid // width
        jx, jy, _ = rnglib.uniform3(seed, rid, SLOT_JITTER)
        o, d = primary_rays(camera, px, py, jx, jy, width, height,
                            settings.screen_z)
        return pid, rid, o, d

    def gen(sidx):
        """Primary ray for queue slot ``sidx`` (clamped; masked later)."""
        return _ray_of(pix_queue[jnp.clip(sidx, 0, S - 1)], sidx)

    # in-loop regen avoids the full-queue gather: claimed slots are the
    # contiguous range [issued, issued + n), so ONE dynamic slice pulls
    # the next B entries and a rank-indexed pick from that B-block
    # distributes them.  Padding rows carry the HW drop sentinel and
    # are never claimed.
    pixq_pad = jnp.concatenate([pix_queue, jnp.full((B,), HW, jnp.int32)])

    def gen_contig(issued, ranks):
        block = jax.lax.dynamic_slice(
            pixq_pad, (jnp.clip(issued, 0, S),), (B,))
        pid = jnp.minimum(block[jnp.clip(ranks, 0, B - 1)], HW)
        return _ray_of(pid, issued + ranks)

    sidx0 = jnp.arange(B, dtype=jnp.int32)
    pid0, rid0, o0, d0 = gen(sidx0)
    state = dict(
        issued=jnp.int32(min(B, S)),
        o=o0, d=d0,
        tp=jnp.ones((B, 3), jnp.float32),
        col=jnp.zeros((B, 3), jnp.float32),
        alive=sidx0 < S,
        hdb=jnp.zeros((B,), bool),
        absorb=jnp.zeros((B, 3), jnp.float32),
        bounce=jnp.zeros((B,), jnp.uint32),
        pid=pid0, rid=rid0,
        # deferred frame records: finished paths record into a
        # lane-local ring via a dense one-hot write, and ONE scatter
        # after the loop folds the records into the frame (no scatter
        # inside the loop body).
        ring_col=jnp.zeros((K, B, 3), jnp.float32),
        ring_pid=jnp.full((K, B), HW, jnp.int32),   # HW = drop sentinel
        k_lane=jnp.zeros((B,), jnp.int32),
        # per-lane int32 cost: exact (a scalar f32 accumulator rounds
        # past 2^24); callers reduce host-side in int64
        cost=jnp.zeros((B,), jnp.int32),
        # outer-loop iteration count (a full-width trace runs every
        # iteration regardless of lane liveness)
        it=jnp.int32(0),
    )

    def cond(st):
        return jnp.any(st["alive"])

    def body(st):
        was = st["alive"]
        slot0 = st["bounce"] * _SLOTS_PER_BOUNCE
        (o, d, tp, col, alive, hdb, absorb), step_cost = _bounce_step(
            prep, scene, settings, light_tab, photon_grid,
            st["o"], st["d"], st["tp"], st["col"], was, st["hdb"],
            st["absorb"], slot0, st["rid"], seed,
            packed_rows=packed_rows)
        cost = st["cost"] + step_cost
        bounce = st["bounce"] + jnp.uint32(1)

        # a path is done when it died this step or hit the bounce cap
        done = was & (~alive | (bounce >= jnp.uint32(settings.max_bounces)))
        alive = alive & ~done

        # record finished paths into the lane ring (dense one-hot write)
        sel = (jax.lax.broadcasted_iota(jnp.int32, (K, B), 0)
               == st["k_lane"][None, :]) & done[None, :]
        ring_col = jnp.where(sel[..., None], col[None], st["ring_col"])
        ring_pid = jnp.where(sel, st["pid"][None], st["ring_pid"])
        k_lane = st["k_lane"] + done.astype(jnp.int32)

        # regenerate: finished lanes with ring capacity left claim the
        # next queue slots in lane order (deterministic)
        claimable = done & (k_lane < K)
        ranks = jnp.cumsum(claimable.astype(jnp.int32)) - 1
        new_sidx = st["issued"] + ranks
        can = claimable & (new_sidx < S)
        issued = jnp.minimum(
            st["issued"] + jnp.sum(claimable.astype(jnp.int32)), S)
        pid_n, rid_n, o_n, d_n = gen_contig(st["issued"], ranks)

        canc = can[:, None]
        return dict(
            issued=issued,
            o=jnp.where(canc, o_n, o),
            d=jnp.where(canc, d_n, d),
            tp=jnp.where(canc, 1.0, tp),
            col=jnp.where(canc, 0.0, col),
            alive=alive | can,
            hdb=jnp.where(can, False, hdb),
            absorb=jnp.where(canc, 0.0, absorb),
            bounce=jnp.where(can, jnp.uint32(0), bounce),
            pid=jnp.where(can, pid_n, st["pid"]),
            rid=jnp.where(can, rid_n, st["rid"]),
            ring_col=ring_col, ring_pid=ring_pid, k_lane=k_lane,
            cost=cost,
            it=st["it"] + 1,
        )

    st = jax.lax.while_loop(cond, body, state)
    # the ONE frame scatter: unwritten ring slots carry the HW sentinel
    # and drop; a sharded caller's queue-pad paths (pixel id >= H*W)
    # drop the same way
    rp = st["ring_pid"].reshape(-1)
    accum = jnp.zeros((HW, 3), jnp.float32).at[rp].add(
        st["ring_col"].reshape(-1, 3), mode="drop")
    counts = jnp.zeros((HW,), jnp.int32).at[rp].add(1, mode="drop")
    return _ret(accum, counts, st["cost"], st["it"])


def trace_depth(prep, scene, o, d):
    """Grayscale depth render (``tracer.rs:205-213``)."""
    t, _, hit, cost = tr.trace_scene(prep, scene, o, d)
    return jnp.where(hit, t, jnp.inf), cost


def trace_bvh_cost(prep, scene, o, d):
    """BVH-cost render: primitive/node tests per primary ray
    (``tracer.rs:216-219``, ``scene.rs:137-144``)."""
    _, _, _, cost = tr.trace_scene(prep, scene, o, d)
    return cost
