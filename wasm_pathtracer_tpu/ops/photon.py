"""Photon-guided next-event estimation (PNEE) on a flat grid.

The reference implements PNEE with an adaptive octree whose every node
carries an empirical PDF over light ids, sampled with stochastic
per-axis neighbor selection and an exact trilinearly-interpolated pdf
(``src/data/photon_tree.rs``, adapted from Mikolajewski's thesis).  A
pointer-chasing octree cannot vectorize; the batched equivalent is a
**flat dense grid** of per-cell light histograms:

- photon deposition is one ``scatter-add`` over the whole photon batch
  (replacing per-photon ``Octree::insert``, ``photon_tree.rs:165-196``);
- cell lookup is arithmetic, not tree descent;
- the trilinear-by-sampling scheme and the 8-neighbor interpolated pdf
  (``photon_tree.rs:90-158``) translate directly — per-axis own-cell
  weight ``1 - |u - 0.5|`` with stochastic neighbor choice, then an
  exact pdf sum over the 8 cells, so the estimator stays unbiased.

Histogram bins start at 1.0 so no light ever has probability zero,
matching ``EmpiricalPDF::new`` (``src/math/empirical_pdf.rs:4-28``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.models.scene import MatKind, SceneData
from wasm_pathtracer_tpu.ops import intersect as isx
from wasm_pathtracer_tpu.ops import trace as tr
from wasm_pathtracer_tpu.utils import rng as rnglib
from wasm_pathtracer_tpu.utils import vecmath as vm


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhotonGrid:
    bins: jax.Array       # (res^3, L) f32 intensity histogram (init 1.0)
    lo: jax.Array         # (3,) grid lower corner
    hi: jax.Array         # (3,) grid upper corner
    num_photons: jax.Array  # () int32 photons deposited so far
    res: int = _field(metadata=dict(static=True), default=32)

    @staticmethod
    def create(num_lights: int, lo, hi, res: int = 32) -> "PhotonGrid":
        n = res ** 3
        return PhotonGrid(
            bins=jnp.ones((n, max(num_lights, 1)), jnp.float32),
            lo=jnp.asarray(lo, jnp.float32),
            hi=jnp.asarray(hi, jnp.float32),
            num_photons=jnp.zeros((), jnp.int32),
            res=res,
        )


_SLOT_EMIT_PICK = 0
_SLOT_EMIT_POINT = 1
_SLOT_EMIT_DIR = 2


def _cell_coords(grid: PhotonGrid, p):
    """Continuous grid coordinates and integer cell of a point."""
    ext = grid.hi - grid.lo
    u = (p - grid.lo) / ext * grid.res                 # (..., 3) in [0, res]
    c = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, grid.res - 1)
    return u, c


def _cell_index(grid: PhotonGrid, c):
    return (c[..., 0] * grid.res + c[..., 1]) * grid.res + c[..., 2]


def _uniform_hemisphere(n, u1, u2):
    """Uniform direction on the hemisphere around ``n``.

    Replaces the reference's rejection sampler
    (``src/rng.rs:50-68``: uniform sphere point, sign-flipped to the
    hemisphere) with the equivalent closed form.
    """
    z = 2.0 * u1 - 1.0
    phi = 2.0 * jnp.pi * u2
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    v = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    flip = vm.dot(v, n) < 0.0
    return jnp.where(flip[..., None], -v, v)


def emit_photons(grid: PhotonGrid, prep: tr.ScenePrep, scene: SceneData,
                 settings, seed, batch: int) -> PhotonGrid:
    """Shoot one batch of photons and scatter them into the grid.

    Mirrors ``RenderInstance::preprocess_photons`` (``tracer.rs:126-152``):
    pick a random area light, a random surface point, a uniform
    hemisphere direction; trace; deposit
    ``(ln . dir) * max(intensity_rgb)`` at the hit point when the hit is
    diffuse.  Photons are only *counted* when they land (``tracer.rs:109``).
    """
    L = max(scene.num_lights, 1)
    pid = jnp.arange(batch, dtype=jnp.uint32)

    u_pick = rnglib.uniform3(seed, pid, _SLOT_EMIT_PICK)[0]
    lid = jnp.minimum((u_pick * L).astype(jnp.int32), L - 1)
    lsid = scene.light_shape[lid]
    lrows = scene.params[lsid]
    s1, s2, s3 = rnglib.uniform3(seed, pid, _SLOT_EMIT_POINT)
    p_l, ln = isx.triangle_pick_random(lrows[:, 0:3], lrows[:, 3:6],
                                       lrows[:, 6:9], s1, s2, s3)
    d1, d2, _ = rnglib.uniform3(seed, pid, _SLOT_EMIT_DIR)
    d = _uniform_hemisphere(ln, d1, d2)
    o = p_l + d * settings.epsilon

    t, sid, hit, _ = tr.trace_scene(prep, scene, o, d)
    info = tr.hit_info(scene, o, d, jnp.where(hit, t, 1.0),
                       jnp.maximum(sid, 0))
    diffuse = hit & (info["kind"] == int(MatKind.DIFFUSE))

    hp = o + d * t[..., None] + info["n"] * settings.epsilon
    intensity = scene.emission[lsid]
    w = vm.dot(ln, d) * jnp.max(intensity, axis=-1)

    _, c = _cell_coords(grid, hp)
    cell = _cell_index(grid, c)
    w = jnp.where(diffuse, w, 0.0)
    bins = grid.bins.at[cell, lid].add(w)
    return dataclasses.replace(
        grid, bins=bins,
        num_photons=grid.num_photons + jnp.sum(diffuse).astype(jnp.int32))


def sample(grid: PhotonGrid, p, seed, ray_id, slot):
    """Sample a light id for shading point ``p``; returns (lid, pdf).

    Implements ``PhotonTree::sample`` (``photon_tree.rs:80-159``) on the
    flat grid: per-axis stochastic own/adjacent cell choice with weight
    ``1 - |u - 0.5|`` (the linear interpolation weights the reference
    derives at ``photon_tree.rs:90-124``), CDF sampling of the chosen
    cell, then the exact pdf as the trilinear combination over all 8
    neighbor cells.
    """
    L = grid.bins.shape[1]
    u, c = _cell_coords(grid, p)
    frac = u - c.astype(jnp.float32)                   # position in cell [0,1]

    # own-cell weight per axis; adjacent offset direction per axis
    w_own = 1.0 - jnp.abs(frac - 0.5)                  # (..., 3)
    off = jnp.where(frac > 0.5, 1, -1).astype(jnp.int32)

    u1, u2, u3 = rnglib.uniform3(seed, ray_id, slot)
    # slot+2 (not +1) keeps clear of the integrator's material slot
    u4 = rnglib.uniform3(seed, ray_id, slot + 2)[0]
    pick_own = jnp.stack([u1, u2, u3], axis=-1) <= w_own

    c_sel = jnp.clip(c + jnp.where(pick_own, 0, off), 0, grid.res - 1)
    cell_sel = _cell_index(grid, c_sel)

    # Per-CELL tables, computed from the (static-per-dispatch) bins —
    # loop-invariant, so XLA hoists them out of the render loop.  The
    # per-event work then drops from 9 row gathers + a (lanes, L)
    # cumsum + 8 (lanes, L) row sums to ONE row gather + 8 scalar
    # gathers (r05; values bit-identical — same per-row op sequence).
    cdf_tab = jnp.cumsum(grid.bins, axis=-1)            # (cells, L)
    sum_tab = jnp.sum(grid.bins, axis=-1)               # (cells,)
    norm_flat = (grid.bins / sum_tab[:, None]).reshape(-1)

    cdf = cdf_tab[cell_sel]                             # (..., L)
    total = cdf[..., -1:]
    r = u4[..., None] * total
    lid = jnp.minimum(jnp.sum(cdf < r, axis=-1), L - 1).astype(jnp.int32)

    # exact pdf over the 8 neighbors (``photon_tree.rs:141-158``)
    pdf = jnp.zeros(p.shape[:-1], jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sel = jnp.array([dx, dy, dz], jnp.int32)
                cc = jnp.clip(c + off * sel[None, :], 0, grid.res - 1)
                cell = _cell_index(grid, cc)
                prob = norm_flat[cell * L + lid]
                w = jnp.prod(jnp.where(sel[None, :] == 0, w_own, 1.0 - w_own),
                             axis=-1)
                pdf = pdf + prob * w

    # outside the grid: uniform selection (``photon_tree.rs:83-85``)
    outside = jnp.any((p < grid.lo) | (p > grid.hi), axis=-1)
    uni_lid = jnp.minimum((u4 * L).astype(jnp.int32), L - 1)
    lid = jnp.where(outside, uni_lid, lid)
    pdf = jnp.where(outside, 1.0 / L, pdf)
    # Detach the pdf: it is the light-SELECTION distribution, and for
    # any FIXED selection distribution q the NEE estimator f/q is
    # unbiased, so grad E[f/q] = grad(sum_l f_l) flows exactly through
    # f alone (the solid-angle contribution).  Differentiating through
    # q would instead add the partial score term E[f * d(1/q)] =
    # -sum_l f_l dq_l / q_l, which is NOT zero in expectation on its
    # own (it only cancels when paired with a matching score-function
    # term this estimator does not sample) — detaching q is what keeps
    # the gradient unbiased, not a variance trade.
    return lid, jax.lax.stop_gradient(pdf)


def grid_bounds_for_scene(scene: SceneData, settings):
    """Grid bounds: the scene's finite AABB (padded) when
    ``photon_grid_fit_scene`` is set, else the reference's fixed
    +-``photon_world_size`` box (``photon_tree.rs:52-54``)."""
    import numpy as np
    from wasm_pathtracer_tpu.models.scene import finite_aabb
    if settings.photon_grid_fit_scene:
        lo, hi = finite_aabb(scene)
        # Infinite planes contribute nothing to the finite AABB, yet
        # most photons land on them (floors/walls), so pad every axis
        # by half the largest extent (at least 1 unit).  The estimator
        # is unbiased for any cell layout; tight-but-covering bounds
        # just give better guidance than the reference's fixed +-1024
        # box (``photon_tree.rs:52-54``).
        ext = float(np.max(hi - lo))
        pad = np.float32(max(0.5 * ext, 1.0))
        return lo - pad, hi + pad
    s = settings.photon_world_size
    return (np.full(3, -s, np.float32), np.full(3, s, np.float32))
