"""Edge-aware (silhouette) gradients via warped-area reparameterization.

The interior-term gradients of :mod:`ops.integrator` differentiate the
shading/pdf terms but treat every DISCRETE visibility event as a
constant: which primitive a ray hits, and whether a shadow ray is
occluded.  Finite differences additionally pick up the motion of those
discontinuities — silhouettes sweeping across pixels when the camera
or geometry moves, shadow boundaries sweeping across the light-sample
domain when an area light moves.  This module supplies the missing
BOUNDARY terms (the north star's "reparameterized edge-aware
sampling", BASELINE.json:5; SURVEY §7 hard part (b)) with the
warped-area method: instead of sampling boundary curves explicitly,
each sample's integration variable is reparameterized by a
value-preserving warp ``T(u, theta) = u + V - stop_grad(V)`` whose
theta-velocity matches the velocity of nearby discontinuities, plus
the Jacobian factor ``det dT/du`` (value 1).  Autodiff of
``L(T(u)) * J`` then yields interior + boundary terms together:
by change of variables the warped integral IS the true integral for
every theta, so its a.e.-pointwise derivative is an unbiased gradient
estimator up to the warp's boundary-consistency error.

Two warps:

- :func:`render_pixels_edgeaware` — SCREEN-space warp for primary
  visibility.  The warp field is a boundary-weighted average of the
  screen velocities of auxiliary primary hits: each aux hit point is
  re-expressed in surface-attached coordinates (barycentric for
  triangles, center+radius*normal for spheres, translation for the
  rest), so moving geometry moves the attached point, and a moving
  camera moves its projection — the screen velocity of
  geometry-attached content, which on a silhouette equals the
  silhouette's own screen velocity.  Weights concentrate on
  near-boundary samples (grazing |n.d| for curved primitives,
  barycentric edge proximity for triangles), making the field approach
  the correct boundary velocity where it matters.

- the NEE warp (:func:`nee_warp`, applied inside the integrator's NEE
  block when ``RenderSettings.edge_aware_nee``) — warps the area-light
  sample uniforms ``(r1, r2)``.  The discontinuity in that domain is
  the occluder's shadow: the warp velocity at a near-boundary sample
  is the motion, in uniform space, of the point where the ray from the
  shading point through the occluder's silhouette pierces the (moving)
  light plane.  Silhouette proximity and nearest-silhouette points are
  computed per occluder family: spheres exactly from the
  closest-approach geometry — from BOTH sides of the boundary — tori
  from the signed minimum of their SDF along the segment (the museum
  flagship's occluders are all tori, ``src/scenes.rs:15-52``),
  triangles from their edges, and aarect boxes / squares from their
  outline edges.  Only infinite planes have no silhouette term (no
  outline exists).

Both warps are value-preserving: forward radiance is unchanged
(bit-identical modulo float reassociation); only gradients change.
Differentiation requires the jvp-able dense trace path (no
while_loop): a dense ``ScenePrep`` without BVH/cluster/Pallas, the
same requirement as the scan-form integrator.

The reference has no analog (it is not differentiable at all); the
capability target is BASELINE.json's north star.  Method lineage:
warped-area sampling (Bangaru et al. 2020) adapted to this renderer's
primitive families and its counter-RNG sample parameterization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.models.camera import Camera
from wasm_pathtracer_tpu.models.scene import PrimType
from wasm_pathtracer_tpu.utils import rng as rnglib
from wasm_pathtracer_tpu.utils import vecmath as vm

sg = jax.lax.stop_gradient

_B_MISS = 1.0        # boundary test for rays that hit nothing
_B_EPS = 1e-3        # weight regularizer: w = kernel / (B^2 + eps)
_T_FAR = 1e3         # attachment distance for miss "hits"


def _aux_offsets(n_aux: int, radius: float):
    """Fixed aux-sample pattern: ``n_aux`` points on two rings (no
    center point — a zero-offset sample would see B -> 0 exactly when
    the primary sample sits on a silhouette and dominate the average
    with its own velocity, which is fine, but its weight singularity
    hurts conditioning).  Deterministic: the warp is a pure function of
    the sample position."""
    k = jnp.arange(n_aux, dtype=jnp.float32)
    ang = 2.0 * jnp.pi * (k / n_aux) + 0.5
    r = jnp.where(k % 2 == 0, 1.0, 0.55) * radius
    return jnp.stack([r * jnp.cos(ang), r * jnp.sin(ang)], axis=-1)  # (K,2)


def _rays_from_screen(camera: Camera, ux, uy, width, height, screen_z):
    """Primary rays from CONTINUOUS pixel coordinates (the
    ``primary_rays`` formula, ``src/tracer.rs:178-193``, with
    ``px + jx`` fused into one float)."""
    fw = jnp.float32(width)
    fh = jnp.float32(height)
    ar = fw / fh
    fx = (ux / fw - 0.5) * ar
    fy = 0.5 - uy / fh
    pixel = jnp.stack([fx, fy, jnp.full_like(fx, screen_z)], axis=-1)
    d = vm.normalize(pixel)
    d = vm.rot_x(d, camera.rot_x)
    d = vm.rot_y(d, camera.rot_y)
    o = jnp.broadcast_to(camera.location, d.shape)
    return o, d


def project_screen(camera: Camera, x, width, height, screen_z):
    """World point -> continuous pixel coordinates (the exact inverse
    of the primary-ray construction)."""
    p = x - camera.location
    p = vm.rot_y(p, -camera.rot_y)
    p = vm.rot_x(p, -camera.rot_x)
    z = jnp.maximum(p[..., 2], 1e-6)
    ar = jnp.float32(width) / jnp.float32(height)
    fx = p[..., 0] / z * screen_z
    fy = p[..., 1] / z * screen_z
    ux = (fx / ar + 0.5) * width
    uy = (0.5 - fy) * height
    return jnp.stack([ux, uy], axis=-1)


def _barycentric(x, v0, v1, v2):
    """Barycentric coordinates of ``x`` w.r.t. a triangle (projected
    onto the triangle's plane)."""
    e1 = v1 - v0
    e2 = v2 - v0
    w = x - v0
    d11 = vm.dot(e1, e1)
    d12 = vm.dot(e1, e2)
    d22 = vm.dot(e2, e2)
    dw1 = vm.dot(w, e1)
    dw2 = vm.dot(w, e2)
    den = d11 * d22 - d12 * d12
    den = jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
    b1 = (d22 * dw1 - d12 * dw2) / den
    b2 = (d11 * dw2 - d12 * dw1) / den
    return 1.0 - b1 - b2, b1, b2


def _attached_point(scene, scene0, sid, x0):
    """Re-express hit point ``x0`` in surface-attached coordinates.

    Value == ``x0``; the expression carries the GEOMETRY-parameter
    derivatives of the attached surface point (content motion):
    triangles by frozen barycentrics, spheres by frozen unit offset
    from the center, everything else by translation of its anchor row.
    ``scene0`` is the theta-detached twin of ``scene`` used for the
    frozen coordinates (everything built from it is theta-free but
    still differentiable in the aux-sample position).
    """
    sidc = jnp.maximum(sid, 0)
    rows = scene.params[sidc]
    rows0 = scene0.params[sidc]
    pt = scene0.ptype[sidc]

    # triangle: frozen barycentrics on the moving vertices
    b0, b1, b2 = _barycentric(x0, rows0[:, 0:3], rows0[:, 3:6],
                              rows0[:, 6:9])
    x_tri = (b0[..., None] * rows[:, 0:3] + b1[..., None] * rows[:, 3:6]
             + b2[..., None] * rows[:, 6:9])

    # sphere: frozen unit offset on the moving center/radius
    c0 = rows0[:, 0:3]
    r0 = jnp.maximum(rows0[:, 3], 1e-9)
    nbar = (x0 - c0) / r0[..., None]
    x_sph = rows[:, 0:3] + rows[:, 3:4] * nbar

    # default: rigid translation with the anchor point (plane point,
    # torus/aarect/square anchor)
    x_tr = x0 + (rows[:, 0:3] - rows0[:, 0:3])

    is_tri = (pt == int(PrimType.TRIANGLE))[..., None]
    is_sph = (pt == int(PrimType.SPHERE))[..., None]
    x_att = jnp.where(is_tri, x_tri, jnp.where(is_sph, x_sph, x_tr))
    # miss: the far point is scene-free (attached to the background)
    return jnp.where((sid < 0)[..., None], x0, x_att)


def _boundary_test(scene0, sid, x0, d0, n0):
    """Silhouette proximity B >= 0 (-> 0 at a silhouette) for aux hits.

    Curved families (sphere/torus) and the plane horizon: |n.d|.
    Triangles: min barycentric edge distance (every edge of a loose
    triangle is an outline).  AARect boxes / squares: distance from
    the hit point to the nearest outline edge, normalized by the
    primitive's own extent (their screen silhouettes are their
    edges).  Misses: far from any boundary.
    """
    sidc = jnp.maximum(sid, 0)
    pt = scene0.ptype[sidc]
    rows0 = scene0.params[sidc]
    b_curved = jnp.abs(vm.dot(n0, d0))
    b0, b1, b2 = _barycentric(x0, rows0[:, 0:3], rows0[:, 3:6],
                              rows0[:, 6:9])
    b_tri = jnp.clip(jnp.minimum(jnp.minimum(b0, b1), b2), 0.0, 1.0)
    # aarect: distance to the nearest of the three slab boundaries,
    # per axis min(|x - bmin|, |bmax - x|), each normalized by ITS OWN
    # axis extent (a shared max-extent norm would saturate B ~ 0 over
    # entire faces of elongated boxes like the museum divider rails,
    # 0.2 x 3 x 40).  The hit lies ON one face, so that axis
    # contributes ~0; the SECOND-smallest normalized distance -> 0
    # only near an actual outline edge.
    bmin, bmax = rows0[:, 0:3], rows0[:, 3:6]
    dax = jnp.minimum(jnp.abs(x0 - bmin), jnp.abs(bmax - x0))  # (N,3)
    ext = jnp.maximum(bmax - bmin, 1e-6)                       # (N,3)
    d_sorted = jnp.sort(dax / ext, axis=-1)
    b_rect = jnp.clip(d_sorted[..., 1], 0.0, 1.0)
    # square: chebyshev distance from the outline in the y-plane
    half = jnp.maximum(0.5 * rows0[:, 3], 1e-6)
    dxz = jnp.abs(x0[..., ::2] - rows0[:, 0:3][..., ::2])       # (N,2) |dx|,|dz|
    b_sq = jnp.clip((half - jnp.max(dxz, axis=-1)) / half, 0.0, 1.0)
    curved = (pt == int(PrimType.SPHERE)) | (pt == int(PrimType.TORUS)) \
        | (pt == int(PrimType.PLANE))
    B = jnp.where(curved, b_curved,
                  jnp.where(pt == int(PrimType.TRIANGLE), b_tri,
                            jnp.where(pt == int(PrimType.AARECT), b_rect,
                                      jnp.where(pt == int(PrimType.SQUARE),
                                                b_sq, _B_MISS))))
    return jnp.where(sid < 0, _B_MISS, B)


def _screen_warp_T(prep, scene, settings, camera, u, width, height,
                   n_aux, aux_radius, margin):
    """The warped screen position T(u): (R,2) -> (R,2), value == u.

    theta-derivatives (w.r.t. ``scene`` and ``camera``) carry the
    boundary-weighted content velocity; u-derivatives (taken by the
    caller via jvp) supply the warp Jacobian.
    """
    from wasm_pathtracer_tpu.ops import trace as tr

    cam0 = jax.tree.map(sg, camera)
    scene0 = jax.tree.map(sg, scene)
    offs = _aux_offsets(n_aux, aux_radius)                  # (K,2)
    R = u.shape[0]
    K = n_aux
    uk = (u[:, None, :] + offs[None]).reshape(R * K, 2)

    # aux primary rays and hits: theta-FREE (built from the detached
    # camera/scene), u-differentiable
    o0, d0 = _rays_from_screen(cam0, uk[:, 0], uk[:, 1], width, height,
                               settings.screen_z)
    t, sid, hit, _ = tr.trace_scene(prep, scene0, o0, d0)
    t_eff = jnp.where(hit, t, _T_FAR)
    x0 = o0 + d0 * t_eff[..., None]
    sid_eff = jnp.where(hit, sid, -1)

    info = tr.hit_info(scene0, o0, d0, jnp.where(hit, t, 1.0),
                       jnp.maximum(sid, 0))
    B = _boundary_test(scene0, sid_eff, x0, d0, info["n"])  # (R*K,)

    # content velocity: projection (by the moving camera) of the
    # surface-attached (moving-geometry) hit point
    x_att = _attached_point(scene, scene0, sid_eff, x0)
    u_proj = project_screen(camera, x_att, width, height,
                            settings.screen_z)               # (R*K,2)
    vel = (u_proj - sg(u_proj)).reshape(R, K, 2)  # zero value, theta-vel

    kern = jnp.exp(-0.5 * (jnp.sum(offs ** 2, -1)
                           / (0.6 * aux_radius) ** 2))       # (K,)
    w = kern[None, :] / (B.reshape(R, K) ** 2 + _B_EPS)      # (R,K)
    V = jnp.sum(w[..., None] * vel, axis=1) / \
        jnp.maximum(jnp.sum(w, axis=1), 1e-12)[..., None]    # (R,2)

    # damp to zero at the pixel-window boundary: the window is a FIXED
    # domain edge (no boundary flux), so a non-vanishing warp there
    # would add spurious flux
    if margin > 0.0:
        dx = jnp.minimum(u[:, 0], width - u[:, 0]) / margin
        dy = jnp.minimum(u[:, 1], height - u[:, 1]) / margin
        rho = jnp.clip(dx, 0.0, 1.0) * jnp.clip(dy, 0.0, 1.0)
        V = V * rho[:, None]
    return u + V


def warp_jacobian(T_fn, u):
    """``T = T_fn(u)`` and the 2x2 warp Jacobian determinant with its
    value pinned to exactly 1 (the warp is zero at the evaluation
    point; only theta-derivatives of the divergence survive)."""
    ex = jnp.zeros_like(u).at[:, 0].set(1.0)
    ey = jnp.zeros_like(u).at[:, 1].set(1.0)
    T, dx = jax.jvp(T_fn, (u,), (ex,))
    _, dy = jax.jvp(T_fn, (u,), (ey,))
    # columns of dT/du, value-pinned to the identity
    a = dx[:, 0] - sg(dx[:, 0]) + 1.0
    b = dy[:, 0] - sg(dy[:, 0])
    c = dx[:, 1] - sg(dx[:, 1])
    d = dy[:, 1] - sg(dy[:, 1]) + 1.0
    return T, a * d - b * c


def render_pixels_edgeaware(prep, scene, settings, camera: Camera,
                            px, py, width: int, height: int, seed,
                            photon_grid=None, n_aux: int = 8,
                            aux_radius: float = 1.25,
                            window_margin: float = 1.5):
    """Edge-aware twin of :func:`ops.integrator.render_pixels`.

    Same value (the warp is value-preserving); gradients additionally
    carry primary-visibility boundary terms.  Requires a dense,
    differentiable prep (same contract as the scan-form integrator).

    ``aux_radius`` is the screen-space support of the warp in pixels:
    boundary terms from silhouettes farther than ~radius from a sample
    are smoothed over that scale (consistent as radius -> 0 with
    sample count -> inf).
    """
    assert prep.cluster is None and not prep.has_bvh and \
        not prep.use_fused, \
        "edge-aware gradients need the dense differentiable trace path"
    from wasm_pathtracer_tpu.ops import integrator

    ray_id = (py * width + px).astype(jnp.uint32)
    jx, jy, _ = rnglib.uniform3(seed, ray_id, integrator.SLOT_JITTER)
    u = jnp.stack([px.astype(jnp.float32) + jx,
                   py.astype(jnp.float32) + jy], axis=-1)

    T_fn = functools.partial(_screen_warp_T, prep, scene, settings,
                             camera, width=width, height=height,
                             n_aux=n_aux, aux_radius=aux_radius,
                             margin=window_margin)
    T, J = warp_jacobian(T_fn, u)

    o, d = _rays_from_screen(camera, T[:, 0], T[:, 1], width, height,
                             settings.screen_z)
    col, cost = integrator.trace_paths(prep, scene, settings, o, d,
                                       ray_id, seed,
                                       photon_grid=photon_grid)
    return col * J[:, None], cost


# ---------------------------------------------------------------------------
# NEE shadow-visibility warp (light-sample uniform space)
# ---------------------------------------------------------------------------

def _torus_sdf_grad(p, big_r, small_r):
    """Analytic gradient of :func:`isx._torus_sdf` (flat-lying torus,
    local coordinates).  Unit-length wherever the SDF is smooth."""
    rho = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-24))
    qx = rho - big_r
    L = jnp.sqrt(jnp.maximum(qx * qx + p[..., 1] ** 2, 1e-24))
    gx = (qx / L) * (p[..., 0] / rho)
    gy = p[..., 1] / L
    gz = (qx / L) * (p[..., 2] / rho)
    return jnp.stack([gx, gy, gz], axis=-1)


def _ray_edges_clearance(x0, nu, seg_len, a, b):
    """Closest approach of the segments ``x0 + s*nu, s in (0, seg_len)``
    to a set of EDGE segments ``a[e] .. b[e]``.

    Returns (B (R,E) angular clearance dist/s, z (R,E,3) closest edge
    points).  Shared by triangle edges and the rectangle outlines of
    aarect boxes and squares — in all three families every edge is a
    potential shadow silhouette.
    """
    e = b - a                                          # (E,3)
    w0 = a[None, :, :] - x0[:, None, :]                # (R,E,3)
    nu_e = nu[:, None, :]
    d_ee = jnp.sum(e * e, -1)[None]                    # (1,E)
    d_en = jnp.sum(e[None] * nu_e, -1)                 # (R,E)
    d_w0e = jnp.sum(w0 * e[None], -1)
    d_w0n = jnp.sum(w0 * nu_e, -1)
    den = d_ee - d_en * d_en                           # (R,E)
    den_s = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    tc = jnp.clip((d_en * d_w0n - d_w0e * 1.0) / -den_s, 0.0, 1.0)
    # ^ parameter on the edge of the closest point to the ray line:
    #   minimize |w0 + tc*e - s*nu|^2 over (tc, s)
    s_c = d_w0n + tc * d_en                            # (R,E)
    s_c = jnp.clip(s_c, 1e-4, seg_len[:, None])
    ze = a[None] + tc[..., None] * e[None]             # (R,E,3)
    diff = ze - (x0[:, None, :] + s_c[..., None] * nu_e)
    dist = jnp.sqrt(jnp.maximum(vm.length_sq(diff), 1e-20))
    return dist / s_c, ze


def _fold_min(best_B, best_z, Bs, zs):
    """Fold a per-family (R, N) candidate set into the running
    (best_B (R,), best_z (R,3)) minimum."""
    j = jnp.argmin(Bs, axis=1)
    Bmin = jnp.take_along_axis(Bs, j[:, None], 1)[:, 0]
    zmin = jnp.take_along_axis(zs, j[:, None, None], 1)[:, 0]
    better = Bmin < best_B
    return (jnp.where(better, Bmin, best_B),
            jnp.where(better[:, None], zmin, best_z))


_TORUS_COARSE = 16    # coarse samples along the segment
_TORUS_REFINE = 8     # samples per refinement pass (x2 passes)
_TORUS_NEWTON = 2     # Newton polishes of d/ds sdf = 0


def _torus_segment_clearance(x0, nu, seg_len, c, big_r, small_r):
    """Min |sdf| of the segment against each torus, via coarse-to-fine
    1-D search on ``f(s) = sdf(x0 + s*nu - c)`` plus Newton polish of
    ``f'(s) = grad_sdf . nu = 0``.

    The signed minimum is the exact analog of the sphere's
    ``dist - r``: positive clearance when the segment passes outside,
    negative penetration depth when it is blocked, 0 at grazing — so
    ``B = |min_s sdf| / s*`` vanishes at the silhouette from BOTH
    sides.  The nearest silhouette point is the SDF-projection of the
    argmin point onto the torus surface, ``q - sdf(q)*grad(q)``.  All
    of this runs on the theta-DETACHED scene (the search needs no
    theta-derivatives; u-derivatives flow through the sample
    positions).
    """
    from wasm_pathtracer_tpu.ops.intersect import _torus_sdf

    p0 = x0[:, None, :] - c[None]                       # (R,T,3)
    nu_t = nu[:, None, :]                               # (R,1,3)
    Rb, rb = big_r[None], small_r[None]                 # (1,T)

    def f(s):                                           # (R,T,S) sdf
        return _torus_sdf(p0[..., None, :] + s[..., None] * nu_t[..., None, :],
                          Rb[..., None], rb[..., None])

    lo = jnp.full_like(seg_len[:, None] * Rb, 1e-4)     # (R,T)
    hi = seg_len[:, None] * jnp.ones_like(Rb)
    frac = (jnp.arange(_TORUS_COARSE, dtype=jnp.float32) + 0.5) / _TORUS_COARSE
    s = lo[..., None] + (hi - lo)[..., None] * frac      # (R,T,S)
    v = f(s)
    j = jnp.argmin(v, axis=-1)[..., None]
    s_best = jnp.take_along_axis(s, j, -1)[..., 0]       # (R,T)
    w = (hi - lo) / _TORUS_COARSE
    for _ in range(2):                                   # two refinement passes
        frac = (jnp.arange(_TORUS_REFINE, dtype=jnp.float32) + 0.5) / _TORUS_REFINE
        s = jnp.clip(s_best[..., None] + w[..., None] * (2.0 * frac - 1.0),
                     lo[..., None], hi[..., None])
        v = f(s)
        j = jnp.argmin(v, axis=-1)[..., None]
        s_best = jnp.take_along_axis(s, j, -1)[..., 0]
        w = w * (2.0 / _TORUS_REFINE)

    # Newton polish of f'(s) = 0 with analytic f' and finite-diff f''
    h = jnp.maximum(1e-3 * (hi - lo), 1e-5)
    for _ in range(_TORUS_NEWTON):
        p = p0 + s_best[..., None] * nu_t
        g = jnp.sum(_torus_sdf_grad(p, Rb, rb) * nu_t, -1)      # f'(s)
        p_h = p0 + (s_best + h)[..., None] * nu_t
        g_h = jnp.sum(_torus_sdf_grad(p_h, Rb, rb) * nu_t, -1)
        curv = (g_h - g) / h
        curv = jnp.where(jnp.abs(curv) < 1e-6, 1e-6, curv)
        step = jnp.clip(-g / curv, -w, w)
        s_best = jnp.clip(s_best + step, lo, hi)

    p = p0 + s_best[..., None] * nu_t
    sdf = _torus_sdf(p, Rb, rb)                          # (R,T) signed
    grad = _torus_sdf_grad(p, Rb, rb)
    z = x0[:, None, :] + s_best[..., None] * nu_t - sdf[..., None] * grad
    B = jnp.abs(sdf) / s_best
    return B, z


def _segment_clearance(prep, scene0, light_sid, x0, nu, seg_len):
    """Angular clearance of the segment ``x0 + s*nu, s in (0, seg_len)``
    against every finite occluder, plus the nearest silhouette point.

    Returns (B (R,), z (R,3)): B -> 0 when the segment grazes an
    occluder silhouette (valid from BOTH sides — the closest-approach
    distance |dist - r| for spheres and the signed-minimum |sdf| for
    tori vanish at grazing whether the segment passes or is blocked),
    z the nearest silhouette point on the critical occluder.  Triangle
    occluders use their edges; aarect boxes their 12 box edges;
    squares their 4 outline edges; tori the SDF minimum along the
    segment (the museum's only occluders are tori,
    ``src/scenes.rs:15-52`` — this family is the flagship case).
    Planes are the one family without silhouette clearance (an
    infinite plane has no outline; its shadows have no boundary to
    warp).
    """
    R = x0.shape[0]
    best_B = jnp.full((R,), 1e9, jnp.float32)
    best_z = x0 + nu  # placeholder

    # --- spheres ---------------------------------------------------------
    if prep.idx_sphere.shape[0]:
        rows = scene0.params[prep.idx_sphere]
        c = rows[:, 0:3]                                   # (S,3)
        r = rows[:, 3]                                     # (S,)
        to_c = c[None, :, :] - x0[:, None, :]              # (R,S,3)
        s_star = jnp.clip(jnp.sum(to_c * nu[:, None, :], -1),
                          1e-4, seg_len[:, None])          # (R,S)
        q = x0[:, None, :] + s_star[..., None] * nu[:, None, :]
        dq = q - c[None]
        dist = jnp.sqrt(jnp.maximum(vm.length_sq(dq), 1e-20))
        Bs = jnp.abs(dist - r[None, :]) / s_star           # (R,S)
        zs = c[None] + (r[None, :] / dist)[..., None] * dq  # (R,S,3)
        best_B, best_z = _fold_min(best_B, best_z, Bs, zs)

    # --- tori (SDF minimum along the segment) ----------------------------
    if prep.idx_torus.shape[0]:
        rows = scene0.params[prep.idx_torus]
        Bt, zt = _torus_segment_clearance(x0, nu, seg_len, rows[:, 0:3],
                                          rows[:, 3], rows[:, 4])
        best_B, best_z = _fold_min(best_B, best_z, Bt, zt)

    # --- triangles (edges) -------------------------------------------------
    if prep.idx_triangle.shape[0]:
        ids = prep.idx_triangle
        rows = scene0.params[ids]                          # (T,9)
        verts = rows.reshape(-1, 3, 3)                     # (T,3,3)
        a = verts.reshape(-1, 3)                           # edge starts (3T,3)
        b = jnp.roll(verts, -1, axis=1).reshape(-1, 3)     # edge ends
        eid_sid = jnp.repeat(ids, 3)                       # (3T,)
        Bt, ze = _ray_edges_clearance(x0, nu, seg_len, a, b)
        # area-light triangles are not warp occluders: the sampled
        # light itself is transparent to its own shadow rays, and a
        # COPLANAR sibling triangle (quad lights are triangle pairs)
        # sits exactly on the sampling plane — its edges would
        # register B -> 0 with meaningless velocities on every sample
        # near the shared diagonal, despite never actually occluding
        if scene0.num_lights > 0:
            is_light = jnp.any(
                eid_sid[:, None] == scene0.light_shape[None, :], axis=1)
            Bt = jnp.where(is_light[None, :], 1e9, Bt)
        else:
            Bt = jnp.where(eid_sid[None, :] == light_sid[:, None], 1e9, Bt)
        best_B, best_z = _fold_min(best_B, best_z, Bt, ze)

    # --- aarect boxes (12 box edges each) --------------------------------
    if prep.idx_aarect.shape[0]:
        rows = scene0.params[prep.idx_aarect]              # (A,6)
        a_e, b_e = _box_edges(rows[:, 0:3], rows[:, 3:6])
        Br, zr = _ray_edges_clearance(x0, nu, seg_len, a_e, b_e)
        best_B, best_z = _fold_min(best_B, best_z, Br, zr)

    # --- squares (4 outline edges each) ----------------------------------
    if prep.idx_square.shape[0]:
        rows = scene0.params[prep.idx_square]              # (Q,4)
        a_e, b_e = _square_edges(rows[:, 0:3], rows[:, 3])
        Bq, zq = _ray_edges_clearance(x0, nu, seg_len, a_e, b_e)
        best_B, best_z = _fold_min(best_B, best_z, Bq, zq)

    return jnp.minimum(best_B, _B_MISS), best_z


def _box_edges(bmin, bmax):
    """The 12 edges of each axis-aligned box: (A,3),(A,3) ->
    (12A,3),(12A,3) endpoint arrays."""
    A = bmin.shape[0]
    # 8 corners: bit k of the index selects min/max on axis k
    sel = jnp.array([[(i >> k) & 1 for k in range(3)] for i in range(8)],
                    jnp.float32)                           # (8,3)
    corners = (bmin[:, None, :] * (1.0 - sel[None])
               + bmax[:, None, :] * sel[None])             # (A,8,3)
    E = jnp.array([[0, 1], [2, 3], [4, 5], [6, 7],         # x-edges
                   [0, 2], [1, 3], [4, 6], [5, 7],         # y-edges
                   [0, 4], [1, 5], [2, 6], [3, 7]])        # z-edges
    a = corners[:, E[:, 0], :].reshape(12 * A, 3)
    b = corners[:, E[:, 1], :].reshape(12 * A, 3)
    return a, b


def _square_edges(center, size):
    """The 4 outline edges of each axis-aligned y-plane square
    (``square.rs:56-99`` parameterization: center + FULL side length)."""
    Q = center.shape[0]
    h = (0.5 * size)[:, None]                              # (Q,1)
    sx = jnp.array([[-1.0, 1.0, 1.0, -1.0]])
    sz = jnp.array([[-1.0, -1.0, 1.0, 1.0]])
    corners = jnp.stack([center[:, 0:1] + h * sx,
                         jnp.broadcast_to(center[:, 1:2], (Q, 4)),
                         center[:, 2:3] + h * sz], axis=-1)  # (Q,4,3)
    a = corners.reshape(4 * Q, 3)
    b = jnp.roll(corners, -1, axis=1).reshape(4 * Q, 3)
    return a, b


def _uv_from_point(y, l0, l1, l2):
    """Invert the triangle sqrt-warp sampling map: point on the light
    plane -> the (r1, r2) uniforms that :func:`isx.triangle_pick_random`
    would map there (b0 = 1 - sqrt(r1), b2 = r2 * sqrt(r1))."""
    b0, b1, b2 = _barycentric(y, l0, l1, l2)
    s = jnp.clip(1.0 - b0, 1e-4, None)
    r1 = s * s
    r2 = b2 / s
    return jnp.stack([r1, r2], axis=-1)


def _nee_warp_T(prep, scene, light_rows, light_sid, x_sh, u, n_aux, radius):
    """Warped light-sample uniforms T(u): (R,2) -> (R,2), value == u.

    ``light_rows`` are the theta-ATTACHED (l0,l1,l2) rows of the
    sampled light; ``x_sh`` the (detached) shading points.
    """
    scene0 = jax.tree.map(sg, scene)
    rows0 = sg(light_rows)
    l0a, l1a, l2a = light_rows[:, 0:3], light_rows[:, 3:6], light_rows[:, 6:9]
    l00, l10, l20 = rows0[:, 0:3], rows0[:, 3:6], rows0[:, 6:9]

    offs = _aux_offsets(n_aux, radius)                      # (K,2)
    R = u.shape[0]
    K = n_aux
    uk = u[:, None, :] + offs[None]                         # (R,K,2)
    uk = jnp.clip(uk, 1e-3, 1.0 - 1e-3).reshape(R * K, 2)

    # aux light points from the FROZEN light (theta-free, u-diff)
    r1s = jnp.sqrt(uk[:, 0])[..., None]
    rep = lambda v: jnp.repeat(v, K, axis=0)
    y = ((1.0 - r1s) * rep(l00) + (r1s * (1.0 - uk[:, 1][..., None]))
         * rep(l10) + (uk[:, 1][..., None] * r1s) * rep(l20))  # (R*K,3)

    x0 = rep(x_sh)
    to_y = y - x0
    seg_len = jnp.sqrt(jnp.maximum(vm.length_sq(to_y), 1e-20))
    nu = to_y / seg_len[..., None]

    B, z = _segment_clearance(prep, scene0, rep(light_sid), x0, nu, seg_len)

    # boundary point in uniform space: the ray through the (frozen)
    # silhouette point pierced into the MOVING light plane, mapped back
    # through the sampling warp
    nu_z = vm.normalize(z - x0, eps=1e-12)
    n_l = jnp.cross(rep(l1a) - rep(l0a), rep(l2a) - rep(l0a))
    denom = vm.dot(nu_z, n_l)
    denom = jnp.where(jnp.abs(denom) < 1e-9,
                      jnp.where(denom < 0, -1e-9, 1e-9), denom)
    t_star = vm.dot(rep(l0a) - x0, n_l) / denom
    y_star = x0 + t_star[..., None] * nu_z
    u_star = _uv_from_point(y_star, rep(l0a), rep(l1a), rep(l2a))  # (R*K,2)
    # clamp the boundary point to the sampling domain's neighborhood:
    # a silhouette whose shadow falls far outside the light cannot be
    # this sample's nearest discontinuity, and the unclamped
    # extrapolation (b0 -> 1 singularities in the sqrt-warp inverse)
    # would otherwise produce unbounded velocities
    u_star = jnp.clip(u_star, -0.5, 1.5)
    # gate the velocity by clearance: the warp only needs to MATCH the
    # boundary velocity at B -> 0 and stay continuous; decaying it to
    # zero away from boundaries removes the variance of meaningless
    # far-field velocities.  GATE is in the angular clearance units of
    # _segment_clearance.
    GATE = 0.08
    gate = GATE * GATE / (B * B + GATE * GATE)
    vel = ((u_star - sg(u_star)) * gate[..., None]).reshape(R, K, 2)

    kern = jnp.exp(-0.5 * (jnp.sum(offs ** 2, -1) / (0.6 * radius) ** 2))
    w = kern[None, :] / (B.reshape(R, K) ** 2 + _B_EPS)
    V = jnp.sum(w[..., None] * vel, axis=1) / \
        jnp.maximum(jnp.sum(w, axis=1), 1e-12)[..., None]

    # damp at the uniform-domain boundary (fixed domain, no flux) —
    # EXCEPT r1 -> 1... all four edges are fixed in u-space, so damp all
    m = 0.04
    rho = jnp.clip(jnp.minimum(u[:, 0], 1.0 - u[:, 0]) / m, 0.0, 1.0) \
        * jnp.clip(jnp.minimum(u[:, 1], 1.0 - u[:, 1]) / m, 0.0, 1.0)
    return u + V * rho[:, None]


def nee_warp(prep, scene, light_rows, light_sid, hit_point, s1, s2,
             n_aux: int = 6, radius: float = 0.12):
    """Warp the NEE light-sample uniforms; returns (s1', s2', J).

    Called from the integrator's NEE block when
    ``RenderSettings.edge_aware_nee``.  Values are preserved
    (s1' == s1, s2' == s2, J == 1); theta-gradients gain the
    shadow-boundary flux w.r.t. light geometry.
    """
    u = jnp.stack([s1, s2], axis=-1)
    x_sh = sg(hit_point)
    T_fn = functools.partial(_nee_warp_T, prep, scene, light_rows,
                             light_sid, x_sh, n_aux=n_aux, radius=radius)
    T, J = warp_jacobian(T_fn, u)
    return T[:, 0], T[:, 1], J
