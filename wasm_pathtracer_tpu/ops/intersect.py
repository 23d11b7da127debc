"""Vectorized ray-primitive intersection kernels.

The reference dispatches ``Tracable::trace`` through vtables, one ray at
a time (``src/graphics/ray.rs:91-121``).  Here each primitive family is
a dense rays-x-primitives elementwise kernel over SoA arrays: all
distances for a (R,) ray batch against (P,) primitives come out as one
(R, P) tensor with ``inf`` marking misses.  No branches — every
reference early-return becomes a ``jnp.where`` mask, so XLA fuses the
whole scene test into a handful of vector loops.

Semantics match the reference per-primitive code exactly (cited on each
function), including the t <= 0 rejection and the triangle half-space
epsilon slack.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.utils import vecmath as vm

INF = jnp.inf
# Reference EPSILON (``src/math/mod.rs:11``); triangles use 0.1x slack
# (``src/graphics/primitives/triangle.rs:44``).
EPSILON = 2e-4


def _posmask(t, extra=True):
    """Keep t where (t > 0) & extra, else +inf."""
    return jnp.where((t > 0.0) & extra, t, INF)


def _nonzero(x, eps=1e-30):
    """Clamp |x| away from 0 (sign-preserving) so masked lanes never
    divide by zero — a 0-cotangent times an inf partial is NaN in the
    VJP even when the forward value is masked out."""
    return jnp.where(jnp.abs(x) < eps, eps, x)


def _dot_rp(a, b):
    """(R,3) x (P,3) -> (R,P) dot products.

    Written as broadcast multiply + sum, NOT einsum/matmul: on a GPU a
    float32 K=3 matmul may run on the tensor cores in TF32 (about three
    decimal digits), which is catastrophic for intersection tests (hit
    distances off by ~1e-3 relative).  The broadcast form stays in full
    f32 elementwise arithmetic and fuses.
    """
    return jnp.sum(a[:, None, :] * b[None, :, :], axis=-1)


# ---------------------------------------------------------------------------
# Planes (``src/graphics/primitives/plane.rs:80-99``)
# ---------------------------------------------------------------------------

def rays_vs_planes(o, d, loc, n):
    """(R,3),(R,3) x (P,3),(P,3) -> (R,P) distances."""
    n_dot_d = _dot_rp(d, n)
    o_dist = jnp.sum(n * loc, axis=-1)                # n . location
    n_dot_o = _dot_rp(o, n)
    t = (o_dist[None, :] - n_dot_o) / _nonzero(n_dot_d)
    return _posmask(t, n_dot_d != 0.0)


# ---------------------------------------------------------------------------
# Spheres (``src/graphics/primitives/sphere.rs:104-131``)
# ---------------------------------------------------------------------------

def rays_vs_spheres(o, d, center, radius):
    """(R,3),(R,3) x (S,3),(S,) -> (R,S)."""
    oc = o[:, None, :] - center[None, :, :]           # (R,S,3)
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * c                             # a == 1 (unit dir)
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    return jnp.where((disc >= 0.0) & (t > 0.0), t, INF)


# ---------------------------------------------------------------------------
# Triangles (``src/graphics/primitives/triangle.rs:159-191``)
# ---------------------------------------------------------------------------

def rays_vs_triangles(o, d, v0, v1, v2):
    """(R,3),(R,3) x (T,3)x3 -> (R,T).

    Plane intersection followed by three ``is_approx_left_of`` half-space
    tests with +0.1*EPSILON slack against T-junction gaps
    (``triangle.rs:41-45``).
    """
    n = jnp.cross(v1 - v0, v2 - v0)                    # (T,3), unnormalized
    n_dot_d = _dot_rp(d, n)
    orig_dis = jnp.sum(n * v0, axis=-1)
    t = (orig_dis[None, :] - _dot_rp(o, n)) / _nonzero(n_dot_d)

    nn = n / _nonzero(jnp.linalg.norm(n, axis=-1, keepdims=True))  # (T,3)
    p = o[:, None, :] + d[:, None, :] * t[..., None]     # (R,T,3)

    def left_of(a, bb):
        edge = bb - a                                   # (T,3)
        v0p = p - a[None, :, :]                         # (R,T,3)
        c = jnp.cross(jnp.broadcast_to(edge[None], v0p.shape), v0p)
        return jnp.sum(c * nn[None, :, :], axis=-1) + 0.1 * EPSILON >= 0.0

    inside = left_of(v0, v1) & left_of(v1, v2) & left_of(v2, v0)
    return _posmask(t, (n_dot_d != 0.0) & inside)


# ---------------------------------------------------------------------------
# AARects (``src/graphics/primitives/aa_rect.rs:142-174``)
# ---------------------------------------------------------------------------

def rays_vs_aarects(o, d, bmin, bmax):
    """(R,3),(R,3) x (A,3),(A,3) -> (R,A).  Slab test; returns tmin when
    outside, tmax when inside the box."""
    inv_d = 1.0 / _nonzero(d)                          # (R,3)
    t1 = (bmin[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (bmax[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)       # (R,A)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    t = jnp.where(tmin > 0.0, tmin, tmax)
    return jnp.where((tmin < tmax) & (t > 0.0), t, INF)


# ---------------------------------------------------------------------------
# Squares (``src/graphics/primitives/square.rs:56-99``)
# ---------------------------------------------------------------------------

def rays_vs_squares(o, d, center, size):
    """(R,3),(R,3) x (Q,3),(Q,) -> (R,Q).  Axis-aligned y-plane quad."""
    n_dot_d = d[:, 1:2]                                # (R,1)
    t = (center[None, :, 1] - o[:, 1:2]) / _nonzero(n_dot_d)  # (R,Q)
    px = o[:, 0:1] + d[:, 0:1] * t
    pz = o[:, 2:3] + d[:, 2:3] * t
    dx = jnp.abs(px - center[None, :, 0])
    dz = jnp.abs(pz - center[None, :, 2])
    inside = (2.0 * dx < size[None, :]) & (2.0 * dz < size[None, :])
    return _posmask(t, (n_dot_d != 0.0) & inside)


# ---------------------------------------------------------------------------
# Tori (``src/graphics/primitives/torus.rs:61-126``)
# ---------------------------------------------------------------------------
#
# The reference solves the quartic in f64 because f32 root-finding is
# catastrophically cancellous ("Grainy tori are ugly", torus.rs:74).
# f64 is slow or absent on accelerators, so the answer here is *sphere
# tracing*: the torus has an exact signed distance function
#     sdf(p) = |(|p.xz| - R, p.y)| - r
# so we march the ray with a fixed-trip-count loop (branch-free, pure
# f32) and polish the hit with a few Newton steps on the quartic.  The
# reference itself left a vestigial `Marchable` SDF trait
# (``src/graphics/ray.rs:127-136``) — this realizes it.

_TORUS_STEPS = 24     # over-relaxed march iterations
_TORUS_NEWTON = 4     # Newton polish iterations
_TORUS_OMEGA = 1.6    # over-relaxation factor (Keinert et al. 2014)
_TORUS_TOL = 1e-4


def _torus_sdf(p, big_r, small_r):
    """Signed distance to a flat-lying torus centered at the origin.
    p: (..., 3); big_r/small_r broadcastable."""
    qx = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-24)) - big_r
    return jnp.sqrt(jnp.maximum(qx * qx + p[..., 1] ** 2, 1e-24)) - small_r


def rays_vs_tori(o, d, center, big_r, small_r):
    """(R,3),(R,3) x (T,3),(T,),(T,) -> (R,T).

    Over-relaxed sphere tracing (Keinert et al. 2014: step ``omega*d``,
    reject when the step's bounding spheres stop overlapping — no
    surface crossing can be skipped) inside the torus AABB
    (``torus.rs:32-51``), then Newton iterations on ``f(t) = sdf(ray(t))``
    using the analytic directional derivative.  24+4 evaluations land
    within ~3e-5 of the f64 quartic oracle — tighter than 64
    conservative steps (~2.5e-3) at half the cost.
    """
    # local-space origins (R,T,3); directions broadcast (R,1,3)
    lo = o[:, None, :] - center[None, :, :]
    ld = d[:, None, :]
    return tori_march(lo, ld, big_r[None], small_r[None])


@jax.custom_vjp
def tori_march(lo, ld, R_, r_):
    """Broadcast-generic torus intersection core.

    ``lo``: (..., 3) torus-local ray origins; ``ld``: broadcastable
    (..., 3) unit directions; ``R_``/``r_``: broadcastable (...)
    major/minor radii.  Returns (...) distances, inf on miss.  Shared
    by the dense (R, T) sweep above and the cluster block test, where
    each ray carries its own gathered primitive rows (R, G).

    Differentiation is by the IMPLICIT FUNCTION THEOREM (custom_vjp
    below), not by unrolling the march: the hit distance solves
    ``sdf(lo + ld*t) = 0``, so ``dt/dtheta = -(df/dtheta)/(df/dt)`` at
    the root — one sdf VJP instead of 24 march + 4 Newton steps of
    saved residuals.  The r03 backward OOM dump fingered exactly those
    residuals (f32[bounces, ..., rays, tori] march carries); with IFT
    the torus term costs O(1) memory and one extra sdf evaluation in
    the backward pass, and the gradient is exact at the converged root
    (the unrolled chain only approximated it through the clipping).
    """
    return _tori_march_impl(lo, ld, R_, r_)


def _tori_march_impl(lo, ld, R_, r_):
    ext = jnp.stack([R_ + r_, r_, R_ + r_], axis=-1) * jnp.ones_like(lo)
    inv_d = 1.0 / _nonzero(ld)
    t1 = (-ext - lo) * inv_d
    t2 = (ext - lo) * inv_d
    t_in = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_out = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit_box = (t_in < t_out) & (t_out > 0.0)

    def sdf(t):
        return _torus_sdf(lo + ld * t[..., None], R_, r_)

    def dsdf(t):
        p = lo + ld * t[..., None]
        rho = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-24))
        qx = rho - R_
        ql = jnp.sqrt(jnp.maximum(qx * qx + p[..., 1] ** 2, 1e-24))
        drho = (p[..., 0] * ld[..., 0] + p[..., 2] * ld[..., 2]) / rho
        return (qx * drho + p[..., 1] * ld[..., 1]) / ql

    t0 = jnp.maximum(t_in, 1e-4)                          # (R,T)
    sign0 = jnp.sign(sdf(t0))
    sign0 = jnp.where(sign0 == 0.0, 1.0, sign0)

    # fori_loop, not a Python unroll: the march sits inside the
    # integrator's bounce scan, and unrolled bodies x every bounce
    # explode XLA compile time on scenes with tori
    def march(_, st):
        t, dist, relaxed = st
        step = dist * jnp.where(relaxed, _TORUS_OMEGA, 1.0)
        t2_ = t + jnp.where((dist > _TORUS_TOL) & (t < t_out), step, 0.0)
        d2 = sign0 * sdf(t2_)
        # accept while the consecutive step spheres overlap; otherwise
        # stay put and retry conservatively (one sdf eval either way)
        accept = (step <= _TORUS_TOL) | (d2 + dist >= step)
        return (jnp.where(accept, t2_, t), jnp.where(accept, d2, dist),
                accept)

    t, _, _ = jax.lax.fori_loop(
        0, _TORUS_STEPS, march,
        (t0, sign0 * sdf(t0), jnp.ones(t0.shape, bool)))

    def newton(_, t):
        f = sign0 * sdf(t)
        fp = sign0 * dsdf(t)
        fp = jnp.where(jnp.abs(fp) < 1e-6,
                       jnp.where(fp < 0, -1e-6, 1e-6), fp)
        tn = jnp.clip(t - f / fp, jnp.maximum(t_in, 1e-4), t_out)
        return jnp.where(jnp.abs(f) > 1e-6, tn, t)

    t = jax.lax.fori_loop(0, _TORUS_NEWTON, newton, t)

    dist = jnp.abs(sdf(t))
    ok = hit_box & (dist <= 10.0 * _TORUS_TOL) & (t > 0.0) & (t <= t_out + _TORUS_TOL)
    return jnp.where(ok, t, INF)


def _tori_march_fwd(lo, ld, R_, r_):
    t = _tori_march_impl(lo, ld, R_, r_)
    return t, (t, lo, ld, R_, r_)


def _tori_march_bwd(res, ct):
    """IFT cotangents: ``dt/dtheta = -(df/dtheta) / (df/dt)`` at the
    root of ``f(t; theta) = sdf(lo + ld*t, R_, r_)``.  Misses carry
    zero cotangent (the inf branch is constant)."""
    t, lo, ld, R_, r_ = res
    fin = jnp.isfinite(t)
    ts = jnp.where(fin, t, 1.0)
    ct = jnp.where(fin, ct, 0.0)

    # df/dt: the analytic directional derivative (same formula as the
    # Newton polish's dsdf)
    p = lo + ld * ts[..., None]
    rho = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-24))
    qx = rho - R_
    ql = jnp.sqrt(jnp.maximum(qx * qx + p[..., 1] ** 2, 1e-24))
    drho = (p[..., 0] * ld[..., 0] + p[..., 2] * ld[..., 2]) / rho
    ft = (qx * drho + p[..., 1] * ld[..., 1]) / ql
    ft = jnp.where(jnp.abs(ft) < 1e-6,
                   jnp.where(ft < 0, -1e-6, 1e-6), ft)

    def f(lo_, ld_, Rb, rb):
        return _torus_sdf(lo_ + ld_ * ts[..., None], Rb, rb)

    _, vjp = jax.vjp(f, lo, ld, R_, r_)
    return vjp(-ct / ft)


tori_march.defvjp(_tori_march_fwd, _tori_march_bwd)


def torus_is_inside(o_local, big_r, small_r):
    """Whether a (local-space) point is inside the torus volume —
    replaces the reference's root-parity test (``torus.rs:120-124``)."""
    return _torus_sdf(o_local, big_r, small_r) < 0.0


# ---------------------------------------------------------------------------
# Normals at a hit point (the ``Hit`` construction of each primitive)
# ---------------------------------------------------------------------------

def plane_normal(d, n):
    """Double-sided plane normal (``plane.rs:63-66``): flip toward origin."""
    flip = vm.dot(d, n) > 0.0
    return jnp.where(flip[..., None], -n, n), jnp.ones(d.shape[:-1], bool)


def sphere_normal(o, d, t, center, radius):
    """``sphere.rs:69-99``: outward normal; flipped when exiting."""
    p = o + d * t[..., None]
    n = (p - center) / _nonzero(radius)[..., None]
    # entering iff the near root was taken; equivalently origin outside
    inside = vm.length_sq(o - center) < radius * radius
    n = jnp.where(inside[..., None], -n, n)
    return n, ~inside


def triangle_normal(d, v0, v1, v2):
    """``triangle.rs:116-157``: plane normal, flipped for back-side hits."""
    n = vm.normalize(jnp.cross(v1 - v0, v2 - v0))
    back = vm.dot(n, d) > 0.0
    return jnp.where(back[..., None], -n, n), ~back


def aarect_normal(o, d, t, bmin, bmax):
    """``aa_rect.rs:102-138``: face normal by which slab bounded tmin/tmax;
    inward-facing when the ray starts inside."""
    inv_d = 1.0 / _nonzero(d)
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    inside = ~(tmin > 0.0)
    # which slab produced the hit t — first match in the reference's test
    # order tx1, tx2, ty1, ty2, tz1, tz2 (``aa_rect.rs:106-118``)
    cands = jnp.stack([t1[..., 0], t2[..., 0], t1[..., 1], t2[..., 1],
                       t1[..., 2], t2[..., 2]], axis=-1)       # (R,6)
    match = jnp.isclose(t[..., None], cands, rtol=1e-6, atol=1e-7)
    idx = jnp.argmax(match, axis=-1)                           # (R,)
    face_normals = jnp.array(
        [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
         [0.0, -1.0, 0.0], [0.0, 1.0, 0.0],
         [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], dtype=o.dtype)
    n = face_normals[idx]
    n = jnp.where(inside[..., None], -n, n)
    return n, ~inside


def square_normal(d):
    """``square.rs:82-87``: +-y toward the ray origin."""
    up = d[..., 1] <= 0.0
    n = jnp.zeros_like(d).at[..., 1].set(jnp.where(up, 1.0, -1.0))
    return n, jnp.ones(d.shape[:-1], bool)


def torus_normal(o, d, t, center, big_r, small_r):
    """``torus.rs:113-124``: alpha formula; flipped when inside."""
    p = o + d * t[..., None] - center
    alpha = 1.0 - big_r / jnp.sqrt(
        jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-24))
    n = vm.normalize(jnp.stack(
        [alpha * p[..., 0], p[..., 1], alpha * p[..., 2]], axis=-1))
    inside = torus_is_inside(o - center, big_r, small_r)
    n = jnp.where(inside[..., None], -n, n)
    return n, ~inside


# ---------------------------------------------------------------------------
# Area-light sampling (``triangle.rs:89-114``)
# ---------------------------------------------------------------------------

def triangle_area(v0, v1, v2):
    """Uniform-measure triangle area.  The reference uses Heron
    (``triangle.rs:70-78``); 0.5*|cross| is the same value, cheaper and
    smooth for autodiff."""
    return 0.5 * jnp.linalg.norm(jnp.cross(v1 - v0, v2 - v0), axis=-1)


def triangle_pick_random(v0, v1, v2, r1, r2, r3):
    """Uniform point on a triangle via the sqrt warp, with a random-sign
    normal (``triangle.rs:91-114``).  Returns (point, normal)."""
    r1s = jnp.sqrt(r1)[..., None]
    p = (1.0 - r1s) * v0 + (r1s * (1.0 - r2[..., None])) * v1 \
        + (r2[..., None] * r1s) * v2
    n = vm.normalize(jnp.cross(v1 - v0, v2 - v0))
    n = jnp.where((r3 > 0.5)[..., None], -n, n)
    return p, n
