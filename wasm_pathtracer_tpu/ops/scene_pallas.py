"""Pallas (Triton) scene kernel: fused whole-scene nearest hit and
any-hit shadow query.

The XLA dense path (``ops.trace.trace_scene``) tests each primitive
family as its own rays x primitives kernel, and the torus SDF march is
a ``fori_loop`` over (R, T) carries: every march step is one more
kernel launch that sends its carries through device memory, twice per
bounce (nearest hit and shadow query).  A scene of the reference's
scale is tiny — the museum's 146 shapes are a few KB of parameters
(``src/scenes.rs:15-68``) — so one kernel can keep the rays, the march
state and the running (t, code) minimum in registers for the whole
scene.

Layout: one program serves a power-of-two block of ``RAY_BLOCK`` rays
held as 1-D vectors.  Each primitive family is a loop over its
primitives with scalar parameter loads from one flat table (the
family's rows at a static offset), so register pressure does not grow
with the family size and nothing is padded.  Per primitive the block
folds its candidate into a running ``(t, code)`` with
``code = family << SLOT_BITS | slot``; a strict ``<`` keeps the first
primitive on ties, the same order as the XLA path's per-family argmin.
The wrapper decodes codes back to global shape ids with one R-sized
gather per family.

Tori first slab-test the whole block and skip the march (a
``lax.cond`` on the block) when no ray of the block can reach the torus
before its current bound.  The march never ends before the slab entry,
so the skip changes no result.

Each family's intersection math is the componentwise transcription of
``ops.intersect`` (which cites the reference per primitive); misses are
``inf``.  The kernel is forward-only (Pallas has no VJP here), so
``ScenePrep.use_fused`` is a static forward-only flag and gradient
workloads keep the XLA path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

RAY_BLOCK = 64
NUM_WARPS = 2
SLOT_BITS = 20
_SLOT_MASK = (1 << SLOT_BITS) - 1
_EPS_SLACK = 0.1 * 2e-4          # triangle.rs:44
_TORUS_STEPS = 24                # ops.intersect._TORUS_STEPS
_TORUS_NEWTON = 4                # ops.intersect._TORUS_NEWTON
_TORUS_OMEGA = 1.6               # ops.intersect._TORUS_OMEGA
_TORUS_TOL = 1e-4

# family codes (order matches ops.trace's tie-break order) and the
# parameter-row width each family reads from the shape table
FAM_PLANE, FAM_SPHERE, FAM_TRI, FAM_TORUS, FAM_AARECT, FAM_SQUARE = range(6)
_FAM_KEYS = ("plane", "sphere", "triangle", "torus", "aarect", "square")
_FAM_WIDTH = (6, 4, 9, 5, 6, 4)


def _nz(x, eps=1e-30):
    return jnp.where(jnp.abs(x) < eps, eps, x)


def _any(mask):
    """Block-wide any() (the Triton lowering has no reduce_or)."""
    return jnp.max(jnp.where(mask, 1, 0)) > 0


# ---------------------------------------------------------------------------
# Per-primitive candidate distances.  Each takes the primitive's scalar
# parameters ``p`` and the block's ray components and returns the (RB,)
# candidate distances (inf = miss).  Shared by both kernels.
# ---------------------------------------------------------------------------

def _t_plane(p, o3, d3):
    """Planes (plane.rs:80-99)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    lx, ly, lz, nx, ny, nz_ = p
    ndd = nx * dx + ny * dy + nz_ * dz
    ndo = nx * ox + ny * oy + nz_ * oz
    t = (nx * lx + ny * ly + nz_ * lz - ndo) / _nz(ndd)
    return jnp.where((t > 0.0) & (ndd != 0.0), t, jnp.inf)


def _t_sphere(p, o3, d3):
    """Spheres (sphere.rs:104-131)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    cx, cy, cz, rad = p
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    t = jnp.where(jnp.minimum(t0, t1) > 0.0, jnp.minimum(t0, t1),
                  jnp.maximum(t0, t1))
    return jnp.where((disc >= 0.0) & (t > 0.0), t, jnp.inf)


def _t_tri(p, o3, d3):
    """Triangles (triangle.rs:159-191)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = p
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz_ = e1x * e2y - e1y * e2x
    inv_len = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz_ * nz_,
                                        1e-30))
    ndd = nx * dx + ny * dy + nz_ * dz
    ndo = nx * ox + ny * oy + nz_ * oz
    t = (nx * v0x + ny * v0y + nz_ * v0z - ndo) / _nz(ndd)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t

    def left_of(ax, ay, az, ex, ey, ez):
        wx, wy, wz = px - ax, py - ay, pz - az
        s = ((ey * wz - ez * wy) * nx + (ez * wx - ex * wz) * ny
             + (ex * wy - ey * wx) * nz_)
        return s * inv_len + _EPS_SLACK >= 0.0

    inside = left_of(v0x, v0y, v0z, e1x, e1y, e1z)
    inside &= left_of(v1x, v1y, v1z, v2x - v1x, v2y - v1y, v2z - v1z)
    inside &= left_of(v2x, v2y, v2z, v0x - v2x, v0y - v2y, v0z - v2z)
    return jnp.where(inside & (t > 0.0) & (ndd != 0.0), t, jnp.inf)


def _torus_slab(p, o3, d3):
    """Torus bounding-box interval: (t_in, t_out, hit_box, local o)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    cx, cy, cz, bigr, smr = p
    lox, loy, loz = ox - cx, oy - cy, oz - cz
    ext_xz = bigr + smr
    idx_, idy_, idz_ = 1.0 / _nz(dx), 1.0 / _nz(dy), 1.0 / _nz(dz)
    ax1, ax2 = (-ext_xz - lox) * idx_, (ext_xz - lox) * idx_
    ay1, ay2 = (-smr - loy) * idy_, (smr - loy) * idy_
    az1, az2 = (-ext_xz - loz) * idz_, (ext_xz - loz) * idz_
    t_in = jnp.maximum(jnp.maximum(jnp.minimum(ax1, ax2),
                                   jnp.minimum(ay1, ay2)),
                       jnp.minimum(az1, az2))
    t_out = jnp.minimum(jnp.minimum(jnp.maximum(ax1, ax2),
                                    jnp.maximum(ay1, ay2)),
                        jnp.maximum(az1, az2))
    hit_box = (t_in < t_out) & (t_out > 0.0)
    return t_in, t_out, hit_box, (lox, loy, loz)


def _torus_march(p, lo3, d3, t_in, t_out, hit_box):
    """Over-relaxed SDF march + Newton polish, the componentwise form of
    ``ops.intersect._tori_march_impl`` (same step counts and guards)."""
    lox, loy, loz = lo3
    dx, dy, dz = d3
    bigr, smr = p[3], p[4]

    def sdf(t):
        px, py, pz = lox + dx * t, loy + dy * t, loz + dz * t
        qx = jnp.sqrt(jnp.maximum(px * px + pz * pz, 1e-24)) - bigr
        return jnp.sqrt(jnp.maximum(qx * qx + py * py, 1e-24)) - smr

    def dsdf(t):
        px, py, pz = lox + dx * t, loy + dy * t, loz + dz * t
        rho = jnp.sqrt(jnp.maximum(px * px + pz * pz, 1e-24))
        qx = rho - bigr
        ql = jnp.sqrt(jnp.maximum(qx * qx + py * py, 1e-24))
        drho = (px * dx + pz * dz) / rho
        return (qx * drho + py * dy) / ql

    t_lo = jnp.maximum(t_in, 1e-4)
    sign0 = jnp.sign(sdf(t_lo))
    sign0 = jnp.where(sign0 == 0.0, 1.0, sign0)

    # the relaxation flag rides as f32 (1.0 / 0.0) to keep the loop
    # carries plain float vectors
    def march(_, st):
        t, dist, relaxed = st
        step = dist * jnp.where(relaxed > 0.5, _TORUS_OMEGA, 1.0)
        t2_ = t + jnp.where((dist > _TORUS_TOL) & (t < t_out), step, 0.0)
        d2 = sign0 * sdf(t2_)
        accept = (step <= _TORUS_TOL) | (d2 + dist >= step)
        return (jnp.where(accept, t2_, t), jnp.where(accept, d2, dist),
                jnp.where(accept, 1.0, 0.0))

    t, _, _ = jax.lax.fori_loop(
        0, _TORUS_STEPS, march,
        (t_lo, sign0 * sdf(t_lo), jnp.ones_like(t_lo)))

    def newton(_, t):
        f = sign0 * sdf(t)
        fp = sign0 * dsdf(t)
        fp = jnp.where(jnp.abs(fp) < 1e-6,
                       jnp.where(fp < 0, -1e-6, 1e-6), fp)
        tn = jnp.clip(t - f / fp, t_lo, t_out)
        return jnp.where(jnp.abs(f) > 1e-6, tn, t)

    t = jax.lax.fori_loop(0, _TORUS_NEWTON, newton, t)
    ok = hit_box & (jnp.abs(sdf(t)) <= 10.0 * _TORUS_TOL) & (t > 0.0) \
        & (t <= t_out + _TORUS_TOL)
    return jnp.where(ok, t, jnp.inf)


def _t_torus(p, o3, d3, bound):
    """Tori (torus.rs:61-126 via the SDF march).  ``bound`` is the
    block's per-ray distance past which no candidate matters: when no
    ray enters the torus box before it, the march is skipped."""
    t_in, t_out, hit_box, lo3 = _torus_slab(p, o3, d3)
    need = hit_box & (t_in <= bound)
    return jax.lax.cond(
        _any(need),
        lambda: _torus_march(p, lo3, d3, t_in, t_out, hit_box),
        lambda: jnp.full(t_in.shape, jnp.inf, jnp.float32))


def _t_aarect(p, o3, d3):
    """AARects (aa_rect.rs:142-174)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    x0, y0, z0, x1, y1, z1 = p
    idx_, idy_, idz_ = 1.0 / _nz(dx), 1.0 / _nz(dy), 1.0 / _nz(dz)
    ax1, ax2 = (x0 - ox) * idx_, (x1 - ox) * idx_
    ay1, ay2 = (y0 - oy) * idy_, (y1 - oy) * idy_
    az1, az2 = (z0 - oz) * idz_, (z1 - oz) * idz_
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(ax1, ax2),
                                   jnp.minimum(ay1, ay2)),
                       jnp.minimum(az1, az2))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(ax1, ax2),
                                   jnp.maximum(ay1, ay2)),
                       jnp.maximum(az1, az2))
    t = jnp.where(tmin > 0.0, tmin, tmax)
    return jnp.where((tmin < tmax) & (t > 0.0), t, jnp.inf)


def _t_square(p, o3, d3):
    """Squares (square.rs:56-99)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    scx, scy, scz, size = p
    t = (scy - oy) / _nz(dy)
    inside = (2.0 * jnp.abs(ox + dx * t - scx) < size) \
        & (2.0 * jnp.abs(oz + dz * t - scz) < size)
    return jnp.where(inside & (t > 0.0) & (dy != 0.0), t, jnp.inf)


_T_FNS = (_t_plane, _t_sphere, _t_tri, None, _t_aarect, _t_square)


def _family_loop(tab_ref, layout, o3, d3, carry, fold, bound_of):
    """Fold every primitive of every present family into ``carry``.

    ``layout``: static ((fam, n, offset), ...) into the flat table.
    ``fold(carry, t, code)`` merges one primitive's candidates;
    ``bound_of(carry)`` is the per-ray distance the torus skip tests.
    """
    for fam, n, off in layout:
        width = _FAM_WIDTH[fam]

        def body(j, carry, fam=fam, off=off, width=width):
            base = off + j * width
            p = tuple(tab_ref[base + k] for k in range(width))
            if fam == FAM_TORUS:
                t = _t_torus(p, o3, d3, bound_of(carry))
            else:
                t = _T_FNS[fam](p, o3, d3)
            return fold(carry, t, (fam << SLOT_BITS) + j)

        carry = jax.lax.fori_loop(0, n, body, carry)
    return carry


def _make_nearest_kernel(layout):
    def kernel(tab_ref, ray_ref, t_ref, code_ref):
        o3 = (ray_ref[0, :], ray_ref[1, :], ray_ref[2, :])
        d3 = (ray_ref[3, :], ray_ref[4, :], ray_ref[5, :])
        init = (jnp.full(o3[0].shape, jnp.inf, jnp.float32),
                jnp.full(o3[0].shape, -1, jnp.int32))

        def fold(carry, t, code):
            best_t, best_code = carry
            better = t < best_t
            return (jnp.where(better, t, best_t),
                    jnp.where(better, code, best_code))

        best_t, best_code = _family_loop(tab_ref, layout, o3, d3, init,
                                         fold, lambda c: c[0])
        t_ref[...] = best_t
        code_ref[...] = best_code

    return kernel


def _make_occluded_kernel(layout):
    """Any-hit query: the reference keeps the shadow ray a distinct,
    cheaper query than the nearest hit (``scene.rs:104-133``: the
    sampled light shape does not occlude, and candidates past the light
    do not matter).  Two running minima replace the argmin: the nearest
    candidate that is not the excluded light shape, and the nearest
    candidate of the excluded shape.  Occluded iff the first beats both
    the second and the light distance — the verdict of the trace-based
    ``hit & t < dist & sid != light`` except at an exact float tie
    between the light and another shape."""
    def kernel(tab_ref, ray_ref, excl_ref, occ_ref):
        o3 = (ray_ref[0, :], ray_ref[1, :], ray_ref[2, :])
        d3 = (ray_ref[3, :], ray_ref[4, :], ray_ref[5, :])
        dist = ray_ref[6, :]
        excl = excl_ref[...]
        inf = jnp.full(dist.shape, jnp.inf, jnp.float32)

        def fold(carry, t, code):
            t_non, t_exc = carry
            is_exc = excl == code
            return (jnp.minimum(t_non, jnp.where(is_exc, jnp.inf, t)),
                    jnp.minimum(t_exc, jnp.where(is_exc, t, jnp.inf)))

        # a torus entered past the light or past the nearest occluder
        # found so far cannot change the verdict
        t_non, t_exc = _family_loop(
            tab_ref, layout, o3, d3, (inf, inf), fold,
            lambda c: jnp.minimum(c[0], dist))
        occ_ref[...] = jnp.where((t_non < dist) & (t_non < t_exc), 1, 0)

    return kernel


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def build_table(prep, scene):
    """Flat per-family parameter table and its static layout.

    Runs inside jit (gathers from ``scene.params``).  Returns
    ``(table (P,) f32, layout)`` with ``layout`` the static
    ``((fam, n, offset), ...)`` of the families present; the table is
    zero-padded to a power of two.
    """
    parts, layout, off = [], [], 0
    for fam, key in enumerate(_FAM_KEYS):
        idx = getattr(prep, f"idx_{key}")
        n = idx.shape[0]
        if n:
            parts.append(scene.params[idx][:, :_FAM_WIDTH[fam]].reshape(-1))
            layout.append((fam, n, off))
            off += n * _FAM_WIDTH[fam]
    table = jnp.concatenate(parts) if parts else jnp.zeros((0,), jnp.float32)
    table = jnp.pad(table, (0, _pow2(max(off, 1)) - off))
    return table, tuple(layout)


def _ray_rows(o, d, extra=None):
    """(R, 3) rays (+ optional (R,) row) -> (8, R') f32, R' a multiple
    of RAY_BLOCK; padding rays point along +1 so no division meets 0."""
    R = o.shape[0]
    pad = (-R) % RAY_BLOCK
    cols = [o, d] + ([extra[:, None]] if extra is not None else [])
    rays = jnp.concatenate(cols, axis=1)
    rays = jnp.pad(rays, ((0, pad), (0, 8 - rays.shape[1])))
    rays = rays.at[R:, 3:6].set(1.0)
    return rays.T


def _call(name, kernel, table, rays, extra_in, out_dtype, interpret):
    Rp = rays.shape[1]
    n_out = len(out_dtype)
    block = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    outs = pl.pallas_call(
        kernel,
        grid=(Rp // RAY_BLOCK,),
        in_specs=[pl.BlockSpec(table.shape, lambda i: (0,)),
                  pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i))]
        + [block] * len(extra_in),
        out_specs=[block] * n_out,
        out_shape=[jax.ShapeDtypeStruct((Rp,), dt) for dt in out_dtype],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=name,
    )(table, rays, *extra_in)
    return outs


def fused_nearest(table, layout, o, d, interpret=False):
    """Nearest hit over the whole scene in one kernel.

    Returns (t (R,), code (R,)) with code == -1 on miss.
    """
    R = o.shape[0]
    t, code = _call("scene_nearest", _make_nearest_kernel(layout), table,
                    _ray_rows(o, d), (), (jnp.float32, jnp.int32),
                    interpret)
    return t[:R], code[:R]


def fused_occluded(table, layout, o, d, dist, excl_code, interpret=False):
    """Occlusion predicate over the whole scene in one kernel.

    ``dist``: (R,) distance to the light point; ``excl_code``: (R,) the
    sampled light shape's ``fam << SLOT_BITS | slot`` code, -1 for none.
    Returns (R,) bool.
    """
    R = o.shape[0]
    pad = (-R) % RAY_BLOCK
    excl = jnp.pad(excl_code, (0, pad), constant_values=-1)
    # padding rays get dist 0: never occluded
    (occ,) = _call("scene_occluded", _make_occluded_kernel(layout), table,
                   _ray_rows(o, d, dist), (excl,), (jnp.int32,), interpret)
    return occ[:R] > 0


def _total(prep):
    return sum(getattr(prep, f"idx_{k}").shape[0] for k in _FAM_KEYS)


def shape_codes(prep, n_shapes: int):
    """(N,) int32 map shape id -> ``fam << SLOT_BITS | slot`` kernel
    code (-2 where the shape is in no family — matches no candidate)."""
    code_of = jnp.full((n_shapes,), -2, jnp.int32)
    for fam, key in enumerate(_FAM_KEYS):
        idx = getattr(prep, f"idx_{key}")
        if idx.shape[0]:
            code_of = code_of.at[idx].set(
                (fam << SLOT_BITS) + jnp.arange(idx.shape[0], dtype=jnp.int32))
    return code_of


def trace_scene_fused(prep, scene, o, d):
    """Kernel form of ``ops.trace.trace_scene`` over the dense families.

    Same return contract: (t, shape_id, hit_mask, cost) — cost is the
    per-ray primitive-test count (every family tests all its
    primitives, as in the dense path).
    """
    table, layout = build_table(prep, scene)
    t, code = fused_nearest(table, layout, o, d, prep.interpret)
    fam = jnp.where(code >= 0, code >> SLOT_BITS, -1)
    slot = code & _SLOT_MASK
    sid = jnp.full(t.shape, -1, jnp.int32)
    for f, key in enumerate(_FAM_KEYS):
        idx = getattr(prep, f"idx_{key}")
        if idx.shape[0]:
            sid = jnp.where(fam == f,
                            idx[jnp.clip(slot, 0, idx.shape[0] - 1)], sid)
    hit = jnp.isfinite(t)
    cost = jnp.full(t.shape, _total(prep), jnp.int32)
    return jnp.where(hit, t, jnp.inf), sid, hit, cost


def occluded_fused(prep, scene, o, d, dist, light_sid):
    """Kernel form of ``ops.trace.shadow_ray``'s occlusion query
    (``scene.rs:104-133`` semantics — the sampled light shape does not
    occlude).  Returns (occluded (R,) bool, cost (R,) int32)."""
    table, layout = build_table(prep, scene)
    code_of = shape_codes(prep, scene.params.shape[0])
    excl = jnp.where(light_sid >= 0, code_of[jnp.maximum(light_sid, 0)], -1)
    occ = fused_occluded(table, layout, o, d, dist, excl, prep.interpret)
    return occ, jnp.full(occ.shape, _total(prep), jnp.int32)
