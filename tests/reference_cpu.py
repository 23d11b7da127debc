"""Independent NumPy re-implementation of the reference estimator.

This is the test oracle: a direct, scalar-minded NumPy translation of
the *semantics* of the Rust tracer (``/root/reference/src/tracer.rs``,
``src/graphics/*``), consuming the same counter-based RNG streams as the
JAX integrator (``wasm_pathtracer_tpu.utils.rng`` with ``xp=np``).  Per
SURVEY §4, forward renders of the JAX framework must be allclose to this
oracle; discrete decisions (light picks, RR, branch choices) are derived
from identical uniforms so they coincide except at float borderline
cases.

Kept deliberately simple and slow — clarity over speed.
"""

from __future__ import annotations

import numpy as np

from wasm_pathtracer_tpu.models.scene import MatKind, PrimType
from wasm_pathtracer_tpu.utils import rng as rnglib

EPS = np.float32(2e-4)

_SLOTS_PER_BOUNCE = 8
_SLOT_HEMI = 0
_SLOT_RR = 1
_SLOT_LIGHT_PICK = 2
_SLOT_LIGHT_POINT = 3
_SLOT_MAT = 5
SLOT_JITTER = 0x7FFF0000


def _np_scene(scene):
    return dict(
        ptype=np.asarray(scene.ptype),
        params=np.asarray(scene.params, np.float32),
        mat_kind=np.asarray(scene.mat_kind),
        albedo=np.asarray(scene.albedo, np.float32),
        emission=np.asarray(scene.emission, np.float32),
        light_shape=np.asarray(scene.light_shape),
        background=np.asarray(scene.background, np.float32),
        num_lights=scene.num_lights,
    )


# -- primitive intersections (scalar per shape, one ray) ---------------------

def _isect(ptype, p, o, d):
    """Returns hit distance or inf; mirrors each Rust ``trace_simple``."""
    if ptype == PrimType.PLANE:
        n = p[3:6]
        ndd = float(np.dot(n, d))
        if ndd == 0.0:
            return np.inf
        t = (np.dot(n, p[0:3]) - np.dot(n, o)) / ndd
        return t if t > 0 else np.inf
    if ptype == PrimType.SPHERE:
        oc = o - p[0:3]
        b = 2.0 * np.dot(d, oc)
        c = np.dot(oc, oc) - p[3] * p[3]
        disc = b * b - 4 * c
        if disc < 0:
            return np.inf
        sq = np.sqrt(disc)
        t0, t1 = (-b + sq) / 2, (-b - sq) / 2
        t = min(t0, t1)
        if t <= 0:
            t = max(t0, t1)
            if t <= 0:
                return np.inf
        return t
    if ptype == PrimType.TRIANGLE:
        v0, v1, v2 = p[0:3], p[3:6], p[6:9]
        n = np.cross(v1 - v0, v2 - v0)
        ndd = float(np.dot(n, d))
        if ndd == 0.0:
            return np.inf
        t = (np.dot(n, v0) - np.dot(n, o)) / ndd
        if t <= 0:
            return np.inf
        nn = n / np.linalg.norm(n)
        q = o + d * t
        for a, b2 in ((v0, v1), (v1, v2), (v2, v0)):
            if np.dot(nn, np.cross(b2 - a, q - a)) + 0.1 * EPS < 0:
                return np.inf
        return t
    if ptype == PrimType.AARECT:
        bmin, bmax = p[0:3], p[3:6]
        with np.errstate(divide="ignore"):
            inv = 1.0 / d
        t1 = (bmin - o) * inv
        t2 = (bmax - o) * inv
        tmin = np.max(np.minimum(t1, t2))
        tmax = np.min(np.maximum(t1, t2))
        if tmin >= tmax:
            return np.inf
        if tmin > 0:
            return tmin
        if tmax > 0:
            return tmax
        return np.inf
    if ptype == PrimType.SQUARE:
        if d[1] == 0.0:
            return np.inf
        t = (p[1] - o[1]) / d[1]
        if t <= 0:
            return np.inf
        q = o + d * t
        if 2 * abs(q[0] - p[0]) >= p[3] or 2 * abs(q[2] - p[2]) >= p[3]:
            return np.inf
        return t
    if ptype == PrimType.TORUS:
        # f64 quartic, like the reference (``torus.rs:61-126``)
        a, b = float(p[3]), float(p[4])
        dd = (o - p[0:3]).astype(np.float64)
        e = d.astype(np.float64)
        g = 4 * a * a * (e[0] ** 2 + e[2] ** 2)
        h = 8 * a * a * (dd[0] * e[0] + dd[2] * e[2])
        i = 4 * a * a * (dd[0] ** 2 + dd[2] ** 2)
        j = e @ e
        k = 2 * (dd @ e)
        l = dd @ dd + a * a - b * b
        coeffs = [j * j, 2 * j * k, 2 * j * l + k * k - g, 2 * k * l - h,
                  l * l - i]
        roots = np.roots(coeffs)
        real = roots[np.abs(roots.imag) < 1e-9].real
        pos = real[real >= 1e-4]
        return float(pos.min()) if pos.size else np.inf
    raise ValueError(ptype)


def _normal(ptype, p, o, d, t):
    """(normal, is_entering); mirrors each Rust ``trace``'s Hit."""
    q = o + d * t
    if ptype == PrimType.PLANE:
        n = p[3:6].copy()
        if np.dot(n, d) > 0:
            n = -n
        return n, True
    if ptype == PrimType.SPHERE:
        n = (q - p[0:3]) / p[3]
        inside = np.dot(o - p[0:3], o - p[0:3]) < p[3] * p[3]
        return (-n, False) if inside else (n, True)
    if ptype == PrimType.TRIANGLE:
        v0, v1, v2 = p[0:3], p[3:6], p[6:9]
        n = np.cross(v1 - v0, v2 - v0)
        n = n / np.linalg.norm(n)
        if np.dot(n, d) > 0:
            return -n, False
        return n, True
    if ptype == PrimType.AARECT:
        bmin, bmax = p[0:3], p[3:6]
        with np.errstate(divide="ignore"):
            inv = 1.0 / d
        t1 = (bmin - o) * inv
        t2 = (bmax - o) * inv
        tmin = np.max(np.minimum(t1, t2))
        inside = not (tmin > 0)
        cands = [t1[0], t2[0], t1[1], t2[1], t1[2], t2[2]]
        normals = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                   (0, 0, -1), (0, 0, 1)]
        idx = int(np.argmin([abs(t - c) for c in cands]))
        n = np.array(normals[idx], np.float32)
        if inside:
            n = -n
        return n, not inside
    if ptype == PrimType.SQUARE:
        n = np.array([0.0, 1.0, 0.0], np.float32)
        if d[1] > 0:
            n = -n
        return n, True
    if ptype == PrimType.TORUS:
        c, a, b = p[0:3], p[3], p[4]
        lp = q - c
        alpha = 1.0 - a / np.sqrt(lp[0] ** 2 + lp[2] ** 2)
        n = np.array([alpha * lp[0], lp[1], alpha * lp[2]], np.float32)
        n = n / np.linalg.norm(n)
        lo = o - c
        qx = np.sqrt(lo[0] ** 2 + lo[2] ** 2) - a
        inside = np.sqrt(qx * qx + lo[1] ** 2) - b < 0
        return (-n, False) if inside else (n, True)
    raise ValueError(ptype)


def trace_nearest(S, o, d):
    best_t, best_i = np.inf, -1
    for i in range(len(S["ptype"])):
        t = _isect(int(S["ptype"][i]), S["params"][i], o, d)
        if t < best_t:
            best_t, best_i = t, i
    return best_t, best_i


def shadow_occluded(S, p, p_l, light_sid):
    to_l = p_l - p
    dir_len = np.linalg.norm(to_l)
    d = to_l / dir_len
    o = p + d * EPS
    t, sid = trace_nearest(S, o, d)
    return sid >= 0 and t < dir_len and sid != light_sid


def _orthogonal(v):
    # ``src/math/vec3.rs:37-54``
    x, y, z = v
    if abs(z) > 0.1:
        o = np.array([1.0, 1.0, -(x + y) / z], np.float32)
    elif abs(x) > 0.1:
        o = np.array([-(y + z) / x, 1.0, 1.0], np.float32)
    else:
        o = np.array([1.0, -(x + z) / y, 1.0], np.float32)
    return o / np.linalg.norm(o)


def sample_hemisphere(n, r1, r2):
    x = np.cos(2 * np.pi * r1) * np.sqrt(1 - r2)
    y = np.sqrt(r2)
    z = np.sin(2 * np.pi * r1) * np.sqrt(1 - r2)
    t = _orthogonal(n)
    b = np.cross(n, t)
    wi = x * t + y * n + z * b
    wi = wi / np.linalg.norm(wi)
    return wi, np.dot(wi, n) / np.pi


def trace_color(S, o, d, ray_id, seed, has_nee=True, max_bounces=16):
    """``trace_original_color`` (``tracer.rs:224-330``) for one path."""
    color = np.zeros(3, np.float32)
    tp = np.ones(3, np.float32)
    hdb = False
    L = S["num_lights"]

    for b in range(max_bounces):
        slot0 = b * _SLOTS_PER_BOUNCE
        t, sid = trace_nearest(S, o, d)
        if not np.isfinite(t):
            color += tp * S["background"]
            return color
        p = S["params"][sid]
        pt = int(S["ptype"][sid])
        kind = int(S["mat_kind"][sid])
        hit_point = o + d * t
        if kind == MatKind.EMISSIVE:
            if (not has_nee) or (not hdb):
                color += tp * S["emission"][sid]
            return color

        n, _ent = _normal(pt, p, o, d, t)
        r1, r2, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_HEMI, xp=np)
        wi, pdf = sample_hemisphere(n, float(r1), float(r2))
        brdf = S["albedo"][sid] / np.pi
        cos_i = np.dot(wi, n)
        tp = tp * brdf * cos_i / pdf
        o = hit_point + wi * EPS
        d = wi
        hdb = True

        if has_nee and L > 0:
            u = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_PICK, xp=np)[0]
            lid = min(int(u * L), L - 1)
            chance = 1.0 / L
            lsid = int(S["light_shape"][lid])
            lv = S["params"][lsid]
            v0, v1, v2 = lv[0:3], lv[3:6], lv[6:9]
            s1, s2, s3 = rnglib.uniform3(seed, ray_id,
                                         slot0 + _SLOT_LIGHT_POINT, xp=np)
            r1s = np.sqrt(s1)
            p_l = (1 - r1s) * v0 + (r1s * (1 - s2)) * v1 + (s2 * r1s) * v2
            n_l = np.cross(v1 - v0, v2 - v0)
            n_l = n_l / np.linalg.norm(n_l)
            if s3 > 0.5:
                n_l = -n_l
            intensity = S["emission"][lsid]

            to_l = p_l - hit_point
            dis_sq = float(np.dot(to_l, to_l))
            to_l = to_l / np.sqrt(dis_sq)
            ci = float(np.dot(to_l, n))
            co = float(np.dot(-to_l, n_l))
            if ci > 0 and co > 0:
                if not shadow_occluded(S, hit_point, p_l, lsid):
                    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0))
                    solid = area * co / dis_sq
                    color += tp * intensity * solid * ci * (1.0 / chance)

        u_rr = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_RR, xp=np)[0]
        keep = float(np.clip(np.max(tp), 0.1, 0.9))
        if u_rr < keep:
            tp = tp / keep
        else:
            return color
    return color


def render(scene, camera, width, height, seed, has_nee=True, max_bounces=16,
           screen_z=0.8):
    """Full-frame render, 1 sample per pixel: the oracle for
    ``integrator.render_pixels``."""
    S = _np_scene(scene)
    loc = np.asarray(camera.location, np.float32)
    rx = float(camera.rot_x)
    ry = float(camera.rot_y)
    out = np.zeros((height, width, 3), np.float32)
    ar = width / height
    for y in range(height):
        for x in range(width):
            rid = y * width + x
            jx, jy, _ = rnglib.uniform3(seed, rid, SLOT_JITTER, xp=np)
            fx = ((x + float(jx)) / width - 0.5) * ar
            fy = 0.5 - (y + float(jy)) / height
            pix = np.array([fx, fy, screen_z], np.float32)
            dd = pix / np.linalg.norm(pix)
            c, s = np.cos(rx), np.sin(rx)
            dd = np.array([dd[0], c * dd[1] - s * dd[2], s * dd[1] + c * dd[2]])
            c, s = np.cos(ry), np.sin(ry)
            dd = np.array([c * dd[0] + s * dd[2], dd[1],
                           -s * dd[0] + c * dd[2]], np.float32)
            out[y, x] = trace_color(S, loc.copy(), dd, rid, seed,
                                    has_nee=has_nee, max_bounces=max_bounces)
    return out
