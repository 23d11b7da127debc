"""Vector math over trailing-axis-3 arrays.

The reference implements these as scalar ``Vec3`` methods
(``src/math/vec3.rs``).  Here every function operates on arrays of shape
``(..., 3)`` so a whole ray batch flows through at once, and all
of them are differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """Batched dot product -> ``(...)`` (``src/math/vec3.rs:32-34``)."""
    return jnp.sum(a * b, axis=-1)


def length_sq(v):
    return dot(v, v)


def length(v):
    return jnp.sqrt(length_sq(v))


def normalize(v, eps: float = 0.0):
    """Unit-scale ``v``; matches ``Vec3::normalize`` (v * 1/len)."""
    return v * (1.0 / jnp.maximum(length(v), eps))[..., None] if eps else v / length(v)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def reflect(v, n):
    """Reflect ``v`` along normal ``n`` (``src/math/vec3.rs:85-87``).

    Note the reference convention: ``v`` points *away* from the surface
    (it reflects ``wo``, not the incoming ray direction).
    """
    return 2.0 * dot(v, n)[..., None] * n - v


def rot_x(v, angle):
    """Rotate about the x axis (``src/math/vec3.rs:108-119``)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([x, c * y - s * z, s * y + c * z], axis=-1)


def rot_y(v, angle):
    """Rotate about the y axis (``src/math/vec3.rs:95-106``)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


def orthogonal(v):
    """Some unit vector orthogonal to ``v``.

    Branch-free rewrite of ``Vec3::orthogonal`` (``src/math/vec3.rs:37-54``):
    the reference picks which two components to set to 1 based on which of
    z / x / y has magnitude > 0.1 and solves the third from v.o = 0.  We
    reproduce the same three candidate solutions and select with
    ``jnp.where`` so the whole batch vectorizes.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    safe = lambda d: jnp.where(jnp.abs(d) > 1e-12, d, 1.0)

    # z-branch: (1, 1, -(x+y)/z)
    cand_z = jnp.stack([jnp.ones_like(x), jnp.ones_like(x), -(x + y) / safe(z)], axis=-1)
    # x-branch: (-(y+z)/x, 1, 1)
    cand_x = jnp.stack([-(y + z) / safe(x), jnp.ones_like(x), jnp.ones_like(x)], axis=-1)
    # y-branch: (1, -(x+z)/y, 1)
    cand_y = jnp.stack([jnp.ones_like(x), -(x + z) / safe(y), jnp.ones_like(x)], axis=-1)

    use_z = (jnp.abs(z) > 0.1)[..., None]
    use_x = (jnp.abs(x) > 0.1)[..., None]
    out = jnp.where(use_z, cand_z, jnp.where(use_x, cand_x, cand_y))
    return normalize(out)


def tangent_frame(n):
    """Tangent basis (t, b) around normal ``n``.

    Matches the frame built inside ``PointMaterial::sample_hemisphere``
    (``src/graphics/material.rs:109-110``): t = orthogonal(n),
    b = n x t.
    """
    t = orthogonal(n)
    b = cross(n, t)
    return t, b
