"""Iterative BVH4 traversal.

Replaces the reference's recursive traversals
(``src/graphics/scene.rs:218-342``): a short-stack ``lax.while_loop``
per ray, vmapped over the batch.  Each step pops one node, slab-tests
its four child boxes at once (the vectorized analog of ``AABBx4::hit``,
``aabb.rs:252-300``), intersects leaf triangles inline, and pushes
surviving internal children near-first (the reference sorts <=4
children by distance, ``scene.rs:346-388``).  ``max_dis`` pruning — a
child is skipped when its entry distance exceeds the best hit — carries
over directly.

Node-visit counting is preserved: the loop returns visits per ray, the
reference's built-in cost metric (``scene.rs:137-144``).

Sessions trace meshes through the cluster structure
(``ops.cluster``); this walk is the BVH route of ``trace.trace_scene``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.ops import bvh as bvhmod
from wasm_pathtracer_tpu.ops import intersect as isx
from wasm_pathtracer_tpu.utils import vecmath as vm

STACK_DEPTH = 48
_COUNT_BITS = bvhmod._COUNT_BITS


def _aabb4_hit(o, inv_d, bounds, t_max):
    """Entry distances of one ray against 4 child AABBs.

    ``AABBx4::hit`` semantics (``aabb.rs:252-300``): returns the entry
    distance, 0 if the origin is inside, +inf on miss or beyond t_max.
    bounds: (4, 6) [lo, hi].
    """
    t1 = (bounds[:, 0:3] - o[None, :]) * inv_d[None, :]
    t2 = (bounds[:, 3:6] - o[None, :]) * inv_d[None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    entry = jnp.maximum(tmin, 0.0)
    return jnp.where(hit & (entry < t_max), entry, jnp.inf)


def _leaf_intersect(tri_rows, o, d, first, count, t_best, slot_best):
    """Intersect up to LEAF_MAX triangles of one leaf (single ray).

    ``tri_rows`` is the (T, 9) leaf-ordered vertex table
    (``ScenePrep.bvh_tri_rows``) — NOT the full shape table: gathering
    ``scene.params`` inside the vmapped loop makes XLA materialize a
    rays x shapes x 9 broadcast.  Returns leaf slots; callers map slots
    to shape ids outside the loop.
    """
    for i in range(bvhmod.LEAF_MAX):
        valid = i < count
        slot = jnp.maximum(first + jnp.minimum(i, count - 1), 0)
        # jnp.take, not tri_rows[slot]: scalar indexing lowers to
        # dynamic_slice, whose vmap rule broadcasts the whole table to
        # (rays, T, 9); take lowers to a gather
        row = jnp.take(tri_rows, slot, axis=0, mode='clip')
        t = _tri_one(o, d, row[0:3], row[3:6], row[6:9])
        better = valid & (t < t_best)
        t_best = jnp.where(better, t, t_best)
        slot_best = jnp.where(better, slot, slot_best)
    return t_best, slot_best


def _tri_one(o, d, v0, v1, v2):
    """Single ray-triangle test (``triangle.rs:159-191``)."""
    # vm.dot sums, not jnp.dot: under vmap a float32 dot may become a
    # matrix product that a GPU runs in TF32
    n = jnp.cross(v1 - v0, v2 - v0)
    n_dot_d = vm.dot(n, d)
    t = (vm.dot(n, v0) - vm.dot(n, o)) / n_dot_d
    nn = n * jax.lax.rsqrt(jnp.maximum(vm.dot(n, n), 1e-30))
    p = o + d * t

    def left_of(a, b):
        return vm.dot(nn, jnp.cross(b - a, p - a)) + 0.1 * isx.EPSILON >= 0.0

    inside = left_of(v0, v1) & left_of(v1, v2) & left_of(v2, v0)
    ok = (n_dot_d != 0.0) & (t > 0.0) & inside
    return jnp.where(ok, t, jnp.inf)


def trace_bvh4(bounds, children, prim_index, tri_rows, o, d, t_init):
    """Nearest triangle hit through the BVH for a ray batch.

    Args:
      bounds: (M, 4, 6) child AABBs; children: (M, 4) int32 slots
        (>=0 internal, <0 leaf-encoded, EMPTY for none).
      prim_index: (T,) leaf-order -> global shape id.
      tri_rows: (T, 9) leaf-ordered triangle vertices.
      t_init: (R,) current best distances (prunes traversal).

    Returns (t, shape_id, visits).
    """

    def one(o1, d1, t0):
        inv_d = 1.0 / d1

        def cond(state):
            sp, _, _, _, _ = state
            return sp > 0

        def body(state):
            sp, stack, t_best, sid_best, visits = state
            node = stack[sp - 1]
            sp = sp - 1
            visits = visits + 1

            nb = jnp.take(bounds, node, axis=0, mode='clip')    # (4, 6)
            ch = jnp.take(children, node, axis=0, mode='clip')  # (4,)
            dist = _aabb4_hit(o1, inv_d, nb, t_best)
            dist = jnp.where(ch == bvhmod.EMPTY, jnp.inf, dist)

            # --- leaves: intersect inline -----------------------------
            # no lax.cond here: under vmap, cond batching broadcasts the
            # branch's closed-over tables to (rays, T, 9); a masked
            # unconditional call costs LEAF_MAX cheap tests instead
            is_leaf = (ch < 0) & (ch != bvhmod.EMPTY) & jnp.isfinite(dist)
            for i in range(4):
                first, count = bvhmod.decode_leaf(ch[i])
                count = jnp.where(is_leaf[i], count, 0)
                first = jnp.where(is_leaf[i], first, 0)
                t_best, sid_best = _leaf_intersect(
                    tri_rows, o1, d1, first, count, t_best, sid_best)

            # --- internals: push far-to-near so near pops first -------
            is_int = (ch >= 0) & jnp.isfinite(dist)
            d_int = jnp.where(is_int, dist, -jnp.inf)
            order = jnp.argsort(-d_int)            # far first
            for i in range(4):
                k = order[i]
                push = is_int[k]
                stack = stack.at[sp].set(jnp.where(push, ch[k], stack[sp]))
                sp = sp + jnp.where(push, 1, 0)

            return sp, stack, t_best, sid_best, visits

        stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
        state = (jnp.int32(1), stack, t0, jnp.int32(-1), jnp.int32(0))
        sp, stack, t_best, slot_best, visits = jax.lax.while_loop(
            cond, body, state)
        return t_best, slot_best, visits

    t, slot, visits = jax.vmap(one)(o, d, t_init)
    sid = prim_index[jnp.maximum(slot, 0)]
    sid = jnp.where(slot >= 0, sid, -1)
    return t, sid, visits
