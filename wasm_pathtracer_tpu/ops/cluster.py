"""Cluster-dense traversal — the acceleration structure for scenes with
many finite primitives (any type, not just triangles).

A vmapped per-ray BVH walk (``ops.traverse``) is a divergent
``while_loop`` with one scalar gather per node visit; the reference's
recursion (``scene.rs:218-342``) has no direct batched analog.  The
cluster structure trades that for wide dense compute and
block-granular memory moves.  Primitives are grouped into
fixed-size **clusters** (contiguous runs of the BVH leaf order, so each
cluster is spatially coherent — the BVH build quality still matters,
it just moves into the data layout):

1. rays x clusters slab test — one dense (R, C) pass (the
   descendant of ``AABBx4::hit``, scaled from 4 boxes to all of them);
2. iterative nearest-cluster probing: each round, every active ray
   picks its nearest untested cluster, gathers that cluster's whole
   (G, 9) parameter block (one contiguous ~4.5 KB slice per ray — a
   coarse, memory-friendly gather), tests all G primitives densely with a
   masked type switch, and retires the cluster;
3. a ray stops when its nearest remaining cluster entry distance
   exceeds its best hit — the same ``max_dis`` pruning as the
   reference's ordered descent.

The masked type switch mirrors the reference's generic
``ShapeRep { shape: Rc<dyn Tracable>, .. }`` BVH (``bvh.rs:84-103``):
the acceleration structure covers every finite shape, with the vtable
dispatch replaced by per-type vectorized formulas gated on the block's
type codes.  Only the families actually present in the structure are
compiled in (``ClusterSet.families`` is static).

The loop is a ``lax.while_loop`` in lockstep over the batch; rounds
cost O(R*G) dense work + one structured gather, and typical rays
finish in a handful of rounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.models.scene import PrimType
from wasm_pathtracer_tpu.ops import intersect as isx

CLUSTER_SIZE = 128   # primitives per cluster (G)


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Device-side cluster tables."""

    lo: jax.Array          # (C, 3) cluster AABB min
    hi: jax.Array          # (C, 3) cluster AABB max
    blocks: jax.Array      # (C, G, 9) primitive param rows (padded zero)
    btype: jax.Array       # (C, G) int32 PrimType, -1 = padding
    slot_to_sid: jax.Array  # (C*G,) leaf-slot -> global shape id (-1 pad)
    # static tuple of PrimType ints present — gates which intersection
    # branches get compiled into the block test
    families: tuple = _field(metadata=dict(static=True),
                             default=(int(PrimType.TRIANGLE),))
    max_rounds: int = _field(metadata=dict(static=True), default=64)
    # whether any emissive (light_shape) shape is baked into ``blocks``
    # — if so, light-geometry training must refuse this prep (updated
    # light rows would go stale in the baked tables); build with
    # ``bvh.attach_clusters(..., exclude_lights=True)`` to keep lights
    # in the live dense remainder instead
    has_baked_lights: bool = _field(metadata=dict(static=True),
                                    default=True)


def prim_aabbs(rows: np.ndarray, ptypes: np.ndarray):
    """Host-side AABBs for a (N, 9) param-row table of finite
    primitives.  Mirrors each primitive's ``Bounded::aabb``
    (sphere.rs / triangle.rs / torus.rs / aa_rect.rs / square.rs)."""
    rows = np.asarray(rows, np.float32)
    ptypes = np.asarray(ptypes)
    n = rows.shape[0]
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)

    m = ptypes == int(PrimType.TRIANGLE)
    if m.any():
        v = rows[m, :9].reshape(-1, 3, 3)
        lo[m], hi[m] = v.min(1), v.max(1)
    m = ptypes == int(PrimType.SPHERE)
    if m.any():
        c, r = rows[m, 0:3], rows[m, 3:4]
        lo[m], hi[m] = c - r, c + r
    m = ptypes == int(PrimType.TORUS)
    if m.any():
        c = rows[m, 0:3]
        ext = np.stack([rows[m, 3] + rows[m, 4], rows[m, 4],
                        rows[m, 3] + rows[m, 4]], axis=-1)
        lo[m], hi[m] = c - ext, c + ext
    m = ptypes == int(PrimType.AARECT)
    if m.any():
        lo[m], hi[m] = rows[m, 0:3], rows[m, 3:6]
    m = ptypes == int(PrimType.SQUARE)
    if m.any():
        c, s = rows[m, 0:3], rows[m, 3]
        half = np.stack([s / 2, np.zeros_like(s), s / 2], axis=-1)
        lo[m], hi[m] = c - half, c + half

    pad = np.float32(0.1 * 2e-4)
    return lo - pad, hi + pad


def build_clusters(rows: np.ndarray, ptypes: np.ndarray,
                   prim_index: np.ndarray,
                   group: int = CLUSTER_SIZE) -> ClusterSet:
    """Partition leaf-ordered finite primitives into fixed clusters.

    ``rows``: (T, 9) leaf-ordered param rows (from the BVH build — the
    leaf order is what makes contiguous runs spatially tight).
    ``ptypes``: (T,) PrimType codes.  ``prim_index``: (T,) leaf slot ->
    shape id.
    """
    rows = np.asarray(rows, np.float32)
    ptypes = np.asarray(ptypes, np.int32)
    prim_index = np.asarray(prim_index, np.int32)
    T = rows.shape[0]
    pad = (-T) % group
    rows_p = np.pad(rows, ((0, pad), (0, 0)))
    types_p = np.pad(ptypes, (0, pad), constant_values=-1)
    sids = np.pad(prim_index, (0, pad), constant_values=-1)
    C = rows_p.shape[0] // group
    blocks = rows_p.reshape(C, group, 9)
    btype = types_p.reshape(C, group)

    lo_t, hi_t = prim_aabbs(rows, ptypes)
    lo_p = np.pad(lo_t, ((0, pad), (0, 0)), constant_values=1e30)
    hi_p = np.pad(hi_t, ((0, pad), (0, 0)), constant_values=-1e30)
    lo = lo_p.reshape(C, group, 3).min(axis=1)
    hi = hi_p.reshape(C, group, 3).max(axis=1)

    fams = tuple(sorted(int(t) for t in np.unique(ptypes)))
    return ClusterSet(
        lo=jnp.asarray(lo),
        hi=jnp.asarray(hi),
        blocks=jnp.asarray(blocks),
        btype=jnp.asarray(btype),
        slot_to_sid=jnp.asarray(sids),
        families=fams,
        max_rounds=int(C),
    )


def _rays_vs_boxes(o, d, lo, hi):
    """(R,3) x (C,3) -> (R,C) entry distance (0 if inside), inf miss."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    t1 = (lo[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (hi[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return jnp.where(hit, jnp.maximum(tmin, 0.0), jnp.inf)


def _tri_block_test(o, d, block):
    """(R,3) rays vs per-ray (R,G,9) triangle blocks -> (R,G) distances."""
    v0, v1, v2 = block[..., 0:3], block[..., 3:6], block[..., 6:9]
    n = jnp.cross(v1 - v0, v2 - v0)                      # (R,G,3)
    ndd = jnp.sum(n * d[:, None, :], -1)
    ndd = jnp.where(jnp.abs(ndd) < 1e-30, 1e-30, ndd)
    t = (jnp.sum(n * v0, -1) - jnp.sum(n * o[:, None, :], -1)) / ndd
    nn = n * jax.lax.rsqrt(jnp.maximum(jnp.sum(n * n, -1), 1e-30))[..., None]
    p = o[:, None, :] + d[:, None, :] * t[..., None]

    inside = jnp.ones(t.shape, bool)
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        c = jnp.cross(b - a, p - a)
        inside &= jnp.sum(c * nn, -1) + 0.1 * 2e-4 >= 0.0
    return jnp.where(inside & (t > 0.0), t, jnp.inf)


def _sphere_block_test(o, d, block):
    """Per-ray sphere rows: center block[...,0:3], radius block[...,3]."""
    oc = o[:, None, :] - block[..., 0:3]                 # (R,G,3)
    rad = block[..., 3]
    b = 2.0 * jnp.sum(oc * d[:, None, :], -1)
    c = jnp.sum(oc * oc, -1) - rad * rad
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    tn, tf = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
    t = jnp.where(tn > 0.0, tn, tf)
    ok = (disc >= 0.0) & (t > 0.0) & (rad > 0.0)
    return jnp.where(ok, t, jnp.inf)


def _aarect_block_test(o, d, block):
    """Per-ray aarect rows: (min, max) corners."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    t1 = (block[..., 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (block[..., 3:6] - o[:, None, :]) * inv_d[:, None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), -1)
    tmax = jnp.min(jnp.maximum(t1, t2), -1)
    t = jnp.where(tmin > 0.0, tmin, tmax)
    return jnp.where((tmin < tmax) & (t > 0.0), t, jnp.inf)


def _square_block_test(o, d, block):
    """Per-ray square rows: center block[...,0:3], size block[...,3]."""
    dy = d[:, None, 1]
    ndd = jnp.where(jnp.abs(dy) < 1e-30, 1e-30, dy)
    t = (block[..., 1] - o[:, None, 1]) / ndd
    px = o[:, None, 0] + d[:, None, 0] * t
    pz = o[:, None, 2] + d[:, None, 2] * t
    dx = jnp.abs(px - block[..., 0])
    dz = jnp.abs(pz - block[..., 2])
    size = block[..., 3]
    inside = (2.0 * dx < size) & (2.0 * dz < size)
    return jnp.where(inside & (t > 0.0) & (dy != 0.0), t, jnp.inf)


def _torus_block_test(o, d, block):
    """Per-ray torus rows: center, R, r — the shared march core."""
    lo = o[:, None, :] - block[..., 0:3]
    ld = jnp.broadcast_to(d[:, None, :], lo.shape)
    return isx.tori_march(lo, ld, block[..., 3], block[..., 4])


_BLOCK_TESTS = {
    int(PrimType.TRIANGLE): _tri_block_test,
    int(PrimType.SPHERE): _sphere_block_test,
    int(PrimType.TORUS): _torus_block_test,
    int(PrimType.AARECT): _aarect_block_test,
    int(PrimType.SQUARE): _square_block_test,
}


def _block_test(o, d, block, btype, families):
    """Masked type-switched intersection of per-ray (R,G,9) blocks.

    Only the families present in the structure are compiled in; a
    single-family structure (the common triangle-mesh case) pays no
    switch at all.
    """
    if len(families) == 1:
        t = _BLOCK_TESTS[families[0]](o, d, block)
        return jnp.where(btype == families[0], t, jnp.inf)
    t = jnp.full(btype.shape, jnp.inf, jnp.float32)
    for fam in families:
        tf = _BLOCK_TESTS[fam](o, d, block)
        t = jnp.where(btype == fam, tf, t)
    return t


def trace_clusters(cs: ClusterSet, o, d, t_init):
    """Nearest hit through the cluster structure.

    Returns (t, leaf_slot, rounds) — map slots through
    ``cs.slot_to_sid`` for shape ids; rounds is the per-ray probe count
    (the cost counter analog of BVH node visits).
    """
    R = o.shape[0]
    G = cs.blocks.shape[1]
    ent = _rays_vs_boxes(o, d, cs.lo, cs.hi)            # (R, C)

    def cond(state):
        ent, t_best, _, _ = state
        return jnp.any(jnp.min(ent, axis=1) < t_best)

    def body(state):
        ent, t_best, slot_best, rounds = state
        e = jnp.min(ent, axis=1)
        c = jnp.argmin(ent, axis=1).astype(jnp.int32)   # (R,)
        active = e < t_best
        rounds = rounds + jnp.where(active, 1, 0)

        block = jnp.take(cs.blocks, c, axis=0)          # (R, G, 9)
        btype = jnp.take(cs.btype, c, axis=0)           # (R, G)
        t = _block_test(o, d, block, btype, cs.families)
        t = jnp.where(active[:, None], t, jnp.inf)
        jloc = jnp.argmin(t, axis=1).astype(jnp.int32)
        tloc = jnp.min(t, axis=1)
        better = tloc < t_best
        t_best = jnp.where(better, tloc, t_best)
        slot_best = jnp.where(better, c * G + jloc, slot_best)

        # retire the probed cluster
        cols = jax.lax.broadcasted_iota(jnp.int32, ent.shape, 1)
        ent = jnp.where(cols == c[:, None], jnp.inf, ent)
        return ent, t_best, slot_best, rounds

    state = (ent, t_init, jnp.full((R,), -1, jnp.int32),
             jnp.zeros((R,), jnp.int32))
    _, t_best, slot_best, rounds = jax.lax.while_loop(cond, body, state)
    return t_best, slot_best, rounds
