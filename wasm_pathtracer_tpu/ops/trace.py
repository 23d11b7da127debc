"""Scene tracing: nearest-hit, shadow rays, hit shading info.

Replaces ``Scene::{trace, trace_simple, shadow_ray}``
(``src/graphics/scene.rs:104-184``).  Three routes, chosen per scene by
the static :class:`ScenePrep`:

- **dense**: every primitive family is tested rays x primitives;
  results concatenate and a single argmin picks the winner.  For large
  triangle counts the test runs as a ``lax.scan`` over fixed-size
  triangle chunks holding a running minimum, so memory stays bounded
  while the compute remains dense.  This is the differentiable path and
  the plain reference the kernels are checked against.
- **fused**: the dense families run through the Pallas scene kernel
  (``ops.scene_pallas``), forward only.  :func:`prepare` turns it on
  for the GPU backend.
- **bvh**: triangles go through the flat-array BVH traversal
  (``ops.traverse``); everything else stays dense.

A cluster structure (``ops.cluster``), when attached, covers the large
finite families and merges its nearest hit after the dense/fused pass.
The infinite-shape prefix is always dense, mirroring the reference's
brute-force prefix (``scene.rs:162-184``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.models.scene import PrimType, SceneData
from wasm_pathtracer_tpu.ops import intersect as isx
from wasm_pathtracer_tpu.utils import vecmath as vm


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScenePrep:
    """Static trace-time plan for a scene.

    Holds per-type *index* arrays into the unified shape table; the
    parameter gathers happen inside jit so gradients flow back to
    ``SceneData.params`` / material leaves.
    """

    idx_plane: jax.Array
    idx_sphere: jax.Array
    idx_triangle: jax.Array
    idx_torus: jax.Array
    idx_aarect: jax.Array
    idx_square: jax.Array
    # triangle chunk size for the scanned dense test (static)
    tri_chunk: int = _field(metadata=dict(static=True), default=2048)
    # filled in by ops.bvh.attach_bvh when a BVH is attached
    bvh_bounds: jax.Array | None = None      # (M, 4, 6) f32 child AABBs
    bvh_children: jax.Array | None = None    # (M, 4) int32 (neg = leaf)
    bvh_prim_index: jax.Array | None = None  # (T,) int32 leaf->shape id
    bvh_tri_rows: jax.Array | None = None    # (T, 9) f32 leaf-order verts
    # cluster-dense structure (ops.cluster) — the fast path for meshes
    cluster: object | None = None            # ClusterSet pytree
    # route the dense-family scene test through the Pallas scene kernel
    # (ops.scene_pallas) — forward-only (the kernel has no VJP).
    # Composes with an attached cluster structure (the kernel covers
    # the dense remainder, the clusters merge after); ignored when a
    # BVH is attached
    use_fused: bool = _field(metadata=dict(static=True), default=False)
    # run that kernel in Pallas's interpreter (how the CPU tests reach it)
    interpret: bool = _field(metadata=dict(static=True), default=False)

    @property
    def has_bvh(self) -> bool:
        return self.bvh_bounds is not None


def prepare(scene: SceneData, tri_chunk: int = 2048,
            use_fused: bool | None = None,
            interpret: bool = False) -> ScenePrep:
    """Host-side split of the shape table into per-type index sets, and
    the platform decision for the forward trace.

    ``use_fused=None`` decides once, here: the Pallas scene kernel on
    the GPU backend, the XLA dense path everywhere else (on the CPU,
    XLA is the plain reference).  ``interpret=True`` runs the kernel in
    Pallas's interpreter, the only way to reach it without a GPU.
    Gradient workloads need ``use_fused=False``
    (``parallel.make_train_step`` clears it itself).  Nothing falls
    back: a kernel that does not compile fails the trace.
    """
    gpu = jax.default_backend() == "gpu"
    if use_fused is None:
        use_fused = gpu or interpret
    if use_fused and not (gpu or interpret):
        raise ValueError("the Pallas scene kernel needs the GPU backend "
                         "or interpret=True")
    ptype = np.asarray(scene.ptype)

    def idx(t):
        return jnp.asarray(np.nonzero(ptype == int(t))[0].astype(np.int32))

    return ScenePrep(
        idx_plane=idx(PrimType.PLANE),
        idx_sphere=idx(PrimType.SPHERE),
        idx_triangle=idx(PrimType.TRIANGLE),
        idx_torus=idx(PrimType.TORUS),
        idx_aarect=idx(PrimType.AARECT),
        idx_square=idx(PrimType.SQUARE),
        tri_chunk=tri_chunk,
        use_fused=bool(use_fused),
        interpret=bool(interpret),
    )


def _min_over(t_mat, gids, best_t, best_id):
    """Fold an (R, P) candidate matrix into the running (t, shape_id)."""
    if t_mat.shape[1] == 0:
        return best_t, best_id
    j = jnp.argmin(t_mat, axis=1)
    t = jnp.take_along_axis(t_mat, j[:, None], axis=1)[:, 0]
    sid = gids[j]
    better = t < best_t
    return jnp.where(better, t, best_t), jnp.where(better, sid, best_id)


def trace_scene(prep: ScenePrep, scene: SceneData, o, d):
    """Nearest hit for a ray batch.

    Returns ``(t, shape_id, hit_mask, cost)`` — ``cost`` counts
    primitive/node tests per ray, the analog of the reference's BVH-visit
    counter (``scene.rs:137-144``).
    """
    R = o.shape[0]
    n_dense = sum(getattr(prep, f"idx_{k}").shape[0] for k in
                  ("plane", "sphere", "torus", "aarect", "square"))

    if prep.use_fused and not prep.has_bvh:
        # whole-scene Pallas kernel over the dense families (forward
        # only); clustered families merge below
        if n_dense + prep.idx_triangle.shape[0] > 0:
            from wasm_pathtracer_tpu.ops import scene_pallas
            best_t, best_id, _, cost = scene_pallas.trace_scene_fused(
                prep, scene, o, d)
        else:
            best_t = jnp.full((R,), jnp.inf, jnp.float32)
            best_id = jnp.full((R,), -1, jnp.int32)
            cost = jnp.zeros((R,), jnp.int32)
        return _merge_cluster(prep, o, d, best_t, best_id, cost)

    best_t = jnp.full((R,), jnp.inf, jnp.float32)
    best_id = jnp.full((R,), -1, jnp.int32)
    cost = jnp.zeros((R,), jnp.int32)

    P = scene.params

    if prep.idx_plane.shape[0]:
        rows = P[prep.idx_plane]
        t = isx.rays_vs_planes(o, d, rows[:, 0:3], rows[:, 3:6])
        best_t, best_id = _min_over(t, prep.idx_plane, best_t, best_id)
        cost += prep.idx_plane.shape[0]

    if prep.idx_sphere.shape[0]:
        rows = P[prep.idx_sphere]
        t = isx.rays_vs_spheres(o, d, rows[:, 0:3], rows[:, 3])
        best_t, best_id = _min_over(t, prep.idx_sphere, best_t, best_id)
        cost += prep.idx_sphere.shape[0]

    if prep.idx_torus.shape[0]:
        rows = P[prep.idx_torus]
        t = isx.rays_vs_tori(o, d, rows[:, 0:3], rows[:, 3], rows[:, 4])
        best_t, best_id = _min_over(t, prep.idx_torus, best_t, best_id)
        cost += prep.idx_torus.shape[0]

    if prep.idx_aarect.shape[0]:
        rows = P[prep.idx_aarect]
        t = isx.rays_vs_aarects(o, d, rows[:, 0:3], rows[:, 3:6])
        best_t, best_id = _min_over(t, prep.idx_aarect, best_t, best_id)
        cost += prep.idx_aarect.shape[0]

    if prep.idx_square.shape[0]:
        rows = P[prep.idx_square]
        t = isx.rays_vs_squares(o, d, rows[:, 0:3], rows[:, 3])
        best_t, best_id = _min_over(t, prep.idx_square, best_t, best_id)
        cost += prep.idx_square.shape[0]

    n_tri = prep.idx_triangle.shape[0]
    if n_tri:
        if prep.has_bvh:
            from wasm_pathtracer_tpu.ops import traverse
            t, sid, visits = traverse.trace_bvh4(
                prep.bvh_bounds, prep.bvh_children, prep.bvh_prim_index,
                prep.bvh_tri_rows, o, d, best_t)
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_id = jnp.where(better, sid, best_id)
            cost += visits
        elif n_tri <= prep.tri_chunk:
            rows = P[prep.idx_triangle]
            t = isx.rays_vs_triangles(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
            best_t, best_id = _min_over(t, prep.idx_triangle, best_t, best_id)
            cost += n_tri
        else:
            # scan fixed-size chunks with a running min: dense compute,
            # bounded memory
            C = prep.tri_chunk
            n_chunks = -(-n_tri // C)
            pad = n_chunks * C - n_tri
            idx_pad = jnp.pad(prep.idx_triangle, (0, pad))  # pad rows re-test tri 0
            valid = jnp.pad(jnp.ones((n_tri,), bool), (0, pad))
            idx_cs = idx_pad.reshape(n_chunks, C)
            valid_cs = valid.reshape(n_chunks, C)

            def body(carry, chunk):
                bt, bid = carry
                ids, ok = chunk
                rows = P[ids]
                t = isx.rays_vs_triangles(o, d, rows[:, 0:3], rows[:, 3:6],
                                          rows[:, 6:9])
                t = jnp.where(ok[None, :], t, jnp.inf)
                bt, bid = _min_over(t, ids, bt, bid)
                return (bt, bid), None

            (best_t, best_id), _ = jax.lax.scan(
                body, (best_t, best_id), (idx_cs, valid_cs))
            cost += n_tri

    return _merge_cluster(prep, o, d, best_t, best_id, cost)


def _merge_cluster(prep: ScenePrep, o, d, best_t, best_id, cost):
    """Fold the cluster structure's nearest hit into the running best
    and finalize the (t, sid, hit, cost) contract."""
    if prep.cluster is not None:
        from wasm_pathtracer_tpu.ops import cluster as cl
        # the cluster structure covers FROZEN baked geometry, and its
        # traversal while_loop has no reverse-mode rule — detach ALL
        # its inputs so it stays off the differentiation path.  This
        # is exact for the supported gradient modes (the train-step
        # guard, parallel/shard.py): differentiable geometry (lights)
        # lives in the live dense remainder (attach_clusters
        # exclude_lights=True); paths terminate at emissive hits, so
        # light tangents reach ray origins/directions only through
        # shadow rays, whose cluster-side verdict is discrete; and
        # camera training (whose tangents would ride o/d into mesh
        # hit distances) requires a dense prep.  The running best
        # enters only as a pruning bound — discrete accept/visit.
        sg = jax.lax.stop_gradient
        t, slot, rounds = cl.trace_clusters(
            prep.cluster, sg(o), sg(d), sg(best_t))
        hit_cl = slot >= 0
        sid = prep.cluster.slot_to_sid[jnp.maximum(slot, 0)]
        sid = jnp.where(hit_cl, sid, -1)
        better = hit_cl & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_id = jnp.where(better, sid, best_id)
        cost += rounds * prep.cluster.blocks.shape[1]
    hit = jnp.isfinite(best_t)
    return jnp.where(hit, best_t, jnp.inf), best_id, hit, cost


def shadow_ray(prep: ScenePrep, scene: SceneData, p, point_on_light,
               light_sid, epsilon: float = isx.EPSILON):
    """Occlusion test ``Scene::shadow_ray`` (``scene.rs:104-133``).

    The target light shape itself does not occlude.  Returns
    (occluded mask, cost).

    On the fused forward path this is a DISTINCT any-hit query
    (``ops.scene_pallas.occluded_fused``) rather than a nearest-hit
    trace plus comparison — the reference keeps the shadow ray a
    cheaper query with light exclusion and distance-bounded early-out
    (``scene.rs:104-133``, ``max_dis`` pruning ``scene.rs:262-288``);
    the any-hit kernel mirrors that: no argmin/shape-id reduction, and
    a torus march is skipped where it cannot change the verdict.
    """
    to_l = point_on_light - p
    dir_len = vm.length(to_l)
    d = to_l / dir_len[..., None]
    o = p + d * epsilon
    if prep.use_fused and not prep.has_bvh and prep.cluster is None:
        from wasm_pathtracer_tpu.ops import scene_pallas
        return scene_pallas.occluded_fused(prep, scene, o, d, dir_len,
                                           light_sid)
    t, sid, hit, cost = trace_scene(prep, scene, o, d)
    occluded = hit & (t < dir_len) & (sid != light_sid)
    return occluded, cost


# ---------------------------------------------------------------------------
# Hit shading info (the per-primitive ``Hit`` construction, evaluated only
# for the winning shape of each ray)
# ---------------------------------------------------------------------------

def pack_hit_rows(scene: SceneData):
    """One (N, 24) f32 row per shape: params 0:9, albedo 9:12,
    emission 12:15, mat_extra 15:20, ptype 20, mat_kind 21, tex_id 22,
    pad 23.

    :func:`hit_info` reads ONE packed row per ray instead of seven
    separate tables (one gather op instead of seven).  Int columns are
    exact in f32 (values << 2^24).  Differentiable leaves (albedo /
    emission / mat_extra) flow through concat->gather->slice, so
    gradients are unchanged.

    Loop callers should build this once outside their bounce loop and
    pass it to :func:`hit_info` — it depends on the (possibly updated)
    material leaves, so it cannot be baked into ``ScenePrep``.
    """
    f32 = jnp.float32
    return jnp.concatenate(
        [scene.params, scene.albedo, scene.emission, scene.mat_extra,
         scene.ptype[:, None].astype(f32),
         scene.mat_kind[:, None].astype(f32),
         scene.tex_id[:, None].astype(f32),
         jnp.zeros((scene.params.shape[0], 1), f32)], axis=1)


def hit_info(scene: SceneData, o, d, t, sid, packed=None):
    """Normals, entering flags and material rows for hits.

    Per-ray single-row gathers; all six primitive normal formulas are
    evaluated on the gathered row and selected by type (cheap: one row
    per ray, not per primitive).

    ``packed`` is :func:`pack_hit_rows`'s output (built here when not
    supplied — loop callers pass it in to keep it loop-invariant).

    Returns dict with n, is_entering, kind, albedo, emission, extra.
    """
    if packed is None:
        packed = pack_hit_rows(scene)
    prow = packed[sid]                             # (R, 24) — ONE gather
    rows = prow[:, 0:9]
    pt = prow[:, 20].astype(jnp.int32)             # (R,)

    n_pl, e_pl = isx.plane_normal(d, rows[:, 3:6])
    n_sp, e_sp = isx.sphere_normal(o, d, t, rows[:, 0:3], rows[:, 3])
    n_tr, e_tr = isx.triangle_normal(d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    n_to, e_to = isx.torus_normal(o, d, t, rows[:, 0:3], rows[:, 3], rows[:, 4])
    n_aa, e_aa = isx.aarect_normal(o, d, t, rows[:, 0:3], rows[:, 3:6])
    n_sq, e_sq = isx.square_normal(d)

    def sel3(vals):
        # PrimType values are 0..5 in this order (see models.scene.PrimType)
        out = vals[0]
        for k, v in enumerate(vals[1:], start=1):
            out = jnp.where((pt == k)[..., None], v, out)
        return out

    n = sel3([n_pl, n_sp, n_tr, n_to, n_aa, n_sq])
    ent = jnp.select(
        [pt == int(k) for k in (PrimType.PLANE, PrimType.SPHERE,
                                PrimType.TRIANGLE, PrimType.TORUS,
                                PrimType.AARECT, PrimType.SQUARE)],
        [e_pl, e_sp, e_tr, e_to, e_aa, e_sq], default=True)

    albedo = prow[:, 9:12]
    tex = prow[:, 22].astype(jnp.int32)
    if scene.textures.shape[0] > 0:
        u, v = _hit_uv(pt, rows, o, d, t, n)
        albedo = jnp.where((tex >= 0)[..., None],
                           _texture_lookup(scene.textures, tex, u, v), albedo)

    return dict(
        n=n,
        is_entering=ent,
        kind=prow[:, 21].astype(jnp.int32),
        albedo=albedo,
        emission=prow[:, 12:15],
        extra=prow[:, 15:20],
    )


def _hit_uv(pt, rows, o, d, t, n):
    """UV coordinates for textured primitives.

    Sphere: ``sphere.rs:88-89``; square: ``square.rs:93-94``.  Other
    types return (0,0) — the reference's UV plumbing is identity there.
    """
    p = o + d * t[..., None]
    # sphere
    u_sp = 0.5 + jnp.arctan2(n[..., 2], n[..., 0]) / (2.0 * jnp.pi)
    v_sp = 0.5 - jnp.arcsin(jnp.clip(n[..., 1], -1.0, 1.0)) / jnp.pi
    # square
    size = jnp.maximum(rows[:, 3], 1e-12)
    u_sq = (p[..., 0] - rows[:, 0]) / size + 0.5
    v_sq = (p[..., 2] - rows[:, 2]) / size + 0.5
    is_sq = pt == int(PrimType.SQUARE)
    is_sp = pt == int(PrimType.SPHERE)
    u = jnp.where(is_sq, u_sq, jnp.where(is_sp, u_sp, 0.0))
    v = jnp.where(is_sq, v_sq, jnp.where(is_sp, v_sp, 0.0))
    return u, v


def _texture_lookup(atlas, tex, u, v):
    """Nearest-neighbor wrap-around lookup (``src/graphics/texture.rs:23-31``)."""
    K, th, tw, _ = atlas.shape
    k = jnp.clip(tex, 0, K - 1)
    x = jnp.mod((u * tw).astype(jnp.int32), tw)
    y = jnp.mod((v * th).astype(jnp.int32), th)
    return atlas[k, y, x]
