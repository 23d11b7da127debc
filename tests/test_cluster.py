"""Cluster-dense traversal tests (ops.cluster): hits must equal the
dense brute-force reference on a real surface mesh."""

import numpy as np
import jax.numpy as jnp
import pytest

from wasm_pathtracer_tpu.models.scene import SceneBuilder, Material
from wasm_pathtracer_tpu.ops import bvh, cluster, trace


def _surface_mesh(n=24, seed=0):
    """Small deformed-sphere surface mesh (~2*n^2 triangles).

    Polar caps excluded: pole rings produce zero-area triangles whose
    plane test is numeric noise in every backend.
    """
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.3 * np.sin(3 * T) * np.cos(4 * P)
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                  r * np.sin(T) * np.sin(P)], -1)
    tris = []
    for i in range(n - 1):
        for j in range(n):
            j2 = (j + 1) % n
            a, b, c, d = V[i, j], V[i, j2], V[i + 1, j], V[i + 1, j2]
            tris.append([a, b, c])
            tris.append([b, d, c])
    return np.asarray(tris, np.float32)


def _scene():
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    b.add_triangles(_surface_mesh(), Material.diffuse(0.8, 0.4, 0.4))
    return b.build()


def _rays(n, seed=1):
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 4.0
    d = r.normal(size=(n, 3)) * 0.4 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))


def test_cluster_build_structure():
    scene = _scene()
    prep = bvh.attach_clusters(trace.prepare(scene), scene, group=32)
    cs = prep.cluster
    assert cs is not None
    C, G, _ = cs.blocks.shape
    assert G == 32
    sids = np.asarray(cs.slot_to_sid)
    # every triangle appears exactly once
    real = sids[sids >= 0]
    assert len(real) == scene.num_shapes
    assert len(np.unique(real)) == len(real)
    # cluster bounds contain their triangles
    blocks = np.asarray(cs.blocks).reshape(C, G, 3, 3)
    lo, hi = np.asarray(cs.lo), np.asarray(cs.hi)
    valid = sids.reshape(C, G) >= 0
    for c in range(C):
        v = blocks[c][valid[c]]
        if len(v):
            assert (v.reshape(-1, 3) >= lo[c] - 1e-3).all()
            assert (v.reshape(-1, 3) <= hi[c] + 1e-3).all()


def test_cluster_trace_matches_dense():
    scene = _scene()
    prep_cl = bvh.attach_clusters(trace.prepare(scene), scene, group=32)
    prep_dn = trace.prepare(scene, tri_chunk=100000)  # force dense

    o, d = _rays(512)
    t0, s0, h0, _ = trace.trace_scene(prep_dn, scene, o, d)
    t1, s1, h1, cost = trace.trace_scene(prep_cl, scene, o, d)

    t0, t1 = np.asarray(t0), np.asarray(t1)
    h0, h1 = np.asarray(h0), np.asarray(h1)
    assert (h0 == h1).mean() > 0.998, f"hit masks differ {(h0 == h1).mean()}"
    both = h0 & h1
    assert np.allclose(t0[both], t1[both], rtol=1e-5, atol=1e-5)
    assert (np.asarray(s0)[both] == np.asarray(s1)[both]).mean() > 0.99
    # pruning works: average tested primitives well below the full count
    assert np.asarray(cost)[both].mean() < scene.num_shapes / 2


def test_cluster_prunes_miss_rays_quickly():
    scene = _scene()
    prep = bvh.attach_clusters(trace.prepare(scene), scene, group=32)
    # rays pointing away from the mesh: zero cluster probes
    o = jnp.asarray([[5.0, 0.0, 0.0]] * 16, jnp.float32)
    d = jnp.asarray([[1.0, 0.0, 0.0]] * 16, jnp.float32)
    t, sid, hit, cost = trace.trace_scene(prep, scene, o, d)
    assert not np.asarray(hit).any()
    assert np.asarray(cost).max() == 0


def test_cluster_generalizes_to_spheres():
    """The structure accepts any finite primitive (the reference's BVH
    is generic over ``ShapeRep``, ``bvh.rs:84-103``): a sphere cloud
    traces with sub-linear cost and full parity vs dense."""
    r = np.random.default_rng(3)
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    n_sph = 4096
    for c, rad in zip(r.uniform(-20, 20, size=(n_sph, 3)),
                      r.uniform(0.05, 0.25, size=n_sph)):
        b.add_sphere(tuple(c), float(rad), Material.diffuse(0.5, 0.5, 0.5))
    scene = b.build()

    prep_cl = bvh.attach_clusters(trace.prepare(scene), scene,
                                  min_count=1, group=64)
    assert prep_cl.cluster is not None
    assert prep_cl.idx_sphere.shape[0] == 0     # moved out of dense
    prep_dn = trace.prepare(scene)

    o, d = _rays(256, seed=5)
    o = o * 8.0   # start outside the cloud
    t0, s0, h0, _ = trace.trace_scene(prep_dn, scene, o, d)
    t1, s1, h1, cost = trace.trace_scene(prep_cl, scene, o, d)

    t0, t1 = np.asarray(t0), np.asarray(t1)
    h0, h1 = np.asarray(h0), np.asarray(h1)
    assert (h0 == h1).all()
    # f32 quadratic roundoff at t ~ 40 differs ~2e-5 relative between
    # the dense and gathered evaluation orders
    assert np.allclose(t0[h0], t1[h0], rtol=3e-4, atol=1e-4)
    assert (np.asarray(s0)[h0] == np.asarray(s1)[h0]).mean() > 0.99
    # sub-linear: mean primitives tested well below the 4096 dense count
    assert np.asarray(cost).mean() < n_sph / 4


def test_cluster_mixed_families():
    """Spheres + triangles in ONE structure, masked type switch."""
    r = np.random.default_rng(11)
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    for c, rad in zip(r.uniform(-5, 5, size=(600, 3)),
                      r.uniform(0.1, 0.3, size=600)):
        b.add_sphere(tuple(c), float(rad), Material.diffuse(0.5, 0.5, 0.5))
    tris = _surface_mesh(16)
    b.add_triangles(tris * 2.0, Material.diffuse(0.8, 0.4, 0.4))
    scene = b.build()

    prep_cl = bvh.attach_clusters(trace.prepare(scene), scene,
                                  min_count=1, group=32)
    fams = prep_cl.cluster.families
    assert len(fams) == 2
    prep_dn = trace.prepare(scene)

    o, d = _rays(256, seed=9)
    o = o * 3.0
    t0, s0, h0, _ = trace.trace_scene(prep_dn, scene, o, d)
    t1, s1, h1, _ = trace.trace_scene(prep_cl, scene, o, d)
    h0, h1 = np.asarray(h0), np.asarray(h1)
    assert (h0 == h1).mean() > 0.995
    both = h0 & h1
    assert np.allclose(np.asarray(t0)[both], np.asarray(t1)[both],
                       rtol=1e-4, atol=1e-4)


def _family_scene(fam):
    """16 primitives of one finite family (or all five mixed) around the
    origin."""
    r = np.random.default_rng(len(fam))
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    m = Material.diffuse(0.5, 0.5, 0.5)
    fams = ("triangle", "sphere", "torus", "aarect", "square") \
        if fam == "mixed" else (fam,) * 5
    for k in range(16):
        f = fams[k % 5]
        c = r.uniform(-2.0, 2.0, 3)
        if f == "triangle":
            v = c + r.uniform(-0.6, 0.6, (3, 3))
            b.add_triangle(v[0], v[1], v[2], m)
        elif f == "sphere":
            b.add_sphere(c, float(r.uniform(0.2, 0.6)), m)
        elif f == "torus":
            b.add_torus(c, float(r.uniform(0.4, 0.7)),
                        float(r.uniform(0.1, 0.2)), m)
        elif f == "aarect":
            e = r.uniform(0.1, 0.6, 3)
            b.add_aarect(c[0] - e[0], c[0] + e[0], c[1] - e[1],
                         c[1] + e[1], c[2] - e[2], c[2] + e[2], m)
        else:
            b.add_square(c, float(r.uniform(0.4, 1.0)), m)
    return b.build()


@pytest.mark.parametrize("fam", ["triangle", "sphere", "torus", "aarect",
                                 "square", "mixed"])
def test_block_test_matches_dense_trace(fam):
    """The flat wavefront's per-lane probe (a gathered (G, 9) block
    through ``cluster._block_test``) agrees with the dense trace of the
    same primitives, family by family."""
    scene = _family_scene(fam)
    prep = trace.prepare(scene)
    o, d = _rays(400, seed=7)
    d = jnp.asarray(np.asarray(d) * 0.3 - np.asarray(o) * 0.25)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    t0, s0, h0, _ = trace.trace_scene(prep, scene, o, d)

    R, G = o.shape[0], scene.num_shapes
    block = jnp.broadcast_to(scene.params[:, :9], (R, G, 9))
    btype = jnp.broadcast_to(scene.ptype.astype(jnp.int32), (R, G))
    families = tuple(sorted(int(t) for t in np.unique(scene.ptype)))
    t_blk = cluster._block_test(o, d, block, btype, families)
    t1 = np.asarray(jnp.min(t_blk, axis=1))
    s1 = np.asarray(jnp.argmin(t_blk, axis=1))
    h0, t0, s0 = np.asarray(h0), np.asarray(t0), np.asarray(s0)
    h1 = np.isfinite(t1)
    assert h0.sum() > 20
    assert (h0 == h1).mean() > 0.995
    both = h0 & h1
    np.testing.assert_allclose(t1[both], t0[both], rtol=1e-4, atol=1e-5)
    assert (s1[both] == s0[both]).mean() > 0.99
