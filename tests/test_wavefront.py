"""Parity tests: the flattened wavefront (ops.wavefront) must reproduce
the lockstep persistent queue (ops.integrator.render_queue) exactly —
same per-path radiance (same RNG keying, same estimator code, same
nearest-hit tie-breaking), same sample counts.  Only the per-pixel
float accumulation ORDER differs, so images compare with a tight
allclose instead of bit equality.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models.camera import Camera
from wasm_pathtracer_tpu.models.scene import SceneBuilder, Material
from wasm_pathtracer_tpu.models import scenes
from wasm_pathtracer_tpu.ops import bvh, integrator, trace, wavefront


def _cloud_scene(n_tri=300, n_sphere=0, seed=3):
    """Small procedural scene with enough primitives to cluster."""
    r = np.random.default_rng(seed)
    b = SceneBuilder(background=(0.05, 0.05, 0.1))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0),
                Material.diffuse(0.8, 0.8, 0.8))
    if n_tri:
        centers = r.uniform(-2.0, 2.0, size=(n_tri, 1, 3))
        offs = r.uniform(-0.35, 0.35, size=(n_tri, 3, 3))
        tris = (centers + offs + np.array([0.0, 0.0, 6.0])).astype(np.float32)
        b.add_triangles(tris, Material.diffuse(0.7, 0.4, 0.3))
    for i in range(n_sphere):
        c = r.uniform(-2.0, 2.0, size=3) + np.array([0.0, 0.0, 6.0])
        b.add_sphere(tuple(c), float(r.uniform(0.05, 0.25)),
                     Material.diffuse(0.3, 0.5, 0.7))
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 6.0, 7.5), (1.5, 6.0, 4.5), (-1.5, 6.0, 4.5), light)
    b.add_triangle((-1.5, 6.0, 7.5), (1.5, 6.0, 7.5), (-1.5, 6.0, 4.5), light)
    return b.build()


def _render_both(scene, settings, S=2048, B=256, W=48, H=48, seed=5,
                 group=64, min_count=64, photon_grid=None):
    prep = trace.prepare(scene)
    prep = bvh.attach_clusters(prep, scene, group=group,
                               min_count=min_count)
    assert prep.cluster is not None
    camera = Camera.create((0.0, 0.5, -2.0), 0.15, 0.0)
    pix = jax.random.randint(jax.random.key(seed), (S,), 0, W * H,
                             dtype=jnp.int32)
    a1, c1, k1 = integrator.render_queue(prep, scene, settings, camera,
                                         pix, W, H, jnp.uint32(seed), B,
                                         photon_grid=photon_grid)
    a2, c2, k2 = wavefront.render_queue_flat(prep, scene, settings, camera,
                                             pix, W, H, jnp.uint32(seed), B,
                                             photon_grid=photon_grid)
    return (np.asarray(a1), np.asarray(c1), np.asarray(k1),
            np.asarray(a2), np.asarray(c2), np.asarray(k2))


def test_flat_matches_queue_triangle_cloud():
    scene = _cloud_scene(n_tri=300)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=4)
    a1, c1, _, a2, c2, _ = _render_both(scene, settings)
    assert (c1 == c2).all()
    assert int(c1.sum()) == 2048
    np.testing.assert_allclose(a2, a1, rtol=2e-5, atol=2e-5)
    assert a1.sum() > 0


def test_flat_lane_count_independent():
    """Per-path radiance is a pure function of the queue slot's RNG
    stream, so the per-pixel result must not depend on the wavefront
    width (each pixel gets exactly one sample here, so accumulation
    order cannot differ either).  Not bit-compared: B=64 and B=256 are
    differently-shaped programs and XLA's fusion/FMA choices can drift
    ~1 ULP; a traversal divergence would diverge the whole downstream
    RNG stream and blow well past this tolerance."""
    scene = _cloud_scene(n_tri=300)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=3)
    prep = trace.prepare(scene)
    prep = bvh.attach_clusters(prep, scene, group=64, min_count=64)
    camera = Camera.create((0.0, 0.5, -2.0), 0.15, 0.0)
    W = H = 32
    pix = jnp.arange(W * H, dtype=jnp.int32)
    outs = []
    for lanes in (64, 256):
        a, c, _ = wavefront.render_queue_flat(
            prep, scene, settings, camera, pix, W, H, jnp.uint32(9), lanes)
        outs.append((np.asarray(a), np.asarray(c)))
    (a64, c64), (a256, c256) = outs
    assert (c64 == c256).all()
    np.testing.assert_allclose(a256, a64, rtol=3e-7, atol=3e-7)


def test_flat_matches_queue_multi_family():
    """Clusters over triangles AND spheres (the generic ShapeRep analog,
    bvh.rs:84-103)."""
    scene = _cloud_scene(n_tri=150, n_sphere=150)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=4)
    a1, c1, _, a2, c2, _ = _render_both(scene, settings, S=1024, B=128)
    assert (c1 == c2).all()
    np.testing.assert_allclose(a2, a1, rtol=2e-5, atol=2e-5)


def test_flat_matches_queue_no_nee():
    scene = _cloud_scene(n_tri=200)
    settings = RenderSettings(render_type=RenderType.NO_NEE, max_bounces=4)
    a1, c1, _, a2, c2, _ = _render_both(scene, settings, S=1024, B=128)
    assert (c1 == c2).all()
    np.testing.assert_allclose(a2, a1, rtol=2e-5, atol=2e-5)


def test_flat_edge_cases():
    scene = _cloud_scene(n_tri=100)
    prep = trace.prepare(scene)
    prep = bvh.attach_clusters(prep, scene, group=64, min_count=64)
    camera = Camera.create((0.0, 0.5, -2.0), 0.15, 0.0)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=4)
    W = H = 16
    # empty queue
    a, c, k = wavefront.render_queue_flat(
        prep, scene, settings, camera, jnp.zeros((0,), jnp.int32),
        W, H, jnp.uint32(1), 64)
    assert float(np.abs(np.asarray(a)).sum()) == 0.0
    assert int(np.asarray(c).sum()) == 0
    # zero bounce cap: counts advance, radiance stays black
    pix = jnp.arange(W * H, dtype=jnp.int32)
    a, c, k = wavefront.render_queue_flat(
        prep, scene, settings.replace(max_bounces=0), camera, pix,
        W, H, jnp.uint32(1), 64)
    assert float(np.abs(np.asarray(a)).sum()) == 0.0
    assert (np.asarray(c) == 1).all()


def test_flat_cost_counter_positive_and_sublinear():
    """The probe counter must show sub-linear per-ray work vs the
    brute-force prim count (the acceleration actually accelerates)."""
    scene = _cloud_scene(n_tri=512)
    prep = trace.prepare(scene)
    prep = bvh.attach_clusters(prep, scene, group=64, min_count=64)
    camera = Camera.create((0.0, 0.5, -2.0), 0.15, 0.0)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=2)
    W = H = 24
    pix = jnp.arange(W * H, dtype=jnp.int32)
    _, c, cost = wavefront.render_queue_flat(
        prep, scene, settings, camera, pix, W, H, jnp.uint32(2), 64)
    per_path = float(np.asarray(cost).sum()) / float(np.asarray(c).sum())
    n_prims = 512 + 2
    # <= brute force per trace; a path has up to 2*(bounces) traces
    assert 0 < per_path < n_prims * 2 * 2


def _material_mesh_scene(kind):
    """A clustered triangle cloud whose triangles carry either one of
    64 distinct materials or a texture (a textured floor square too)."""
    r = np.random.default_rng(21)
    b = SceneBuilder(background=(0.05, 0.05, 0.1))
    if kind == "textured":
        checker = np.zeros((8, 8, 3), np.float32)
        checker[::2, ::2] = checker[1::2, 1::2] = 0.9
        tex = b.add_texture(checker)
        b.add_square((0.0, -2.5, 6.0), 8.0,
                     Material.diffuse(0.5, 0.5, 0.5, texture_id=tex))
    else:
        b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0),
                    Material.diffuse(0.8, 0.8, 0.8))
    centers = r.uniform(-2.0, 2.0, size=(256, 1, 3))
    tris = (centers + r.uniform(-0.35, 0.35, size=(256, 3, 3))
            + np.array([0.0, 0.0, 6.0])).astype(np.float32)
    for k, tri in enumerate(tris):
        if kind == "textured":
            mat = Material.diffuse(0.7, 0.4, 0.3, texture_id=tex)
        else:
            mat = Material.diffuse(*r.uniform(0.1, 0.9, 3))
        b.add_triangle(tri[0], tri[1], tri[2], mat)
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 6.0, 7.5), (1.5, 6.0, 4.5), (-1.5, 6.0, 4.5), light)
    b.add_triangle((-1.5, 6.0, 7.5), (1.5, 6.0, 7.5), (-1.5, 6.0, 4.5), light)
    return b.build()


@pytest.mark.parametrize("kind", ["textured", "many_materials"])
def test_flat_matches_queue_materials(kind):
    """Shading gathers each hit's packed row, so textured meshes and
    meshes with more than 32 materials take the same flat path and
    match the lockstep queue."""
    scene = _material_mesh_scene(kind)
    if kind == "textured":
        assert scene.textures.shape[0] == 1
    else:
        assert len(np.unique(np.asarray(scene.albedo), axis=0)) > 32
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=4)
    a1, c1, _, a2, c2, _ = _render_both(scene, settings, S=1024, B=128)
    assert (c1 == c2).all()
    np.testing.assert_allclose(a2, a1, rtol=2e-5, atol=2e-5)
    assert a1.sum() > 0
