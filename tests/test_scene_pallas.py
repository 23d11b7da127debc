"""Pallas scene kernel tests (Triton kernel in interpret mode on CPU).

The kernel (``ops/scene_pallas.py``) must agree with the XLA dense path
(``ops/trace.py``) — same nearest hit, same shape id, same occlusion
verdict — on every scene family mix, since ``trace.prepare`` enables it
for all forward rendering on the GPU.  The CPU reaches it only through
``interpret=True``; its compiled form on the card is checked by the
``gpu``-marked test below and by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models import scenes
from wasm_pathtracer_tpu.models.camera import Camera
from wasm_pathtracer_tpu.models.scene import SceneBuilder, Material
from wasm_pathtracer_tpu.ops import trace, scene_pallas as sp
from wasm_pathtracer_tpu.utils import vecmath as vm


def _rays(n, seed=0, aim=False):
    """Random rays; ``aim`` points them roughly at the origin."""
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    if aim:
        d = 0.3 * d - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_scene(scene, n_rays=1024, seed=3, aim=False):
    prep = trace.prepare(scene)
    prep_k = trace.prepare(scene, interpret=True)
    o, d = _rays(n_rays, seed, aim)
    t0, sid0, hit0, _ = trace.trace_scene(prep, scene, o, d)
    t1, sid1, hit1, cost = sp.trace_scene_fused(prep_k, scene, o, d)
    t0, t1 = np.asarray(t0), np.asarray(t1)
    hit0, hit1 = np.asarray(hit0), np.asarray(hit1)
    assert (hit0 == hit1).mean() > 0.999
    both = hit0 & hit1
    assert np.allclose(t0[both], t1[both], rtol=1e-5, atol=1e-4)
    same = np.asarray(sid0)[both] == np.asarray(sid1)[both]
    assert same.sum() >= 0.995 * both.sum()
    assert (np.asarray(cost) > 0).all()
    return int(both.sum())


def test_fused_matches_dense_museum():
    """Tori + triangles + aarects + plane (the flagship scene)."""
    _check_scene(scenes.museum())


def test_fused_matches_dense_whitted():
    """Spheres + squares + textured materials scene."""
    _check_scene(scenes.whitted())


def test_fused_matches_dense_sphere_plane():
    _check_scene(scenes.sphere_plane())


def _all_family_scene():
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    r = np.random.default_rng(11)
    for i in range(3):
        b.add_sphere(r.uniform(-2, 2, 3), 0.5, Material.diffuse(0.6, 0.4, 0.3))
    b.add_plane((0, -2, 0), (0, 1, 0), Material.diffuse(0.5, 0.5, 0.5))
    for i in range(2):
        b.add_torus(r.uniform(-2, 2, 3), 0.8, 0.25,
                    Material.diffuse(0.7, 0.7, 0.2))
    lo = r.uniform(-2, 0, (2, 3)); hi = lo + r.uniform(0.2, 1.0, (2, 3))
    for j in range(2):
        b.add_aarect(lo[j][0], hi[j][0], lo[j][1], hi[j][1],
                     lo[j][2], hi[j][2], Material.diffuse(0.2, 0.6, 0.7))
    b.add_square((0.5, -1.0, 0.5), 1.5, Material.diffuse(0.9, 0.2, 0.2))
    tris = scenes.triangle_cloud(5, seed=4)
    b.add_triangles(tris, Material.emissive(4.0, 4.0, 4.0))
    return b.build()


def test_fused_matches_dense_all_families():
    """A synthetic scene exercising every primitive family at once."""
    _check_scene(_all_family_scene(), n_rays=2048, seed=5)


@pytest.mark.parametrize("n_rays", [1, sp.RAY_BLOCK + 1,
                                    3 * sp.RAY_BLOCK - 5])
def test_fused_ragged_ray_counts(n_rays):
    """Ray counts that are not a multiple of the kernel's ray block: the
    padded tail must neither leak into nor disturb the real rays."""
    _check_scene(_all_family_scene(), n_rays=n_rays, seed=n_rays, aim=True)


@pytest.mark.parametrize("families", ["spheres", "triangles", "none"])
def test_fused_empty_families(families):
    """Families absent from the scene are left out of the kernel; with
    no family at all the kernel reports a miss for every ray."""
    o, d = _rays(100, seed=2)
    if families == "none":
        table = jnp.zeros((1,), jnp.float32)
        t, code = sp.fused_nearest(table, (), o, d, interpret=True)
        assert np.isinf(np.asarray(t)).all()
        assert (np.asarray(code) == -1).all()
        occ = sp.fused_occluded(table, (), o, d, jnp.full((100,), 5.0),
                                jnp.full((100,), -1, jnp.int32),
                                interpret=True)
        assert not np.asarray(occ).any()
        return
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    if families == "spheres":
        for c in np.random.default_rng(1).uniform(-2, 2, (7, 3)):
            b.add_sphere(c, 0.6, Material.diffuse(0.5, 0.5, 0.5))
    else:
        b.add_triangles(scenes.triangle_cloud(40, seed=6),
                        Material.diffuse(0.5, 0.5, 0.5))
    scene = b.build()
    _, layout = sp.build_table(trace.prepare(scene), scene)
    assert len(layout) == 1
    assert _check_scene(scene, n_rays=300, seed=4, aim=True) > 0


def test_trace_scene_routes_through_fused_flag():
    """prepare(interpret=True) must produce identical results through
    the public trace_scene entry point."""
    scene = scenes.sphere_plane()
    o, d = _rays(512, seed=7)
    prep0 = trace.prepare(scene)
    prep1 = trace.prepare(scene, interpret=True)
    assert prep1.use_fused and not prep0.use_fused
    t0, sid0, hit0, _ = trace.trace_scene(prep0, scene, o, d)
    t1, sid1, hit1, _ = trace.trace_scene(prep1, scene, o, d)
    both = np.asarray(hit0) & np.asarray(hit1)
    assert (np.asarray(hit0) == np.asarray(hit1)).all()
    assert np.allclose(np.asarray(t0)[both], np.asarray(t1)[both],
                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,kw,want", [
    ("cpu", {}, False),
    ("gpu", {}, True),
    ("cpu", {"interpret": True}, True),
    ("gpu", {"use_fused": False}, False),
])
def test_prepare_platform_decision(monkeypatch, backend, kw, want):
    """XLA on the CPU, the kernel on the GPU backend or with an explicit
    interpret=True; an explicit use_fused=False always wins."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    prep = trace.prepare(scenes.sphere_plane(), **kw)
    assert prep.use_fused is want
    assert prep.interpret is bool(kw.get("interpret", False))


def test_prepare_refuses_kernel_without_gpu_or_interpret():
    """No quiet fallback: asking for the kernel on the CPU without the
    interpreter is an error, not an XLA trace."""
    with pytest.raises(ValueError):
        trace.prepare(scenes.sphere_plane(), use_fused=True)


def test_train_step_runs_xla_path_for_kernel_prep():
    """make_train_step clears the forward-only kernel flag, so a prep
    made for forward rendering still trains (the kernel has no VJP)."""
    from wasm_pathtracer_tpu.parallel import make_ray_mesh, make_train_step
    scene = scenes.sphere_plane()
    prep = trace.prepare(scene, interpret=True)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=2)
    mesh = make_ray_mesh(jax.devices()[:1])
    step = make_train_step(mesh, prep, settings, 8, 8, lr=0.01)
    cam = Camera.create((0.0, 1.5, -2.0), 0.25, 0.0)
    loss, scene2, _ = step(scene, cam, jnp.full((8, 8, 3), 0.25),
                           jnp.uint32(3))
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(scene2.albedo)).all()


def _all_family_light_scene():
    """Every primitive family plus emissive squares AND an emissive
    sphere — the light-exclusion path must hold for every family the
    excluded shape can belong to."""
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    r = np.random.default_rng(13)
    for i in range(3):
        b.add_sphere(r.uniform(-2, 2, 3), 0.5,
                     Material.diffuse(0.6, 0.4, 0.3))
    b.add_sphere((0.0, 2.5, 1.0), 0.4, Material.emissive(5.0, 5.0, 5.0))
    b.add_plane((0, -2, 0), (0, 1, 0), Material.diffuse(0.5, 0.5, 0.5))
    for i in range(2):
        b.add_torus(r.uniform(-2, 2, 3), 0.8, 0.25,
                    Material.diffuse(0.7, 0.7, 0.2))
    lo = r.uniform(-2, 0, (2, 3))
    hi = lo + r.uniform(0.2, 1.0, (2, 3))
    for j in range(2):
        b.add_aarect(lo[j][0], hi[j][0], lo[j][1], hi[j][1],
                     lo[j][2], hi[j][2], Material.diffuse(0.2, 0.6, 0.7))
    b.add_square((0.5, 3.0, 0.5), 1.5, Material.emissive(6.0, 6.0, 6.0))
    tris = scenes.triangle_cloud(5, seed=4)
    b.add_triangles(tris, Material.emissive(4.0, 4.0, 4.0))
    return b.build()


def _check_anyhit(scene, seed, n=512):
    prep = trace.prepare(scene)
    prep_k = trace.prepare(scene, interpret=True)
    r = np.random.default_rng(seed)
    p = jnp.asarray(r.uniform(-4, 4, (n, 3)).astype(np.float32))
    lsid = jnp.asarray(r.choice(np.asarray(scene.light_shape),
                                n).astype(np.int32))
    p_l = scene.params[lsid][:, 0:3]
    to_l = p_l - p
    dl = vm.length(to_l)
    dd = to_l / jnp.maximum(dl, 1e-30)[..., None]
    o = p + dd * 1e-4
    t, sid, hit, _ = trace.trace_scene(prep, scene, o, dd)
    ref = np.asarray(hit & (t < dl) & (sid != lsid))
    occ, cost = sp.occluded_fused(prep_k, scene, o, dd, dl, lsid)
    np.testing.assert_array_equal(np.asarray(occ), ref)
    assert (np.asarray(cost) > 0).all()


def test_anyhit_occlusion_all_families():
    """Any-hit verdict parity on a scene with EVERY family present,
    including an emissive sphere and square as excluded lights."""
    _check_anyhit(_all_family_light_scene(), seed=17)


def test_anyhit_occlusion_matches_trace_predicate():
    """The any-hit shadow kernel equals the trace-based predicate
    ``hit & (t < dist) & (sid != light)`` exactly — the reference's
    distinct cheaper shadow query (``scene.rs:104-133``) with identical
    verdicts."""
    _check_anyhit(scenes.museum(), seed=11)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend (run with JAX_PLATFORMS=cuda)")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_card(gpu_backend):
    """The Triton-compiled kernel against the XLA dense trace on the
    card, at full float32 precision."""
    scene = scenes.museum()
    prep_x = trace.prepare(scene, use_fused=False)
    prep_k = trace.prepare(scene)
    assert prep_k.use_fused and not prep_k.interpret
    o, d = _rays(4096, seed=21)
    with jax.default_matmul_precision("highest"):
        t0, s0, h0, _ = trace.trace_scene(prep_x, scene, o, d)
        t1, s1, h1, _ = trace.trace_scene(prep_k, scene, o, d)
    h0, h1 = np.asarray(h0), np.asarray(h1)
    assert (h0 == h1).mean() > 0.9999
    both = h0 & h1
    np.testing.assert_allclose(np.asarray(t1)[both], np.asarray(t0)[both],
                               rtol=1e-4)
    assert (np.asarray(s0)[both] == np.asarray(s1)[both]).mean() > 0.9999
