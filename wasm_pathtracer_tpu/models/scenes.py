"""Built-in scene definitions.

Array-form re-creations of the reference's scene registry
(``src/scenes.rs`` + ``src/wasm_interface.rs:389-398``):

- id 0: museum — ground plane, 27 white tori, 2x2-triangle emissive area
  lights per torus (108 light triangles, colors shuffled per row with the
  reference RNG stream), AARect walls (``src/scenes.rs:15-68``).
- id 2: bunny — two planes + an uploaded triangle mesh + one
  two-triangle area light at intensity (16,16,16) (``src/scenes.rs:71-111``).
- id 100: sphere+plane — the hardcoded minimal scene named by
  BASELINE.json config 1 (not present in the reference snapshot's live
  code; spiritually the PR1 debug scene).
- id 101: whitted — the commented-out Turner-Whitted texture scene
  restored (``src/scenes.rs:113-130``): textured floor square, a
  refractive and a reflective sphere, sky background.

Mesh-dependent scenes accept a mesh registry dict (mesh id ->
(T, 3, 3) float32 vertices), the analog of ``Config.meshes``
(``src/wasm_interface.rs:39``).
"""

from __future__ import annotations

import numpy as np

from wasm_pathtracer_tpu.models.scene import Material, SceneBuilder, SceneData
from wasm_pathtracer_tpu.utils.rng import Xorshift32

# Mesh ids (``src_ts/client/meshes.ts:5-13`` defines BUNNY_LOW=0 /
# BUNNY_HIGH=1 / CLOUD_100=2 / CLOUD_10K=3 / CLOUD_100K=4;
# ``src/scenes.rs:12`` keys the high bunny as mesh 1).
MESH_BUNNY_LOW = 0
MESH_BUNNY_HIGH = 1
MESH_CLOUD_100 = 2
MESH_CLOUD_10K = 3
MESH_CLOUD_100K = 4


def museum() -> SceneData:
    """``setup_scene_museum`` (``src/scenes.rs:15-52``)."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.7, 0.7, 0.7))

    xs = [-16.0, -12.0, -8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0]
    colors = [
        (1.0, 0.3, 0.3),
        (0.0, 1.0, 1.0), (0.3, 0.3, 1.0), (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
        (0.3, 1.0, 0.3),
    ]

    # The reference advances its global xorshift twice before shuffling
    # (``src/scenes.rs:30-32``), then shuffles the color list after each
    # row (``:39``).  Reproducing the stream keeps the scene identical.
    rng = Xorshift32()
    rng.next()
    rng.next()

    for y in (-7.5, 0.0, 7.5):
        for i, x in enumerate(xs):
            b.add_torus((x, -0.5, y), 1.3, 0.3, Material.diffuse(1.0, 1.0, 1.0))
            _museum_lights(b, x, y, tuple(2.5 * c for c in colors[i]))
        rng.shuffle(colors)

    for x in (-14.0, -10.0, -6.0, -2.0, 2.0, 6.0, 10.0, 14.0):
        b.add_aarect(x - 0.1, x + 0.1, -1.0, 2.0, -20.0, 20.0,
                     Material.diffuse(0.7, 0.7, 0.7))
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, 3.75 - 0.1, 3.75 + 0.1,
                 Material.diffuse(0.7, 0.7, 0.7))
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, -3.75 - 0.1, -3.75 + 0.1,
                 Material.diffuse(0.7, 0.7, 0.7))
    return b.build()


def _museum_lights(b: SceneBuilder, x: float, y: float, color: tuple):
    """Two 2-triangle area lights per torus (``src/scenes.rs:54-68``)."""
    m = Material.emissive(*color)
    for dz in (2.8, -2.8):
        z_near = y + dz
        z_far = y + (2.5 if dz > 0 else -2.5)
        lc1 = (x - 1.0, 0.0, z_near)
        lc2 = (x + 1.0, 0.0, z_near)
        lc3 = (x + 1.0, 1.0, z_far)
        lc4 = (x - 1.0, 1.0, z_far)
        b.add_triangle(lc3, lc2, lc1, m)
        b.add_triangle(lc4, lc3, lc1, m)


def bunny_high(meshes: dict | None = None) -> SceneData:
    """``setup_scene_bunny_high`` / ``display_obj`` (``src/scenes.rs:71-111``)."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(1.0, 1.0, 1.0))
    b.add_plane((0.0, 0.0, 13.0), (0.0, 0.0, -1.0), Material.diffuse(0.8, 1.0, 0.8))

    if meshes and MESH_BUNNY_HIGH in meshes:
        # mesh-upload transform: x0.5 scale, +5z translate
        # (``src/wasm_interface.rs:300-313``)
        tris = np.asarray(meshes[MESH_BUNNY_HIGH], np.float32) * 0.5
        tris = tris + np.array([0.0, 0.0, 5.0], np.float32)
        b.add_triangles(tris, Material.diffuse(1.0, 0.4, 0.4))

    light = Material.emissive(16.0, 16.0, 16.0)
    lc1 = (-1.0, 7.0, 0.0)
    lc2 = (1.0, 7.0, 0.0)
    lc3 = (1.0, 7.0, 2.0)
    lc4 = (-1.0, 7.0, 2.0)
    b.add_triangle(lc3, lc2, lc1, light)
    b.add_triangle(lc4, lc3, lc1, light)
    return b.build()


def cloud(n: int, meshes: dict | None = None,
          mesh_id: int | None = None) -> SceneData:
    """Triangle-cloud workload scene.

    The reference client registers 100 / 10k / 100k-triangle procedural
    clouds as standing workloads (``src_ts/client/index.ts:164-184,
    224-226``, mesh ids ``src_ts/client/meshes.ts:10-12``); here they
    are first-class scenes (ids 3/4/5).  An uploaded mesh under the
    matching CLOUD_* id takes precedence (with the reference's
    mesh-upload transform, x0.5 scale +5z, ``wasm_interface.rs:300-313``);
    otherwise the deterministic :func:`triangle_cloud` generates it.
    """
    b = SceneBuilder(background=(0.02, 0.02, 0.04))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0),
                Material.diffuse(0.8, 0.8, 0.8))
    if meshes and mesh_id is not None and mesh_id in meshes:
        tris = np.asarray(meshes[mesh_id], np.float32) * 0.5
        tris = tris + np.array([0.0, 0.0, 5.0], np.float32)
    else:
        # raw cloud spans [-2.5,3]^2 x [0,5.5]; the upload transform
        # (x0.5 +5z) puts it at [-1.25,1.5]^2 x [5,7.75]
        tris = triangle_cloud(n) * 0.5 + np.array([0.0, 0.0, 5.0],
                                                  np.float32)
    b.add_triangles(tris, Material.diffuse(0.75, 0.55, 0.35))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 7.0, 4.5), (2.0, 7.0, 0.5), (-2.0, 7.0, 0.5), light)
    b.add_triangle((-2.0, 7.0, 4.5), (2.0, 7.0, 4.5), (-2.0, 7.0, 0.5), light)
    return b.build()


def sphere_plane() -> SceneData:
    """Minimal sphere+plane scene (BASELINE.json config 1)."""
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 0.0, 5.0), 1.0, Material.diffuse(0.8, 0.2, 0.2))
    light = Material.emissive(8.0, 8.0, 8.0)
    b.add_triangle((1.0, 4.0, 6.0), (1.0, 4.0, 4.0), (-1.0, 4.0, 4.0), light)
    b.add_triangle((-1.0, 4.0, 6.0), (1.0, 4.0, 6.0), (-1.0, 4.0, 4.0), light)
    return b.build()


def whitted(textures: dict | None = None) -> SceneData:
    """Turner Whitted's scene, restored from ``src/scenes.rs:113-130``."""
    b = SceneBuilder(background=(135.0 / 255.0, 206.0 / 255.0, 250.0 / 255.0))
    tex_id = -1
    if textures and 0 in textures:
        tex_id = b.add_texture(textures[0])
    else:
        tex_id = b.add_texture(checker_texture())
    b.add_square((0.0, -1.0, 4.0), 8.0, Material.diffuse(1.0, 1.0, 1.0,
                                                         texture_id=tex_id))
    b.add_sphere((-1.3, 1.0, -0.2), 0.7, Material.refract((0.5, 1.0, 0.5), 1.02))
    b.add_sphere((-0.4, 0.0, 1.0), 0.6, Material.reflect(1.0, 1.0, 1.0, 0.3))
    # an area light overhead so the path tracer has something to sample
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.0, 6.0, -2.0), (1.0, 6.0, -4.0), (-1.0, 6.0, -4.0), light)
    b.add_triangle((-1.0, 6.0, -2.0), (1.0, 6.0, -2.0), (-1.0, 6.0, -4.0), light)
    return b.build()


def checker_texture(n: int = 16) -> np.ndarray:
    """16x16 red/yellow checkerboard (``src_ts/shared/texture.ts:17-36``)."""
    t = np.zeros((n, n, 3), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    red = (xx + yy) % 2 == 0
    t[red] = (1.0, 0.0, 0.0)
    t[~red] = (1.0, 1.0, 0.0)
    return t


def surface_mesh(n: int) -> np.ndarray:
    """Deformed-sphere surface mesh with ~2*n^2 triangles — the
    bunny-class stand-in workload (the reference snapshot ships no
    bunny2.obj blob, ``.MISSING_LARGE_BLOBS``; its slot is the x8-scaled
    high-poly bunny, ``src_ts/client/index.ts:213-222``).  n=188 gives
    ~70k triangles."""
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.5 + 0.35 * np.sin(6 * T) * np.cos(5 * P) + 0.15 * np.cos(9 * P)
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                  r * np.sin(T) * np.sin(P)], -1).astype(np.float32)
    tris = []
    for i in range(n - 1):
        j = np.arange(n)
        j2 = (j + 1) % n
        a, b_, c, d = V[i, j], V[i, j2], V[i + 1, j], V[i + 1, j2]
        tris.append(np.stack([a, b_, c], 1))
        tris.append(np.stack([b_, d, c], 1))
    return np.concatenate(tris, 0)


def mesh_scene(tris: np.ndarray) -> SceneData:
    """Ground plane + triangle mesh + one two-triangle area light —
    the bunny-class benchmark scene shape (``src/scenes.rs:71-111``)."""
    b = SceneBuilder(background=(0.05, 0.05, 0.08))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                Material.diffuse(0.8, 0.8, 0.8))
    b.add_triangles(tris, Material.diffuse(0.9, 0.45, 0.3))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 6.0, 2.0), (2.0, 6.0, -2.0), (-2.0, 6.0, -2.0),
                   light)
    b.add_triangle((-2.0, 6.0, 2.0), (2.0, 6.0, 2.0), (-2.0, 6.0, -2.0),
                   light)
    return b.build()


def triangle_cloud(n: int, seed: int = 7) -> np.ndarray:
    """Procedural triangle cloud (``src_ts/client/index.ts:164-184``):
    n triangles with centers in [-2.5, 2.5]^2 x [0, 5] and positive
    [0, 0.5] per-vertex offsets, matching the reference generator
    exactly in distribution.  Deterministic here (the reference uses
    Math.random)."""
    r = np.random.default_rng(seed)
    cx = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cy = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cz = r.uniform(0.0, 5.0, size=(n, 1, 1))
    centers = np.concatenate([cx, cy, cz], axis=-1)
    offsets = r.uniform(0.0, 0.5, size=(n, 3, 3))
    return (centers + offsets).astype(np.float32)


SCENE_REGISTRY = {
    0: lambda meshes=None, textures=None: museum(),
    2: lambda meshes=None, textures=None: bunny_high(meshes),
    # the client's standing procedural workloads as first-class scenes
    # (scene id = cloud mesh id + 1, matching the session's
    # scene-uses-mesh convention, ``wasm_interface.rs:316-324``)
    3: lambda meshes=None, textures=None: cloud(100, meshes,
                                                MESH_CLOUD_100),
    4: lambda meshes=None, textures=None: cloud(10_000, meshes,
                                                MESH_CLOUD_10K),
    5: lambda meshes=None, textures=None: cloud(100_000, meshes,
                                                MESH_CLOUD_100K),
    100: lambda meshes=None, textures=None: sphere_plane(),
    101: lambda meshes=None, textures=None: whitted(textures),
}


def select_scene(scene_id: int, meshes=None, textures=None) -> SceneData:
    """``select_scene`` (``src/wasm_interface.rs:389-398``)."""
    if scene_id not in SCENE_REGISTRY:
        raise ValueError(f"Invalid scene {scene_id}")
    return SCENE_REGISTRY[scene_id](meshes=meshes, textures=textures)
