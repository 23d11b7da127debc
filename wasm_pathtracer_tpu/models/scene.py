"""Structure-of-arrays scene representation.

The reference stores shapes as ``Vec<Rc<dyn Tracable>>`` — heap-boxed
trait objects dispatched through vtables (``src/graphics/scene.rs:31-36``),
with materials as per-shape enums (``src/graphics/material.rs:16-20``).
None of that batches.  Here a scene is a pytree of flat arrays:

- one unified parameter table ``params (N, 9)`` + ``ptype (N,)`` so BVH
  leaves can intersect any shape by gathered row + type switch;
- per-type dense views (``tri_*``, ``sph_*``, ...) for the brute-force
  rays x primitives path, where the whole intersection is one fused
  elementwise pass;
- a material table (``albedo``, ``emission``, ``mat_kind``, ``mat_extra``)
  whose float leaves are the differentiable parameters of the renderer;
- area lights as an index array into shapes, mirroring
  ``LightEnum::Area(shape_idx)`` (``src/graphics/scene.rs:20-25``) with
  emissive shapes auto-registered (``src/graphics/scene.rs:47-66``).

Infinite shapes (planes) occupy a prefix of the shape table and are
always brute-forced, exactly like the reference's ``shapes[..num_inf]``
prefix (``src/graphics/scene.rs:162-184``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


class PrimType(enum.IntEnum):
    PLANE = 0      # infinite; always in the brute-force prefix
    SPHERE = 1
    TRIANGLE = 2
    TORUS = 3
    AARECT = 4
    SQUARE = 5


class MatKind(enum.IntEnum):
    """Material families.

    DIFFUSE and EMISSIVE are the live reference set
    (``src/graphics/material.rs:16-20``).  REFLECT and REFRACT restore the
    documented pre-conversion capability (reflect/refract/Fresnel/Beer,
    see ``src/scenes.rs:113-130`` and README credits) as first-class,
    differentiable materials.
    """

    DIFFUSE = 0
    EMISSIVE = 1
    REFLECT = 2   # mirror component mixed with diffuse by `reflectivity`
    REFRACT = 3   # dielectric: Fresnel reflect/transmit + Beer absorption


# mat_extra column layout
EXTRA_REFLECTIVITY = 0
EXTRA_IOR = 1
EXTRA_ABSORB_R = 2
EXTRA_ABSORB_G = 3
EXTRA_ABSORB_B = 4

_N_PARAMS = 9
_N_EXTRA = 5


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material description used by the scene builder."""

    kind: MatKind = MatKind.DIFFUSE
    albedo: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    reflectivity: float = 0.0
    ior: float = 1.0
    absorption: tuple = (0.0, 0.0, 0.0)
    texture_id: int = -1

    @staticmethod
    def diffuse(r, g, b, texture_id: int = -1) -> "Material":
        return Material(MatKind.DIFFUSE, albedo=(r, g, b), texture_id=texture_id)

    @staticmethod
    def emissive(r, g, b) -> "Material":
        return Material(MatKind.EMISSIVE, emission=(r, g, b))

    @staticmethod
    def reflect(r, g, b, reflectivity: float) -> "Material":
        return Material(MatKind.REFLECT, albedo=(r, g, b), reflectivity=reflectivity)

    @staticmethod
    def refract(absorption: tuple, ior: float) -> "Material":
        return Material(MatKind.REFRACT, albedo=(1.0, 1.0, 1.0), ior=ior,
                        absorption=absorption)


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Device-side scene pytree.  All float leaves are differentiable."""

    # --- unified shape table ---------------------------------------------
    ptype: jax.Array        # (N,) int32, PrimType
    params: jax.Array       # (N, 9) f32, layout per PrimType (see builder)
    # --- material table ---------------------------------------------------
    mat_kind: jax.Array     # (N,) int32, MatKind
    albedo: jax.Array       # (N, 3) f32
    emission: jax.Array     # (N, 3) f32
    mat_extra: jax.Array    # (N, 5) f32: reflectivity, ior, absorption rgb
    tex_id: jax.Array       # (N,) int32, -1 = untextured
    # --- lights -----------------------------------------------------------
    light_shape: jax.Array  # (L,) int32 shape ids of emissive (area) shapes
    # 0-sized lights (``src/graphics/lights/mod.rs``: point/spot/
    # directional — constructed but never shaded in the live reference;
    # restored here for the Whitted integrator)
    plight_kind: jax.Array   # (PL,) int32: 0 point, 1 spot, 2 directional
    plight_pos: jax.Array    # (PL, 3) position (point/spot) or direction
    plight_dir: jax.Array    # (PL, 3) spot direction / directional dir
    plight_color: jax.Array  # (PL, 3) color * strength
    plight_angle: jax.Array  # (PL,) spot falloff angle
    # --- misc -------------------------------------------------------------
    background: jax.Array   # (3,) f32
    # --- textures ---------------------------------------------------------
    # One shared atlas of fixed-size RGB tiles (0 tiles => shape (0,1,1,3)).
    textures: jax.Array     # (K, th, tw, 3) f32
    # --- static metadata --------------------------------------------------
    num_inf: int = _field(metadata=dict(static=True), default=0)
    num_shapes: int = _field(metadata=dict(static=True), default=0)
    num_lights: int = _field(metadata=dict(static=True), default=0)
    num_plights: int = _field(metadata=dict(static=True), default=0)

    @property
    def finite_slice(self):
        return slice(self.num_inf, self.num_shapes)

    def with_materials(self, albedo=None, emission=None, mat_extra=None) -> "SceneData":
        """Functional update of the differentiable material leaves."""
        return dataclasses.replace(
            self,
            albedo=self.albedo if albedo is None else albedo,
            emission=self.emission if emission is None else emission,
            mat_extra=self.mat_extra if mat_extra is None else mat_extra,
        )

    def with_light_rows(self, rows) -> "SceneData":
        """Functional update of the area-light geometry rows (the
        (L, 9) triangle-vertex params of the emissive shapes) — the
        differentiable light-geometry leaves of BASELINE config 4.
        Gradients flow through the NEE solid-angle estimator (area,
        cos_o, 1/d^2, and the sampled point itself) and through
        emissive-hit visibility's shading terms."""
        return dataclasses.replace(
            self, params=self.params.at[self.light_shape].set(rows))

    # Convenience per-type gathers (host-time static index sets are not
    # stored; types are few so boolean masks at trace time are avoided by
    # the renderer pre-splitting the scene — see ops.intersect.split_scene).


class SceneBuilder:
    """Host-side (NumPy) scene assembly.

    Mirrors the constructor duties of ``Scene::new``
    (``src/graphics/scene.rs:43-69``): collect shapes, auto-register
    emissive shapes as area lights, order infinite shapes first (the
    reference's BVH build partitions unbounded shapes into a prefix,
    ``src/graphics/bvh.rs:103-125``).
    """

    def __init__(self, background=(0.0, 0.0, 0.0)):
        self.background = tuple(background)
        self._inf: list[tuple[int, np.ndarray, Material]] = []
        self._fin: list[tuple[int, np.ndarray, Material]] = []
        self.textures: list[np.ndarray] = []
        self._plights: list[tuple[int, tuple, tuple, tuple, float]] = []

    # -- shape adders ------------------------------------------------------
    def _add(self, ptype: PrimType, params: list, mat: Material, infinite: bool):
        row = np.zeros(_N_PARAMS, dtype=np.float32)
        row[: len(params)] = params
        (self._inf if infinite else self._fin).append((int(ptype), row, mat))

    def add_plane(self, location, normal, mat: Material):
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._add(PrimType.PLANE, [*location, *n], mat, infinite=True)

    def add_sphere(self, center, radius, mat: Material):
        self._add(PrimType.SPHERE, [*center, radius], mat, infinite=False)

    def add_triangle(self, v0, v1, v2, mat: Material):
        self._add(PrimType.TRIANGLE, [*v0, *v1, *v2], mat, infinite=False)

    def add_triangles(self, tris: np.ndarray, mat: Material):
        """Bulk add of a (T, 3, 3) vertex array (mesh upload path)."""
        for t in np.asarray(tris, np.float32).reshape(-1, 9):
            self._add(PrimType.TRIANGLE, list(t), mat, infinite=False)

    def add_torus(self, center, big_r, small_r, mat: Material):
        self._add(PrimType.TORUS, [*center, big_r, small_r], mat, infinite=False)

    def add_aarect(self, x_min, x_max, y_min, y_max, z_min, z_max, mat: Material):
        # stored as (min, max) corners
        self._add(PrimType.AARECT, [x_min, y_min, z_min, x_max, y_max, z_max],
                  mat, infinite=False)

    def add_square(self, center, size, mat: Material):
        """Axis-aligned y-plane quad (``src/graphics/primitives/square.rs``)."""
        self._add(PrimType.SQUARE, [*center, size], mat, infinite=False)

    # -- 0-sized lights (``lights/mod.rs:20-35``) -------------------------
    def add_point_light(self, location, color, strength: float):
        c = tuple(strength * x for x in color)
        self._plights.append((0, tuple(location), (0.0, 0.0, 1.0), c, 0.0))

    def add_spot_light(self, location, direction, angle, color, strength):
        c = tuple(strength * x for x in color)
        self._plights.append((1, tuple(location), tuple(direction), c, angle))

    def add_directional_light(self, direction, color):
        self._plights.append((2, (0.0, 0.0, 0.0), tuple(direction),
                              tuple(color), 0.0))

    def add_texture(self, rgb: np.ndarray) -> int:
        """Register an RGB float texture; returns its id."""
        self.textures.append(np.asarray(rgb, np.float32))
        return len(self.textures) - 1

    # -- finalize ----------------------------------------------------------
    def build(self) -> SceneData:
        shapes = self._inf + self._fin
        n = len(shapes)
        ptype = np.array([s[0] for s in shapes], np.int32)
        params = (np.stack([s[1] for s in shapes])
                  if n else np.zeros((0, _N_PARAMS), np.float32))

        mats = [s[2] for s in shapes]
        mat_kind = np.array([int(m.kind) for m in mats], np.int32)
        albedo = np.array([m.albedo for m in mats], np.float32).reshape(n, 3)
        emission = np.array([m.emission for m in mats], np.float32).reshape(n, 3)
        extra = np.zeros((n, _N_EXTRA), np.float32)
        for i, m in enumerate(mats):
            extra[i, EXTRA_REFLECTIVITY] = m.reflectivity
            extra[i, EXTRA_IOR] = m.ior
            extra[i, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1] = m.absorption
        tex_id = np.array([m.texture_id for m in mats], np.int32)

        # emissive shapes become area lights (``scene.rs:47-66``)
        light_shape = np.array(
            [i for i, m in enumerate(mats) if m.kind == MatKind.EMISSIVE],
            np.int32,
        )

        if self.textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), th, tw, 3), np.float32)
            for k, t in enumerate(self.textures):
                atlas[k, : t.shape[0], : t.shape[1]] = t
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)

        pl = self._plights
        plight_kind = np.array([p[0] for p in pl], np.int32)
        plight_pos = np.array([p[1] for p in pl], np.float32).reshape(len(pl), 3)
        plight_dir = np.array([p[2] for p in pl], np.float32).reshape(len(pl), 3)
        plight_color = np.array([p[3] for p in pl], np.float32).reshape(len(pl), 3)
        plight_angle = np.array([p[4] for p in pl], np.float32)

        return SceneData(
            ptype=jnp.asarray(ptype),
            params=jnp.asarray(params),
            mat_kind=jnp.asarray(mat_kind),
            albedo=jnp.asarray(albedo),
            emission=jnp.asarray(emission),
            mat_extra=jnp.asarray(extra),
            tex_id=jnp.asarray(tex_id),
            light_shape=jnp.asarray(light_shape),
            plight_kind=jnp.asarray(plight_kind),
            plight_pos=jnp.asarray(plight_pos),
            plight_dir=jnp.asarray(plight_dir),
            plight_color=jnp.asarray(plight_color),
            plight_angle=jnp.asarray(plight_angle),
            background=jnp.asarray(self.background, jnp.float32),
            textures=jnp.asarray(atlas),
            num_inf=len(self._inf),
            num_shapes=n,
            num_lights=int(light_shape.shape[0]),
            num_plights=len(pl),
        )


def finite_aabb(scene: SceneData) -> tuple[np.ndarray, np.ndarray]:
    """World AABB over finite shapes (host-side; used by the photon grid
    and the BVH builder).  Mirrors per-primitive ``Bounded::aabb()``."""
    params = np.asarray(scene.params)
    ptype = np.asarray(scene.ptype)
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for i in range(scene.num_inf, scene.num_shapes):
        bmin, bmax = prim_aabb(int(ptype[i]), params[i])
        lo = np.minimum(lo, bmin)
        hi = np.maximum(hi, bmax)
    if not np.all(np.isfinite(lo)):
        lo = np.full(3, -1.0, np.float32)
        hi = np.full(3, 1.0, np.float32)
    return lo, hi


def prim_aabb(ptype: int, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side AABB of one primitive row.

    sphere: ``sphere.rs:31-36``; triangle (with 0.1*EPSILON pad):
    ``triangle.rs:48-66``; torus: ``torus.rs:32-51``; aarect:
    ``aa_rect.rs:51-61``; square: ``square.rs``.
    """
    if ptype == PrimType.SPHERE:
        c, r = p[:3], p[3]
        return c - r, c + r
    if ptype == PrimType.TRIANGLE:
        v = p[:9].reshape(3, 3)
        pad = np.float32(0.1 * 2e-4)
        return v.min(0) - pad, v.max(0) + pad
    if ptype == PrimType.TORUS:
        c, big_r, small_r = p[:3], p[3], p[4]
        r = big_r + small_r
        return (c - np.array([r, small_r, r], np.float32),
                c + np.array([r, small_r, r], np.float32))
    if ptype == PrimType.AARECT:
        return p[:3].copy(), p[3:6].copy()
    if ptype == PrimType.SQUARE:
        c, s = p[:3], p[3]
        half = np.array([s / 2, 0.0, s / 2], np.float32)
        return c - half, c + half
    raise ValueError(f"no AABB for ptype {ptype}")
