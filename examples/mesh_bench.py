"""Mesh-scale measurement: throughput of the cluster path.

BASELINE config 3 workload class: a bunny-scale surface mesh (>= 69k
triangles, the reference's `bunny2.obj x8` slot) and the 100k-triangle
procedural cloud (``src_ts/client/index.ts:213-226``).  Prints paths/s
for the production render path (persistent wavefront + cluster probing,
with the Pallas scene kernel on the dense remainder on a GPU).

Usage: python examples/mesh_bench.py [n_subdiv]
"""

import functools
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

# runnable from anywhere: the package lives next to examples/
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models.scene import SceneBuilder, Material
from wasm_pathtracer_tpu.models import scenes
from wasm_pathtracer_tpu.models.camera import Camera
from wasm_pathtracer_tpu.ops import bvh, integrator, trace, wavefront


from wasm_pathtracer_tpu.models.scenes import mesh_scene, surface_mesh  # noqa: E402 (re-export for callers)


def bench_scene(scene, label, S=262_144, B=32_768, iters=3, group=None,
                forms=("lockstep", "flat")):
    prep = trace.prepare(scene)
    kw = {} if group is None else dict(group=group)
    prep = bvh.attach_clusters(prep, scene, **kw)
    n_tri = int(np.sum(np.asarray(scene.ptype) == 2))
    C = prep.cluster.blocks.shape[0] if prep.cluster is not None else 0
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=8)
    cam = Camera.create((0.0, 1.0, -6.0), 0.1, 0.0)
    W = H = 512
    best = 0.0

    for form in forms:
        if form == "flat" and prep.cluster is None:
            continue

        @jax.jit
        def step(seed, form=form):
            pix = jax.random.randint(jax.random.key(seed), (S,), 0, W * H)
            fn = (integrator.render_queue if form == "lockstep"
                  else wavefront.render_queue_flat)
            acc, cnt, cost = fn(prep, scene, settings, cam, pix, W, H,
                                seed, B)
            return acc.sum(), cnt.sum(), cost.astype(jnp.float32).sum()

        t0 = time.perf_counter()
        out = step(jnp.uint32(0))
        jax.block_until_ready(out)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        outs = [step(jnp.uint32(i)) for i in range(1, iters + 1)]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        done = sum(int(c) for _, c, _ in outs)
        cost = sum(float(x) for _, _, x in outs)
        assert done == iters * S, (done, iters * S)
        pps = done / dt
        print(f"{label} [{form}]: {n_tri} tris, {C} clusters -> "
              f"{pps/1e6:.3f} Mpaths/s (compile {compile_s:.0f}s, "
              f"{cost/done:.0f} prim-tests/path)", flush=True)
        best = max(best, pps)
    return best


def main():
    forms = tuple(sys.argv[2].split(",")) if len(sys.argv) > 2 \
        else ("flat", "lockstep")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 188  # ~70k tris
    tris = surface_mesh(n)
    print(f"surface mesh: {len(tris)} triangles", flush=True)
    bench_scene(mesh_scene(tris), "bunny-class mesh", forms=forms)

    cloud = scenes.triangle_cloud(100_000)
    b = SceneBuilder(background=(0.05, 0.05, 0.08))
    b.add_triangles(cloud, Material.diffuse(0.7, 0.7, 0.7))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 6.0, 2.0), (2.0, 6.0, -2.0), (-2.0, 6.0, -2.0), light)
    b.add_triangle((-2.0, 6.0, 2.0), (2.0, 6.0, 2.0), (-2.0, 6.0, -2.0), light)
    bench_scene(b.build(), "100k triangle cloud", forms=forms)


if __name__ == "__main__":
    main()
