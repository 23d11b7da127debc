"""Smoke test of the renderer's main path on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py                # one card: phases a-e below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

One process runs the phases in order and exits non-zero the moment one
fails (nothing is caught):

  a. device   — JAX must report a GPU; prints the card's name and power
                limit (``nvidia-smi``), the compile-cache directory and
                the JAX version.
  b. parity   — the Triton scene kernel (``ops/scene_pallas.py``)
                against the XLA dense trace at 16,384 museum rays,
                primary and random-direction rays from interior points,
                nearest hit and occlusion, at full float32 precision.
  c. museum   — ``Session(512, 512, scene_id=0)`` with its default
                halves (NEE left; PNEE with its 300k-photon emission and
                adaptive sampling right): >= 1M paths, queues drained,
                finite image, paths/s.
  d. cloud    — the same on ``scene_id=5`` (100k-triangle cloud, cluster
                structure, flat wavefront).
  e. grads    — one ``make_train_step`` step on a 1-device mesh (museum,
                albedo + camera, per-bounce remat, 512x512): finite loss
                and gradients, and one albedo gradient against a central
                finite difference under common random numbers.

``--four-cards`` runs only the sharded phase: ``render_queue_sharded``
on the museum and ``render_queue_flat_sharded`` on cloud100k, each
against the same queue on one card, and one ``make_train_step`` step
on four cards against one.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ONE_CARD_PHASES = ("device", "parity", "museum", "cloud", "grads")
FOUR_CARD_PHASES = ("device", "four_cards")


def select_phases(argv) -> tuple:
    """The phases a command line asks for."""
    if "--four-cards" in argv:
        return FOUR_CARD_PHASES
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        raise SystemExit(f"unknown arguments: {unknown}")
    return ONE_CARD_PHASES


def log(msg: str):
    print(msg, flush=True)


def check(cond, msg: str):
    """Fail the phase (and the process) with ``msg`` unless ``cond``."""
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------

def phase_device(n_cards: int = 1):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"needs a GPU; JAX reports platform {devs[0].platform!r}")
    check(len(devs) >= n_cards, f"needs {n_cards} cards, found {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"jax {jax.__version__}, devices {[d.device_kind for d in devs]}")


# ---------------------------------------------------------------------------
# b. kernel parity
# ---------------------------------------------------------------------------

def _parity_rays(n: int, r):
    """Half primary rays through a 512x512 museum frame, half random
    directions from interior points."""
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.models.camera import initial_camera, primary_rays
    h = n // 2
    pix = r.integers(0, 512 * 512, h)
    o1, d1 = primary_rays(initial_camera(0), jnp.asarray(pix % 512),
                          jnp.asarray(pix // 512),
                          jnp.asarray(r.random(h), jnp.float32),
                          jnp.asarray(r.random(h), jnp.float32), 512, 512)
    o2 = np.stack([r.uniform(-19, 19, n - h), r.uniform(-0.9, 1.9, n - h),
                   r.uniform(-19, 19, n - h)], -1).astype(np.float32)
    d2 = r.normal(size=(n - h, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return (np.concatenate([np.asarray(o1), o2]),
            np.concatenate([np.asarray(d1), d2]))


def _light_targets(scene, p, r):
    """A light shape per shadow query — the nearest light for even
    queries (mostly visible), a random one for odd queries (mostly
    behind a wall) — and a random point on it."""
    n = p.shape[0]
    lights = np.asarray(scene.light_shape)
    v = np.asarray(scene.params)[lights][:, :9].reshape(-1, 3, 3)
    dist = np.linalg.norm(p[:, None, :] - v.mean(1)[None], axis=-1)
    pick = np.where(np.arange(n) % 2 == 0, dist.argmin(1),
                    r.integers(0, len(lights), n))
    w = r.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    p_l = np.einsum("nk,nkc->nc", w, v[pick]).astype(np.float32)
    return lights[pick].astype(np.int32), p_l


def phase_parity(n: int = 16_384, seed: int = 0):
    import jax
    from wasm_pathtracer_tpu.models import scenes
    from wasm_pathtracer_tpu.models.scene import PrimType
    from wasm_pathtracer_tpu.ops import trace

    scene = scenes.museum()
    prep_x = trace.prepare(scene, use_fused=False)
    prep_k = trace.prepare(scene)
    check(prep_k.use_fused and not prep_k.interpret,
          "trace.prepare did not pick the compiled kernel on the GPU")
    r = np.random.default_rng(seed)
    o, d = _parity_rays(n, r)
    ptype = np.asarray(scene.ptype)

    nearest = [jax.jit(lambda o, d, p=p: trace.trace_scene(p, scene, o, d))
               for p in (prep_x, prep_k)]
    shadow = [jax.jit(lambda a, b, c, p=p: trace.shadow_ray(p, scene, a, b,
                                                            c)[0])
              for p in (prep_x, prep_k)]
    with jax.default_matmul_precision("highest"):
        (t0, s0, h0, _), (t1, s1, h1, _) = [
            jax.tree.map(np.asarray, f(o, d)) for f in nearest]
        # shadow queries start on the hit points (ray origins on a miss)
        p = o + d * np.where(h0, t0, 0.0)[:, None]
        lsid, p_l = _light_targets(scene, p, r)
        occ0, occ1 = [np.asarray(f(p, p_l, lsid)) for f in shadow]

    same = (h0 == h1) & (np.where(h0, s0, -1) == np.where(h1, s1, -1))
    agree = h0 & h1 & (s0 == s1)
    rel = np.abs(t1[agree] - t0[agree]) / np.maximum(t0[agree], 1e-6)
    torus = ptype[np.maximum(s0[agree], 0)] == int(PrimType.TORUS)
    rel_torus = float(rel[torus].max()) if torus.any() else 0.0
    rel_other = float(rel[~torus].max()) if (~torus).any() else 0.0
    occ_same = occ0 == occ1
    log(f"parity: {n} rays, hits {int(h0.sum())}, hit/id mismatches "
        f"{int((~same).sum())}, max rel t {rel_other:.3g} (tori "
        f"{rel_torus:.3g}), occlusion mismatches {int((~occ_same).sum())} "
        f"of {n} ({int(occ0.sum())} occluded)")
    log("parity: a mismatch can only come from a grazing hit or a tie the "
        "two compilers round differently (FMA contraction, division "
        "order); the tolerances allow 1 in 10^4")
    check(same.mean() >= 0.9999, "hit/id agreement below 99.99%")
    check(rel_other <= 1e-5, f"t rel error {rel_other} > 1e-5")
    check(rel_torus <= 1e-4, f"torus t rel error {rel_torus} > 1e-4")
    check(occ_same.mean() >= 0.9999, "occlusion agreement below 99.99%")


# ---------------------------------------------------------------------------
# c/d. sessions
# ---------------------------------------------------------------------------

def _session_phase(scene_id: int, label: str, width: int, height: int,
                   n_paths: int, left=None, right=None):
    import jax
    from wasm_pathtracer_tpu.runtime.session import Session
    t0 = time.perf_counter()
    s = Session(width, height, scene_id=scene_id, left=left, right=right)
    log(f"{label}: session built in {time.perf_counter() - t0:.1f} s "
        f"(clusters: {s.prep.cluster is not None}, "
        f"kernel: {s.prep.use_fused})")
    ri = s.right
    batch = ri.settings.ray_batch_size
    spp = ri.settings.adaptive_bootstrap_spp if ri.settings.adaptive else 0
    traced = 0
    # warm up until both halves have compiled every step they will run
    # in the timed window (photon emission done, adaptive bootstrap over)
    t0 = time.perf_counter()
    while True:
        traced += s.compute(4 * batch)
        if ri._photons_done() and \
                ri._rays_traced > (spp + 1) * ri.width * ri.height:
            break
    jax.block_until_ready(s.buffer.acc)
    log(f"{label}: warm-up {traced} paths in "
        f"{time.perf_counter() - t0:.1f} s (compiles included)")
    t0 = time.perf_counter()
    n = s.compute(n_paths)
    jax.block_until_ready(s.buffer.acc)
    dt = time.perf_counter() - t0
    traced += n
    counts = int(np.asarray(s.buffer.count, np.int64).sum())
    img = s.image()
    log(f"{label}: {n} paths in {dt:.3f} s = {n / dt:.1f} paths/s "
        f"(both halves, {width}x{height})")
    check(n >= n_paths, f"{label}: traced {n} < {n_paths}")
    check(counts == traced,
          f"{label}: queues not drained ({counts} samples, {traced} paths)")
    check(np.isfinite(img).all() and img.max() > 0,
          f"{label}: image not finite or black")
    if ri.photon_grid is not None:
        log(f"{label}: photons landed {int(ri.photon_grid.num_photons)}")
    return n / dt


def phase_museum(n_paths: int = 1_048_576, size: int = 512):
    return _session_phase(0, "museum", size, size, n_paths)


def phase_cloud(n_paths: int = 1_048_576, size: int = 512):
    return _session_phase(5, "cloud100k", size, size, n_paths)


# ---------------------------------------------------------------------------
# e. gradients
# ---------------------------------------------------------------------------

def _train_setup(size: int, bounces: int):
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu.models import scenes
    from wasm_pathtracer_tpu.models.camera import initial_camera
    from wasm_pathtracer_tpu.ops import trace
    scene = scenes.museum()
    # the RR keep chance is pinned so the survival decision does not
    # depend on albedo and a finite difference sees no discrete flips
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=bounces, checkpoint_bounces=True,
                              rr_clamp_min=0.9, rr_clamp_max=0.9)
    target = jnp.full((size, size, 3), 0.25, jnp.float32)
    return scene, trace.prepare(scene), settings, initial_camera(0), target


def phase_grads(size: int = 512, bounces: int = 8, h: float = 1e-2):
    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.parallel import make_ray_mesh, make_train_step
    scene, prep, settings, cam, target = _train_setup(size, bounces)
    # plain SGD: the updated leaves are old - lr * grad (albedo clipped
    # to [0, 1]), so the gradient is read back from one step
    lr = 1e-2
    step = make_train_step(make_ray_mesh(jax.devices()[:1]), prep,
                           settings, size, size, lr=lr)
    seed = jnp.uint32(5)
    t0 = time.perf_counter()
    loss, sc2, cam2 = jax.block_until_ready(step(scene, cam, target, seed))
    log(f"grads: first step {time.perf_counter() - t0:.1f} s "
        f"(compile included), loss {float(loss):.6g}")
    t0 = time.perf_counter()
    jax.block_until_ready(step(scene, cam, target, seed))
    dt = time.perf_counter() - t0
    log(f"grads: step {dt:.3f} s = {size * size / dt:.1f} grad rays/s")
    g_alb = (np.asarray(scene.albedo) - np.asarray(sc2.albedo)) / lr
    g_cam = [(np.asarray(a) - np.asarray(b)) / lr for a, b in
             zip(jax.tree.leaves(cam), jax.tree.leaves(cam2))]
    check(np.isfinite(float(loss)), "non-finite loss")
    check(np.isfinite(g_alb).all() and all(np.isfinite(g).all()
                                           for g in g_cam),
          "non-finite gradients")
    # the ground plane's red albedo (0.7): far from the [0, 1] clip
    k, c = 0, 0
    alb = scene.albedo

    def loss_at(delta):
        sc = scene.with_materials(albedo=alb.at[k, c].add(delta))
        return float(step(sc, cam, target, seed)[0])

    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    ana = float(g_alb[k, c])
    rel = abs(ana - fd) / max(abs(fd), 1e-12)
    log(f"grads: d loss / d albedo[{k},{c}] analytic {ana:.6g}, central "
        f"difference {fd:.6g} (h={h}), rel {rel:.3g}")
    check(0.0 < float(sc2.albedo[k, c]) < 1.0, "probe entry was clipped")
    check(rel <= 5e-2, f"albedo gradient off the finite difference: {rel}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _rel_close(name, a4, a1, rtol):
    a4, a1 = np.asarray(a4, np.float64), np.asarray(a1, np.float64)
    scale = np.abs(a1).max() + 1e-30
    err = np.abs(a4 - a1)
    worst = float((err / (np.abs(a1) + 1e-6 * scale)).max())
    log(f"four_cards: {name} max rel diff {worst:.3g}")
    check(np.all(err <= rtol * np.abs(a1) + 1e-6 * rtol * scale),
          f"{name}: 4-card result differs from 1 card beyond {rtol}")


def _on_n_devices(x, n):
    devs = x.sharding.device_set
    check(len(devs) == n and len(x.addressable_shards) == n,
          f"output sits on {len(devs)} devices, not {n}")


def phase_four_cards(n_dev: int = 4, museum_paths: int = 524_288,
                     cloud_paths: int = 262_144, lanes: int = 4096,
                     size: int = 512, train_size: int = 256,
                     train_bounces: int = 4, cloud_scene: int = 5):
    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu.models import scenes
    from wasm_pathtracer_tpu.models.camera import initial_camera
    from wasm_pathtracer_tpu.ops import bvh, trace
    from wasm_pathtracer_tpu.parallel import (
        make_ray_mesh, make_train_step, render_queue_sharded,
        render_queue_flat_sharded)

    devs = jax.devices()
    check(len(devs) >= n_dev, f"needs {n_dev} devices, found {len(devs)}")
    mesh_n, mesh_1 = make_ray_mesh(devs[:n_dev]), make_ray_mesh(devs[:1])
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=8)

    def queue_pair(label, renderer, prep, scene, cam, n_paths):
        pix = jax.random.randint(jax.random.key(1), (n_paths,), 0,
                                 size * size, dtype=jnp.int32)
        outs = {}
        for key, mesh in (("n", mesh_n), ("1", mesh_1)):
            fn = jax.jit(lambda p, m=mesh: renderer(
                m, prep, scene, settings, cam, p, size, size,
                jnp.uint32(9), lanes))
            jax.block_until_ready(fn(pix))                 # compile
            t0 = time.perf_counter()
            outs[key] = jax.block_until_ready(fn(pix))
            log(f"four_cards: {label} on {mesh.devices.size} card(s) "
                f"{n_paths / (time.perf_counter() - t0):.1f} paths/s")
        (acc4, cnt4, _), (acc1, cnt1, _) = outs["n"], outs["1"]
        _on_n_devices(acc4, n_dev)
        check(np.array_equal(np.asarray(cnt4), np.asarray(cnt1)),
              f"{label}: sample counts differ")
        check(int(np.asarray(cnt4).sum()) == n_paths,
              f"{label}: queue not drained")
        _rel_close(f"{label} radiance", acc4, acc1, 1e-5)

    museum = scenes.museum()
    queue_pair("museum render_queue_sharded", render_queue_sharded,
               trace.prepare(museum), museum, initial_camera(0),
               museum_paths)
    cloud = scenes.select_scene(cloud_scene)
    queue_pair("cloud100k render_queue_flat_sharded",
               render_queue_flat_sharded,
               bvh.attach_clusters(trace.prepare(cloud), cloud), cloud,
               initial_camera(cloud_scene), cloud_paths)

    scene, prep, tset, cam, target = _train_setup(train_size, train_bounces)
    res = {}
    for key, mesh in (("n", mesh_n), ("1", mesh_1)):
        step = make_train_step(mesh, prep, tset, train_size, train_size)
        res[key] = jax.block_until_ready(step(scene, cam, target,
                                              jnp.uint32(5)))
    (l4, sc4, cam4), (l1, sc1, cam1) = res["n"], res["1"]
    _rel_close("train loss", l4, l1, 1e-5)
    _rel_close("train albedo", sc4.albedo, sc1.albedo, 1e-5)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(cam4),
                                   jax.tree.leaves(cam1))):
        _rel_close(f"train camera leaf {i}", a, b, 1e-5)


# ---------------------------------------------------------------------------

PHASES = {
    "device": phase_device,
    "parity": phase_parity,
    "museum": phase_museum,
    "cloud": phase_cloud,
    "grads": phase_grads,
    "four_cards": phase_four_cards,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = select_phases(argv)
    from wasm_pathtracer_tpu.runtime import compile_cache
    compile_cache.enable()
    import jax
    n_cards = 4 if "four_cards" in phases else 1
    for name in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        if name == "device":
            phase_device(n_cards)
        else:
            PHASES[name]()
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
