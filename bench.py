"""Benchmark: path-traced paths per second on one device, across the
reference's workload classes, plus the backward (gradient) pass.

Headline metric (the JSON line's ``value``): museum-scene paths/s —
the reference flagship (146 shapes, 108 area lights, ``SURVEY.md``) at
512x512 with NEE path tracing, 8-bounce persistent wavefront.  A "ray"
is one full path tick (the reference's unit of work: 1 tick ~ 1 primary
path, ``src/tracer.rs:99-123``), including all bounce and shadow rays.

``extras`` carries the other BASELINE-named workloads:
  - ``mesh70k_paths_per_sec``: bunny-class surface mesh (~70k tris,
    BASELINE config 3's class; reference workload slot
    ``src_ts/client/index.ts:213-222``) through the flattened wavefront.
  - ``cloud100k_paths_per_sec``: the 100k-triangle procedural cloud
    (``index.ts:224-226``), same path.
  - ``cloud300k_paths_per_sec``: a 300k-triangle cloud (the x8-scale
    high-poly workload class).
  - ``backward_grad_rays_per_sec``: value_and_grad of the scan-form
    integrator on the museum w.r.t. materials + camera (BASELINE.md:
    "backward grad rays/sec measured alongside forward"): 262,144
    rays x 5 iterations with per-bounce rematerialization, plus
    half-batch and no-remat variants and XLA-reported gradient
    temp memory.  The no-remat variant runs LAST and its failure
    (compile or runtime) is recorded as a *result*
    (``backward_noremat_failed`` + temp size + error head).
  - ``adaptive_1080p_paths_per_sec``: 1920x1080 variance-guided
    adaptive sampling, single device (BASELINE config 5's 1-device
    half).

Every result names the device it ran on (platform, kind, count, and
the card's name and power limit from ``nvidia-smi``).  Every stage runs
under ``_stage``, which records failures into ``extras["failures"]``
and emits the partial result set after EVERY stage — one flushed
``bench-stage:`` line on stderr plus a rewrite of
``BENCH_PARTIAL.json`` — so a hard kill can lose at most the stage in
flight.  The single stdout JSON line still prints exactly once at the
end, and the process exits non-zero when any stage failed.

``vs_baseline``: the reference publishes no numbers (BASELINE.md); the
only throughput machinery it documents is the worker auto-tuner's
initial rate of 500 rays / 50 ms = 10,000 rays/sec in-browser
(``src_ts/worker/worker.ts:22,71-81``).  We report against that 1e4
rays/sec anchor.
"""

import json
import os
import sys
import time

import numpy as np

# NOTE on memory gating: XLA's ``memory_analysis().temp_size_in_bytes``
# reports TOTAL temp buffer bytes, not peak simultaneous allocation, so
# it cannot decide runnability; every backward variant ATTEMPTS
# execution, a failure is recorded as the result, and the riskiest
# variant (no-remat) runs as the LAST stage.


def _bench_queue(fn, prep, scene, settings, cam, W, H, S, B, n_iters=3,
                 want_iters=False, photon_grid=None):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(seed):
        pix = jax.random.randint(jax.random.key(seed), (S,), 0, W * H)
        if want_iters:
            acc, cnt, cost, its = fn(prep, scene, settings, cam, pix, W, H,
                                     seed, B, photon_grid=photon_grid,
                                     return_iters=True)
        else:
            acc, cnt, cost = fn(prep, scene, settings, cam, pix, W, H,
                                seed, B, photon_grid=photon_grid)
            its = jnp.int32(0)
        return acc.sum(), cnt.sum(), cost.astype(jnp.float32).sum(), its

    jax.block_until_ready(step(jnp.uint32(0)))            # compile + warm
    t0 = time.perf_counter()
    outs = [step(jnp.uint32(i)) for i in range(1, n_iters + 1)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    acc = sum(float(x) for x, _, _, _ in outs)
    done = sum(int(c) for _, c, _, _ in outs)
    tests = sum(float(t) for _, _, t, _ in outs)
    loop_iters = sum(int(i) for _, _, _, i in outs)
    assert np.isfinite(acc)
    assert done == n_iters * S, f"queue not drained: {done} != {n_iters*S}"
    if want_iters:
        return done / dt, tests / done, loop_iters / dt
    return done / dt, tests / done


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    ("not available" where there is no such tool)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


class _Results:
    """Accumulates stage results and emits partials after every stage."""

    def __init__(self):
        self.extras = {}
        self.failures = {}
        self.headline = None
        self._partial_path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "BENCH_PARTIAL.json")

    def emit_partial(self, stage_name, dt):
        snap = {"stage": stage_name, "stage_seconds": round(dt, 1),
                "headline_paths_per_sec": self.headline,
                "extras": self.extras, "failures": self.failures}
        line = json.dumps(snap)
        print(f"bench-stage: {line}", file=sys.stderr, flush=True)
        try:
            tmp = self._partial_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(line + "\n")
            os.replace(tmp, self._partial_path)
        except OSError:
            pass


def _stage(res, name):
    """Decorator-ish runner: run ``fn`` under try/except, record any
    failure in ``extras['failures']`` instead of dying, and emit the
    partial result set either way."""
    def run(fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — recorded; main() exits 1
            msg = f"{type(e).__name__}: {e}"
            res.failures[name] = msg[:400]
        res.emit_partial(name, time.perf_counter() - t0)
    return run


def main():
    from wasm_pathtracer_tpu.runtime import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu.models import scenes
    from wasm_pathtracer_tpu.models.camera import Camera, initial_camera
    from wasm_pathtracer_tpu.ops import bvh, integrator, trace, wavefront

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = _card()
    print(f"bench: device {device}, card {card}", file=sys.stderr,
          flush=True)
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE,
                              max_bounces=8)
    res = _Results()
    extras = res.extras

    # -- 0. shared scene construction: its own stage, so a failure here
    # is recorded and later stages each fail with a recorded KeyError
    # instead of the whole bench dying before the first emit
    # (ADVICE r04: nothing may run outside a _stage wrapper) ----------
    shared = {}

    @_stage(res, "setup")
    def _():
        shared["scene"] = scenes.museum()

    # -- 1. museum headline (scene kernel, regenerating wavefront) -----
    @_stage(res, "museum")
    def _():
        scene = shared["scene"]
        prep = trace.prepare(scene)
        pps, _, ips = _bench_queue(
            integrator.render_queue, prep, scene, settings,
            initial_camera(0), 512, 512, S=2_621_440, B=16_384,
            want_iters=True)
        res.headline = round(pps, 1)
        extras["museum_iters_per_sec"] = round(ips, 1)

    # -- 2. bunny-class mesh (~70k tris) through the flat wavefront ----
    @_stage(res, "mesh70k")
    def _():
        mesh = scenes.mesh_scene(scenes.surface_mesh(188))
        prep_m = bvh.attach_clusters(trace.prepare(mesh), mesh)
        cam_m = Camera.create((0.0, 1.0, -6.0), 0.1, 0.0)
        pps, _ = _bench_queue(wavefront.render_queue_flat, prep_m,
                              mesh, settings, cam_m, 512, 512,
                              S=524_288, B=16_384)
        extras["mesh70k_paths_per_sec"] = round(pps, 1)

    # -- 3. 100k-triangle cloud (scene id 5) ----------------------------
    @_stage(res, "cloud100k")
    def _():
        cloud = scenes.select_scene(5)
        prep_c = bvh.attach_clusters(trace.prepare(cloud), cloud)
        pps, _ = _bench_queue(wavefront.render_queue_flat, prep_c,
                              cloud, settings, initial_camera(5),
                              512, 512, S=524_288, B=16_384)
        extras["cloud100k_paths_per_sec"] = round(pps, 1)

    # -- 3b. 300k-triangle cloud (the x8-scale high-poly workload slot,
    # ``index.ts:213-222``) ------------------------------------------
    @_stage(res, "cloud300k")
    def _():
        big = scenes.cloud(300_000)
        prep_big = bvh.attach_clusters(trace.prepare(big), big)
        pps, _ = _bench_queue(wavefront.render_queue_flat, prep_big,
                              big, settings, initial_camera(5),
                              512, 512, S=262_144, B=8_192)
        extras["cloud300k_paths_per_sec"] = round(pps, 1)

    # -- 3c. photon emission: the reference's PNEE preprocessing at its
    # 300k-photon budget (``src/tracer.rs:103-123``; config.py
    # total_photons).  Photons are COUNTED when they land (diffuse
    # deposit, ``tracer.rs:109``), so both the landed rate and the shot
    # rate are reported. -------------------------------------------------
    @_stage(res, "photon_emission")
    def _():
        from wasm_pathtracer_tpu.ops import photon
        scene = shared["scene"]
        prep = trace.prepare(scene)
        lo, hi = photon.grid_bounds_for_scene(scene, settings)

        def fresh():
            return photon.PhotonGrid.create(scene.num_lights, lo, hi,
                                            settings.photon_grid_res)

        batch = 65_536

        @jax.jit
        def emit(grid, seed):
            return photon.emit_photons(grid, prep, scene, settings,
                                       seed, batch)

        grid = emit(fresh(), jnp.uint32(0))               # warm/compile
        jax.block_until_ready(grid.bins)
        grid = fresh()
        budget = settings.total_photons                   # 300,000
        t0 = time.perf_counter()
        shots = 0
        seed = 1
        while int(grid.num_photons) < budget and shots < 64 * batch:
            grid = emit(grid, jnp.uint32(seed))
            seed += 1
            shots += batch
        jax.block_until_ready(grid.bins)
        dt = time.perf_counter() - t0
        landed = int(grid.num_photons)
        extras["photon_landed_per_sec"] = round(landed / dt, 1)
        extras["photon_shots_per_sec"] = round(shots / dt, 1)
        extras["photon_budget_seconds"] = round(dt, 3)
        shared["photon_grid"] = grid

    # -- 3d. museum under PNEE: the reference's flagship estimator
    # (``src/tracer.rs:103-152``; BASELINE config 4's perf half).  Same
    # workload as stage 1 with photon-guided light selection (grid
    # sample + 8-cell pdf gather per NEE event) so the delta vs the
    # headline is the PNEE overhead. --------------------------------------
    @_stage(res, "museum_pnee")
    def _():
        scene = shared["scene"]
        grid = shared["photon_grid"]
        prep = trace.prepare(scene)
        pnee = settings.replace(render_type=RenderType.PNEE)
        pps, _, _ = _bench_queue(
            integrator.render_queue, prep, scene, pnee,
            initial_camera(0), 512, 512, S=2_621_440, B=16_384,
            want_iters=True, photon_grid=grid)
        extras["museum_pnee_paths_per_sec"] = round(pps, 1)

    # -- 4. backward: grads of the scan-form museum render --------------
    # (XLA dense path: the scene kernel is forward-only;
    # bounce-checkpointed scan.)
    # BASELINE.md: "backward grad rays/sec measured alongside forward".
    # Methodology: 262,144 rays/step (large enough that dispatch is
    # noise), 5 timed iterations, with and without per-bounce
    # rematerialization (config.checkpoint_bounces), plus a half-batch
    # run to show the rate survives a 2x batch change; gradient memory
    # from XLA's own memory analysis of the compiled executable.  The
    # no-remat variant ALWAYS attempts execution (see the module-level
    # memory-gating note: memory_analysis cannot pre-decide
    # runnability); a compile-helper death or runtime OOM is caught
    # and recorded as the remat-tradeoff datum.
    cam0 = initial_camera(0)

    def _bench_backward(Rg, remat, n_iters=5):
        # scene/prep built here so a failure lands in the calling
        # stage's failure record (ADVICE r04)
        scene = shared["scene"]
        prep_g = trace.prepare(scene, use_fused=False)
        gset = settings.replace(early_exit=False, checkpoint_bounces=remat)
        pix = jnp.arange(Rg, dtype=jnp.int32)
        px, py = pix % 512, (pix // 512) % 512

        @jax.jit
        def grad_step(albedo, camera, seed):
            def loss(albedo, camera):
                sc = scene.with_materials(albedo=albedo)
                col, _ = integrator.render_pixels(prep_g, sc, gset, camera,
                                                  px, py, 512, 512, seed)
                return jnp.mean(col ** 2)
            l, g = jax.value_and_grad(loss, argnums=(0, 1))(albedo, camera)
            return l, g

        try:
            lowered = grad_step.lower(scene.albedo, cam0, jnp.uint32(0))
            compiled = lowered.compile()
        except Exception as e:
            # a compile failure of the no-remat variant is the
            # remat-tradeoff datum too
            return None, float("nan"), f"{type(e).__name__}: {e}"[:300], \
                "compile_failed"
        try:
            # informational only: total temp bytes, NOT peak (see the
            # module note) — still the right remat-vs-memory datum
            temp_mb = compiled.memory_analysis().temp_size_in_bytes / 2**20
        except Exception:
            temp_mb = float("nan")
        try:
            out = grad_step(scene.albedo, cam0, jnp.uint32(0))   # warm
            jax.block_until_ready(out)
        except Exception as e:                  # runtime OOM is a RESULT
            return None, temp_mb, f"{type(e).__name__}: {e}"[:300], \
                "runtime_failed"
        t0 = time.perf_counter()
        outs = [grad_step(scene.albedo, cam0, jnp.uint32(i))
                for i in range(1, n_iters + 1)]
        jax.block_until_ready(outs)
        return n_iters * Rg / (time.perf_counter() - t0), temp_mb, None, None

    @_stage(res, "backward_remat")
    def _():
        rps, mem, err, kind = _bench_backward(262_144, remat=True)
        if mem == mem:                      # NaN is not strict JSON
            # XLA total-temp bytes, NOT peak simultaneous allocation
            # (see module note) — informational remat-tradeoff datum
            extras["backward_temp_mem_total_mb"] = round(mem, 1)
        if rps is None:
            extras["backward_remat_failed"] = kind
            extras["backward_remat_error"] = err
        else:
            extras["backward_grad_rays_per_sec"] = round(rps, 1)

    @_stage(res, "backward_half_batch")
    def _():
        rps_h, _, _, _ = _bench_backward(131_072, remat=True)
        if rps_h is not None:
            extras["backward_grad_rays_per_sec_half_batch"] = round(rps_h, 1)

    # -- 5. 1080p adaptive, single device (config 5's 1-device half) ----
    @_stage(res, "adaptive_1080p")
    def _():
        from wasm_pathtracer_tpu.runtime.session import Session
        aset = settings.replace(adaptive=True, ray_batch_size=262_144,
                                regen_lanes=16_384)
        sess = Session(1920, 1080, scene_id=0, left=aset, right=aset)
        sess.compute(262_144)                             # warm both halves
        t0 = time.perf_counter()
        traced = sess.compute(2 * 2_097_152)
        dt = time.perf_counter() - t0
        extras["adaptive_1080p_paths_per_sec"] = round(traced / dt, 1)

    # -- 5b. decompose the museum-vs-1080p gap (r04 weak #5): the same
    # renderer as the headline on (a) a raw full-frame 1080p queue (no
    # session, no halves, no allocator) and (b) the session WITHOUT the
    # adaptive allocator (uniform random pixels).  raw -> uniform-session
    # delta = session/half/step machinery; uniform -> adaptive delta =
    # the variance-guided allocator itself. ------------------------------
    @_stage(res, "adaptive_1080p_decomp")
    def _():
        from wasm_pathtracer_tpu.runtime.session import Session
        scene = shared["scene"]
        prep = trace.prepare(scene)
        pps_raw, _ = _bench_queue(
            integrator.render_queue, prep, scene, settings,
            initial_camera(0), 1920, 1080, S=2_097_152, B=16_384)
        extras["raw_1080p_paths_per_sec"] = round(pps_raw, 1)

        uset = settings.replace(adaptive=False, ray_batch_size=262_144,
                                regen_lanes=16_384)
        sess = Session(1920, 1080, scene_id=0, left=uset, right=uset)
        sess.compute(262_144)
        t0 = time.perf_counter()
        traced = sess.compute(2 * 2_097_152)
        dt = time.perf_counter() - t0
        extras["uniform_1080p_paths_per_sec"] = round(traced / dt, 1)

    # -- 6. backward WITHOUT remat: 8 bounces x 108 lights x 262k rays
    # of residuals.  LAST on purpose: a failure here (compile or
    # runtime) must not cost any other stage, and either failure mode
    # is itself the remat-tradeoff datum.
    @_stage(res, "backward_noremat")
    def _():
        rps_nr, mem_nr, err, kind = _bench_backward(262_144, remat=False)
        if mem_nr == mem_nr:                # NaN is not strict JSON
            extras["backward_noremat_temp_mem_total_mb"] = round(mem_nr, 1)
        if rps_nr is None:
            # "compile_failed" or "runtime_failed": either way the datum
            # is "does not fit without remat at this batch"
            extras["backward_noremat_failed"] = kind
            extras["backward_noremat_error"] = err
            # the tradeoff still gets a measured point at 65k rays
            rps_sm, _, err2, _ = _bench_backward(65_536, remat=False)
            if rps_sm is not None:
                extras["backward_noremat_rays_per_sec_65k"] = \
                    round(rps_sm, 1)
        else:
            extras["backward_noremat_failed"] = False
            extras["backward_noremat_rays_per_sec"] = round(rps_nr, 1)

    baseline = 1.0e4  # reference worker initial auto-tune rate (see above)
    if res.failures:
        extras["failures"] = res.failures
    headline = res.headline if res.headline is not None else 0.0
    print(json.dumps({
        "metric": "rays_per_sec_1chip",
        "value": headline,
        "unit": "paths/s",
        "vs_baseline": round(headline / baseline, 2),
        "device": device,
        "card": card,
        "extras": extras,
    }))
    return 1 if res.failures else 0


if __name__ == "__main__":
    sys.exit(main())
