"""Attribute the museum backward (gradient) pass.

Measures, on the museum scan-form integrator (the bench's backward
workload):
  - forward-only render time (same scan settings, no grad);
  - value_and_grad w.r.t. albedo only / albedo+camera / light rows;
  - remat (checkpoint_bounces) on vs off at the probe batch;
  - batch sweep in both directions (does grad rays/s fall with batch?).

Prints one JSON line.
Usage: python examples/profile_backward.py [--rays 262144]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=262_144)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu.models import scenes
    from wasm_pathtracer_tpu.models.camera import initial_camera
    from wasm_pathtracer_tpu.ops import integrator, trace

    scene = scenes.museum()
    prep = trace.prepare(scene)          # XLA dense path (differentiable)
    cam0 = initial_camera(0)
    base = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8,
                          early_exit=False, checkpoint_bounces=True)

    def timed(fn, *args_, n=None):
        n = n or args.iters
        out = fn(*args_)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        outs = [fn(*args_) for _ in range(n)]
        jax.block_until_ready(outs)
        return (time.perf_counter() - t0) / n

    def make(Rg, remat=True, mode="albedo+camera", nee=True):
        st = base.replace(
            checkpoint_bounces=remat,
            render_type=(RenderType.NORMAL_NEE if nee
                         else RenderType.NO_NEE))
        pix = jnp.arange(Rg, dtype=jnp.int32)
        px, py = pix % 512, (pix // 512) % 512

        def render(sc, camera, seed):
            col, _ = integrator.render_pixels(prep, sc, st, camera,
                                              px, py, 512, 512, seed)
            return jnp.mean(col ** 2)

        if mode == "forward":
            @jax.jit
            def f(albedo, camera, seed):
                return render(scene.with_materials(albedo=albedo),
                              camera, seed)
            return f, (scene.albedo, cam0, jnp.uint32(0))
        if mode == "albedo":
            @jax.jit
            def f(albedo, camera, seed):
                return jax.value_and_grad(
                    lambda a: render(scene.with_materials(albedo=a),
                                     camera, seed))(albedo)
            return f, (scene.albedo, cam0, jnp.uint32(0))
        if mode == "albedo+camera":
            @jax.jit
            def f(albedo, camera, seed):
                return jax.value_and_grad(
                    lambda a, c: render(scene.with_materials(albedo=a),
                                        c, seed),
                    argnums=(0, 1))(albedo, camera)
            return f, (scene.albedo, cam0, jnp.uint32(0))
        if mode == "lights":
            rows0 = scene.params[scene.light_shape]

            @jax.jit
            def f(rows, camera, seed):
                return jax.value_and_grad(
                    lambda r: render(scene.with_light_rows(r),
                                     camera, seed))(rows)
            return f, (rows0, cam0, jnp.uint32(0))
        raise ValueError(mode)

    R = args.rays
    res = {"rays": R, "backend": jax.default_backend()}
    rows = []
    for name, kw in [
        ("forward", dict(mode="forward")),
        ("grad albedo", dict(mode="albedo")),
        ("grad albedo+camera", dict(mode="albedo+camera")),
        ("grad lights", dict(mode="lights")),
        ("grad a+c NO remat", dict(mode="albedo+camera", remat=False)),
        ("grad a+c no-NEE", dict(mode="albedo+camera", nee=False)),
    ]:
        try:
            f, fargs = make(R, **kw)
            dt = timed(f, *fargs)
            rows.append((name, dt, R / dt))
            res[name] = {"sec_per_step": round(dt, 4),
                         "rays_per_sec": round(R / dt, 1)}
        except Exception as e:  # noqa: BLE001 — record failures as data
            res[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            rows.append((name, float("nan"), float("nan")))
        print(f"{name:22s}: "
              f"{res[name].get('sec_per_step', 'FAIL')!s:>8} s/step  "
              f"{res[name].get('rays_per_sec', '')!s:>12} rays/s",
              file=sys.stderr, flush=True)

    # batch sweep — BOTH directions, so a rate that falls with batch
    # can be attributed: if forward shows the same
    # negative slope, it is a working-set effect of the scan-form
    # renderer, not a backward pathology
    sweep, sweep_f = {}, {}
    for Rg in (65_536, 131_072, 262_144):
        f, fargs = make(Rg)
        dt = timed(f, *fargs)
        sweep[Rg] = round(Rg / dt, 1)
        ff, ffargs = make(Rg, mode="forward")
        dtf = timed(ff, *ffargs)
        sweep_f[Rg] = round(Rg / dtf, 1)
        print(f"batch {Rg:>7}: {Rg/dt:,.0f} grad rays/s | "
              f"{Rg/dtf:,.0f} fwd rays/s | ratio {dt/dtf:.2f}",
              file=sys.stderr, flush=True)
    res["batch_sweep_rays_per_sec"] = sweep
    res["batch_sweep_forward_rays_per_sec"] = sweep_f
    print(json.dumps(res))


if __name__ == "__main__":
    main()
