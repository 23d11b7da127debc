"""Command-line shell: the replacement for the reference's L3-L5 web UI.

Everything the Elm panels expose (``PanelScenes.elm``,
``PanelSettings.elm:19-27``) is a flag here: scene id, per-half render
type (0=NoNEE 1=NEE 2=PNEE), per-half adaptive sampling, light-debug,
sampling-density view, viewport size (clamped [128,1024] like
``PanelSettings.elm:123-125``), plus PNG output, checkpointing, and a
benchmark mode reporting rays/sec and BVH-visit counts.

Usage:
  python -m wasm_pathtracer_tpu.runtime.cli --scene 0 --seconds 10 \
      --out frame.png
"""

from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", type=int, default=0,
                   help="scene id (0=museum, 2=bunny, 100=sphere+plane, "
                        "101=whitted)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--left-type", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--right-type", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--left-adaptive", action="store_true")
    p.add_argument("--right-adaptive", action="store_true")
    p.add_argument("--light-debug", action="store_true")
    p.add_argument("--show-sampling", action="store_true",
                   help="write the sampling-density view instead of color")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--ticks", type=int, default=None,
                   help="exact tick budget (overrides --seconds)")
    p.add_argument("--max-bounces", type=int, default=16)
    p.add_argument("--batch", type=int, default=None,
                   help="rays per wavefront batch (default 32768)")
    p.add_argument("--lanes", type=int, default=None,
                   help="persistent-wavefront lane count (default 8192)")
    p.add_argument("--whitted", type=int, default=None, metavar="DEPTH",
                   help="render one deterministic Whitted frame at this "
                        "recursion depth instead of path tracing")
    p.add_argument("--debug-view", choices=["depth", "bvh"], default=None,
                   help="render a single depth / BVH-cost false-color "
                        "frame (``tracer.rs:205-219``)")
    p.add_argument("--obj", type=str, default=None,
                   help="OBJ mesh to upload as mesh id 1 (bunny slot)")
    p.add_argument("--out", type=str, default=None, help="output PNG path")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--bench", action="store_true",
                   help="print a JSON throughput report")
    p.add_argument("--camera", type=float, nargs=5, default=None,
                   metavar=("X", "Y", "Z", "RX", "RY"))
    p.add_argument("--seed", type=int, default=0xBABABEBE)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from wasm_pathtracer_tpu.runtime import compile_cache
    compile_cache.enable()

    from wasm_pathtracer_tpu.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu.models.camera import Camera
    from wasm_pathtracer_tpu.runtime.session import Session
    from wasm_pathtracer_tpu.runtime.driver import Driver
    from wasm_pathtracer_tpu.runtime import checkpoint
    from wasm_pathtracer_tpu.utils.png import write_png

    # viewport clamped like the GUI (PanelSettings.elm:123-125 caps at
    # 1024; we extend to 1080p-capable since BASELINE config 5 asks for
    # 1080p adaptive path tracing)
    width = min(max(args.width, 128), 1920)
    height = min(max(args.height, 128), 1920)

    def settings(rt, adaptive):
        kw = {}
        if args.batch:
            kw["ray_batch_size"] = args.batch
        if args.lanes:
            kw["regen_lanes"] = args.lanes
        return RenderSettings(render_type=RenderType(rt), adaptive=adaptive,
                              is_debug_photons=args.light_debug,
                              max_bounces=args.max_bounces, **kw)

    camera = Camera.create(args.camera[:3], args.camera[3],
                           args.camera[4]) if args.camera else None

    sess = Session(width, height, args.scene, camera=camera,
                   left=settings(args.left_type, args.left_adaptive),
                   right=settings(args.right_type, args.right_adaptive),
                   seed=args.seed)

    if args.obj:
        from wasm_pathtracer_tpu.utils.obj import load_obj
        # client-side prep: scale x8, flip z (index.ts:213-222)
        sess.store_mesh(1, load_obj(args.obj, scale=8.0, flip_z=True))

    if args.resume:
        checkpoint.load(args.resume, sess)

    if args.debug_view is not None:
        import jax.numpy as jnp
        import numpy as np
        from wasm_pathtracer_tpu.models.camera import primary_rays
        from wasm_pathtracer_tpu.ops import accum, integrator
        from wasm_pathtracer_tpu.utils.png import write_png, tonemap_u8
        pix = jnp.arange(width * height, dtype=jnp.int32)
        px, py = pix % width, pix // width
        o, d = primary_rays(sess.camera, px, py,
                            jnp.full(px.shape, 0.5), jnp.full(py.shape, 0.5),
                            width, height)
        if args.debug_view == "depth":
            t, _ = integrator.trace_depth(sess.prep, sess.scene, o, d)
            img = np.asarray(accum.depth_image(t.reshape(height, width)))
        else:
            cost = integrator.trace_bvh_cost(sess.prep, sess.scene, o, d)
            c = cost.reshape(height, width).astype(jnp.float32)
            img = np.asarray(accum.mix_color(c / jnp.maximum(jnp.max(c), 1)))
        if args.out:
            write_png(args.out, tonemap_u8(img))
            print(f"wrote {args.out}")
        return

    if args.whitted is not None:
        import jax.numpy as jnp
        import numpy as np
        from wasm_pathtracer_tpu.ops import whitted as wh
        from wasm_pathtracer_tpu.utils.png import tonemap_u8
        pix = jnp.arange(width * height, dtype=jnp.int32)
        img = wh.render_whitted(sess.prep, sess.scene, sess.left.settings,
                                sess.camera, pix % width, pix // width,
                                width, height, depth=args.whitted)
        img = np.asarray(img).reshape(height, width, 3)
        if args.out:
            write_png(args.out, tonemap_u8(img))
            print(f"wrote {args.out}")
        return

    drv = Driver(sess)
    if args.bench:
        # warm the jit caches (both halves + photon emission) so the
        # reported rate is steady-state, not first-compile latency
        sess.compute(2)
    t0 = time.perf_counter()
    if args.ticks is not None:
        sess.compute(args.ticks)
        drv.total_ticks = args.ticks
    else:
        drv.run(seconds=args.seconds)
    dt = time.perf_counter() - t0

    if args.bench:
        print(json.dumps({
            "metric": "rays_per_sec_1chip",
            "value": round(drv.total_ticks / dt, 1),
            "unit": "paths/s",
            "bvh_visits": sess.num_bvh_hits,
            "ticks": drv.total_ticks,
            "seconds": round(dt, 3),
        }))

    if args.out:
        write_png(args.out, sess.results(show_sampling=args.show_sampling))
        print(f"wrote {args.out}")

    if args.checkpoint:
        checkpoint.save(args.checkpoint, sess)
        print(f"checkpointed to {args.checkpoint}")


if __name__ == "__main__":
    main()
