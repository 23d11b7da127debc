"""Adaptive sampling allocator tests (``sampling_strategy.rs`` semantics)."""

import numpy as np
import jax.numpy as jnp

from wasm_pathtracer_tpu.ops import accum, adaptive, filters


def test_gaussian_filters_match_reference_kernels_interior():
    """Interior pixels: plain normalized convolution (/16 and /256)."""
    r = np.random.default_rng(0)
    img = r.uniform(size=(16, 16, 3)).astype(np.float32)
    g3 = np.asarray(filters.gaussian3(jnp.asarray(img)))
    # hand-computed at an interior pixel
    k = filters.GAUSS3
    y, x = 7, 9
    want = np.zeros(3)
    for dy in range(3):
        for dx in range(3):
            want += k[dy, dx] * img[y + dy - 1, x + dx - 1]
    want /= k.sum()
    assert np.allclose(g3[y, x], want, atol=1e-5)


def test_gaussian_edge_renormalization():
    """At corners only the in-bounds taps count (``render_target.rs:130-138``)."""
    img = jnp.ones((8, 8, 3), jnp.float32)
    g = np.asarray(filters.gaussian3(img))
    # constant image stays constant even at the border thanks to renorm
    assert np.allclose(g, 1.0, atol=1e-6)
    g5 = np.asarray(filters.gaussian5(img))
    assert np.allclose(g5, 1.0, atol=1e-6)


def test_error_field_flags_noisy_pixels():
    buf = accum.AccumBuffer.create(16, 16)
    acc = np.zeros((16, 16, 3), np.float32)
    acc[8, 8] = 30.0                   # one bright outlier ("firefly")
    buf = accum.AccumBuffer(acc=jnp.asarray(acc),
                            count=jnp.ones((16, 16), jnp.float32))
    err = np.asarray(adaptive.error_field(buf))
    assert err[8, 8] == err.max()
    assert err[8, 8] > 0.5


def test_pick_pixels_proportional_allocation():
    acc = np.zeros((16, 16, 3), np.float32)
    acc[4, 4] = 30.0
    buf = accum.AccumBuffer(acc=jnp.asarray(acc),
                            count=jnp.ones((16, 16), jnp.float32))
    px, py, density, _ = adaptive.pick_pixels(buf, 4096, jnp.uint32(7),
                                              bootstrap=False)
    px, py = np.asarray(px), np.asarray(py)
    assert ((px >= 0) & (px < 16)).all() and ((py >= 0) & (py < 16)).all()
    hot = ((px == 4) & (py == 4)).sum()
    # noisy pixel receives ~33x the samples of a clean one (1 + 32*err)
    per_pixel = 4096 / 256
    assert hot > 3 * per_pixel, f"hot pixel got {hot} samples"


def test_pick_pixels_batch_times_area_past_int32():
    """A session half of 256x512 pixels drawing 32k-sample batches:
    batch * area exceeds 2^31 and must not overflow the allocation."""
    W, H = 512, 512
    acc = np.zeros((H, W, 3), np.float32)
    acc[100, 300] = 30.0
    buf = accum.AccumBuffer(acc=jnp.asarray(acc),
                            count=jnp.ones((H, W), jnp.float32))
    px, py, density, pos = adaptive.pick_pixels(
        buf, 32768, jnp.uint32(5), bootstrap=False, x0=256, y0=0,
        width=256, height=512)
    px, py = np.asarray(px), np.asarray(py)
    assert px.shape == (32768,)
    assert ((px >= 256) & (px < 512)).all() and ((py >= 0) & (py < H)).all()
    assert 0 <= int(pos) < 256 * 512


def test_pick_pixels_bootstrap_uniform():
    buf = accum.AccumBuffer.create(8, 8)
    px, py, _, _ = adaptive.pick_pixels(buf, 6400, jnp.uint32(3),
                                        bootstrap=True)
    counts = np.bincount(np.asarray(py) * 8 + np.asarray(px), minlength=64)
    # cyclic sweep: exactly uniform (6400 = 100 * 64)
    assert (counts == 100).all()


def test_pick_pixels_respects_region():
    buf = accum.AccumBuffer.create(16, 8)
    px, py, _, _ = adaptive.pick_pixels(buf, 1024, jnp.uint32(9),
                                        bootstrap=True, x0=8, y0=0,
                                        width=8, height=8)
    px = np.asarray(px)
    assert (px >= 8).all() and (px < 16).all()


def test_pick_pixels_no_starvation():
    """The per-round floor (``sampling_strategy.rs:163-166``: every
    pixel enqueued >= once per refill round): even with the error mass
    concentrated on one pixel, the cyclic floor sweep reaches every
    pixel within about total/batch consecutive batches."""
    acc = np.zeros((16, 16, 3), np.float32)
    acc[4, 4] = 30.0        # all error at one pixel
    buf = accum.AccumBuffer(acc=jnp.asarray(acc),
                            count=jnp.ones((16, 16), jnp.float32))
    batch = 512
    seen = np.zeros(256, bool)
    sweep = None
    # total mass <= 256 + 33 => one round is <= ceil(289*... ) batches;
    # floor share is 256/289 of each batch => ~2 batches sweep all 256
    for k in range(4):
        px, py, _, sweep = adaptive.pick_pixels(
            buf, batch, jnp.uint32(100 + k), bootstrap=False,
            sweep_pos=sweep)
        seen[np.asarray(py) * 16 + np.asarray(px)] = True
    assert seen.all(), f"{(~seen).sum()} pixels starved"


def test_random_pixels_region():
    px, py = adaptive.random_pixels(2048, jnp.uint32(1), 4, 2, 8, 6)
    px, py = np.asarray(px), np.asarray(py)
    assert px.min() >= 4 and px.max() < 12
    assert py.min() >= 2 and py.max() < 8


def test_mix_color_endpoints():
    c = np.asarray(accum.mix_color(jnp.asarray([0.0, 0.5, 1.0])))
    assert np.allclose(c[0], [0, 1, 0], atol=1e-6)   # below avg: green
    assert np.allclose(c[1], [0, 0, 1], atol=1e-6)   # avg: blue
    assert np.allclose(c[2], [1, 0, 0], atol=1e-6)   # above avg: red
