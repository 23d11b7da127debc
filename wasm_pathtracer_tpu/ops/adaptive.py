"""Variance-guided adaptive sample allocation, fully jittable.

The reference's ``AdaptiveSamplingStrategy`` is a host-side work queue:
when empty it runs an O(W*H*25) error pass, pushes ``ceil(1+32*err)``
copies of every pixel, shuffles, and pops one pixel per ray
(``src/graphics/sampling_strategy.rs:120-219``).  Queues don't jit; the
batched allocator computes the same per-pixel error field with two
fused convolutions (``ops.filters``) and draws a *fixed-size batch* of
pixels proportional to the target spp via stratified inverse-CDF
sampling — the same allocation in expectation, with static shapes.

The error metric is the reference's:
``max(|mean - gauss3(mean)|^2, |mean - gauss5(mean)|^2)``
(``sampling_strategy.rs:140-144``), normalized piecewise around the
mean error (below-mean -> [0, 0.5], above -> [0.5, 1],
``sampling_strategy.rs:154-162``).
"""

from __future__ import annotations

import jax.numpy as jnp

from wasm_pathtracer_tpu.ops import accum, filters
from wasm_pathtracer_tpu.utils import rng as rnglib

_SLOT_PIXEL = 0x7FFE0000


def error_field(buf: accum.AccumBuffer):
    """Per-pixel scaled error in [0,1] (``sampling_strategy.rs:133-162``)."""
    img = accum.clamped_image(buf)
    g3 = filters.gaussian3(img)
    g5 = filters.gaussian5(img)
    d3 = jnp.sum((img - g3) ** 2, axis=-1)
    d5 = jnp.sum((img - g5) ** 2, axis=-1)
    mse = jnp.maximum(d3, d5)

    mse_avg = jnp.mean(mse)
    mse_min = jnp.min(mse)
    mse_max = jnp.max(mse)
    lo = 0.5 * (mse - mse_min) / jnp.maximum(mse_avg - mse_min, 1e-12)
    hi = 0.5 + 0.5 * (mse - mse_avg) / jnp.maximum(mse_max - mse_avg, 1e-12)
    scaled = jnp.where(mse < mse_avg, lo, hi)
    degenerate = mse_min == mse_max
    return jnp.where(degenerate, 0.0, jnp.clip(scaled, 0.0, 1.0))


def target_spp(buf: accum.AccumBuffer, spp_scale: float = 32.0):
    """Relative samples-per-pixel weights (``sampling_strategy.rs:163``)."""
    return jnp.ceil(1.0 + error_field(buf) * spp_scale)


def pick_pixels(buf: accum.AccumBuffer, batch: int, seed,
                bootstrap: bool, spp_scale: float = 32.0,
                x0: int = 0, y0: int = 0,
                width: int | None = None, height: int | None = None,
                sweep_pos=None):
    """Draw a batch of pixel coordinates for the region
    ``[x0, x0+width) x [y0, y0+height)``.

    ``bootstrap`` reproduces the uniform first round
    (``sampling_strategy.rs:194-205``) as an exact cyclic sweep.

    The reference enqueues ``ceil(1 + 32*err)`` copies of EVERY pixel
    per refill round (``sampling_strategy.rs:163-166``), so each round
    gives each pixel at least one sample.  The fixed-batch analog
    splits each batch: the uniform "+1" share (``hw / total`` of the
    mass) runs a seamless cyclic sweep from ``sweep_pos`` — a hard
    no-starvation floor — and the error-proportional excess ``w - 1``
    fills the rest by stratified inverse-CDF.  The same allocation in
    expectation, with static shapes.

    Returns (px, py, density, new_sweep_pos) where ``density`` is the
    (H, W) scaled error for the sampling-density debug view and
    ``new_sweep_pos`` must be threaded into the next call (a device
    scalar: no host sync).
    """
    H, W = buf.acc.shape[:2]
    width = W - x0 if width is None else width
    height = H - y0 if height is None else height
    hw = width * height
    if sweep_pos is None:
        sweep_pos = jnp.int32(0)
    i = jnp.arange(batch, dtype=jnp.int32)
    sweep_idx = (sweep_pos + i) % hw

    region = slice(y0, y0 + height), slice(x0, x0 + width)
    if bootstrap:
        density = jnp.zeros((height, width), jnp.float32)
        idx = sweep_idx
        new_pos = (sweep_pos + batch) % hw
    else:
        sub = accum.AccumBuffer(acc=buf.acc[region], count=buf.count[region])
        density = error_field(sub)
        w = jnp.ceil(1.0 + density * spp_scale)
        flat = w.ravel()
        total = jnp.maximum(jnp.sum(flat), 1.0)
        # batch * hw passes 2^31 at real sizes (32k x 256x512): take
        # the product as a float, never as an int32 operand
        n_floor = jnp.clip(
            jnp.round(float(batch * hw) / total).astype(jnp.int32), 1, batch)

        excess = flat - 1.0
        cdf = jnp.cumsum(excess)
        etotal = cdf[-1]
        n_excess = jnp.maximum(batch - n_floor, 1).astype(jnp.float32)
        u = rnglib.uniform3(seed, i.astype(jnp.uint32), _SLOT_PIXEL)[0]
        # stratified inverse-CDF over the excess mass: excess slot j
        # targets mass ((j + u_j) / n_excess) * etotal
        j = (i - n_floor).astype(jnp.float32)
        targets = (j + u) / n_excess * jnp.maximum(etotal, 1e-12)
        cdf_idx = jnp.minimum(jnp.searchsorted(cdf, targets, side="right"),
                              hw - 1)
        # degenerate error field (no excess mass): keep sweeping
        use_sweep = (i < n_floor) | (etotal <= 0.0)
        idx = jnp.where(use_sweep, sweep_idx, cdf_idx)
        new_pos = (sweep_pos + n_floor) % hw

    py = (idx // width).astype(jnp.int32) + y0
    px = (idx % width).astype(jnp.int32) + x0
    return px, py, density, new_pos


def random_pixels(batch: int, seed, x0: int, y0: int, width: int, height: int):
    """Uniform pixel selection (``RandomSamplingStrategy::next``,
    ``sampling_strategy.rs:54-71``)."""
    i = jnp.arange(batch, dtype=jnp.uint32)
    u1, u2, _ = rnglib.uniform3(seed, i, _SLOT_PIXEL)
    px = x0 + jnp.minimum((u1 * width).astype(jnp.int32), width - 1)
    py = y0 + jnp.minimum((u2 * height).astype(jnp.int32), height - 1)
    return px, py
