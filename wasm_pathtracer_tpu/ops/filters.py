"""Edge-renormalized Gaussian filters.

The reference applies 3x3 / 5x5 Gaussian kernels per pixel with the
kernel weights renormalized at image edges
(``src/render_target.rs:88-138``).  Here the same filter is one depthwise
convolution over the whole image plus a weight-sum convolution of a ones
image for the renormalization — two fused conv ops instead of W*H*25
scalar reads (the reference's adaptive-sampler refill is O(W*H*25) on
the CPU, SURVEY §3.2 hot loop 4).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

GAUSS3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
GAUSS5 = np.array(
    [[1, 4, 6, 4, 1],
     [4, 16, 24, 16, 4],
     [6, 24, 36, 24, 6],
     [4, 16, 24, 16, 4],
     [1, 4, 6, 4, 1]], np.float32)


def _conv2d_same(img, kernel):
    """(H, W, C) x (k, k) -> (H, W, C), zero-padded SAME conv."""
    k = jnp.asarray(kernel)[::-1, ::-1]  # correlation == conv for symmetric k
    x = jnp.moveaxis(img, -1, 0)[None]                 # (1, C, H, W)
    w = jnp.broadcast_to(k, (x.shape[1], 1, *k.shape))  # depthwise
    y = lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        feature_group_count=x.shape[1],
        precision=lax.Precision.HIGHEST)  # full f32, not TF32
    return jnp.moveaxis(y[0], 0, -1)


def gaussian_renorm(img, kernel):
    """Edge-renormalized Gaussian blur of an (H, W, 3) image.

    Matches ``RenderTarget::gaussian3/gaussian5``: out-of-bounds taps
    contribute neither value nor weight (``render_target.rs:130-138``).
    """
    num = _conv2d_same(img, kernel)
    ones = jnp.ones((*img.shape[:2], 1), img.dtype)
    den = _conv2d_same(ones, kernel)
    return num / den


def gaussian3(img):
    return gaussian_renorm(img, GAUSS3)


def gaussian5(img):
    return gaussian_renorm(img, GAUSS5)
