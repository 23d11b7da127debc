"""Random numbers.

The reference threads one mutable xorshift32 stream through everything
(``src/rng.rs``, seed 0xBABABEBE), shared via ``Rc<RefCell<..>>`` — a
design that cannot vectorize and whose output depends on global call
order.  The batched replacement is a *counter-based* hash RNG: every
draw is a pure function of ``(seed, ray_id, sample_id, slot)``, so it is
reproducible, order-independent, shardable across a device mesh with no
communication, and identical between the JAX kernels and the NumPy
reference tracer used by the tests.

The hash is pcg3d (Jarzynski & Olano, "Hash Functions for GPU
Rendering", JCGT 2020) — 3 x 32-bit in, 3 x 32-bit out, excellent
statistical quality and only ~20 integer ops.

``Xorshift32`` reimplements the reference generator *for host-side scene
construction only*: the museum scene's light colors are shuffled with it
(``src/scenes.rs:30-39``), so scene parity requires the same stream.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_INV_2_24 = np.float32(1.0 / (1 << 24))


def _pcg3d(x, y, z, xp):
    """pcg3d hash: three uint32 arrays -> three uint32 arrays."""
    m = xp.uint32(1664525)
    a = xp.uint32(1013904223)
    x = x * m + a
    y = y * m + a
    z = z * m + a
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> xp.uint32(16))
    y = y ^ (y >> xp.uint32(16))
    z = z ^ (z >> xp.uint32(16))
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def _to_unit(u, xp):
    """uint32 -> f32 in [0, 1): use the top 24 bits so the float is exact."""
    return (u >> xp.uint32(8)).astype(xp.float32) * _INV_2_24


def uniform3(seed, ray_id, slot, xp=jnp):
    """Three independent U[0,1) floats per (seed, ray_id, slot).

    ``seed`` folds together the session seed and the sample index;
    ``ray_id`` is the pixel / path id; ``slot`` names the consumption
    site (one slot per bounce x purpose), so streams never collide.
    All args broadcast; pass ``xp=np`` for the NumPy twin.
    """
    seed = xp.asarray(seed, dtype=xp.uint32)
    ray_id = xp.asarray(ray_id, dtype=xp.uint32)
    slot = xp.asarray(slot, dtype=xp.uint32)
    x, y, z = _pcg3d(ray_id, slot, seed, xp)
    return _to_unit(x, xp), _to_unit(y, xp), _to_unit(z, xp)


def uniform1(seed, ray_id, slot, xp=jnp):
    return uniform3(seed, ray_id, slot, xp)[0]


def uniform2(seed, ray_id, slot, xp=jnp):
    u = uniform3(seed, ray_id, slot, xp)
    return u[0], u[1]


class Xorshift32:
    """The reference's RNG (``src/rng.rs:9-47``), host-side only.

    Used to reproduce scene-construction randomness (museum color
    shuffle, ``src/scenes.rs:30-39``); never used on-device.
    """

    def __init__(self, state: int = 0xBABABEBE):
        self.state = np.uint32(state)

    def next_u32(self) -> int:
        x = self.state
        with np.errstate(over="ignore"):
            x ^= np.uint32((int(x) << 13) & 0xFFFFFFFF)
            x ^= x >> np.uint32(17)
            x ^= np.uint32((int(x) << 5) & 0xFFFFFFFF)
        self.state = x
        return int(x)

    def next(self) -> float:
        # f32 in [0,1]; the reference divides by 0xFFFFFFFF (:19-21).
        return float(np.float32(self.next_u32()) * np.float32(1.0 / 0xFFFFFFFF))

    def next_in_range(self, low: int, high: int) -> int:
        # ``src/rng.rs:25-38``
        if high <= low:
            raise ValueError("Invalid range")
        if high == low + 1:
            return 0
        f = self.next()
        if f == 1.0:
            return high - 1
        return int(np.floor(np.float32(f) * np.float32(high - low))) + low

    def shuffle(self, xs: list) -> None:
        # ``src/rng.rs:70-75`` — swap each index with a random index.
        for i in range(len(xs)):
            j = self.next_in_range(0, len(xs))
            xs[i], xs[j] = xs[j], xs[i]
