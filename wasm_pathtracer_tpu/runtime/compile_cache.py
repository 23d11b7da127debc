"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (the CLI, the live viewer, ``bench.py``,
``chip_smoke.py``, ``__graft_entry__.py``) calls :func:`enable` before
its first compilation.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here; otherwise the cache goes to
the fixed path ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
The path is part of what the cache is keyed on, so it never depends on
a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    """``<checkout>/.jax_cache``: beside the package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
