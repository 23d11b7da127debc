"""Test configuration: run everything on a virtual 8-device CPU mesh.

Per SURVEY §4(d): multi-host behavior is validated with the same
single-controller code on fake CPU devices.

The tests run on the CPU, where the XLA trace is the plain reference
and the Pallas scene kernel runs in interpret mode.  Tests marked
``gpu`` need the card and skip here (their fixture decides at run
time); on a machine with the GPU run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  The platform
is set through ``jax.config`` before any backend initializes, so an
explicit ``JAX_PLATFORMS`` is honored and the CPU is the default.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)


# -- slow-test gating: the FD-heavy gradient/training tests take most
# of the suite's time on a small CPU host.  They stay first-class
# contracts: run them with ``pytest --runslow`` (or RUNSLOW=1) in CI /
# full verification.

def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (FD-heavy, full train steps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: FD-heavy/long test, deselected by default; enable with "
        "--runslow or RUNSLOW=1")
    config.addinivalue_line(
        "markers",
        "gpu: needs the GPU backend; skips elsewhere (run with "
        "JAX_PLATFORMS=cuda)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUNSLOW"):
        return
    skip = pytest.mark.skip(reason="slow (use --runslow / RUNSLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
