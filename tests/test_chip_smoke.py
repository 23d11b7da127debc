"""CPU tests of what ``chip_smoke.py`` and the compile-cache helper
decide without a card: the device check refuses the CPU, the script
fails outside a checkout, ``--four-cards`` selects only its phase, and
the cache lands where the helper says."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from wasm_pathtracer_tpu.runtime import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_refuses_without_gpu(tmp_path, where):
    """No accelerator (or no repo beside the script): non-zero exit and
    no result line."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_cards_runs_no_other_phase():
    assert chip_smoke.select_phases(["--four-cards"]) == ("device",
                                                          "four_cards")
    assert "four_cards" not in chip_smoke.select_phases([])
    assert set(chip_smoke.select_phases([])) == {
        "device", "parity", "museum", "cloud", "grads"}
    with pytest.raises(SystemExit):
        chip_smoke.select_phases(["--bogus"])


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable() == path       # same on every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
