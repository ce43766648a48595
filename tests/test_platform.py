"""Platform rules: the backend ``auto`` resolves to, the compile-cache
location, and the on-card scripts refusing to run without a GPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from gsplat_tpu.utils.platform import resolve_backend, setup_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,want", [("cpu", "tiles"), ("gpu", "pallas"), ("tpu", None)]
)
def test_resolve_backend(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(platform=platform)])
    if want is None:
        with pytest.raises(RuntimeError, match=platform):
            resolve_backend("auto")
    else:
        assert resolve_backend("auto") == want
    # explicit names pass through untouched, whatever the platform
    assert resolve_backend("pallas_interpret") == "pallas_interpret"


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert setup_compile_cache(str(tmp_path)) == str(tmp_path / "env")
            # the variable is JAX's own: nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(str(tmp_path), ".jax_cache")
            assert setup_compile_cache(str(tmp_path)) == want
            assert jax.config.jax_compilation_cache_dir == want
            # a fixed path: asking again gives the same directory
            assert setup_compile_cache(str(tmp_path)) == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_cpu(script):
    """Without a GPU both on-card scripts exit non-zero at once and print
    no result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, script)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "GPU" in r.stderr
