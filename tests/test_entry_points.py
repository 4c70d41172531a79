"""Entry-point rules: the compile-cache location, and the GPU-only scripts
refusing to run (or fall back) without a GPU."""

import os
import sys

import jax
import pytest

from pi_sph_fluid_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_wins(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: nothing is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    """Unset: the fixed, gitignored directory inside the checkout."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.configure_compile_cache() == path  # never moves
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _import_script(name):
    sys.path.insert(0, REPO)
    try:
        return __import__(name)
    finally:
        sys.path.remove(REPO)


def test_chip_smoke_refuses_cpu(capsys):
    smoke = _import_script("chip_smoke")
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu():
    bench = _import_script("bench")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
