"""Placement of the persistent XLA compilation cache
(utils.devices.enable_compile_cache): `JAX_COMPILATION_CACHE_DIR` wins and
nothing is set in code; without it the cache lives at one fixed directory
inside the checkout, which git ignores.  A cold compile on the GPU costs
seconds to minutes per executable, so the CLI, bench.py and chip_smoke.py
all keep their cache there.
"""

from __future__ import annotations

import pathlib

import jax
import pytest

from autognothi.utils.devices import CHECKOUT_CACHE_DIR, enable_compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)
    # the initialized cache object may point at a test dir; drop it so
    # later suite compiles go back to the restored dir (lazy re-init)
    from jax.experimental.compilation_cache import compilation_cache

    compilation_cache.reset_cache()


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compile_cache(tmp_path / "default") == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "default").exists()


def test_default_dir_is_fixed_inside_the_checkout():
    assert CHECKOUT_CACHE_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cache_dir_created_and_populated(monkeypatch, tmp_path,
                                         restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    cache = tmp_path / "xla_cache"
    try:
        assert enable_compile_cache(cache) == str(cache)
        assert cache.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(cache)
        from jax.experimental.compilation_cache import compilation_cache

        compilation_cache.reset_cache()
        import jax.numpy as jnp

        # a shape unlikely to collide with any other test's executables
        x = jnp.arange(173.0).reshape(1, 173)

        @jax.jit
        def fn(v):
            return (v * 3.0 + 1.0).sum()

        fn(x).block_until_ready()
        assert list(cache.iterdir()), "compile produced no cache entry"
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_secs)
