"""The persistent compilation cache helper (portrayer_tpu/compile_cache)."""

import os

import jax

from portrayer_tpu import compile_cache


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable(root=str(tmp_path)) == str(tmp_path / "env")
    assert calls == []
    assert jax.config.jax_compilation_cache_dir == old


def test_fixed_path_without_env_var(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable(root=str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    default = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(compile_cache.__file__))), ".jax_cache")
    try:
        assert compile_cache.enable() == default
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
