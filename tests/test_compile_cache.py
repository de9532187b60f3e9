"""The persistent compilation cache helper (utils/compile_cache.py)."""

import os

import jax

from upsp_tpu.utils import compile_cache


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        _restore(prev)


def test_default_is_fixed_repo_dir(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        _restore(prev)


def test_default_dir_is_in_repo_and_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
