"""The persistent compile cache's directory rule (utils/compile_cache.py):
JAX_COMPILATION_CACHE_DIR wins and the program sets no directory;
otherwise the fixed <checkout>/.jax_cache."""

import os

import jax
import pytest

from raytracingengine.utils import compile_cache as cc


@pytest.fixture
def updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_set_means_no_directory_in_code(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.setup_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates


def test_env_var_unset_uses_checkout_jax_cache(updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expect = os.path.join(repo, ".jax_cache")
    assert cc.setup_compile_cache() == expect
    assert updates["jax_compilation_cache_dir"] == expect
