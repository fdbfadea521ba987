"""`enable_compilation_cache`: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache lives in one fixed directory inside the checkout."""

import os

import jax
import pytest

from mcos_tpu.utils import checkpoint


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_from_environment(monkeypatch, tmp_path,
                                    restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    monkeypatch.delenv("MCOS_DISABLE_JIT_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert checkpoint.enable_compilation_cache() == str(tmp_path / "x")
    # JAX reads the variable itself; the code sets no other directory.
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch,
                                                    restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("MCOS_DISABLE_JIT_CACHE", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = checkpoint.enable_compilation_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert path == checkpoint.enable_compilation_cache()   # stable
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_cache_can_be_disabled(monkeypatch, restore_cache_config):
    monkeypatch.setenv("MCOS_DISABLE_JIT_CACHE", "1")
    assert checkpoint.enable_compilation_cache() is None
