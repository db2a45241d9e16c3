"""Persistent compile cache placement: JAX_COMPILATION_CACHE_DIR when set
(left to JAX), else one fixed directory inside the checkout."""

import os
import tempfile

import jax
import pytest

import pwn_vocoder
from pwn_vocoder.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(pwn_vocoder.__file__)))


@pytest.fixture
def clean_config():
    prior = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prior)


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_rule(monkeypatch, tmp_path, clean_config, env):
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; nothing is set in code
        assert jax.config.jax_compilation_cache_dir is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_path_is_fixed(monkeypatch, clean_config):
    """No temp directory, pid or time in the path: a later process must
    find what an earlier one compiled."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert not path.startswith(tempfile.gettempdir() + os.sep)
    assert str(os.getpid()) not in path
    assert path == compile_cache.DEFAULT_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
