"""utils/compile_cache: where the persistent compilation cache goes."""
import os

import jax
import pytest

from project3_cuda_path_tracer_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_fixed_repo_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache()
    assert path == os.path.join(cc.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same place on every call: no pid-, time- or temp-derived name
    assert cc.enable_compile_cache() == path


def test_environment_variable_wins(monkeypatch, tmp_path,
                                   restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)
    assert cc.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_is_gitignored():
    with open(os.path.join(cc.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
