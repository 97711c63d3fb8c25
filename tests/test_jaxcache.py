"""Compile-cache placement: the environment wins, else <checkout>/.jax_cache."""
import os

import jax
import pytest

from longreadselfcorrect_tpu import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "unchanged")
        if env_set:
            monkeypatch.setenv(jaxcache.ENV, str(tmp_path))
            assert jaxcache.configure_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "unchanged"
        else:
            monkeypatch.delenv(jaxcache.ENV, raising=False)
            path = jaxcache.configure_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
