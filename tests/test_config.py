"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR, when set, is the
only cache directory (JAX reads it itself; the program sets none);
otherwise the cache lives at one fixed path inside the checkout."""
import jax
import pytest

from libflagstats_tpu import config


def test_env_dir_wins_and_program_sets_none(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(config, "_cache_enabled", False)
    config.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("value", [None, ""])
def test_default_dir_is_fixed_inside_the_checkout(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    path = config.compilation_cache_dir()
    assert path == config.DEFAULT_CACHE_DIR
    assert path.name == ".jax_cache"
    assert (path.parent / "libflagstats_tpu" / "config.py").is_file()
    # the same path in every process: nothing per-process in it
    assert config.compilation_cache_dir() == path


def test_enable_sets_the_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(config, "_cache_enabled", False)
    try:
        config.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(
            config.DEFAULT_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
