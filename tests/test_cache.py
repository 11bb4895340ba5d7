"""Persistent-compilation-cache utility (utils/cache.py).

CPU-hermetic: only config behavior is asserted — nothing compiles long
enough on CPU for entries to be written."""

import importlib
import os

import jax
import pytest


_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs",
         "jax_persistent_cache_min_entry_size_bytes")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_cache_config():
    """Later suite tests must not write cache entries into a deleted
    tmp_path (whole-planner CPU compiles exceed the 1 s threshold) nor
    inherit the lowered compile-time/entry-size thresholds."""
    prev = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in prev.items():
        jax.config.update(k, v)


def _fresh(monkeypatch, tmp_path, env=None):
    """A freshly imported cache module whose default directory lives
    under tmp_path, with JAX_COMPILATION_CACHE_DIR set to ``env``."""
    import mfgp_jax.utils.cache as cache

    importlib.reload(cache)
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "default"))
    if env is None:
        monkeypatch.delenv(cache.ENV, raising=False)
    else:
        monkeypatch.setenv(cache.ENV, env)
    return cache


def test_enable_sets_config_and_is_idempotent(monkeypatch, tmp_path):
    cache = _fresh(monkeypatch, tmp_path)
    d = str(tmp_path / "default")
    assert cache.enable_compilation_cache() == d
    assert jax.config.jax_compilation_cache_dir == d
    assert os.path.isdir(d)
    # a second call keeps the first directory even if the env changes
    monkeypatch.setenv(cache.ENV, str(tmp_path / "other"))
    assert cache.enable_compilation_cache() == d


def test_env_opt_out(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the code sets no directory of
    its own: JAX's own reading of the variable stands."""
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    cache = _fresh(monkeypatch, tmp_path, env=str(tmp_path / "envdir"))
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"
    assert not os.path.exists(str(tmp_path / "default"))


def test_env_overrides_location(monkeypatch, tmp_path):
    d = str(tmp_path / "envdir")
    cache = _fresh(monkeypatch, tmp_path, env=d)
    assert cache.enable_compilation_cache() == d


@pytest.mark.parametrize("env, expect", [
    (None, "default"),
    ("", "default"),
    ("envdir", "envdir"),
])
def test_cache_location_rules(monkeypatch, tmp_path, env, expect):
    """The env variable wins when set and non-empty; otherwise the one
    fixed default directory."""
    cache = _fresh(monkeypatch, tmp_path,
                   env=None if env is None else
                   (str(tmp_path / env) if env else ""))
    assert cache.cache_dir() == str(tmp_path / expect)


def test_default_cache_dir_is_fixed_inside_checkout(monkeypatch, tmp_path):
    """The default is <checkout>/.jax_cache whatever the working
    directory (a moving cache path never hits)."""
    import mfgp_jax.utils.cache as cache

    importlib.reload(cache)
    assert cache.DEFAULT_DIR == os.path.join(REPO_ROOT, ".jax_cache")
    monkeypatch.chdir(tmp_path)
    importlib.reload(cache)
    assert cache.DEFAULT_DIR == os.path.join(REPO_ROOT, ".jax_cache")
