"""Persistent XLA compilation cache for the entry points.

A single large executable (a study fit sweep, the one-launch planner, a
whole-mission program) takes tens of seconds or more to compile. The
reference has no compilation at all (pure NumPy), so cold-compile latency
is a cost the rebuild introduces — and JAX's persistent compilation cache
removes it for every run after the first: compiled executables are
serialized to disk keyed by the HLO fingerprint, so repeated studies,
benches, served planners, and mission launches skip straight to execution.

Location: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself, and no other directory is set in code); otherwise the fixed
``<checkout>/.jax_cache``. The path is part of what makes a later run
hit, so it does not move with the working directory.

Enabled by the CLI, ``bench.py``, ``chip_smoke.py`` and ``serve.py`` at
startup. Tests do not enable it.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_enabled_dir: str | None = None


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache. Idempotent.

    Returns the cache directory in use."""
    global _enabled_dir
    if _enabled_dir is not None:
        return _enabled_dir
    import jax

    d = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # cache everything that took >=1s to compile (keeps small helper
    # programs out of the cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _enabled_dir = d
    return d
