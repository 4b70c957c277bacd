"""Persistent XLA compilation cache.

A cold compile of the 1080p frame step takes tens of seconds; the JAX
persistent compilation cache turns every repeat compile of an unchanged
program (reruns of ``bench.py`` or ``chip_smoke.py``, CLI renders) into a
disk read. The reference has no analog (Unity caches compiled compute
shaders in its Library folder — the same latency problem, solved the same
way).

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: that directory, exactly as given (JAX
  reads the variable itself; nothing here overrides it).
* unset: ``<checkout>/.cache/jax``, a fixed path (listed in ``.gitignore``),
  so a second run of the same checkout finds what the first one compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".cache", "jax")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Safe to call more than once. Programs that compile in under a second
    are not cached.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
