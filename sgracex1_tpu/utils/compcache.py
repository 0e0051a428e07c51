"""Persistent XLA compilation cache for the framework's compiled programs.

The graph-prepare step and the training steps compile device programs that
recur across runs at the same shapes. JAX's persistent compilation cache
makes a process pay each of them once per machine instead of once per run.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no directory at all;
- otherwise: one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``), so every run from the checkout finds it.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
_enabled = False


def enable_persistent_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache; returns the
    directory in use."""
    global _enabled
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if not _enabled:
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        # keep every program that took measurable compile time
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _enabled = True
    return CACHE_DIR
