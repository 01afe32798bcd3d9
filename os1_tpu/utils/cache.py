"""Persistent XLA compilation cache.

The SLAM pipeline is ~15 large fused device programs whose first compile
takes far longer than a run of any of them. The reference system has the
same shape of problem at a smaller scale — its binary vocabulary format
exists purely because the text parse was ~100x slower than the load
(reference README.md:24) — and the persistent XLA cache is the analogous fix
here: compile once, re-load in every later process.

Enabled automatically on package import (see os1_tpu/__init__.py). The
directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
itself), and otherwise one fixed directory inside the checkout. A fixed path
matters: the path is part of what a later process must find again.
"""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Must run before the first compilation; safe to call repeatedly.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything that took >=1 s to build: the tiny entries are not
    # worth the disk I/O, every real pipeline program is far above this.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
