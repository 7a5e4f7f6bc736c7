"""Where the persistent XLA compilation cache lives."""

from __future__ import annotations

import os

# A fixed path inside the checkout: the path is part of the cache's key, so
# a cache that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX itself reads
    it and nothing is set here; otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
