"""Persistent XLA compilation cache for the entry scripts.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, that
directory is the cache and nothing is configured here.  Otherwise the
cache goes to `<checkout>/.jax_cache`, a fixed path (listed in
.gitignore) so that repeat runs from the same checkout hit it.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(checkout: str = CHECKOUT) -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
