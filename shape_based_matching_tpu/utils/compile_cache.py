"""One rule for JAX's persistent compilation cache, shared by every entry
point (the CLI, bench.py, chip_smoke.py and the tests).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing is
set here. Otherwise the cache goes to ``<repo>/.jax_cache`` (listed in
``.gitignore``): a fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the cache uses under this rule."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Apply the rule; returns the cache directory."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
