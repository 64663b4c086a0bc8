"""Process-wide JAX settings shared by the entry points (cli, bench.py,
chip_smoke.py)."""

from __future__ import annotations

import os


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    when it is set, else at ``<checkout>/.jax_cache``; return the path.

    Call before the first compilation. Sets no other cache option. The
    directory is part of the cache key, so it must not move between runs.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
