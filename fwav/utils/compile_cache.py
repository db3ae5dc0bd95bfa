"""JAX's persistent compilation cache, placed in one spot.

Entry points (the CLI, bench.py, chip_smoke.py) call enable_compile_cache()
before their first compile. Where JAX_COMPILATION_CACHE_DIR is set, JAX
reads it itself and this sets nothing. Otherwise the cache lives at
<checkout>/.jax_cache: a fixed path, because the directory is part of
what a later process must find again (a path from tempfile, a pid or the
clock would never hit).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
#: <checkout>/.jax_cache — the directory above the package.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Must run before the process's first compile:
    JAX fixes the cache location at its first use."""
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
