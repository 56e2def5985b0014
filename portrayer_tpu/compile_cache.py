"""Where JAX keeps its persistent compilation cache for this program.

The depth-10 trace and its fit step take tens of seconds or more to
compile, so the entry points that measure (chip_smoke.py, bench.py) call
``enable()`` before their first compile.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable(root: str = _REPO) -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``<root>/.jax_cache``
    (listed in .gitignore): a fixed path, because the path is part of the
    cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
