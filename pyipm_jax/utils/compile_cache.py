"""Where JAX's persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins whenever it is set: JAX reads it itself
and nothing here overrides it.  Otherwise the cache sits at a fixed path
under the caller's directory (``<root>/.jax_cache``), so a later run of
the same program finds what an earlier one compiled: the path is part of
what the cache is looked up by, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(root: str) -> str:
    """The cache directory a program rooted at ``root`` uses."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root),
                                               ".jax_cache")


def enable(root: str) -> str:
    """Point JAX at :func:`cache_dir` and return the directory in use."""
    path = cache_dir(root)
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
