"""Where JAX keeps its persistent compile cache.

The CLI, bench.py and chip_smoke.py call `enable()` before compiling, so
a second run of the same program reuses the first one's executables.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable():
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it
    itself), else `<repo>/.jax_cache`, created here because JAX does not
    create it. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        DEFAULT_DIR.mkdir(exist_ok=True)
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
