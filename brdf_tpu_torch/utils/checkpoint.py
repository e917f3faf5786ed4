"""Checkpoint / resume for fitting runs.

The port's own copy of ``brdf_tpu/utils/checkpoint.py`` (which imports JAX
only for its process index): fitted parameter maps and solver state are
saved as a compressed ``.npz`` shard plus a JSON manifest, so a long fit can
resume mid-run (p, μ, ν, stop codes, counters).

Format: ``<dir>/step_<n>/shard_<p>.npz`` + ``<dir>/step_<n>/manifest.json``,
the JAX package's, so a checkpoint written by either package is read by the
other. The port runs in one process and writes one shard, ``shard_0000``;
loading concatenates however many shards the manifest records.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

_PROCESS = 0       # the port is single-process: one writer, one shard


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save_fit_state(
    path: str,
    step: int,
    arrays: dict[str, np.ndarray],
    metadata: dict | None = None,
) -> str:
    """Save named arrays + metadata for ``step``. Returns the step directory.

    The shard is published atomically and the manifest is written last: it
    is the commit record, so readers (and :func:`latest_step`) never observe
    a half-written step.
    """
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".shard_{_PROCESS:04d}.tmp.npz")
    np.savez_compressed(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, os.path.join(d, f"shard_{_PROCESS:04d}.npz"))
    manifest = {
        "step": step,
        "num_shards": 1,
        "keys": sorted(arrays.keys()),
        "metadata": metadata or {},
    }
    mtmp = os.path.join(d, ".manifest.tmp")
    with open(mtmp, "w") as fh:
        json.dump(manifest, fh, indent=2)
    os.replace(mtmp, os.path.join(d, "manifest.json"))
    return d


def latest_step(path: str) -> int | None:
    """Newest *committed* step (one whose manifest — written last — exists)."""
    if not os.path.isdir(path):
        return None
    steps = [
        int(n.split("_")[1])
        for n in os.listdir(path)
        if n.startswith("step_")
        and not n.endswith(".tmp")
        and os.path.exists(os.path.join(path, n, "manifest.json"))
    ]
    return max(steps) if steps else None


def load_fit_state(path: str, step: int | None = None) -> tuple[dict, dict]:
    """Load ``(arrays, metadata)`` for a step (default: latest). Shards are
    concatenated on axis 0 in process order."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
    d = _step_dir(path, step)
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    shards = sorted(
        os.path.join(d, n)
        for n in os.listdir(d)
        if n.startswith("shard_") and n.endswith(".npz")
    )
    if len(shards) != manifest["num_shards"]:
        raise FileNotFoundError(
            f"step {step}: {len(shards)} shard files but manifest records "
            f"{manifest['num_shards']}"
        )
    loaded = [np.load(s) for s in shards]
    arrays = {}
    for key in manifest["keys"]:
        parts = [l[key] for l in loaded]
        arrays[key] = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
    return arrays, manifest["metadata"]


class FitCheckpointer:
    """Periodic checkpointing with latest-k retention."""

    def __init__(self, path: str, every: int = 1, keep: int = 3):
        self.path = path
        self.every = max(every, 1)
        self.keep = max(keep, 1)

    def maybe_save(self, step: int, arrays: dict, metadata: dict | None = None):
        if step % self.every:
            return None
        out = save_fit_state(self.path, step, arrays, metadata)
        self._prune()
        return out

    def restore(self, step: int | None = None):
        return load_fit_state(self.path, step)

    def _prune(self):
        if not os.path.isdir(self.path):
            return
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.path)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.path, s), ignore_errors=True)
