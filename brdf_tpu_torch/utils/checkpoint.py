"""Checkpoint / resume for fitting runs.

The port's own copy of ``brdf_tpu/utils/checkpoint.py`` (which imports JAX
only for its process index and count; here they are the ``torch.distributed``
rank and world size): fitted parameter maps and solver state are saved as
compressed ``.npz`` shards, one a process, plus a JSON manifest, so a long
fit can resume mid-run (p, μ, ν, stop codes, counters).

Format: ``<dir>/step_<n>/shard_<p>.npz`` + ``<dir>/step_<n>/manifest.json``,
the JAX package's, so a checkpoint written by either package is read by the
other. A single process writes one shard; over several ranks each writes its
own and rank 0 writes the manifest once all are in. Loading concatenates the
shards on axis 0 in process order.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch.distributed as dist

from brdf_tpu_torch.parallel.mesh import process_count, process_index


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save_fit_state(
    path: str,
    step: int,
    arrays: dict[str, np.ndarray],
    metadata: dict | None = None,
    shard_timeout: float = 120.0,
    process: tuple[int, int] | None = None,
) -> str:
    """Save named arrays + metadata for ``step``. Returns the step directory.

    Multi-process protocol (one writer a rank, on a shared filesystem): every
    process atomically publishes its own ``shard_<p>.npz`` into the step
    directory; process 0 then waits up to ``shard_timeout`` seconds for all
    shards to appear and publishes ``manifest.json`` **last**. The manifest
    is the commit record, so readers (and :func:`latest_step`) never observe
    a half-written step. ``process`` is ``(index, count)``, this process's
    rank and the number of writers; by default the ``torch.distributed``
    rank and world size (0 and 1 without a process group), and then every
    rank returns only once the step is committed (a barrier), so that all
    of them see the same newest step when a fit resumes. A rank that writes
    alone what every rank holds passes ``(0, 1)``.
    """
    proc, expected = (process_index(), process_count()) if process is None else process
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".shard_{proc:04d}.tmp.npz")
    np.savez_compressed(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, os.path.join(d, f"shard_{proc:04d}.npz"))
    if proc == 0:
        _commit(d, step, arrays, metadata, expected, shard_timeout)
    if process is None and expected > 1:
        dist.barrier()
    return d


def _commit(d: str, step: int, arrays: dict, metadata: dict | None, expected: int,
            shard_timeout: float) -> None:
    """Process 0's part: wait for ``expected`` shards, then write the
    manifest."""
    deadline = time.monotonic() + shard_timeout
    while True:
        present = [n for n in os.listdir(d) if n.startswith("shard_") and n.endswith(".npz")]
        if len(present) >= expected:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"step {step}: only {len(present)}/{expected} shards appeared within "
                f"{shard_timeout}s"
            )
        time.sleep(0.05)
    manifest = {
        "step": step,
        "num_shards": expected,
        "keys": sorted(arrays.keys()),
        "metadata": metadata or {},
    }
    mtmp = os.path.join(d, ".manifest.tmp")
    with open(mtmp, "w") as fh:
        json.dump(manifest, fh, indent=2)
    os.replace(mtmp, os.path.join(d, "manifest.json"))


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
        """Save this process's shard of ``step`` every ``every`` steps; rank 0
        alone prunes the steps past the newest ``keep``."""
        if step % self.every:
            return None
        out = save_fit_state(self.path, step, arrays, metadata)
        if process_index() == 0:
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
