"""What every cell shares: the manifest and the files found by name in it,
the closed loop and its statistics, and the guard against JAX.

Everything that belongs to one configuration, cell, entry kind or per-layer
metric sits in a file of its own under ``gpubench/``: ``configs/<config>.json``,
``workloads/<cell>.json`` (the traffic: entry kind and its parameters),
``entries/<entry>.py`` and ``metrics/<metric>.py``, found by the names that
``BENCHMARK.json`` gives.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "brdf_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with the files it names."""

    name: str
    entry: dict            # the manifest's workload entry
    config: dict           # configs/<config>.json
    traffic: dict          # workloads/<cell>.json
    end_to_end: list       # the manifest's end-to-end metrics this cell reports
    per_layer: list        # the manifest's per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, here: Path = HERE) -> Cell:
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(here / "configs" / f"{entry['config']}.json")
    traffic = read_json(here / "workloads" / f"{name}.json")
    if traffic.get("traffic") != entry["traffic"]:
        raise SystemExit(f"workloads/{name}.json is traffic {traffic.get('traffic')!r}, "
                         f"BENCHMARK.json says {entry['traffic']!r}")
    return Cell(name, entry, config, traffic,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def load_by_path(path: Path, tag: str):
    """Import a file of ``gpubench/`` whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(f"gpubench_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(cell: Cell, here: Path = HERE):
    return load_by_path(here / "entries" / f"{cell.traffic['entry']}.py",
                        "entry_" + cell.traffic["entry"])


@functools.lru_cache(maxsize=None)
def metric_module(name: str, here: Path = HERE):
    return load_by_path(here / "metrics" / f"{name}.py", "metric_" + re.sub(r"\W", "_", name))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: ``brdf_tpu_torch`` is not ``brdf_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


# -- the closed loop ---------------------------------------------------------

@dataclasses.dataclass
class Window:
    seconds: float               # from the first request's issue to the last one's end
    times: list                  # seconds of every request, in order
    units: float                 # work completed (texels, images)
    samples: list                # the requests kept for the check, drawn from the seed


def closed_loop(request, seconds: float, keep: int, rng: np.random.Generator) -> Window:
    """One caller: each request is issued when the last one has returned,
    until ``seconds`` have passed. ``request(i)`` returns (units, record);
    ``keep`` records are kept by reservoir sampling from ``rng``."""
    times, samples, units = [], [], 0.0
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        done, record = request(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        units += done
        i += 1
        if len(samples) < keep:
            samples.append(record)
        else:
            j = int(rng.integers(0, i))
            if j < keep:
                samples[j] = record
        if t1 - t_start >= seconds:
            return Window(t1 - t_start, times, units, samples)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of all
    values at or below it."""
    srt = sorted(values)
    return float(srt[max(math.ceil(q / 100.0 * len(srt)) - 1, 0)])
