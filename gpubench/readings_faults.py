"""``readings.py`` for the entry kinds that ``faults.planted`` does not name,
with the same arguments: the tangent per-texel entry plants its faults
through ``faults._texel_fault`` (the per-texel fit's seam), the joint entry
with gains through ``faults._joint_fault`` (each joint solve's).

    python3 gpubench/readings_faults.py --workload <cell> --seeds 1,2,3 [...]
"""

import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gpubench import faults, readings  # noqa: E402

SEAMS = {"fit_per_texel_tangent": faults._texel_fault,
         "fit_joint_normalmap_gains": faults._joint_fault}
_planted = faults.planted


@contextlib.contextmanager
def planted(entry: str, fault: str):
    if entry not in SEAMS:
        with _planted(entry, fault):
            yield
        return
    if fault not in faults.FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    with SEAMS[entry](fault):
        yield


if __name__ == "__main__":
    faults.planted = planted
    sys.exit(readings.main())
