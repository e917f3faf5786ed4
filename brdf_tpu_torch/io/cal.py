# Copied from brdf_tpu/io/cal.py (host numpy; the port imports nothing of brdf_tpu).
"""Tsai camera-calibration (.cal) parsing.

Replaces ``CBRDFdata::LoadCameraParameters`` / ``WriteValue``
(``brdfdata.cpp:149-247``). Unlike the reference — whose
``WriteValue`` has no ``kappa1`` branch and silently drops the radial
distortion coefficient — this parser keeps every tag, including ``kappa1``.

File format (see ``img/cup/cup.cal``): XML-ish single tags

    <camera_model>CameraTsai</camera_model>
    <cx>..</cx> <cy>..</cy> <f>..</f> <sx>..</sx> <kappa1>..</kappa1>
    <nx>..</nx><ny>..</ny><nz>..</nz>   # camera n axis (world coords)
    <ox>..</ox><oy>..</oy><oz>..</oz>   # camera o axis
    <ax>..</ax><ay>..</ay><az>..</az>   # camera a axis (optical axis)
    <px>..</px><py>..</py><pz>..</pz>   # camera position (world coords)

``n``, ``o``, ``a`` are unit and mutually orthogonal (documented at
``brdfdata.h:63-69``); they are the rows of the world→camera rotation.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_TAG_RE = re.compile(r"<([A-Za-z_][A-Za-z0-9_]*)>\s*([^<]*?)\s*</\1>|<([A-Za-z_][A-Za-z0-9_]*)>\s*([^<\s][^<]*)")


@dataclasses.dataclass(frozen=True)
class TsaiCalibration:
    """Raw Tsai calibration values, as read from a ``.cal`` file."""

    cx: float
    cy: float
    f: float
    sx: float
    kappa1: float
    n: np.ndarray  # (3,) camera x-axis in world coords
    o: np.ndarray  # (3,) camera y-axis in world coords
    a: np.ndarray  # (3,) camera optical axis in world coords
    p: np.ndarray  # (3,) camera position in world coords
    camera_model: str = "CameraTsai"

    @property
    def rotation(self) -> np.ndarray:
        """World→camera rotation matrix; rows are (n, o, a)."""
        return np.stack([self.n, self.o, self.a], axis=0)


def parse_cal_text(text: str) -> dict[str, str]:
    """Scan ``<tag>value`` pairs. Tolerates both ``<t>v</t>`` and ``<t>v<``
    styles (the reference scanner only looked for the opening tag and the next
    ``<``, ``brdfdata.cpp:160-186``)."""
    values: dict[str, str] = {}
    for m in _TAG_RE.finditer(text):
        if m.group(1) is not None:
            values[m.group(1)] = m.group(2).strip()
        else:
            values[m.group(3)] = m.group(4).strip()
    return values


def load_cal(path: str) -> TsaiCalibration:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        values = parse_cal_text(fh.read())

    def fget(key: str, default: float | None = None) -> float:
        if key not in values:
            if default is not None:
                return default
            raise KeyError(f"missing <{key}> in {path!r}")
        return float(values[key])

    def vget(prefix: str) -> np.ndarray:
        return np.array(
            [fget(prefix + "x"), fget(prefix + "y"), fget(prefix + "z")],
            dtype=np.float64,
        )

    return TsaiCalibration(
        cx=fget("cx"),
        cy=fget("cy"),
        f=fget("f"),
        sx=fget("sx", 1.0),
        kappa1=fget("kappa1", 0.0),
        n=vget("n"),
        o=vget("o"),
        a=vget("a"),
        p=vget("p"),
        camera_model=values.get("camera_model", "CameraTsai"),
    )
