"""Carry state between the JAX package and the port.

The system has no network weights. Its state is the problem arrays
(``TexelProblem`` and its ``ShadingAngles``/``ShadingGeometry``, with all ten
angle channels when the tangent-frame ones are filled), parameter starts
``p0``, the warm ``(μ, ν, stop)`` resume state, fit results
(``LMResult``/``PallasFitResult``/``VarProResult``/``JointVarProResult``; a
joint normal-map fit is an ``LMResult`` with nine or eleven parameter
columns), the joint layout ``JointSpec`` (a name, two counts and the box:
no arrays, rebuilt field by field) and the box (plain float tuples, which
need no conversion).

:func:`from_numpy` takes any of these as numpy arrays — or as an object of
the JAX package's type with the same name, whose leaves ``np.asarray``
reads — and returns the port's type with tensors on ``device``.
:func:`to_numpy` returns the same port type with numpy leaves; the JAX
types take those as ``JaxType(**x._asdict())``. dtypes are kept as they
are. ``TexelProblem``'s host metadata (``face_ids``, ``pixels``, ``points``,
``normals``) stays numpy in both packages.

The host types ``Scene``, ``TriangleMesh``, ``Camera``, ``RasterMap`` and
``Texelization`` have numpy leaves in both packages. Both functions take one
of either package and return the port's type, built field by field with
numpy leaves (a camera that a scene repeats stays one object, since
``Scene.raster_map`` caches per camera object), so a test feeds both
packages one scene.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.geometry.camera import Camera
from brdf_tpu_torch.geometry.mesh import TriangleMesh
from brdf_tpu_torch.geometry.rasterize import RasterMap
from brdf_tpu_torch.geometry.texel import Texelization
from brdf_tpu_torch.models.brdf import ShadingAngles, ShadingGeometry
from brdf_tpu_torch.models.normalmap import JointSpec
from brdf_tpu_torch.ops.lm import PallasFitResult
from brdf_tpu_torch.pipeline.fit import TexelProblem
from brdf_tpu_torch.pipeline.scene import Scene
from brdf_tpu_torch.solver.lm import LMResult
from brdf_tpu_torch.solver.varpro import VarProResult
from brdf_tpu_torch.solver.varpro_joint import JointVarProResult

_TYPES = {cls.__name__: cls for cls in
          (ShadingAngles, ShadingGeometry, TexelProblem, LMResult, PallasFitResult, VarProResult,
           JointVarProResult)}
_HOST_FIELDS = {"face_ids", "pixels", "points", "normals"}
_HOST_TYPES = {cls.__name__: cls for cls in (TriangleMesh, Camera, RasterMap, Texelization)}


def _host(obj):
    """A host type of either package → the port's, with numpy leaves."""
    name = type(obj).__name__
    if name == "Scene":
        seen: dict = {}
        cams = [seen.setdefault(id(c), _host(c)) for c in obj.cameras]
        return Scene(mesh=_host(obj.mesh), cameras=cams, lights=np.asarray(obj.lights),
                     images=np.asarray(obj.images), name=obj.name)
    cls = _HOST_TYPES[name]
    return cls(**{k: v if isinstance(v, int) else np.asarray(v)
                  for k, v in obj._asdict().items() if k in cls._fields})


def from_numpy(obj, device="cpu"):
    """numpy (or JAX-package) state → the port's types on ``device``."""
    if obj is None:
        return None
    name = type(obj).__name__
    if name == "Scene" or name in _HOST_TYPES:
        return _host(obj)
    if name == "JointSpec":
        return JointSpec(str(obj.base_model), int(obj.n_params), tuple(float(x) for x in obj.lower),
                         tuple(float(x) for x in obj.upper), int(obj.n_shape))
    if hasattr(obj, "_fields"):
        if name not in _TYPES:
            raise TypeError(f"no port type for {name}")
        fields = obj._asdict()
        return _TYPES[name](**{
            k: (None if v is None else np.asarray(v)) if k in _HOST_FIELDS
            else from_numpy(v, device)
            for k, v in fields.items() if k in _TYPES[name]._fields
        })
    if isinstance(obj, (tuple, list)):
        return tuple(from_numpy(x, device) for x in obj)
    return torch.as_tensor(np.array(obj), device=device)


def warm_from_numpy(warm, device="cpu"):
    """A ``(μ, ν, stop)`` triple from either package (``LMResult.warm_state()``,
    or the μ, ν, stop fields of a fused-tier result) → the port's triple on
    ``device``: μ and ν in their dtype, stop as int32."""
    mu, nu, stop = (np.array(x) for x in warm)
    return (torch.as_tensor(mu, device=device), torch.as_tensor(nu, device=device),
            torch.as_tensor(stop.astype(np.int32), device=device))


def to_numpy(obj):
    """The port's state → the same types with numpy leaves (tuples for the
    warm state)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if type(obj).__name__ == "Scene" or type(obj).__name__ in _HOST_TYPES:
        return _host(obj)
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(x) for x in obj)
    return obj
