"""The ``(data, view)`` mesh over ``torch.distributed`` ranks.

Port of ``brdf_tpu/parallel/mesh.py``. The decomposition is the JAX
package's: texels on the ``data`` axis (per-texel problems are independent)
and views on the ``view`` axis (the normal equations are sums over views, so
a sharded view axis turns χ², JᵀJ and Jᵀe into sums across ranks).

PyTorch runs one process (a rank) per device, where JAX runs one controller
over many devices, so the port takes the JAX package's multi-process
contract everywhere: every rank passes its own block and gets its own block
back. Rank ``r`` holds mesh coordinates ``(r // view, r % view)``
(data-major, as ``make_mesh`` reshapes the JAX devices). A process with no
process group is the 1 × 1 mesh, where every collective here is the
identity.

:func:`axis_sum` is the only place where a reduction crosses ranks. It
gathers the partials of the axis group and adds them in rank order, left to
right, so that every rank of the group holds the same bits whatever order
the backend would reduce in: the LM and VarPro loops decide on the host
whether to go on, and one differing bit would leave one replica in a
collective that its peers have left. :func:`use_mesh` makes a mesh current,
so that an ``axis_name`` of ``"view"`` means what it means inside JAX's
``shard_map``.

Backends: NCCL for CUDA ranks, one GPU each (NCCL refuses two ranks on one
GPU), gloo for CPU ranks. Gloo's ``all_gather`` takes CUDA tensors too (it
moves them through host memory itself), which is how several ranks share
one card; the kernels still run on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from brdf_tpu_torch.device import rank_device

DATA_AXIS = "data"
VIEW_AXIS = "view"
ALL_AXES = (DATA_AXIS, VIEW_AXIS)
# every process group's timeout: replicas that diverge fail instead of waiting
GROUP_TIMEOUT = datetime.timedelta(seconds=120)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("brdf_tpu_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``data × view`` grid of ranks as seen from rank ``rank``, with the
    process groups of its row (``view``) and column (``data``); an axis of
    size 1 has no group."""

    data: int
    view: int
    rank: int
    world: int
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(data, view)`` coordinates."""
        return divmod(self.rank, self.view)

    @property
    def shape(self) -> dict:
        """The axes' sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {DATA_AXIS: self.data, VIEW_AXIS: self.view}


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(data: int | None = None, view: int = 1, device=None) -> Mesh:
    """A 2-D ``(data, view)`` mesh of every rank. By default all ranks go to
    the texel (``data``) axis; pass ``view > 1`` to split the views.
    ``device`` is this rank's device (``device.py::rank_device``: a bare
    ``cuda`` is ``cuda:{LOCAL_RANK % device_count}``). Every rank makes every
    group, in one order, so every rank must call this with the same shape."""
    world, rank = process_count(), process_index()
    if data is None:
        if world % view:
            raise ValueError(f"{world} devices not divisible by view={view}")
        data = world // view
    if data * view != world:
        raise ValueError(f"mesh {data}x{view} != {world} devices")
    groups = {}
    if view > 1:
        for d in range(data):
            ranks = [d * view + v for v in range(view)]
            group = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
            if rank in ranks:
                groups[VIEW_AXIS] = group
    if data > 1:
        for v in range(view):
            ranks = [d * view + v for d in range(data)]
            group = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
            if rank in ranks:
                groups[DATA_AXIS] = group
    if world > 1:
        groups[ALL_AXES] = dist.group.WORLD
    return Mesh(data=data, view=view, rank=rank, world=world, device=rank_device(device),
                groups=groups)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, value=0.0):
    """Pad ``x`` along ``axis`` so its size divides evenly across a mesh axis.
    Returns ``(padded, original_size)``. Copied from the JAX package's
    ``parallel/mesh.py`` (NumPy there too)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=value), size


def local_block(arr) -> np.ndarray:
    """This rank's block as host NumPy. A rank's result already is its own
    block, so this is the identity on it; kept so that callers of the JAX
    package find the name."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def block_of(n: int, parts: int, index: int) -> slice:
    """The ``index``-th of ``parts`` equal blocks of ``n`` rows."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> bool:
    """Start the process group of a run over several ranks
    (``python -m brdf_tpu_torch --multihost ...``). Returns True when one is
    active.

    With a ``coordinator`` (``host:port``, or an init method URL such as
    ``file://...``) it calls ``init_process_group`` with it and the given
    world size and rank; with none it reads the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when that is set, and is
    otherwise a single-process no-op returning False, so the same command
    runs on a laptop and on every rank. The backend is ``nccl`` for a CUDA
    rank and ``gloo`` for a CPU one (``device``, default ``cuda`` where
    there is a card) unless the caller names it.
    """
    if dist.is_initialized():
        return True
    from_env = all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if coordinator is None and not from_env:
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator is not None:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, timeout=GROUP_TIMEOUT)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=GROUP_TIMEOUT)
    return True


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` current: :func:`axis_sum` and :func:`axis_gather` of an
    axis name reduce over its groups inside the block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def _group(axis):
    """The current mesh's group of ``axis`` (a name, or ``ALL_AXES``), or
    None where there is nothing to reduce over: no axis, an axis of size 1.
    An axis with no current mesh raises, as an unbound axis name does in
    JAX."""
    if axis is None:
        return None
    mesh = _CURRENT.get()
    if mesh is None:
        raise ValueError(f"axis {axis!r} names an axis of a mesh, and no mesh is current "
                         "(parallel/mesh.py::use_mesh)")
    if axis not in mesh.shape and axis != ALL_AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {ALL_AXES}")
    return mesh.groups.get(axis)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` in the group, in group-rank order (for both axes
    that is the ranks' order)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def axis_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis`` of the current mesh, added in
    rank order from the left: ``((x₀ + x₁) + x₂) + …``, the same bits on
    every rank of the group. The identity for ``axis=None`` and for an axis
    of size 1."""
    group = _group(axis)
    if group is None:
        return x
    parts = _all_gather(x, group)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def axis_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis`` of the current mesh,
    concatenated along ``dim`` in rank order. The identity where
    :func:`axis_sum` is."""
    group = _group(axis)
    if group is None:
        return x
    return torch.cat(_all_gather(x, group), dim=dim)
