"""The plain side of ``csrc/lanegroup.cuh``: how many lanes solve a texel,
and the fixed-order sum over its views that such a group computes.

K5 (``ops/lm.py``) and K8 (``ops/varpro_nd.py``) solve a texel with a group
of S lanes of one warp, lane l holding views l, l + S, …; each lane adds its
views left to right from 0, and the group combines its S partials by an XOR
butterfly. Their plain versions sum every view quantity with
:func:`group_sum`, which repeats that order, so that kernel and plain
version agree bit for bit on the card.
"""

from __future__ import annotations

import torch


def group_lanes(v: int, views_per_lane: int) -> int:
    """The smallest power of two S ≤ 32 that gives a lane at most
    ``views_per_lane`` of ``v`` views, or 32."""
    lanes = 1
    while lanes < 32 and -(-v // lanes) > views_per_lane:
        lanes *= 2
    return lanes


def group_sum(x: torch.Tensor, lanes: int, vpl: int) -> torch.Tensor:
    """The sum of ``x`` over its leading (view) axis → shape ``(1, ...)``, in
    a lane group's order: lane l's partial adds views l, l + lanes, … left to
    right from 0 (a slot past the last view leaves the partial as it is); the
    partials combine as the pairwise tree ((p0 + p1) + (p2 + p3)) + …, the
    bits every lane of the kernel's XOR butterfly ends with."""
    v = x.shape[0]
    acc = torch.zeros((lanes,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for k in range(vpl):
        n = min(lanes, v - k * lanes)       # lanes whose slot k holds a view
        if n <= 0:
            break
        part = acc[:n] + x[k * lanes:k * lanes + n]
        acc = part if n == lanes else torch.cat([part, acc[n:]])
    while acc.shape[0] > 1:
        acc = acc[0::2] + acc[1::2]
    return acc
