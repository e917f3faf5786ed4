"""The plain side of ``csrc/lanegroup.cuh``: how many lanes solve a texel,
and the fixed-order sum over its views that such a group computes.

K1 (``ops/varpro.py``), K5 (``ops/lm.py``) and K8 (``ops/varpro_nd.py``)
solve a texel with a group of S lanes of one warp, lane l holding views l,
l + S, … (K1 and K8 past their register layouts as 32 lanes that read their
views from device memory, :func:`long_view_layout`); K6 and K7
(``ops/ne.py``) split a texel's views the same way over the W warps of a
block. Each thread adds its views left to right from 0, and the partials
combine as a pairwise tree (an XOR butterfly, or a fold in shared memory).
Their plain versions sum every view quantity with :func:`group_sum`, which
repeats that order, so that kernel and plain version agree bit for bit on
the card.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


def group_lanes(v: int, views_per_lane: int) -> int:
    """The smallest power of two S ≤ 32 that gives a lane at most
    ``views_per_lane`` of ``v`` views, or 32."""
    lanes = 1
    while lanes < 32 and -(-v // lanes) > views_per_lane:
        lanes *= 2
    return lanes


def long_view_layout(v: int, threads: int) -> tuple[int, int, int]:
    """K1's and K8's long-view layout, past their register layouts: 32 lanes a
    texel, lane l walking views l, l + 32, … (⌈v / 32⌉ of them, read from
    device memory in every pass), ``threads // 32`` texels a block → ``(S,
    VPL, block_t)``. It reads ``v`` and no texel count, so a texel's rows do
    not depend on its batch."""
    if v < 1:
        raise ValueError(f"a texel has at least one view, got V={v}")
    return 32, -(-v // 32), threads // 32


def group_sum(x: torch.Tensor | Sequence[torch.Tensor], lanes: int, vpl: int) -> torch.Tensor:
    """The sum of ``x`` over its leading (view) axis → shape ``(1, ...)``, in
    a lane group's order: lane l's partial adds views l, l + lanes, … left to
    right from 0 (a slot past the last view leaves the partial as it is); the
    partials combine as the pairwise tree ((p0 + p1) + (p2 + p3)) + …, the
    bits every lane of the kernel's XOR butterfly ends with (and those of a
    warp split's fold in shared memory). ``x`` may be a list of terms of one
    shape: each view then adds them in list order (K7's channels)."""
    terms = [x] if isinstance(x, torch.Tensor) else list(x)
    v = terms[0].shape[0]
    acc = torch.zeros((lanes,) + tuple(terms[0].shape[1:]), dtype=terms[0].dtype,
                      device=terms[0].device)
    for k in range(vpl):
        n = min(lanes, v - k * lanes)       # lanes whose slot k holds a view
        if n <= 0:
            break
        part = acc[:n]
        for term in terms:
            part = part + term[k * lanes:k * lanes + n]
        acc = part if n == lanes else torch.cat([part, acc[n:]])
    while acc.shape[0] > 1:
        acc = acc[0::2] + acc[1::2]
    return acc
