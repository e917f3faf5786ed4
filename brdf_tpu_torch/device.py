"""Where the port's entry points run."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present: an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def rank_device(device=None) -> torch.device:
    """This rank's device: :func:`resolve_device`'s, with a bare ``cuda``
    taken to ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` is set by
    ``torchrun``; 0 without it), so that the ranks of one host spread over
    its cards."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    return dev
