"""The port's device rule.

Every entry point of the port (``grid_sweep``, ``closed_loop_score``,
``BatchSimEngine``) takes ``device=None`` and hands it to :func:`resolve`.
``None`` means the CUDA card, and a missing card is an error — the port never
turns into a CPU program on its own.  Callers that want the CPU (the
differential tests do) say ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceSpec = Union[None, str, torch.device]


def resolve(device: DeviceSpec = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); anything else is
    taken as the caller's explicit choice.  A requested ``cuda`` device that
    is not there raises as well."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly to run the plain CPU path")
    return dev


def require_single(devices: Optional[object]) -> None:
    """The ``devices=`` knob of the reference: one device only for now."""
    if devices not in (None, 1):
        raise NotImplementedError(
            f"devices={devices!r}: multi-device sharding is not ported yet "
            "(ROADMAP queue A item 12)")
