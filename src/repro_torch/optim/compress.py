"""Gradient compression for the interconnect island, mirroring
``repro/optim/compress.py``: per-leaf int8 quantisation,

    q = round(g / scale) : int8, scale = max|g| / 127 per leaf,

4x fewer wire bytes than float32 at an error of at most half a step.  The
pod-axis reduction that uses it (an int8 all-gather and a float32 sum under
``shard_map``) needs a mesh, which waits for ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar); ``torch.round`` rounds half to
    even, as ``jnp.round``."""
    g32 = g.float()
    amax = torch.amax(torch.abs(g32))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _needs_mesh(what: str):
    raise NotImplementedError(
        f"{what}: the pod-axis int8 all-gather runs under a device mesh; "
        "multi-device sharding is not ported yet (ROADMAP queue A item 12)")


def compressed_psum_leaf(g: torch.Tensor, axis: str) -> torch.Tensor:
    """int8 all-gather + float32 sum over one mesh axis (not ported)."""
    _needs_mesh("compressed_psum_leaf")


def compressed_allreduce(grads: Any, mesh, axis: str = "pod") -> Any:
    """Compress-reduce a pod-sharded partial gradient tree (not ported)."""
    _needs_mesh("compressed_allreduce")
