"""Sharding helpers for the sweep and co-sim hot paths.

The counterpart of ``repro/shard.py``.  The chunked ``grid_sweep``
evaluator and the ``BatchSimEngine`` design batch are embarrassingly
parallel along one axis (flat design points, the B design axis).  The port
splits that axis into N shards, runs each shard on its own device and
gathers the shards back in order:

* :func:`resolve_devices` turns a ``devices=`` knob (``None`` / int /
  ``"auto"``) into a shard count, clamped to :func:`device_count`.
* :func:`shard_devices` gives the device each shard runs on, from a
  bounded cache keyed on scalars only (the reference's ``device_mesh``
  cache), so it cannot grow with sweep configurations.
* :func:`pad_axis` / :func:`shard_len` pad an axis so that it splits
  evenly; the pad repeats row 0, and every sharded caller slices its
  results back to the true length.

**The forced device count.**  ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` in the
environment (read at every call) makes :func:`device_count` report N
whatever the machine holds, as the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` does for jax's CPU
devices.  Shard ``i`` then lies on physical device ``i % physical_count``:
``cpu`` on the CPU, ``cuda:0`` on a one-card machine.  The switch changes
where shards run, never what they compute.

Correctness contract: sharding only partitions an elementwise (or
per-design independent) computation, so every shard count, 1 included,
gives the same floats as the unsharded path, which stays the ground truth
(``tests/test_torch_shard.py``).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

FORCE_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"

# bounded by construction: one entry per (shard count, device kind, first
# device index) actually used in this process
_DEVICE_CACHE: Dict[Tuple[int, str, int], Tuple[torch.device, ...]] = {}
_DEVICE_CACHE_MAX = 32


def forced_device_count():
    """The count the environment forces, or ``None``."""
    v = os.environ.get(FORCE_ENV)
    if v is None or v == "":
        return None
    n = int(v)
    if n < 1:
        raise ValueError(f"{FORCE_ENV}={v!r}: must be >= 1")
    return n


def physical_count(kind: str) -> int:
    """Devices of ``kind`` ("cuda" or "cpu") that exist: the CPU is one."""
    if kind == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def device_count() -> int:
    """Devices the ``devices=`` knob may use: the forced count if set, else
    every CUDA device (1 without one)."""
    forced = forced_device_count()
    if forced is not None:
        return forced
    return max(physical_count("cuda"), 1)


def resolve_devices(devices: Union[None, int, str]) -> int:
    """Normalize a ``devices=`` knob to a shard count.

    ``None`` -> 1 (sharding off, the single-device ground truth);
    ``"auto"`` -> :func:`device_count`; an int is clamped to it (asking for
    8 on a one-device machine runs unsharded rather than failing, as in the
    reference: the knob expresses intent, the machine decides)."""
    if devices is None:
        return 1
    n = device_count()
    if devices == "auto":
        return n
    d = int(devices)
    if d < 1:       # the reference asserts, and its tests expect that type
        raise AssertionError(f"devices={devices!r}")
    return min(d, n)


def shard_devices(n_devices: int, device) -> Tuple[torch.device, ...]:
    """The device of each of ``n_devices`` shards of work that lives on
    ``device``: shard ``i`` on physical device ``(first + i) %
    physical_count`` of the same kind, ``first`` being ``device``'s index."""
    dev = torch.device(device)
    first = dev.index or 0
    key = (int(n_devices), dev.type, first)
    devs = _DEVICE_CACHE.get(key)
    if devs is None:
        if len(_DEVICE_CACHE) >= _DEVICE_CACHE_MAX:
            _DEVICE_CACHE.pop(next(iter(_DEVICE_CACHE)))
        if dev.type == "cuda":
            n_phys = physical_count("cuda")
            if n_phys < 1:
                raise RuntimeError("no CUDA device to place shards on")
            devs = tuple(torch.device("cuda", (first + i) % n_phys)
                         for i in range(int(n_devices)))
        else:
            devs = (dev,) * int(n_devices)
        _DEVICE_CACHE[key] = devs  # repro: noqa[TPR002] dev is (dev.type, first = dev.index or 0), both in the key
    return devs


def mesh_cache_size() -> int:
    """Current population of the shard-device cache (bounded)."""
    return len(_DEVICE_CACHE)


def shard_len(n: int, n_devices: int) -> int:
    """``n`` rounded up to a multiple of ``n_devices``."""
    return -(-n // n_devices) * n_devices


def pad_axis(a, n_devices: int, axis: int = 0):
    """Pad ``axis`` of ``a`` (a NumPy array or a tensor) to a multiple of
    ``n_devices`` with copies of row 0.  Zeros would do, since padded rows
    are dropped after the gather, but row 0 keeps every lane on realistic
    values."""
    n = a.shape[axis]
    target = shard_len(n, n_devices)
    if target == n:
        return a
    pad = target - n
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, 1)
    shape = a.shape[:axis] + (pad,) + a.shape[axis + 1:]
    if torch.is_tensor(a):
        return torch.cat([a, a[tuple(idx)].expand(shape)], dim=axis)
    filler = np.broadcast_to(a[tuple(idx)], shape)
    return np.concatenate([a, filler], axis=axis)
