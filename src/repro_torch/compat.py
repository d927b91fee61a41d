"""torch surface-API compatibility shims (the port's counterpart of the
reference's ``compat.py``, which does the same for jax).

The port runs on more than one torch release (the card's machine and a
CPU-only one differ), and a few of its calls are spelled in a private or
moved namespace.  Every such call goes through this module, so a release
that renames one fails here, once, with the torch version in the message,
and never runs a silent substitute:

* :func:`grouped_mm` — ``torch._grouped_mm`` (the grouped GEMM of the MoE
  experts on bf16 CUDA operands; private since it appeared).
* :func:`sequence_nr` / :func:`node_sequence_nr` — the autograd engine's
  next sequence number (``torch._C._autograd._get_sequence_nr``, or the
  same counter read off a fresh node on a release without it) and a
  node's own (``Node._sequence_nr()``), which the FLOP counter's loop
  folding compares.
* :func:`dtensor` — the DTensor namespace (``DTensor``, ``Shard``,
  ``Replicate``), public as ``torch.distributed.tensor`` since it moved out
  of ``torch.distributed._tensor``.

Nothing here runs at import time.
"""
from __future__ import annotations

import importlib
from types import ModuleType

import torch


def _missing(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what} is not in torch {torch.__version__}; repro_torch.compat "
        "names the spellings it knows")


def grouped_mm(xs: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """``torch._grouped_mm(xs, w, offs=offs)``."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        raise _missing("torch._grouped_mm")
    return fn(xs, w, offs=offs)


def node_sequence_nr(node) -> int:
    """The sequence number of an autograd node (``Node._sequence_nr()``)."""
    seq = getattr(node, "_sequence_nr", None)
    if seq is None:
        raise _missing("torch.autograd.graph.Node._sequence_nr")
    return int(seq())


def sequence_nr() -> int:
    """The sequence number the autograd engine gives its next node."""
    get = getattr(torch._C._autograd, "_get_sequence_nr", None)
    if get is not None:
        return int(get())
    with torch.enable_grad():                 # a throwaway node's number
        node = torch.zeros((), requires_grad=True).view(()).grad_fn
    return node_sequence_nr(node) + 1


def dtensor() -> ModuleType:
    """The namespace of ``DTensor``, ``Shard`` and ``Replicate``."""
    try:
        mod = importlib.import_module("torch.distributed.tensor")
    except ImportError as e:
        raise _missing("torch.distributed.tensor") from e
    if not all(hasattr(mod, n) for n in ("DTensor", "Shard", "Replicate")):
        raise _missing("torch.distributed.tensor.{DTensor,Shard,Replicate}")
    return mod
