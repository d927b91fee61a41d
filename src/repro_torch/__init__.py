"""PyTorch/CUDA port of the Vespa SoC design-space framework.

Mirrors the layout of the reference package ``repro`` (which it never
imports): ``configs`` / ``core`` / ``sim`` / ``kernels`` / ``models`` /
``runtime`` / ``launch``.  Two slices are ported: the paper's main pipeline —
static sweep (``core.dse.grid_sweep``), closed-loop re-rank
(``core.dse.closed_loop_score``) and the batched co-simulation engine
(``sim.batch.BatchSimEngine``) with the fused tick kernel — and the dense
LLM serving path (``runtime.serve.ServeEngine`` over ``models.transformer.LM``)
with the flash attention, flash decode and fused RMSNorm-MLP kernels; all
kernels are written in CUDA C++ for Hopper (``kernels``).

Sub-packages are imported on first attribute access, so ``import
repro_torch`` stays cheap and never touches the CUDA build.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("analysis", "compat", "configs", "convert", "core", "device",
               "kernels", "launch", "models", "runtime", "sim")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
