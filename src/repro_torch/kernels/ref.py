"""Oracles for every kernel of the port (the reference's
``repro/kernels/ref.py``), written over the port's plain versions.  The
backward passes of :mod:`repro_torch.kernels.ops` differentiate these, as
the reference's ``custom_vjp`` rules differentiate its oracles."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp_plain
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


def flash_attention_ref(q, k, v, qpos, kpos, *, scale: float,
                        window: int = 0) -> torch.Tensor:
    """Same contract as ``kernels.flash_attention.flash_attention``."""
    return L.attention_naive(q, k, v, qpos, kpos, window, scale)


def ssd_scan_ref(xs, dt, A, Bm, Cm, D, *, chunk: int = 256):
    """Same contract as ``kernels.ssd_scan.ssd_scan``."""
    return M.ssd_scan_ref(xs, dt, A, Bm, Cm, D, chunk)


def fused_rmsnorm_mlp_ref(x, scale, wg, wu, *, act: str = "silu",
                          eps: float = 1e-5) -> torch.Tensor:
    """The norm rounds to x's dtype; the products and the activation run in
    float32; the result comes back in x's dtype."""
    return fused_rmsnorm_mlp_plain(x, scale, wg, wu, act, eps)


def flash_decode_ref(q, cache_k, cache_v, qpos, kpos, *, scale: float,
                     window: int = 0) -> torch.Tensor:
    """Oracle for the split-KV decode kernel via ``attention_naive``."""
    out = L.attention_naive(q[:, None], cache_k, cache_v, qpos[:, None],
                            kpos, window, scale)
    return out[:, 0]                              # (B,KV,G,hd_v)
