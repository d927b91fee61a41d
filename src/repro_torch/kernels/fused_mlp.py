"""Fused RMSNorm -> gated-MLP first half: wrapper, plain version, launch
count.

``fused_rmsnorm_mlp`` computes ``act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu)``
and replaces the Pallas kernel of the reference,
``repro/kernels/fused_mlp.py`` (``_fused_kernel`` /
``fused_rmsnorm_mlp_pallas``).  On CUDA tensors it launches one of the
hand-written kernels of ``csrc/fused_mlp.cu`` (see its source note), chosen
by :func:`_variant` from dtype and shape alone, or raises; on CPU tensors it
runs :func:`fused_rmsnorm_mlp_plain`.  ``fused_rmsnorm_mlp.launches``
counts calls that launched (the ``wgmma_tma`` variant is two kernels: the
row norms, then the products) and ``fused_rmsnorm_mlp.last_variant`` names
the kernel of the latest one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._common import aligned16, check, on_card, \
    stream_of
from repro_torch.models.layers import _act, rms_norm

ACTS = ("silu", "gelu")
# The device kernels, by the code csrc/fused_mlp.cu takes.
VARIANTS = {"cuda_cores": 0, "wmma": 1, "rows": 2, "wgmma_tma": 3}
ROWS_MAX_N = 8                       # decode: the weight-streaming kernel
ROWS_MAX_SMEM = 160 * 1024           # its normalised rows, float32


def _variant(dtype: torch.dtype, N: int, d: int, F: int,
             aligned: bool) -> str:
    """The device kernel for these operands: ``rows`` (weight streaming)
    for at most ``ROWS_MAX_N`` rows whose float32 copy fits in
    ``ROWS_MAX_SMEM``; else ``cuda_cores`` for float32; ``wgmma_tma`` (TMA
    ring + wgmma, Hopper) for bfloat16 with d and F multiples of 8 and
    16-byte aligned operands; ``wmma`` for any other bfloat16 shape."""
    if N <= ROWS_MAX_N and 4 * N * d <= ROWS_MAX_SMEM:
        return "rows"
    if dtype == torch.float32:
        return "cuda_cores"
    if d % 8 == 0 and F % 8 == 0 and aligned:
        return "wgmma_tma"
    return "wmma"


def fused_rmsnorm_mlp_plain(x, scale, wg, wu, act: str = "silu",
                            eps: float = 1e-5) -> torch.Tensor:
    """The reference's oracle (``kernels/ref.py:fused_rmsnorm_mlp_ref``) in
    plain PyTorch: the norm rounds to x's dtype, the two products and the
    activation run in float32."""
    xn = rms_norm(x, scale, eps).float()
    g = _act(xn @ wg.float(), act)
    return (g * (xn @ wu.float())).to(x.dtype)


_FN = None


def _launch(x, scale, wg, wu, act, eps):
    global _FN
    code = check("x", x, 2)
    check("scale", scale, 1, (x.dtype,))
    check("wg", wg, 2, (x.dtype,))
    check("wu", wu, 2, (x.dtype,))
    N, d = x.shape
    F = wg.shape[1]
    if scale.shape != (d,) or wg.shape != (d, F) or wu.shape != (d, F):
        raise ValueError(f"x {tuple(x.shape)}, scale {tuple(scale.shape)}, "
                         f"wg {tuple(wg.shape)}, wu {tuple(wu.shape)}")
    out = torch.empty((N, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if _FN is None:
        from repro_torch.kernels import build
        P, I = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("fused_mlp", "fused_mlp_launch",
                             [P] * 6 + [I] * 4 + [ctypes.c_float, I, I, P])
    variant = _variant(x.dtype, N, d, F, aligned16(x, scale, wg, wu))
    # the wgmma_tma pair's scratch: 1 / rms of each row
    inv_rms = (torch.empty((N,), dtype=torch.float32, device=x.device)
               if variant == "wgmma_tma" else None)
    with torch.cuda.device(x.device):
        rc = _FN(x.data_ptr(), scale.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), out.data_ptr(),
                 None if inv_rms is None else inv_rms.data_ptr(), N, d, F,
                 ACTS.index(act), float(eps), code, VARIANTS[variant],
                 stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed (CUDA error "
                           f"{rc}, {variant}) for x {tuple(x.shape)}, F={F}")
    fused_rmsnorm_mlp.launches += 1
    fused_rmsnorm_mlp.last_variant = variant
    return out


def fused_rmsnorm_mlp(x, scale, wg, wu, act: str = "silu",
                      eps: float = 1e-5) -> torch.Tensor:
    """Same contract as the reference's ``ops.fused_rmsnorm_mlp``: x (N,d),
    scale (d,), wg/wu (d,F) -> (N,F) in x's dtype, with ``rmsnorm(x) =
    x * rsqrt(mean(x^2) + eps) * (1 + scale)`` and ``act`` silu or gelu
    (tanh form).  float32 or bfloat16, accumulation in float32."""
    if act not in ACTS:
        raise ValueError(f"act {act!r} not in {ACTS}")
    if on_card(x, scale, wg, wu):
        return _launch(x, scale, wg, wu, act, eps)
    return fused_rmsnorm_mlp_plain(x, scale, wg, wu, act, eps)


fused_rmsnorm_mlp.launches = 0
fused_rmsnorm_mlp.last_variant = None
