"""Fused RMSNorm -> gated-MLP first half: wrapper, plain version, launch
count.

``fused_rmsnorm_mlp`` computes ``act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu)``
and replaces the Pallas kernel of the reference,
``repro/kernels/fused_mlp.py`` (``_fused_kernel`` /
``fused_rmsnorm_mlp_pallas``).  On CUDA tensors it launches one of the
hand-written kernels of ``csrc/fused_mlp.cu`` (see its source note), chosen
by :func:`_variant` from dtype and shape alone, or raises (also when an
input requires grad with grad mode on: the output would carry no gradient,
so training goes through ``kernels.ops.fused_rmsnorm_mlp``); on CPU tensors
it runs :func:`fused_rmsnorm_mlp_plain`.  ``fused_rmsnorm_mlp.launches``
counts calls that launched (the ``wgmma_tma`` variant is two kernels: the
row norms, then the products) and ``fused_rmsnorm_mlp.last_variant`` names
the kernel of the latest one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels._common import aligned16, check, on_card, \
    refuse_counting, refuse_grad, sm_count, stream_of
from repro_torch.models.layers import _act, rms_norm

ACTS = ("silu", "gelu")
# The device kernels, by the code csrc/fused_mlp.cu takes.
VARIANTS = {"cuda_cores": 0, "wmma": 1, "rows": 2, "wgmma_tma": 3,
            "gemv_tma": 4}
ROWS_MAX_N = 8                       # decode: the weight-streaming kernels
ROWS_MAX_SMEM = 160 * 1024           # the rows kernel's float32 rows

# gemv_tma's split (csrc/fused_mlp.cu, launch_gemv): chunks of a strip of
# 64 * GEMV_BOXES columns of F (GEMV_BOXES 64-column TMA boxes side by side)
# by GEMV_KROWS rows of d, one block per SM, each a contiguous run of
# chunks; a ring of stages (Wg and Wu tiles of a chunk) beside the
# normalised rows (N x (d rounded up to the chunk, + 8) bf16) and the scale
# in one block's shared memory
GEMV_BOXES = 1
GEMV_KROWS = 128
GEMV_MAX_STAGES = 16
GEMV_SMEM = 232448 - 512 - 1024 - 256    # less static, alignment, barriers
GEMV_WARPS = 4                           # consumer warps


def gemv_stages(N: int, d: int) -> int:
    """Ring stages of a gemv_tma block: as many as fit beside the
    normalised rows, at most GEMV_MAX_STAGES (under 2: not taken)."""
    stage = 2 * GEMV_BOXES * GEMV_KROWS * 128
    dpad = -(-d // GEMV_KROWS) * GEMV_KROWS
    room = GEMV_SMEM - (N * (dpad + 8) + dpad) * 2   # rows and scale
    return min(GEMV_MAX_STAGES, room // stage)


def gemv_plan(d: int, F: int, n_sm: int) -> Tuple[int, int, int]:
    """``(blocks, strips, maxseg)`` of a gemv_tma call: one block per SM
    (at most one per chunk), block b taking chunks [b * total / blocks,
    (b + 1) * total / blocks) in strip-major order, and the most blocks
    (segments) that share one strip."""
    strips = -(-F // (64 * GEMV_BOXES))
    kc = -(-d // GEMV_KROWS)
    total = strips * kc
    blocks = min(n_sm, total)

    def block_of(c):
        return ((c + 1) * blocks - 1) // total

    maxseg = max(block_of(s * kc + kc - 1) - block_of(s * kc) + 1
                 for s in range(strips))
    return blocks, strips, maxseg


def _variant(dtype: torch.dtype, N: int, d: int, F: int,
             aligned: bool) -> str:
    """The device kernel for these operands: ``gemv_tma`` (TMA ring,
    tensor-core products, one block per SM) for at most ``ROWS_MAX_N``
    bfloat16 rows with d and F multiples of 8, 16-byte aligned operands and
    room for two ring stages beside the normalised rows; else ``rows``
    (weight streaming) for at most ``ROWS_MAX_N`` rows whose float32 copy
    fits in ``ROWS_MAX_SMEM``; else ``cuda_cores`` for float32;
    ``wgmma_tma`` (TMA ring + wgmma, Hopper) for bfloat16 with d and F
    multiples of 8 and 16-byte aligned operands; ``wmma`` for any other
    bfloat16 shape."""
    tma = d % 8 == 0 and F % 8 == 0 and aligned
    if (dtype == torch.bfloat16 and N <= ROWS_MAX_N and tma
            and gemv_stages(N, d) >= 2):
        return "gemv_tma"
    if N <= ROWS_MAX_N and 4 * N * d <= ROWS_MAX_SMEM:
        return "rows"
    if dtype == torch.float32:
        return "cuda_cores"
    if tma:
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
_COUNTERS: Dict[int, torch.Tensor] = {}  # repro: noqa[TPR003] one counter tensor per CUDA device index, grown in place


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """gemv_tma's strip counters on ``device``: zeros, kept from call to
    call (the kernel leaves them zero), grown when a call needs more."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    have = _COUNTERS.get(idx)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[idx] = have  # repro: noqa[TPR002] keyed by the device's index, which names the device; grown in place to the largest n asked
    return have


def _launch(x, scale, wg, wu, act, eps, variant=None):
    """One launch.  ``variant`` defaults to :func:`_variant`; it is given
    only to time another kernel on the same inputs (the rows kernel beside
    gemv_tma)."""
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
                             [P] * 7 + [I] * 4 + [ctypes.c_float]
                             + [I] * 7 + [P])
    if variant is None:
        variant = _variant(x.dtype, N, d, F, aligned16(x, scale, wg, wu))
    scratch = count = None
    boxes = krows = blocks = stages = maxseg = 0
    if variant == "wgmma_tma":          # the pair's 1 / rms of each row
        scratch = torch.empty((N,), dtype=torch.float32, device=x.device)
    elif variant == "gemv_tma":         # partial sums of split strips
        boxes, krows = GEMV_BOXES, GEMV_KROWS
        blocks, strips, maxseg = gemv_plan(d, F, sm_count(x.device))
        stages = gemv_stages(N, d)
        # a warp's partial: 16 columns per box x 8 rows, gate and up
        scratch = torch.empty((strips * GEMV_WARPS * maxseg * 256 * boxes,),
                              dtype=torch.float32, device=x.device)
        count = _counters(x.device, strips * GEMV_WARPS)
    with torch.cuda.device(x.device):
        rc = _FN(x.data_ptr(), scale.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 None if count is None else count.data_ptr(), N, d, F,
                 ACTS.index(act), float(eps), code, VARIANTS[variant],
                 boxes, krows, blocks, stages, maxseg, stream_of(x))
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
        refuse_grad("fused_rmsnorm_mlp", x, scale, wg, wu)
        refuse_counting("fused_rmsnorm_mlp")
        return _launch(x, scale, wg, wu, act, eps)
    return fused_rmsnorm_mlp_plain(x, scale, wg, wu, act, eps)


fused_rmsnorm_mlp.launches = 0
fused_rmsnorm_mlp.last_variant = None
