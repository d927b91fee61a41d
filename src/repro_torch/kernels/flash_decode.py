"""Split-KV single-token attention over a ring KV cache (decode): wrapper,
plain version, launch count.

``flash_decode`` replaces the Pallas kernel of the reference,
``repro/kernels/flash_decode.py`` (``_decode_kernel`` /
``flash_decode_pallas``).  On CUDA tensors it launches a split sweep of
``csrc/flash_decode.cu`` and the combine kernel (see its source note), the
sweep chosen by :func:`_variant` from dtype and shape alone and its split
by :func:`decode_split`, or raises; on CPU tensors it runs
:func:`flash_decode_plain`.  ``flash_decode.launches`` counts launches of
the pair (``lse_launches`` those with ``return_lse``),
``flash_decode.last_variant`` / ``last_split`` name the sweep and the
split of the latest one.  ``return_lse=True`` adds each row's
log-sum-exp ``(B, KV, G)`` float32 (``-inf`` for a row with no live slot,
whose output is 0), written by either sweep's combine: the weight by which
a caller merges the outputs of several slices of one ring (placed decode,
``models/layers.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._common import aligned16, check, on_card, \
    positions, refuse_counting, refuse_grad, sm_count as _sm_count, \
    stream_of
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 flash_attention_plain)
from repro_torch.models.layers import _gqa_scores, _window_mask

MAX_GROUP_OUT = 2048       # G * hd_v per kv head, the kernel's register bound
# The split sweeps, by the code csrc/flash_decode.cu takes.
VARIANTS = {"cuda_cores": 0, "cp_async": 1}
CP_ASYNC_MAX_G = 16        # heads per kv group of the cp_async sweep
CP_ASYNC_MAX_HD = 128      # and its head dims
MAX_SPLIT = 1024           # its split's live flags sit in shared memory
MAX_SPLITS = 1024          # partials its combine keeps weights of, per row
PARTS_PER_SPLIT = 4        # one partial per warp of a block
SPLIT_STEP = 64            # slots its 4 warps take per step (16 each)
BLOCKS_PER_SM = 2          # the grid it aims for, in blocks per SM


def _variant(cache_dtype: torch.dtype, hd: int, hd_v: int, G: int,
             aligned: bool, W: int = 0) -> str:
    """The split sweep for these operands: ``cp_async`` (per-warp cp.async
    rings of bf16 K/V rows, the products on tensor cores, no block barrier
    in the sweep) for a bfloat16 cache with ``hd`` and ``hd_v`` multiples
    of 8 up to 128, ``G <= 16``, a ring of at most ``MAX_SPLIT x
    MAX_SPLITS / PARTS_PER_SPLIT`` slots and 16-byte aligned q and cache
    tensors, q in either dtype; ``cuda_cores`` for any other case (a
    float32 cache among them)."""
    if (cache_dtype == torch.bfloat16 and hd % 8 == 0 and hd_v % 8 == 0
            and max(hd, hd_v) <= CP_ASYNC_MAX_HD and G <= CP_ASYNC_MAX_G
            and W * PARTS_PER_SPLIT <= MAX_SPLIT * MAX_SPLITS and aligned):
        return "cp_async"
    return "cuda_cores"


def decode_split(bkv: int, W: int, kv_block: int, n_sm: int) -> int:
    """Cache slots per block of the ``cp_async`` sweep: enough blocks for
    ``BLOCKS_PER_SM`` per SM over ``bkv`` (batch x kv heads) rows of ``W``
    slots, in whole ``SPLIT_STEP``s, capped by ``kv_block`` and
    ``MAX_SPLIT`` (and never more than ``W``), yet long enough for at most
    ``MAX_SPLITS`` partials of a row (``PARTS_PER_SPLIT`` per split)."""
    per = -(-bkv * W // (BLOCKS_PER_SM * n_sm))
    split = -(-per // SPLIT_STEP) * SPLIT_STEP
    split = max(1, min(split, kv_block, MAX_SPLIT, W))
    return max(split, -(-W * PARTS_PER_SPLIT // MAX_SPLITS))


def flash_decode_plain(q, cache_k, cache_v, qpos, kpos, window: int = 0,
                       scale: float = 1.0, kv_block: int = 512,
                       return_lse: bool = False):
    """The kernel's function in plain PyTorch: the reference's oracle
    (attention over the cache, ``kernels/ref.py:flash_decode_ref``) in the
    kernel's masked form (:func:`flash_attention_plain`).  ``kv_block`` only
    sets the kernel's split length and does not change the function.  With
    ``return_lse`` also each row's log-sum-exp of its scaled live scores,
    ``(B, KV, G)`` float32, ``-inf`` where no slot is live."""
    out = flash_attention_plain(q[:, None], cache_k, cache_v, qpos[:, None],
                                kpos, window, scale)[:, 0]
    if not return_lse:
        return out
    s = _gqa_scores(q[:, None], cache_k)[..., 0, :] * scale   # (B,KV,G,W)
    live = _window_mask(qpos[:, None], kpos, window)[:, 0][:, None, None]
    lse = torch.logsumexp(torch.where(live, s, -torch.inf), dim=-1)
    return out, lse


_FN = None


def _launch(q, cache_k, cache_v, qpos, kpos, window, scale, kv_block,
            split=None, variant=None, return_lse=False):
    """One launch.  ``variant`` defaults to :func:`_variant` and ``split``
    (slots per block) to the variant's rule; both are given only to time
    the other sweep, or the split ``kv_block`` against the rule's, on the
    same inputs.  ``return_lse``: ``(out, lse)``."""
    global _FN
    qcode = check("q", q, 4)
    ccode = check("cache_k", cache_k, 4)
    check("cache_v", cache_v, 4, (cache_k.dtype,))
    B, KV, G, hd = q.shape
    W, hd_v = cache_k.shape[1], cache_v.shape[-1]
    if cache_k.shape != (B, W, KV, hd) or cache_v.shape[:3] != (B, W, KV):
        raise ValueError(f"cache {tuple(cache_k.shape)} / "
                         f"{tuple(cache_v.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (0 < hd <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM):
        raise ValueError(f"head dims {hd}/{hd_v} outside 1..{MAX_HEAD_DIM}")
    if G * hd_v > MAX_GROUP_OUT:
        raise ValueError(f"G * hd_v = {G * hd_v} > {MAX_GROUP_OUT}")
    if kv_block < 1:
        raise ValueError(f"kv_block must be >= 1, got {kv_block}")
    qp, kp = positions(qpos, (B,)), positions(kpos, (B, W))
    out = torch.empty((B, KV, G, hd_v), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or W == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if return_lse else out
    if variant is None:
        variant = _variant(cache_k.dtype, hd, hd_v, G,
                           aligned16(q, cache_k, cache_v), W)
    if split is None:
        split = (decode_split(B * KV, W, kv_block, _sm_count(q.device))
                 if variant == "cp_async" else kv_block)
    n_parts = -(-W // split) * (PARTS_PER_SPLIT if variant == "cp_async"
                                else 1)
    part = torch.empty(B * KV * n_parts * G * (hd_v + 2),
                       dtype=torch.float32, device=q.device)
    if _FN is None:
        from repro_torch.kernels import build
        P, I = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("flash_decode", "flash_decode_launch",
                             [P] * 8 + [I] * 8 + [ctypes.c_float, I, I, I, P])
    with torch.cuda.device(q.device):
        rc = _FN(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 qp.data_ptr(), kp.data_ptr(), part.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if return_lse else None,
                 B, W, KV, G, hd, hd_v, int(window),
                 int(split), float(scale), qcode, ccode, VARIANTS[variant],
                 stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (CUDA error "
                           f"{rc}, {variant}, split {split}) for q "
                           f"{tuple(q.shape)}, W={W}")
    flash_decode.launches += 1
    flash_decode.lse_launches += bool(return_lse)
    flash_decode.last_variant = variant
    flash_decode.last_split = split
    return (out, lse) if return_lse else out


def flash_decode(q, cache_k, cache_v, qpos, kpos, window: int = 0,
                 scale: float = 1.0, kv_block: int = 512,
                 return_lse: bool = False):
    """Same contract as the reference's ``ops.flash_decode``: q (B,KV,G,hd),
    cache_k (B,W,KV,hd), cache_v (B,W,KV,hd_v), qpos (B,), kpos (B,W) (slots
    not written yet carry a position above ``qpos``) -> (B,KV,G,hd_v) in q's
    dtype.  The kernel sweeps the cache in splits of at most ``kv_block``
    slots in parallel (``decode_split``) and merges them; q and the cache
    may differ in dtype (float32 / bfloat16).  ``return_lse``: ``(out,
    lse)``, lse (B,KV,G) float32 as :func:`flash_decode_plain` gives it."""
    if on_card(q, cache_k, cache_v):
        refuse_grad("flash_decode", q, cache_k, cache_v, backward=False)
        refuse_counting("flash_decode")
        return _launch(q, cache_k, cache_v, qpos, kpos, window, scale,
                       kv_block, return_lse=return_lse)
    return flash_decode_plain(q, cache_k, cache_v, qpos, kpos, window, scale,
                              return_lse=return_lse)


flash_decode.launches = 0
flash_decode.lse_launches = 0      # the launches that asked for the lse
flash_decode.last_variant = None
flash_decode.last_split = None
