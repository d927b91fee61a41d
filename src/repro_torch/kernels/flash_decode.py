"""Split-KV single-token attention over a ring KV cache (decode): wrapper,
plain version, launch count.

``flash_decode`` replaces the Pallas kernel of the reference,
``repro/kernels/flash_decode.py`` (``_decode_kernel`` /
``flash_decode_pallas``).  On CUDA tensors it launches the two kernels of
``csrc/flash_decode.cu`` (the split sweep and the combine; see its source
note) or raises; on CPU tensors it runs :func:`flash_decode_plain`.
``flash_decode.launches`` counts launches of the pair.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._common import check, on_card, positions, stream_of
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 flash_attention_plain)

MAX_GROUP_OUT = 2048       # G * hd_v per kv head, the kernel's register bound


def flash_decode_plain(q, cache_k, cache_v, qpos, kpos, window: int = 0,
                       scale: float = 1.0, kv_block: int = 512
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's oracle
    (attention over the cache, ``kernels/ref.py:flash_decode_ref``) in the
    kernel's masked form (:func:`flash_attention_plain`).  ``kv_block`` only
    sets the kernel's split length and does not change the function."""
    out = flash_attention_plain(q[:, None], cache_k, cache_v, qpos[:, None],
                                kpos, window, scale)
    return out[:, 0]


_FN = None


def _launch(q, cache_k, cache_v, qpos, kpos, window, scale, kv_block):
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
    if out.numel() == 0 or W == 0:
        return out.zero_()
    n_splits = -(-W // kv_block)
    part = torch.empty(B * KV * n_splits * G * (hd_v + 2),
                       dtype=torch.float32, device=q.device)
    if _FN is None:
        from repro_torch.kernels import build
        P, I = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("flash_decode", "flash_decode_launch",
                             [P] * 7 + [I] * 8 + [ctypes.c_float, I, I, P])
    with torch.cuda.device(q.device):
        rc = _FN(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 qp.data_ptr(), kp.data_ptr(), part.data_ptr(),
                 out.data_ptr(), B, W, KV, G, hd, hd_v, int(window),
                 int(kv_block), float(scale), qcode, ccode, stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (CUDA error "
                           f"{rc}) for q {tuple(q.shape)}, W={W}")
    flash_decode.launches += 1
    return out


def flash_decode(q, cache_k, cache_v, qpos, kpos, window: int = 0,
                 scale: float = 1.0, kv_block: int = 512) -> torch.Tensor:
    """Same contract as the reference's ``ops.flash_decode``: q (B,KV,G,hd),
    cache_k (B,W,KV,hd), cache_v (B,W,KV,hd_v), qpos (B,), kpos (B,W) (slots
    not written yet carry a position above ``qpos``) -> (B,KV,G,hd_v) in q's
    dtype.  The kernel sweeps the cache in ``ceil(W / kv_block)`` splits in
    parallel and merges them; q and the cache may differ in dtype (float32 /
    bfloat16)."""
    if on_card(q, cache_k, cache_v):
        return _launch(q, cache_k, cache_v, qpos, kpos, window, scale,
                       kv_block)
    return flash_decode_plain(q, cache_k, cache_v, qpos, kpos, window, scale)


flash_decode.launches = 0
