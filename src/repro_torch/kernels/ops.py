"""Public entry points of the LLM kernels, with the reference's signatures
(``repro/kernels/ops.py``), differentiable.

``flash_attention``, ``ssd_scan`` and ``fused_rmsnorm_mlp`` run through
``torch.autograd.Function``\\ s: the forward launches the hand-written
kernel on CUDA tensors (its plain version on CPU tensors), and the backward
recomputes the oracle of :mod:`repro_torch.kernels.ref` from the saved
inputs and differentiates it with the incoming gradient, as the reference's
``custom_vjp`` rules do (``_fa_bwd``, ``_ssd_bwd``, ``_fm_bwd``).  The
forward calls the kernel's own wrapper (grad mode is off inside
``Function.forward``, so the wrapper's ``refuse_grad`` stays quiet).  Positions,
``window``, ``scale``, ``chunk``, ``act`` and ``eps`` get no gradient (the
reference's ``nondiff_argnums``).  Each Function counts its backward calls
(``backward_calls``); the launches stay counted on the kernel wrappers.
The attention oracle's backward runs over as many kv heads at once as
its float32 score transients leave room for on a card of its own
(:func:`heads_that_fit`: all of them at the training shapes), and one at a
time where several ranks share the card.
``flash_decode`` is forward only (serving), as in the reference, with its
signature (the kernel wrapper's ``return_lse`` is the placed decode's, in
``models/layers.py``).

These are the only callers that launch the kernels with autograd live: the
raw wrappers refuse a CUDA input that requires grad, whose result would
carry no gradient.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import ref as REF
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import flash_decode as _fd


def flash_decode(q, cache_k, cache_v, qpos, kpos, window: int = 0,
                 scale: float = 1.0, kv_block: int = 512) -> torch.Tensor:
    """The reference's ``ops.flash_decode``:
    :func:`repro_torch.kernels.flash_decode.flash_decode` (the kernel on
    CUDA tensors, its plain version on CPU ones), the output alone."""
    return _fd.flash_decode(q, cache_k, cache_v, qpos, kpos, window, scale,
                            kv_block)


def _grad_of(fn, inputs, outputs_grad):
    """Gradients of ``fn(*inputs)`` with respect to every input, given the
    outputs' gradients (``None`` for an output that received none).  Each
    backward runs it inside its profiler range ``"<name>.backward"``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, outputs_grad) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs],
                                   allow_unused=True, materialize_grads=True)


# ----------------------------------------------------------------- attention
# the float32 tensors of the scores' size the attention oracle's backward
# holds at once (the probabilities, their gradient, the scores' gradient
# and one temporary)
SCORE_TENSORS = 4


def _ranks_per_card() -> int:
    """The processes of the default group that share this host's cards
    (one when no group is formed)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return -(-dist.get_world_size() // max(1, torch.cuda.device_count()))


def heads_that_fit(q: torch.Tensor, k: torch.Tensor) -> int:
    """The kv heads whose backward transients (``SCORE_TENSORS`` float32
    tensors of (B, G, Sq, Sk) a head) fit at once: all of them off the
    card; on a card of its own, those that fit in the card's free memory
    plus what this process's allocator holds unused (at least one); one
    where ranks share the card, whose free memory the others' allocations
    move between this reading and its use."""
    B, Sq, KV, G = q.shape[:4]
    if not q.is_cuda:
        return KV
    if _ranks_per_card() > 1:
        return 1
    per_head = SCORE_TENSORS * B * G * Sq * k.shape[1] * 4
    free, _ = torch.cuda.mem_get_info(q.device)
    room = free + torch.cuda.memory_reserved(q.device) \
        - torch.cuda.memory_allocated(q.device)
    return max(1, min(KV, room // per_head))


def attention_grads(q, k, v, qpos, kpos, g, scale, window, heads: int):
    """(dq, dk, dv) of the attention oracle given the output's gradient
    ``g``, over groups of ``heads`` kv heads in turn: the kv heads are
    independent, so each group's float32 score tensors (B, heads, G, Sq,
    Sk) are made and freed before the next group's (the same sums for each
    head as over all of them at once)."""
    def grads(sl):
        return _grad_of(
            lambda q, k, v: REF.flash_attention_ref(
                q, k, v, qpos, kpos, scale=scale, window=window),
            (q[:, :, sl], k[:, :, sl], v[:, :, sl]), (g[:, :, sl],))
    KV = q.shape[2]
    if heads >= KV:
        return grads(slice(None))
    parts = [grads(slice(j, j + heads)) for j in range(0, KV, heads)]
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


class FlashAttention(torch.autograd.Function):
    backward_calls = 0
    last_heads = None           # the kv heads of a group, last backward

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, window, scale):
        out = _fa.flash_attention(q, k, v, qpos, kpos, window, scale)
        ctx.save_for_backward(q, k, v, qpos, kpos)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, g):
        FlashAttention.backward_calls += 1
        q, k, v, qpos, kpos = ctx.saved_tensors
        heads = FlashAttention.last_heads = heads_that_fit(q, k)
        with record_function("flash_attention.backward"):
            dq, dk, dv = attention_grads(q, k, v, qpos, kpos, g, ctx.scale,
                                         ctx.window, heads)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, qpos, kpos, window: int = 0,
                    scale: float = 1.0) -> torch.Tensor:
    """The reference's ``ops.flash_attention``: the kernel's contract
    (``kernels.flash_attention.flash_attention``) with a backward."""
    return FlashAttention.apply(q, k, v, qpos, kpos, window, scale)


# ----------------------------------------------------------------- SSD scan
class SSDScan(torch.autograd.Function):
    backward_calls = 0

    @staticmethod
    def forward(ctx, xs, dt, A, Bm, Cm, D, chunk):
        ctx.set_materialize_grads(False)
        y, h = _ssd.ssd_scan(xs, dt, A, Bm, Cm, D, chunk)
        ctx.save_for_backward(xs, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        SSDScan.backward_calls += 1
        with record_function("ssd_scan.backward"):
            grads = _grad_of(
                lambda *a: REF.ssd_scan_ref(*a, chunk=ctx.chunk),
                ctx.saved_tensors, (gy, gh))
        return (*grads, None)


def ssd_scan(xs, dt, A, Bm, Cm, D, chunk: int = 256):
    """The reference's ``ops.ssd_scan``: the kernel's contract
    (``kernels.ssd_scan.ssd_scan``: returns ``(y, h_final)``) with a
    backward."""
    return SSDScan.apply(xs, dt, A, Bm, Cm, D, chunk)


# ----------------------------------------------------------------- fused MLP
class FusedRMSNormMLP(torch.autograd.Function):
    backward_calls = 0

    @staticmethod
    def forward(ctx, x, scale, wg, wu, act, eps):
        out = _fm.fused_rmsnorm_mlp(x, scale, wg, wu, act, eps)
        ctx.save_for_backward(x, scale, wg, wu)
        ctx.act, ctx.eps = act, eps
        return out

    @staticmethod
    def backward(ctx, g):
        FusedRMSNormMLP.backward_calls += 1
        with record_function("fused_rmsnorm_mlp.backward"):
            grads = _grad_of(
                lambda *a: REF.fused_rmsnorm_mlp_ref(*a, act=ctx.act,
                                                     eps=ctx.eps),
                ctx.saved_tensors, (g,))
        return (*grads, None, None)


def fused_rmsnorm_mlp(x, scale, wg, wu, act: str = "silu",
                      eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``ops.fused_rmsnorm_mlp``: the kernel's contract
    (``kernels.fused_mlp.fused_rmsnorm_mlp``) with a backward."""
    return FusedRMSNormMLP.apply(x, scale, wg, wu, act, eps)


FUNCTIONS = {"flash_attention": FlashAttention, "ssd_scan": SSDScan,
             "fused_rmsnorm_mlp": FusedRMSNormMLP}


def reset_counts() -> None:
    """Every Function's ``backward_calls`` to 0."""
    for fn in FUNCTIONS.values():
        fn.backward_calls = 0
