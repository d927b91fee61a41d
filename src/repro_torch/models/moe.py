"""Mixture-of-Experts FFN of the port: dropless sort-and-group dispatch.

Mirrors ``repro/models/moe.py`` on one device.  A token's router logits
(float32) pick its ``top_k`` experts, ties broken to the lower expert index
as ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
keeps no such order).  The ``(token, slot)`` rows are sorted by expert
(stable), gathered, and the three expert products run as grouped products
over the sorted rows (the reference's ``jax.lax.ragged_dot``), each group's
rows against its expert's weights.  Gates weight the rows in the
activations' dtype, as in the reference; the ``k`` rows of a token are then
brought back by the inverse permutation and summed in float32, cast once —
no atomics, so the sum is the same from run to run (the reference adds the
rows into a zero tensor of the activations' dtype; ROADMAP queue C records
the difference).

The gathers are ``index_select`` (their backward an ``index_add_``, no host
read).  Nothing of the dispatch waits for the card: the group ends are
counted with ``scatter_add_`` (no ``bincount``, whose CUDA version reads the
input's maximum to the host) and handed to the grouped product as a device
tensor.
:func:`grouped_matmul` runs ``torch._grouped_mm`` on CUDA bf16 operands and
the per-expert loop :func:`grouped_matmul_plain` otherwise; the loop reads
the group ends to the host, once per layer under ``experts="loop"``.

Expert parallelism under a mesh (the reference's ``_moe_ep_shard``) waits
for ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._common import active_counter
from repro_torch.models.layers import _act, mlp_apply
from repro_torch.models.params import spec

EXPERTS = ("grouped", "loop")    # moe_apply's expert products


def moe_spec(cfg: ArchConfig):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": spec((d, E), ("embed", "experts"), dtype=torch.float32),
        "wi_gate": spec((E, d, f), ("experts", "embed", "expert_ff")),
        "wi_up": spec((E, d, f), ("experts", "embed", "expert_ff")),
        "wo": spec((E, f, d), ("experts", "expert_ff", "embed"), init="small"),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        out["shared"] = {
            "wi_gate": spec((d, fs), ("embed", "ff")),
            "wi_up": spec((d, fs), ("embed", "ff")),
            "wo": spec((fs, d), ("ff", "embed"), init="small"),
        }
    return out


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices, in
    ``jax.lax.top_k``'s order: descending, equal values by lower index."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(router_w: torch.Tensor, x: torch.Tensor, k: int):
    """Token -> expert assignment.  x: (N, d).  Returns gates (N, k) float32,
    ids (N, k) int64 and the logits (N, E) float32."""
    logits = x.float() @ router_w.float()
    top_logits, top_ids = top_k(logits, k)
    gates = torch.softmax(top_logits, dim=-1)
    return gates, top_ids, logits


def group_offsets(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(n_experts,) int32 cumulative group ends of the rows sorted by expert
    (``jnp.bincount(flat_ids, length=E)`` summed up), counted on the device
    with ``scatter_add_``: no host read."""
    counts = torch.zeros(n_experts, dtype=torch.int32, device=flat_ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids,
                                                     dtype=torch.int32))
    return torch.cumsum(counts, 0, dtype=torch.int32)


def load_balance_loss(logits: torch.Tensor, top_ids: torch.Tensor,
                      n_experts: int, k: int) -> torch.Tensor:
    """Switch-style load-balance aux loss (fraction x probability per
    expert), float32, as the reference's ``_moe_ffn_local`` computes it."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(top_ids, n_experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(frac * probs.mean(dim=0)) * k


# ---------------------------------------------------------------------------
# Grouped expert products
# ---------------------------------------------------------------------------


def grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor,
                         offsets) -> torch.Tensor:
    """The per-expert loop: rows ``offsets[e-1]:offsets[e]`` of ``xs``
    (M, K) times ``w[e]`` (K, N), joined by one ``torch.cat`` (no write in
    place, so autograd follows it); an empty group is skipped.  ``offsets``
    as a tensor is read to the host (one sync per call on a card); a list
    of ints is taken as it is."""
    if torch.is_tensor(offsets):
        offsets = offsets.tolist()
    parts, start = [], 0
    for e, end in enumerate(offsets):
        if end > start:
            parts.append(xs[start:end] @ w[e])
        start = end
    if start < xs.shape[0] or not parts:     # rows after the last group
        parts.append(xs.new_zeros((xs.shape[0] - start, w.shape[-1])))
    return torch.cat(parts)


def _variant(xs: torch.Tensor, w: torch.Tensor) -> str:
    if xs.is_cuda and xs.dtype == w.dtype == torch.bfloat16:
        return "grouped_mm"
    return "loop"


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Grouped product (the reference's ``jax.lax.ragged_dot``): xs (M, K)
    rows sorted by group, w (E, K, N), offsets (E,) int32 cumulative group
    ends.  CUDA bf16 operands run ``torch._grouped_mm`` (no host read; its
    backward is PyTorch's, two more grouped products); anything else the
    loop :func:`grouped_matmul_plain`.  The choice, made
    from the device and dtypes alone, is ``grouped_matmul.last_variant``."""
    counter = active_counter()
    if counter is not None:       # counted by the ragged_dot rule, no read
        return counter.grouped(xs, w)
    variant = _variant(xs, w)
    grouped_matmul.last_variant = variant
    if variant == "grouped_mm":
        return torch._grouped_mm(xs, w, offs=offsets)
    return grouped_matmul_plain(xs, w, offsets)


grouped_matmul.last_variant = None


def expert_ffn(xs: torch.Tensor, p: Dict, offsets, act: str,
               gmm=grouped_matmul) -> torch.Tensor:
    """The gated expert MLP over rows sorted by expert: three grouped
    products through ``gmm`` (``grouped_matmul``, or the plain loop, which
    also takes the offsets as a list)."""
    h = _act(gmm(xs, p["wi_gate"], offsets), act)
    h = h * gmm(xs, p["wi_up"], offsets)
    return gmm(h, p["wo"], offsets)


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------


def _moe_ffn_local(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                   experts: str = "grouped"):
    """Dropless MoE over x (N, d).  Returns (out (N, d) in x's dtype, the
    router logits (N, E), the expert ids (N, k))."""
    N, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gates, top_ids, logits = _route(p["router"], x, k)

    # flatten (token, slot) pairs and sort by expert (stable)
    flat_ids = top_ids.reshape(-1)                        # (N*k,)
    sort_idx = torch.argsort(flat_ids, stable=True)
    xs = x.index_select(0, sort_idx // k)                 # (N*k, d)
    offsets = group_offsets(flat_ids, E)
    if experts == "grouped" or active_counter() is not None:
        ys = expert_ffn(xs, p, offsets, cfg.act)
    else:           # the loop reads the offsets once for its three products
        ys = expert_ffn(xs, p, offsets.tolist(), cfg.act,
                        grouped_matmul_plain)

    gate_sorted = gates.reshape(-1).index_select(0, sort_idx)
    ys = ys * gate_sorted[:, None].to(ys.dtype)
    # back to (token, slot) order; the k rows of a token summed in float32
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(N * k, device=x.device))
    out = ys.index_select(0, inv).reshape(N, k, d).sum(
        dim=1, dtype=torch.float32).to(ys.dtype)
    return out, logits, top_ids


def moe_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, mesh=None,
              ep: bool = False, model_axes=None, *, experts: str = "grouped",
              aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MoE FFN over x (B, S, d), plus the shared experts where the config
    has them.  Returns (out (B, S, d), the load-balance aux loss; ``None``
    with ``aux=False``, as the serving path asks).  ``experts``: the expert
    products through :func:`grouped_matmul` (``"grouped"``) or the
    per-expert loop (``"loop"``)."""
    if mesh is not None or ep or model_axes is not None:
        raise NotImplementedError(
            f"mesh={mesh!r}, ep={ep!r}, model_axes={model_axes!r}: "
            "multi-device sharding is not ported yet (ROADMAP queue A item "
            "12)")
    if experts not in EXPERTS:
        raise ValueError(f"experts={experts!r}; one of {EXPERTS}")
    B, S, d = x.shape
    routed = {k: v for k, v in p.items() if k != "shared"}
    out, logits, top_ids = _moe_ffn_local(routed, x.reshape(B * S, d), cfg,
                                          experts)
    out = out.reshape(B, S, d)
    # the loss before the shared experts: a checkpoint's recompute runs the
    # forward only up to the last tensor its backward saved, so the shared
    # experts' last product, whose output no backward reads, then stays out
    # of it (as the reference's remat drops it)
    loss = (load_balance_loss(logits, top_ids, cfg.n_experts, cfg.top_k)
            if aux else None)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, loss
