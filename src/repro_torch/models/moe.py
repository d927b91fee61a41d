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

Under a mesh (``mesh=`` or the ambient one, a
:class:`~repro_torch.launch.mesh.ProcessMesh`) each rank runs the
reference's ``shard_map`` body on its shard, with the collectives of
:mod:`repro_torch.parallel`; inputs and outputs are the global (replicated)
tensors, as a ``shard_map`` takes and returns global arrays:

* expert-TP (the default): tokens split over the data axes, every expert's
  ``wi_gate`` / ``wi_up`` split on F over the model axis and ``wo`` on its
  rows, routing local to each data shard, the output ``psum``-ed over the
  model axis and gathered over the data axes, ``aux`` the ``pmean`` of the
  shards' losses;
* expert-parallel (``ep=True``, :func:`_moe_ep_shard`): GShard's
  capacity-bounded all-to-all dispatch with the reference's first-come
  slot order, the grouped expert products over the received rows, the
  mirror all-to-all back and the gate-weighted sum at the origin.

Gradients: the router, the expert weights and the tokens enter both paths
through ``replicated`` over the axes the body is split on, so every rank
ends with the whole gradient of each global tensor (the ranks' partial
gradients summed, as the transpose of the reference's ``shard_map`` sums
them), as the unsharded layer's backward gives it.  Under placed
parameters (``blocks=True``) the expert weights come in as this rank's
blocks (:func:`expert_specs`), and their gradients stay this rank's
blocks: no expert weight or its gradient crosses the wire.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._common import active_counter
from repro_torch.launch.mesh import get_mesh
from repro_torch.models.layers import DATA, _act, mlp_apply
from repro_torch.models.params import get_batch_axes, shard_activation, spec
from repro_torch.parallel import collectives as C

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
        offsets = offsets.tolist()  # repro: noqa[TPR001] the plain loop's group ends: it slices on the host
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
        return compat.grouped_mm(xs, w, offsets)
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
        ys = expert_ffn(xs, p, offsets.tolist(), cfg.act,  # repro: noqa[TPR001] experts="loop" (the plain path) reads the group ends once for its three products; "grouped" reads nothing
                        grouped_matmul_plain)

    gate_sorted = gates.reshape(-1).index_select(0, sort_idx)
    ys = ys * gate_sorted[:, None].to(ys.dtype)
    # back to (token, slot) order; the k rows of a token summed in float32
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(N * k, device=x.device))
    out = ys.index_select(0, inv).reshape(N, k, d).sum(
        dim=1, dtype=torch.float32).to(ys.dtype)
    return out, logits, top_ids


def _shard_rows(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """This rank's equal slice of ``x``'s leading axis over ``axes``."""
    n, i = C.axis_size(axes, mesh), C.axis_index(axes, mesh)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} tokens do not split over {n} "
                         f"shards of {axes}")
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def _gather_rows(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The ranks' row slices over ``axes`` joined back in order."""
    if not axes:
        return x
    g = C.all_gather(x, axes, mesh)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def ep_slots(flat_ids: torch.Tensor, e_loc: int, m: int, capacity: int):
    """GShard's dispatch plan of a shard's ``(token, slot)`` rows (flat
    expert ids, in flat order): each row goes to shard ``id // e_loc`` at
    its position in that shard's bucket in first-come order (the exclusive
    running count of earlier rows with the same destination).  Returns
    whether it fits (``keep``: position < ``capacity``) and its send slot
    (``m * capacity``, one past the buffer, for a dropped row)."""
    dest = torch.div(flat_ids, e_loc, rounding_mode="floor")
    onehot = F.one_hot(dest, m).to(torch.int64)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1)
    keep = pos < capacity
    return keep, torch.where(keep, dest * capacity + pos, m * capacity)


def _moe_ep_shard(pp: Dict, x: torch.Tensor, cfg: ArchConfig, *, mesh,
                  model_axis: str, capacity: int, experts: str = "grouped"):
    """The reference's GShard expert-parallel body on one rank: ``x`` (n, d)
    this rank's tokens, ``pp`` the router and this rank's ``E / m``
    complete experts.  Returns (out (n, d), the shard's aux loss, the
    ``keep`` mask of its ``(token, slot)`` rows)."""
    m = C.axis_size(model_axis, mesh)
    E, k = cfg.n_experts, cfg.top_k
    e_loc = E // m
    n, d = x.shape
    cap = capacity
    gates, top_ids, logits = _route(pp["router"], x, k)
    flat_ids = top_ids.reshape(-1)                         # (n*k,)
    keep, slot = ep_slots(flat_ids, e_loc, m, cap)
    tok_of_row = torch.arange(n * k, device=x.device) // k
    # one row past the buffer takes the dropped rows, then is cut off
    send = x.new_zeros((m * cap + 1, d)).index_copy(
        0, slot, x.index_select(0, tok_of_row))[:m * cap]
    send_eid = torch.zeros(m * cap + 1, dtype=torch.int64,
                           device=x.device).index_copy(
        0, slot, flat_ids % e_loc)[:m * cap]     # empty slots: expert 0 of
    #                                   zero rows, whose output is zero
    recv = C.all_to_all(send.reshape(m, cap, d), model_axis,
                        mesh).reshape(m * cap, d)
    eids = C.all_to_all(send_eid.reshape(m, cap), model_axis,
                        mesh).reshape(m * cap)
    sort_idx = torch.argsort(eids, stable=True)
    rows = recv.index_select(0, sort_idx)
    offsets = group_offsets(eids, e_loc)
    if experts == "grouped" or active_counter() is not None:
        y = expert_ffn(rows, pp, offsets, cfg.act)
    else:
        y = expert_ffn(rows, pp, offsets.tolist(), cfg.act,  # repro: noqa[TPR001] experts="loop" (the plain path) reads the group ends once for its three products; "grouped" reads nothing
                       grouped_matmul_plain)
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(m * cap, device=x.device))
    y = y.index_select(0, inv)                             # back to slots
    back = C.all_to_all(y.reshape(m, cap, d), model_axis,
                        mesh).reshape(m * cap, d)
    y_rows = back.index_select(0, torch.clamp(slot, max=m * cap - 1))
    w = (gates.reshape(-1) * keep).to(y_rows.dtype)
    y_rows = torch.where(keep[:, None], y_rows, 0.0) * w[:, None]
    out = y_rows.reshape(n, k, d).sum(dim=1, dtype=torch.float32).to(
        y_rows.dtype)
    aux = load_balance_loss(logits, top_ids, E, k)
    return out, aux, keep


def _model_axis(mesh, model_axes):
    """The expert / F shard axis: ``model_axes`` if given, else "model" on
    the production mesh, "shard" on an MRA-factored one, else ``None``."""
    if model_axes is not None:
        return model_axes
    names = mesh.axis_names
    return "model" if "model" in names else (
        "shard" if "shard" in names else None)


def _data_axes(mesh, mx, batch_axes):
    """The batch axes the body splits the tokens over (not the model's)."""
    mx_set = set(mx) if isinstance(mx, tuple) else {mx}
    if batch_axes is None:
        batch_axes = get_batch_axes()
    return tuple(a for a in batch_axes
                 if a in mesh.axis_names and a not in mx_set)


def _ep_fits(cfg: ArchConfig, mesh, ep, mx, n_tokens: int, dp) -> bool:
    """Whether the expert-parallel path runs: asked for, one model axis
    that splits the experts, and tokens that split over the shards."""
    return bool(ep) and not isinstance(mx, tuple) \
        and cfg.n_experts % mesh.shape[mx] == 0 \
        and n_tokens % C.axis_size(dp + (mx,), mesh) == 0


def expert_specs(cfg: ArchConfig, mesh, ep: bool = False, model_axes=None,
                 n_tokens: int = 0, batch_axes=None) -> Dict:
    """The specs of the blocks of ``wi_gate`` / ``wi_up`` / ``wo`` that
    :func:`moe_apply`'s mesh path reads on each rank for ``n_tokens``
    tokens: ``E / m`` whole experts under expert parallelism, else every
    expert's columns of F (rows for ``wo``) over the model axis; whole
    without a model axis."""
    from repro_torch.launch.mesh import PartitionSpec as P
    mx = _model_axis(mesh, model_axes) if mesh.axis_names else None
    if not mx:
        return {w: P() for w in ("wi_gate", "wi_up", "wo")}
    if _ep_fits(cfg, mesh, ep, mx, n_tokens,
                _data_axes(mesh, mx, batch_axes)):
        return {w: P(mx, None, None) for w in ("wi_gate", "wi_up", "wo")}
    return {"wi_gate": P(None, None, mx), "wi_up": P(None, None, mx),
            "wo": P(None, mx, None)}


def _moe_mesh(routed: Dict, cfg: ArchConfig, xf: torch.Tensor, mesh, ep,
              mx, experts: str, aux: bool, batch_axes=None,
              blocks: bool = False):
    """The mesh paths of :func:`moe_apply` over the flat tokens ``xf``:
    (out (N, d) on every rank, the aux loss or ``None``).  ``blocks``: the
    expert weights are already this rank's blocks (:func:`expert_specs`)."""
    dp = _data_axes(mesh, mx, batch_axes)
    # each rank reads a part of these global tensors: their gradients are
    # summed over every axis the body is split on
    split = dp + (mx if isinstance(mx, tuple) else (mx,))
    routed = {k: v if blocks and k != "router" else
              C.replicated(v, split, mesh) for k, v in routed.items()}
    xf = C.replicated(xf, split, mesh)
    N = xf.shape[0]
    if _ep_fits(cfg, mesh, ep, mx, N, dp):
        all_axes = dp + (mx,)
        m = mesh.shape[mx]
        n_loc = N // C.axis_size(all_axes, mesh)
        capacity = max(1, int(math.ceil(n_loc * cfg.top_k / m
                                        * cfg.capacity_factor)))
        e0 = C.axis_index(mx, mesh) * (cfg.n_experts // m)
        e1 = e0 + cfg.n_experts // m
        pp = {"router": routed["router"],
              **{w: routed[w] if blocks else routed[w][e0:e1]
                 for w in ("wi_gate", "wi_up", "wo")}}
        out, loss, _ = _moe_ep_shard(
            pp, _shard_rows(xf, all_axes, mesh), cfg, mesh=mesh,
            model_axis=mx, capacity=capacity, experts=experts)
        loss = C.pmean(loss, all_axes, mesh) if aux else None
        return _gather_rows(out, all_axes, mesh), loss
    # expert-TP: F split over the model axis, tokens over the data axes
    nf, fi = C.axis_size(mx, mesh), C.axis_index(mx, mesh)
    F_ = cfg.d_ff_expert
    if F_ % nf:
        raise ValueError(f"d_ff_expert {F_} does not split over {nf} "
                         f"shards of {mx}")
    f0, f1 = fi * (F_ // nf), (fi + 1) * (F_ // nf)
    pp = {"router": routed["router"]}
    if blocks:
        pp.update({w: routed[w] for w in ("wi_gate", "wi_up", "wo")})
    else:
        pp.update(wi_gate=routed["wi_gate"][:, :, f0:f1],
                  wi_up=routed["wi_up"][:, :, f0:f1],
                  wo=routed["wo"][:, f0:f1])
    x_loc = _shard_rows(xf, dp, mesh) if dp else xf
    out, logits, top_ids = _moe_ffn_local(pp, x_loc, cfg, experts)
    out = C.psum(out, mx, mesh)
    loss = None
    if aux:
        loss = C.pmean(load_balance_loss(logits, top_ids, cfg.n_experts,
                                         cfg.top_k), mx, mesh)
        if dp:
            loss = C.pmean(loss, dp, mesh)
    return _gather_rows(out, dp, mesh), loss


def moe_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, mesh=None,
              ep: bool = False, model_axes=None, *, experts: str = "grouped",
              aux: bool = True, batch_axes=None, blocks: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MoE FFN over x (B, S, d), plus the shared experts where the config
    has them.  Returns (out (B, S, d), the load-balance aux loss; ``None``
    with ``aux=False``, as the serving path asks).  ``experts``: the expert
    products through :func:`grouped_matmul` (``"grouped"``) or the
    per-expert loop (``"loop"``).

    ``mesh`` (or the ambient :func:`~repro_torch.launch.mesh.get_mesh`)
    with a model axis (``model_axes``, else "model" or "shard") takes the
    reference's ``shard_map`` paths on every rank: expert-TP, or GShard
    expert parallelism with ``ep=True`` where the experts and the tokens
    split evenly (see the module docstring); ``x`` and the output are the
    global tensors, the same on every rank.  Without one (a mesh object
    with no named axes included) the single-device path runs, whatever
    ``ep`` / ``model_axes`` say, as in the reference.  ``batch_axes``
    (default ``params.get_batch_axes()``) are the axes the body splits the
    tokens over; ``()`` when ``x`` is already a rank's share of the batch
    (the model under placed parameters).  ``blocks``: ``p``'s expert
    weights are this rank's blocks of :func:`expert_specs` (placed
    parameters), not the global tensors."""
    if experts not in EXPERTS:
        raise ValueError(f"experts={experts!r}; one of {EXPERTS}")
    B, S, d = x.shape
    routed = {k: v for k, v in p.items() if k != "shared"}
    if mesh is None:
        mesh = get_mesh()
    names = tuple(getattr(mesh, "axis_names", ()) or ())
    mx = _model_axis(mesh, model_axes) if names else None
    if names and mx:
        out, loss = _moe_mesh(routed, cfg, x.reshape(B * S, d), mesh, ep,
                              mx, experts, aux, batch_axes, blocks)
        # the reference's output constraint after its expert-parallel body
        out = shard_activation(out.reshape(B, S, d), DATA, None, None)
        if cfg.n_shared_experts:
            out = out + mlp_apply(p["shared"], x, cfg.act)
        return out, loss
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
