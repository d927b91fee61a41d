"""Cost accounting for the roofline: FLOPs by operator, collective wire
bytes by dispatch, HBM traffic by formula.

The counterpart of the reference's ``launch/costing.py``.  The reference
walks the jaxpr of a step (``jax.make_jaxpr`` on ``ShapeDtypeStruct``\\ s)
and reads collectives from the partitioned HLO text; the port has neither,
so it watches the aten operators a step dispatches:

* **FLOPs** — :func:`flops_of_fn` runs the step under a
  ``TorchDispatchMode`` over ``FakeTensorMode`` tensors on the CPU (no
  memory, no launch; the kernels' plain versions run, which compute what
  the kernels compute).  ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` /
  ``mv`` / ``dot`` count 2·batch·M·N·K (the reference's ``dot_general``
  rule), ``_grouped_mm`` and the port's ``grouped_matmul`` however it runs
  count 2·M·K·N (its ``ragged_dot`` rule), every other operator one FLOP
  per output element, views included, as the jaxpr counts reshapes and
  converts.  The total and the dot part come back apart.  Tracing the
  gradient counts the remat recompute, as the reference's does.
* **Repeated bodies** — the model's loops that the reference writes as
  ``lax.scan`` (the layers, the (q-block, kv-block) rectangles of
  ``attention_chunked``, the SSD chunks) run through
  ``kernels._common.repeat``: under a folding counter one iteration runs
  and counts once per iteration it stands for, forward, backward and
  recompute alike (the nodes it adds to the autograd graph carry the
  multiplier into the backward).  An eager trace of ``prefill_32k`` through
  every rectangle would be ~10^5 operators a layer.
* **A kernel launch while counting is refused**: a wrapper about to launch
  on a CUDA tensor raises and names the kernel (``kernels._common.
  refuse_counting``); the ``ctypes`` launch is invisible to dispatch.
* **Collectives** — :func:`collective_stats` counts the collectives that
  dispatch sees (``_c10d_functional`` and the in-place ``c10d`` ops) with
  the reference's ring wire-byte rule and the size of each op's own group.
  The reference's HLO parser (computations, while-loop trip counts, call
  multipliers) has no counterpart: the port produces no HLO, and an eager
  loop dispatches every iteration's collective as it runs.  The folding
  counter counts them too, at the iteration multipliers, as the parser's
  trip counts do: :func:`placed_step_count` counts one rank's placed step
  (a train step, ``prefill`` or ``decode_step``) on fake tensors over a
  fake process group (``launch.mesh.counting_mesh``) — the dry run's
  collective term, equal op by op to what the same step dispatches on real
  ranks.
* **HBM bytes** — :func:`hbm_bytes`, the reference's formula as it is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import compat


# ---------------------------------------------------------------------------
# FLOP counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _dot_flops(func, args) -> Optional[float]:
    """2·batch·M·N·K of a product operator, ``None`` for any other."""
    packet = getattr(func, "overloadpacket", None)
    if packet in (_aten.mm, _aten.bmm):
        a, b = args[0], args[1]
    elif packet in (_aten.addmm, _aten.baddbmm):
        a, b = args[1], args[2]
    elif packet is _aten.mv:
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1]
    elif packet is _aten.dot:
        return 2.0 * args[0].shape[0]
    elif packet is _aten._grouped_mm:
        # every row of a 2-D ``a`` (or of each group of a 3-D one) meets
        # one slice of ``b``: 2·M·K·N over the rows, as ``ragged_dot``
        return 2.0 * _numel(args[0].shape) * args[1].shape[-1]
    else:
        return None
    batch = _numel(a.shape[:-2])
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


# Allocations leave their values unset: they compute nothing.
_ALLOCATIONS = frozenset(("empty", "new_empty", "empty_like", "empty_strided",
                          "new_empty_strided"))


def _out_elements(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (list, tuple)):
        return sum(_out_elements(o) for o in out)
    return 0


@dataclass
class FlopCount:
    """What :func:`flops_of_fn` returns: the total, the dot products' part
    of it, and the total by aten operator (``"grouped_matmul"`` for the
    port's grouped product)."""
    total: float = 0.0
    dot: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)
    # the collectives dispatched: per-device ring wire bytes and calls by op
    per_op_bytes: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.per_op_bytes.values()))


class _Frame(NamedTuple):
    mult: float      # how many iterations the running code stands for
    seq: int         # autograd sequence number when the frame opened


class _Dispatch(TorchDispatchMode):
    """Counts each operator; ``kernels._common.active_counter`` finds the
    counter by this mode's ``flop_counter`` on the thread's mode stack."""

    def __init__(self, counter: "FlopCounter"):
        super().__init__()
        self.flop_counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.flop_counter._count(func, args, out)
        return out


class _Tagger(TorchFunctionMode):
    """Marks the autograd nodes created inside a folded iteration, so their
    backward counts with the iteration's multiplier."""

    def __init__(self, counter: "FlopCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.counter
        if len(c.frames) > 1 and torch.is_grad_enabled():
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                    c._tag(t.grad_fn)
        return out


class FlopCounter:
    """Counts the FLOPs of the aten operators dispatched inside it (see the
    module docstring).  ``fold`` makes ``kernels._common.repeat`` loops run
    one iteration per class and count it for all of them."""

    _MARK = "repro_torch.fold"

    def __init__(self, fold: bool = True):
        self.fold = fold
        self.count = FlopCount()
        self.frames: List[_Frame] = [_Frame(1.0, 0)]
        self._paused = 0
        self._modes = (_Tagger(self), _Dispatch(self))

    # ----------------------------------------------------------- counting
    @property
    def mult(self) -> float:
        """The top frame's multiplier; at the bottom frame in a backward,
        the one of the node that last ran (the engine adds the gradients a
        node produced into its inputs' buffers after the node's hooks)."""
        if len(self.frames) == 1:
            node = torch._C._current_autograd_node()
            if node is not None:
                return node.metadata.get(self._MARK, 1.0)
        return self.frames[-1].mult

    def _add(self, name: str, flops: float, dot: bool) -> None:
        flops *= self.mult
        self.count.total += flops
        if dot:
            self.count.dot += flops
        self.count.by_op[name] = self.count.by_op.get(name, 0.0) + flops

    def _count(self, func, args, out) -> None:
        if self._paused:
            return
        coll = _collective(func, args, out)
        if coll is not None:
            op, wire = coll
            c = self.count
            c.per_op_bytes[op] = c.per_op_bytes.get(op, 0.0) + wire * self.mult
            c.op_counts[op] = c.op_counts.get(op, 0.0) + self.mult
            return
        dot = _dot_flops(func, args)
        name = str(getattr(func, "overloadpacket", func))
        if name.rpartition(".")[2] in _ALLOCATIONS:
            return
        if dot is not None:
            self._add(name, dot, True)
        else:
            self._add(name, float(_out_elements(out)), False)

    def grouped(self, xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``grouped_matmul(xs, w, offsets)`` counted by the ``ragged_dot``
        rule, 2·M·K·N forward and for each of the two backward products,
        without reading the offsets (no host read); the result is an
        uncounted empty (M, N) tensor in the autograd graph."""
        return _CountedGrouped.apply(xs, w, self)

    # ------------------------------------------------------------- folding
    def _push(self, mult: float) -> None:
        self.frames.append(_Frame(mult, compat.sequence_nr()))

    def _pop(self) -> None:
        self.frames.pop()

    def repeat(self, n: int, key: Optional[Callable[[int], Any]]):
        classes: Dict[Any, List[int]] = {}
        for i in range(n):
            k = key(i) if key is not None else None
            if k in classes:
                classes[k][1] += 1
            else:
                classes[k] = [i, 1]
        for first, count in classes.values():
            self._push(self.mult * count)
            try:
                yield first
            finally:
                self._pop()

    def unfolded(self, outs: list, n: Optional[int]) -> list:
        n = len(outs) if n is None else n
        done = [o for o in outs if o is not None]
        outs = list(outs) + [None] * (n - len(outs))
        self._paused += 1
        try:
            with torch.no_grad():
                return [o if o is not None else torch.empty_like(done[0])
                        for o in outs]
        finally:
            self._paused -= 1

    def _tag(self, node) -> None:
        """Give every untagged node made since the current frame opened
        hooks that run its backward (and any recompute in it) at the
        frame's multiplier."""
        frame = self.frames[-1]
        todo = [node]
        while todo:
            nd = todo.pop()
            if nd is None or self._MARK in nd.metadata \
                    or type(nd).__name__ == "AccumulateGrad" \
                    or compat.node_sequence_nr(nd) < frame.seq:
                continue
            nd.metadata[self._MARK] = frame.mult
            mult = frame.mult
            nd.register_prehook(lambda g, m=mult: self._push(m))
            nd.register_hook(lambda gi, go: self._pop())
            todo.extend(f for f, _ in nd.next_functions)

    # --------------------------------------------------------------- scope
    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


class _CountedGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w, counter):
        ctx.counter = counter
        ctx.save_for_backward(xs, w)
        M, K = xs.shape
        counter._add("grouped_matmul", 2.0 * M * K * w.shape[-1], True)
        counter._paused += 1
        try:
            return xs.new_empty((M, w.shape[-1]))
        finally:
            counter._paused -= 1

    @staticmethod
    def backward(ctx, g):
        xs, w = ctx.saved_tensors
        c = ctx.counter
        M, K = xs.shape
        c._add("grouped_matmul", 2.0 * 2.0 * M * K * w.shape[-1], True)
        c._paused += 1
        try:
            return torch.empty_like(xs), torch.empty_like(w), None
        finally:
            c._paused -= 1


def _abstract(x, mode):
    """A fake tensor standing for ``x``: meta tensors become fakes on the
    CPU (where the plain versions run), real tensors fakes on their own
    device; anything else (and trees of it) as it is."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "meta":
            with mode:
                t = torch.empty(x.shape, dtype=x.dtype, device="cpu")
            return t.requires_grad_(x.requires_grad)
        return mode.from_tensor(x)
    if isinstance(x, dict):
        return {k: _abstract(v, mode) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_abstract(v, mode) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_abstract(v, mode) for v in x)
    return x


def flops_of_fn(fn: Callable, *args, fold: bool = True, **kwargs
                ) -> FlopCount:
    """Count the FLOPs of ``fn(*args, **kwargs)`` on abstract tensors.

    Tensor arguments (in dicts, lists, tuples) may be ``meta`` tensors
    (``models.params.abstract_params``), which become fakes on the CPU, or
    real ones, which become fakes on their device (no data is read).
    Nothing is allocated and nothing is launched: a hand-written kernel
    about to launch on a CUDA tensor raises instead.  ``fold=False`` runs
    every iteration of every ``repeat`` loop."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    a_args, a_kwargs = _abstract(args, mode), _abstract(kwargs, mode)
    counter = FlopCounter(fold=fold)
    with mode, counter:
        fn(*a_args, **a_kwargs)
    return counter.count


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# The wire rule of each collective that dispatch sees: the functional ops
# return their result; the in-place ones write it into their first
# argument (``allreduce_`` reduces its input list in place).
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_INPLACE = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
            "allgather_": "all-gather",
            "_reduce_scatter_base_": "reduce-scatter",
            "alltoall_base_": "all-to-all"}


def _wire_bytes(op: str, result_bytes: int, n: int) -> float:
    """Per-device ring-algorithm wire bytes, from the op's RESULT bytes."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return (n - 1) * result_bytes          # operand = n x result
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    if op == "collective-permute":
        return float(result_bytes)
    return 0.0


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


def _group_size_of(args) -> int:
    """The size of the op's own process group: by name for the functional
    ops (the last string argument), from the ``ProcessGroup`` object for
    the in-place ones (as the reference reads ``replica_groups``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:          # a ReduceOp, not the group
                continue
    names = [a for a in args if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def _collective(func, args, out):
    """``(op, per-device wire bytes)`` of a collective operator, ``None``
    for any other."""
    ns = getattr(func, "namespace", "")
    name = func.overloadpacket.__name__ if hasattr(
        func, "overloadpacket") else ""
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        op, result = _FUNCTIONAL[name], out
    elif ns == "c10d" and name in _INPLACE:
        op, result = _INPLACE[name], args[0]
    else:
        return None
    return op, _wire_bytes(op, _bytes(result), _group_size_of(args))


class _Collectives(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.per_op: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        coll = _collective(func, args, out)
        if coll is not None:
            op, wb = coll
            self.per_op[op] = self.per_op.get(op, 0.0) + wb
            self.counts[op] = self.counts.get(op, 0) + 1
        return out


def collective_stats(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Per-device collective wire bytes of ``fn(*args, **kwargs)``: every
    collective it dispatches, at the ring rule of its own group's size.
    Returns ``collective_bytes``, ``per_op_bytes`` and ``op_counts``, the
    reference's keys."""
    mode = _Collectives()
    with mode:
        fn(*args, **kwargs)
    return {"collective_bytes": sum(mode.per_op.values()),
            "per_op_bytes": dict(mode.per_op), "op_counts": dict(mode.counts)}


def placed_inputs(lm, kind: str, batch: int, seq_len: int, mesh, plan,
                  rules_override: Optional[Dict] = None,
                  device="cpu") -> tuple:
    """The arguments of one rank's placed step on ``mesh`` (a
    ``ProcessMesh``; call under ``FakeTensorMode`` for fakes): the
    parameters placed by the plan's rules (``rules_override`` on top, the
    dry run's expert parallelism), and for ``kind`` ``"train"`` the AdamW
    state placed alike, this rank's rows of a ``batch`` x ``seq_len``
    batch and the C3 counters; ``"prefill"`` this rank's rows of the
    prompts; ``"decode"`` the placed cache of a ``seq_len`` context
    (``launch.specs.place_cache``) and this rank's rows of one token.  The
    values are zeros (only their shapes, and the layout, matter here)."""
    from repro_torch.core.monitor import init_counters
    from repro_torch.core.replication import merged_rules
    from repro_torch.launch.mesh import PartitionSpec
    from repro_torch.launch.specs import cache_specs, place_cache
    from repro_torch.models.params import (place_params, shardings_for,
                                           tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.optim import adamw
    from repro_torch.parallel import placement as PL
    from repro_torch.parallel.collectives import axis_size
    rules = merged_rules(plan, mesh)
    rules.update(rules_override or {})
    rules = {k: (v if all(a in mesh.axis_names for a in PL.entry_axes(v))
                 else None) for k, v in rules.items()}
    full = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), lm.param_specs())
    params = place_params(full, shardings_for(lm.param_specs(), rules, mesh))
    rows = batch // axis_size(lm.rows_axes(mesh), mesh)
    tok = torch.zeros((rows, seq_len if kind != "decode" else 1),
                      dtype=torch.int32, device=device)
    if kind == "train":
        return (params, adamw.init(params), {"tokens": tok, "labels": tok},
                init_counters(plan, device))
    if kind == "prefill":
        return params, tok
    whole = lm.init_cache(batch, seq_len, device=device)
    specs = tree_leaves(cache_specs(lm, batch, lm._window(seq_len), mesh),
                        lambda x: isinstance(x, PartitionSpec))
    blocks = tree_unflatten(whole, [
        PL.local_block(t, sp, mesh).contiguous()
        for t, sp in zip(tree_leaves(whole, torch.is_tensor), specs)])
    return params, place_cache(lm, blocks, mesh, lm._window(seq_len)), tok


def placed_step(lm, kind: str, plan, mesh, tc=None) -> Callable:
    """One rank's placed step of ``kind`` (``make_train_step``'s, ``LM.
    prefill`` or ``LM.decode_step``), taking :func:`placed_inputs`'s
    arguments."""
    if kind == "train":
        from repro_torch.runtime.train import TrainConfig, make_train_step
        return make_train_step(lm, plan, mesh, tc or TrainConfig())
    if kind == "prefill":
        return lambda p, t: lm.prefill(p, t)
    return lambda p, c, t: lm.decode_step(p, c, t)


def placed_step_count(lm, kind: str, batch: int, seq_len: int, mesh, plan,
                      *, tc=None, rules_override=None,
                      fold: bool = True) -> FlopCount:
    """One rank's placed step (:func:`placed_step`) counted on fake
    tensors: its collectives (``per_op_bytes``, ``op_counts``) and its
    FLOPs, ``repeat`` loops folded.  ``mesh`` is a ``ProcessMesh``, a fake
    one (``launch.mesh.counting_mesh``) for a mesh of any size in one
    process.  Nothing is allocated and nothing is read back: the step's
    host reads (the trainer's logging loop) are not in it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        args = placed_inputs(lm, kind, batch, seq_len, mesh, plan,
                             rules_override)
    step = placed_step(lm, kind, plan, mesh, tc)
    counter = FlopCounter(fold=fold)
    with mode, counter:
        step(*args)
    return counter.count


# ---------------------------------------------------------------------------
# Analytic HBM traffic (roofline memory term)
# ---------------------------------------------------------------------------


def hbm_bytes(cfg, shape, *, remat: bool = True, mra_k: int = 1,
              kv_int8: bool = False) -> float:
    """Whole-step HBM traffic estimate across all chips (bytes).

    train  : params read (fwd+bwd) + grads + AdamW m/v read+write + param
             write + activation residual traffic under full remat.
    prefill: params read + activation stream + KV-cache write.
    decode : params read + full KV/state read + small writes.
    """
    P = cfg.n_params()
    Pa = cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.n_layers
    tok = B * S

    if shape.kind == "train":
        w = 2 * Pa * 2 + P * 2          # fwd+bwd reads (bf16) active; + grads
        opt = P * (4 + 4) * 2 + P * 2   # m,v read+write (f32) + param write
        act = 6 * L * tok * d * 2       # residual save + bwd read + recompute
        emb = 3 * tok * d * 2
        return float(w + opt + act + emb)
    if shape.kind == "prefill":
        w = Pa * 2
        act = 4 * L * tok * d * 2
        if cfg.family in ("ssm", "hybrid"):
            kv = ssm_state_bytes(cfg, B)
            if cfg.family == "hybrid" and cfg.shared_attn_every:
                napps = -(-L // cfg.shared_attn_every)
                kv += napps * tok * 2 * cfg.n_kv_heads * cfg.head_dim * 2
        else:
            kv = _kv_bytes_per_pos(cfg) * tok
        return float(w + act + kv)
    # decode: one token, full cache/state sweep (read + write-back).
    # MoE at batch >= E/top_k touches essentially every expert, so decode
    # reads the FULL weight set; MRA replication multiplies resident weight
    # reads by K (each replica group sweeps its own copy) — the paper's
    # area<->throughput trade, visible in the memory term.
    w = (P if (cfg.family == "moe"
               and shape.global_batch * cfg.top_k >= cfg.n_experts)
         else Pa) * 2 * max(mra_k, 1)
    if cfg.family in ("ssm", "hybrid"):
        kv = 2 * ssm_state_bytes(cfg, B)          # state read + write
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            napps = -(-cfg.n_layers // cfg.shared_attn_every)
            win = min(S, 4096)                    # windowed shared-attn cache
            kv += napps * B * win * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    else:
        kv = _kv_bytes_per_pos(cfg) * B * _ctx_len(cfg, S)
    if kv_int8:
        kv *= 0.5                       # int8 cache vs bf16
    act = 4 * L * B * d * 2
    return float(w + kv + act)


def _ctx_len(cfg, S: int) -> int:
    if cfg.sliding_window:
        return min(S, cfg.sliding_window)
    return S


def _kv_bytes_per_pos(cfg) -> float:
    """KV cache bytes per cached position, whole layer stack."""
    if cfg.attn_type == "mla":
        return cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2


def ssm_state_bytes(cfg, batch: int) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    nh, st, hd = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv = 3 * cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_state)
    return float(cfg.n_layers * batch * (nh * st * hd * 4 + conv))
