"""The port's cost model (``repro_torch.launch.costing``) against the
reference's (``repro.launch.costing``).

The FLOP counter of the port watches aten operators on fake tensors; the
reference walks the jaxpr.  Both count a product as 2·batch·M·N·K (a
grouped one as 2·M·K·N) and any other operation as one FLOP per output
element.  The dot parts are compared with this file's own jaxpr walker
(:func:`ref_flops`), which multiplies scan bodies by their length as the
reference's ``flops_of_jaxpr`` does, with three differences, each a
difference of lowering and not of the work the step does:

* a ``dot_general`` that contracts nothing, or whose both sides keep no
  free dimension, is an elementwise product (a three-operand ``einsum``
  lowers its elementwise factor that way, and its transpose to a batched
  vector dot); torch computes the same products with ``mul`` and ``sum``,
  so the walker counts it with the elementwise operations;
* ``ragged_dot_general`` (the transposes of ``ragged_dot`` in the
  gradient) counts 2·M·K·N like ``ragged_dot``; the reference's counter
  counts it one per output element;
* a ``cond`` (the hybrid family's shared tile, taken every
  ``shared_attn_every``-th layer) counts its larger branch at the share of
  layers that take it; the reference's counter counts it on every layer.

Forward steps (prefill, decode) agree exactly in the dot part, and so do
the train steps of the dense and moe families.  The ssm and hybrid train
steps agree within 2 %: the reference's scan differentiates every carry,
the SSD state's zero start included, where the port's autograd skips a
product whose result needs no gradient (at one SSD chunk the chunk states
only feed the final state, which the loss never reads, and the gap is 4 %;
the ssm and hybrid train cases run four chunks, where it is one chunk's
state product, < 1 %).
Totals differ more: torch and XLA split a step into different elementwise
operators (views, casts, the gradient buffers the autograd engine adds),
and the port's layer loop takes each layer's parameters as views of the
stacked ones, which the reference's scan slices without an operation; at
a two-row decode those views weigh as much as the products.  Totals are
held within 60 % of the walker's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import shapes_for as ref_shapes_for
from repro.configs.base import LM_SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RShape
from repro.core.tiles import default_plan as ref_plan
from repro.launch import costing as RC
from repro.launch import specs as RSP
from repro.models.layers import AttnOptions as RAttn
from repro.models.params import abstract_params as ref_abstract
from repro.models.transformer import LM as RLM
from repro.runtime.train import TrainConfig as RTrain
from repro.runtime.train import make_train_step as ref_train_step
from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for
from repro_torch.configs.base import LM_SHAPES, ShapeConfig
from repro_torch.core.tiles import default_plan
from repro_torch.kernels import _common
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import flash_decode as PFD
from repro_torch.kernels import fused_mlp as PFM
from repro_torch.kernels import ops as POPS
from repro_torch.kernels import ssd_scan as PSS
from repro_torch.launch import costing as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.models.layers import AttnOptions
from repro_torch.models.transformer import LM

META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------ the jaxpr walker
def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if hasattr(x, "eqns"):
                yield x
            elif hasattr(x, "jaxpr") and hasattr(x.jaxpr, "eqns"):
                yield x.jaxpr


def _contracting(eqn) -> bool:
    lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    m = np.prod([lhs[i] for i in range(len(lhs)) if i not in lc + lb])
    n = np.prod([rhs[i] for i in range(len(rhs)) if i not in rc + rb])
    return bool(lc) and (m > 1 or n > 1)


def ref_flops(jaxpr, mult=1.0, cond_share=1.0):
    """(total, dot) of a jaxpr by the rules in the module docstring."""
    total = dot = 0.0
    for e in jaxpr.eqns:
        p = e.primitive.name
        f = None
        if p == "dot_general" and _contracting(e):
            f = RC._dot_flops(e)
        elif p == "ragged_dot":
            f = RC._ragged_dot_flops(e)
        elif p == "ragged_dot_general":
            lhs, out = e.invars[0].aval.shape, e.outvars[0].aval.shape
            kn = lhs[1] * out[-1] if len(out) == 2 else out[-2] * out[-1]
            f = 2.0 * lhs[0] * kn
        if f is not None:
            total += mult * f
            dot += mult * f
            continue
        if p == "scan":
            t, d = ref_flops(e.params["jaxpr"].jaxpr,
                             mult * e.params["length"], cond_share)
        elif p == "cond":
            t, d = max(ref_flops(b.jaxpr, mult * cond_share, cond_share)
                       for b in e.params["branches"])
        else:
            subs = list(_sub_jaxprs(e))
            t = d = 0.0
            for sj in subs:
                st, sd = ref_flops(sj, mult, cond_share)
                t, d = t + st, d + sd
            if not subs:
                t = mult * sum(float(np.prod(getattr(o.aval, "shape", ()))
                                     or 1) for o in e.outvars)
        total, dot = total + t, dot + d
    return total, dot


# ------------------------------------------------- the reference's cases
def test_dot_flops_exact():
    c = C.flops_of_fn(lambda a, b: a @ b, meta(8, 32), meta(32, 16))
    a = jax.ShapeDtypeStruct((8, 32), jnp.float32)
    b = jax.ShapeDtypeStruct((32, 16), jnp.float32)
    ref = RC.flops_of_jaxpr(jax.make_jaxpr(lambda a, b: a @ b)(a, b).jaxpr)
    assert c.dot == c.total == ref == 2 * 8 * 32 * 16


def _layers(W, x):
    for i in _common.repeat(W.shape[0]):
        x = x @ W[i]
    return x


@pytest.mark.parametrize("fold", [True, False])
def test_loop_multiplies_by_trip_count(fold):
    d, L, B = 16, 7, 4
    c = C.flops_of_fn(_layers, meta(L, d, d), meta(B, d), fold=fold)
    assert c.dot == 2 * B * d * d * L

    def f(W, x):
        return jax.lax.scan(lambda x, w: (x @ w, None), x, W)[0]
    ref = RC.flops_of_jaxpr(jax.make_jaxpr(f)(
        jax.ShapeDtypeStruct((L, d, d), jnp.float32),
        jax.ShapeDtypeStruct((B, d), jnp.float32)).jaxpr)
    assert ref >= c.dot


def test_remat_grad_counts_recompute():
    d, L, B = 16, 4, 4
    from torch.utils.checkpoint import checkpoint

    def net(W, x):
        for i in _common.repeat(L):
            x = checkpoint(lambda x, w: torch.tanh(x @ w), x, W[i],
                           use_reentrant=False)
        return x.sum()

    def grad(W, x):
        # the gradient of x too, so the first iteration's backward (the one
        # a folded loop runs) is every iteration's: both products (for W
        # alone the first layer's input would need none)
        W.requires_grad_(True)
        x.requires_grad_(True)
        return torch.autograd.grad(net(W, x), (W, x))

    plain = C.flops_of_fn(net, meta(L, d, d), meta(B, d))
    g = C.flops_of_fn(grad, meta(L, d, d), meta(B, d))
    # grad-with-remat ~= fwd + refwd + 2x bwd matmuls ~= 4x fwd dots
    assert g.total >= 3.2 * plain.total
    assert g.dot == 4 * plain.dot


def test_hbm_bytes_orders():
    cfg = get_config("granite-8b")
    train = C.hbm_bytes(cfg, LM_SHAPES["train_4k"])
    dec = C.hbm_bytes(cfg, LM_SHAPES["decode_32k"])
    assert train > 10 * cfg.n_params()
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2 * 32768 * 128
    assert dec > kv


def test_mla_cache_compression_visible_in_memory_term():
    cfg = get_config("deepseek-v2-lite-16b")
    mla_kv = cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    gqa_kv = cfg.n_layers * 2 * cfg.n_heads * cfg.head_dim * 2
    assert gqa_kv / mla_kv > 6.5
    assert C.hbm_bytes(cfg, LM_SHAPES["decode_32k"]) > cfg.n_params() * 2


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_hbm_bytes_bit_equal_to_the_reference(arch):
    assert ASSIGNED_ARCHS == REF_ARCHS
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert sorted(shapes_for(cfg)) == sorted(ref_shapes_for(rcfg))
    for name, shape in shapes_for(cfg).items():
        for k in (1, 4):
            for int8 in (False, True):
                assert C.hbm_bytes(cfg, shape, mra_k=k, kv_int8=int8) == \
                    RC.hbm_bytes(rcfg, REF_SHAPES[name], mra_k=k,
                                 kv_int8=int8), (name, k, int8)
        assert C.ssm_state_bytes(cfg, shape.global_batch) == \
            RC.ssm_state_bytes(rcfg, shape.global_batch)


# ------------------------------------------ the five families, reduced
FAMILIES = ["h2o-danube-1.8b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b"]
QB = 8


def _ref_count(arch, kind, S, B):
    cfg = ref_config(arch).reduced()
    share = 1.0
    if cfg.family == "hybrid":
        share = -(-cfg.n_layers // cfg.shared_attn_every) / cfg.n_layers
    lm = RLM(cfg, opts=RAttn(backend="chunked", q_block=QB, kv_block=QB),
             remat=True)
    p = ref_abstract(lm.param_specs())
    shape = RShape("cell", S, B, kind)
    if kind == "prefill":
        jx = jax.make_jaxpr(lambda p, t: lm.prefill(p, tokens=t))(
            p, RSP.abstract_prefill_tokens(shape))
    elif kind == "decode":
        cache, tok = RSP.abstract_decode_inputs(lm, shape)
        jx = jax.make_jaxpr(lambda p, c, t: lm.decode_step(p, c, tokens=t))(
            p, cache, tok)
    else:
        step = ref_train_step(lm, ref_plan(cfg), None, RTrain())
        jx = jax.make_jaxpr(step)(p, RSP.abstract_opt_state(p),
                                  RSP.abstract_batch(cfg, shape),
                                  RSP.abstract_counters(ref_plan(cfg)))
    return ref_flops(jx.jaxpr, 1.0, share)


def _port_lm(arch, **kw):
    return LM(get_config(arch).reduced(),
              opts=AttnOptions(backend="chunked", q_block=QB, kv_block=QB),
              remat=True, **kw)


def _port_count(arch, kind, S, B, fold=True):
    lm = _port_lm(arch)
    cfg = lm.cfg
    p = lm.abstract()
    shape = ShapeConfig("cell", S, B, kind)
    if kind == "prefill":
        return C.flops_of_fn(lambda p, t: lm.prefill(p, t), p,
                             SP.abstract_prefill_tokens(shape), fold=fold)
    if kind == "decode":
        cache, tok = SP.abstract_decode_inputs(lm, shape)
        return C.flops_of_fn(lambda p, c, t: lm.decode_step(p, c, t), p,
                             cache, tok, fold=fold)
    from repro_torch.runtime.train import TrainConfig, make_train_step
    step = make_train_step(lm, default_plan(cfg), None, TrainConfig())
    return C.flops_of_fn(step, p, SP.abstract_opt_state(p),
                         SP.abstract_batch(cfg, shape),
                         SP.abstract_counters(default_plan(cfg)), fold=fold)


def _seq(arch, kind):
    fam = get_config(arch).family
    return 128 if kind == "train" and fam in ("ssm", "hybrid") else 32


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_match_the_reference(arch, kind):
    S, B = _seq(arch, kind), 2
    ref_total, ref_dot = _ref_count(arch, kind, S, B)
    c = _port_count(arch, kind, S, B)
    if kind == "train" and get_config(arch).family in ("ssm", "hybrid"):
        assert c.dot == pytest.approx(ref_dot, rel=0.02), (c.dot, ref_dot)
    else:
        assert c.dot == ref_dot, (c.dot, ref_dot)
    assert c.total == pytest.approx(ref_total, rel=0.6), (c.total, ref_total)
    assert c.dot <= c.total


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_folded_count_equals_the_full_trace(arch, kind):
    """Every ``repeat`` loop run in full against once per class: the dot
    part is equal; the total within 5 %.  The gap: in the full trace each
    rectangle's slice of q / k / v has a full-size gradient, which the
    autograd engine adds into the tensor's gradient once per rectangle
    (3.8 % of zamba2's reduced train step at 16 x 16 rectangles a layer);
    the folded trace runs one rectangle and adds nothing, as the
    reference's scan, which slices its blocks as scanned inputs, adds
    nothing either.  The folded trace also makes zero gradients for the
    layers it did not run."""
    S, B = _seq(arch, kind), 2
    folded = _port_count(arch, kind, S, B)
    full = _port_count(arch, kind, S, B, fold=False)
    assert folded.dot == full.dot
    assert folded.total == pytest.approx(full.total, rel=0.05)


def test_folded_attention_schedule_counts_half_the_rectangles():
    lm = _port_lm("h2o-danube-1.8b")
    folded = LM(lm.cfg, opts=AttnOptions(backend="chunked", q_block=QB,
                                         kv_block=QB, folded=True))
    p = lm.abstract()
    tok = meta(2, 64, dtype=torch.int32)
    every = C.flops_of_fn(lambda p, t: lm.prefill(p, t), p, tok)
    half = C.flops_of_fn(lambda p, t: folded.prefill(p, t), p, tok)
    nq = 64 // QB
    per_rect = (every.by_op["aten.bmm"] - half.by_op["aten.bmm"]) / (
        nq * nq - nq // 2 * (nq + 1))
    assert per_rect > 0 and half.dot < every.dot
    assert half.by_op == C.flops_of_fn(lambda p, t: folded.prefill(p, t), p,
                                       tok, fold=False).by_op


def test_grouped_products_count_by_the_ragged_rule():
    """The moe family's expert products read no offsets while counting
    (the loop path would read them to the host) and count 2·M·K·N."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    from repro_torch.models import moe
    x = meta(10, cfg.d_model)
    w = meta(cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    off = meta(cfg.n_experts, dtype=torch.int32)
    c = C.flops_of_fn(moe.grouped_matmul, x, w, off)
    assert c.by_op == {"grouped_matmul": 2.0 * 10 * cfg.d_model
                       * cfg.d_ff_expert}


def test_counting_allocates_nothing():
    """A full-width step (gemma-2b's 256 x 4,096 train batch: ~1.6 TB of
    activations) is counted on fakes, in seconds."""
    cell = D.lower_cell("gemma-2b", "train_4k",
                        D.make_cell_mesh(D.CellOptions(), False))
    assert cell["dot_flops_total"] > 6 * get_config("gemma-2b").n_params() \
        * 256 * 4096


# ------------------------------------------- a launch while counting
@pytest.fixture
def fake_card(monkeypatch):
    """Every wrapper believes its tensors lie on the card, and each launch
    is a stub that writes the plain version's output."""
    launched = []
    for mod in (PFA, PFD, PFM, PSS):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)

    def stub(plain, name):
        def launch(*a, variant=None):
            launched.append(name)
            with torch.no_grad():
                return plain(*[t.detach() if torch.is_tensor(t) else t
                               for t in a[:len(a)]])
        return launch
    monkeypatch.setattr(PFA, "_launch",
                        stub(PFA.flash_attention_plain, "flash_attention"))
    monkeypatch.setattr(PFM, "_launch",
                        stub(PFM.fused_rmsnorm_mlp_plain, "fused_mlp"))
    monkeypatch.setattr(PSS, "_launch", stub(PSS.ssd_scan_plain, "ssd_scan"))
    monkeypatch.setattr(
        PFD, "_launch", lambda q, ck, cv, qp, kp, w, s, kvb, variant=None:
        launched.append("flash_decode") or PFD.flash_decode_plain(
            q, ck, cv, qp, kp, w, s))
    return launched


def _attn_args():
    q = torch.randn(1, 16, 1, 2, 8)
    k, v = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    pos = torch.arange(16).expand(1, 16)
    return q, k, v, pos, pos, 0, 0.35


def test_a_kernel_launch_under_the_counter_raises(fake_card):
    """Without the refusal the stubbed launch would run and the kernel's
    work would be missing from the count (the ``ctypes`` call is not an
    aten operator)."""
    with pytest.raises(RuntimeError, match="flash_attention: a kernel launch "
                                           "while counting"):
        C.flops_of_fn(POPS.flash_attention, *_attn_args())
    with pytest.raises(RuntimeError, match="fused_rmsnorm_mlp"):
        C.flops_of_fn(POPS.fused_rmsnorm_mlp, torch.randn(4, 8),
                      torch.zeros(8), torch.randn(8, 6), torch.randn(8, 6),
                      "silu", 1e-5)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        C.flops_of_fn(POPS.ssd_scan, torch.randn(1, 8, 1, 4),
                      torch.rand(1, 8, 1), -torch.ones(1),
                      torch.randn(1, 8, 2), torch.randn(1, 8, 2),
                      torch.ones(1), 8)
    with pytest.raises(RuntimeError, match="flash_decode"):
        C.flops_of_fn(PFD.flash_decode, torch.randn(1, 1, 2, 8),
                      torch.randn(1, 6, 1, 8), torch.randn(1, 6, 1, 8),
                      torch.tensor([5]), torch.arange(6)[None])
    # the whole fused model too: its first attention layer raises
    lm = _port_lm("h2o-danube-1.8b")
    fused = LM(lm.cfg, opts=AttnOptions(backend="fused"))
    with pytest.raises(RuntimeError, match="flash_attention"):
        C.flops_of_fn(lambda p, t: fused.prefill(p, t), lm.abstract(),
                      meta(1, 16, dtype=torch.int32))
    assert fake_card == []
    # outside the counter the same calls launch
    POPS.flash_attention(*_attn_args())
    assert fake_card == ["flash_attention"]


def test_tick_sim_refuses_too():
    with C.FlopCounter():
        with pytest.raises(RuntimeError, match="fused_tick_sim"):
            _common.refuse_counting("fused_tick_sim")
    _common.refuse_counting("fused_tick_sim")           # no counter: quiet


def test_a_counter_leaves_other_threads_alone():
    """A counter is active in its own thread only: another thread's loops
    keep every iteration and its kernels may launch."""
    import threading
    seen = {}
    go = threading.Event()

    def other():
        go.wait()
        seen["counter"] = _common.active_counter()
        seen["repeat"] = list(_common.repeat(3))
        _common.refuse_counting("flash_attention")      # must not raise
        seen["launch_allowed"] = True
    t = threading.Thread(target=other)
    t.start()
    with C.FlopCounter() as c:
        assert _common.active_counter() is c
        assert list(_common.repeat(3)) == [0]
        go.set()
        t.join()
    assert seen == {"counter": None, "repeat": [0, 1, 2],
                    "launch_allowed": True}
    assert _common.active_counter() is None


def test_fused_backend_counts_through_the_plain_versions():
    """On CPU fakes the fused model's kernels run their plain versions,
    which compute what the kernels compute: the same products as the
    chunked schedule at one block."""
    lm = _port_lm("h2o-danube-1.8b")
    one_block = LM(lm.cfg, opts=AttnOptions(backend="chunked", q_block=32,
                                            kv_block=32))
    fused = LM(lm.cfg, opts=AttnOptions(backend="fused"))
    p, tok = lm.abstract(), meta(2, 32, dtype=torch.int32)
    a = C.flops_of_fn(lambda p, t: fused.prefill(p, t), p, tok)
    b = C.flops_of_fn(lambda p, t: one_block.prefill(p, t), p, tok)
    assert a.dot == b.dot


# ------------------------------------------------------- collectives
@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=8, rank=0)
    yield
    dist.destroy_process_group()


def test_collective_bytes_functional(fake_world):
    """The reference's synthetic HLO case: 5 all-reduces of f32[8,16] over
    groups of 4 and one all-gather of f32[8,16] to f32[64,16] over 8."""
    import torch.distributed._functional_collectives as fc
    g = dist.new_group([0, 1, 2, 3])
    x = torch.ones(8, 16)

    def step(x):
        for _ in range(5):
            x = fc.wait_tensor(fc.all_reduce(x, "sum", g))
        return fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD))
    st = C.collective_stats(step, x)
    assert st["per_op_bytes"]["all-reduce"] == pytest.approx(
        5 * 2 * (3 / 4) * 8 * 16 * 4)
    assert st["per_op_bytes"]["all-gather"] == pytest.approx(
        (7 / 8) * 64 * 16 * 4)
    assert st["op_counts"] == {"all-reduce": 5, "all-gather": 1}
    assert st["collective_bytes"] == pytest.approx(
        sum(st["per_op_bytes"].values()))


def test_collective_bytes_in_place(fake_world):
    g = dist.new_group([0, 1, 2, 3])
    x = torch.ones(8, 16)

    def step(x):
        for _ in range(5):
            dist.all_reduce(x, group=g)
        dist.all_gather_into_tensor(torch.empty(64, 16), x)
        dist.reduce_scatter_tensor(torch.empty(1, 16), x)
        dist.all_to_all_single(torch.empty(8, 16), x)
    st = C.collective_stats(step, x)
    assert st["per_op_bytes"] == pytest.approx({
        "all-reduce": 5 * 2 * (3 / 4) * 512,
        "all-gather": (7 / 8) * 4096,
        "reduce-scatter": 7 * 64,
        "all-to-all": (7 / 8) * 512})
    assert st["op_counts"] == {"all-reduce": 5, "all-gather": 1,
                               "reduce-scatter": 1, "all-to-all": 1}


def test_collective_stats_of_a_single_device_step_is_zero():
    st = C.collective_stats(lambda x: x @ x, torch.ones(4, 4))
    assert st == {"collective_bytes": 0, "per_op_bytes": {},
                  "op_counts": {}}
