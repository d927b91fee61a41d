"""The port's ``kernels.ops`` autograd Functions against the reference's
``repro.kernels.ops`` (``custom_vjp``: the Pallas kernel in interpret mode
forward, ``jax.vjp`` of the oracle backward) and against ``jax.vjp`` of the
reference's oracles, on the CPU.

Each case hands the same NumPy inputs (from a seed) to both packages:
forward outputs and the gradient of every differentiable input, for a
random output gradient, at float32 atol 2e-5 (SSD 1e-4) and bfloat16
3e-2 / 5e-2, the tolerances of ``tests/test_kernels.py``.  The port's
``ssd_scan`` oracle zeroes the masked decay before its exp: where the
reference's gradient is NaN (a chunk's decay past e^88), the port's is
finite (pinned).  The raw wrappers refuse a CUDA input that requires grad
(the silent detach), shown with a stubbed launch; the gpu-marked test runs
``chip_smoke.py``'s ``train_kernel_check`` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro_torch.kernels import _common
from repro_torch.kernels import flash_attention as PFA
from repro_torch.kernels import fused_mlp as PFM
from repro_torch.kernels import ops as POPS
from repro_torch.kernels import ref as PREF
from repro_torch.kernels import ssd_scan as PSS

from _torch_port_helpers import chip_smoke

FUNCTION = {"attention": "flash_attention", "mlp": "fused_rmsnorm_mlp",
            "ssd": "ssd_scan"}
ATOL = {("attention", "float32"): 2e-5, ("attention", "bfloat16"): 3e-2,
        ("mlp", "float32"): 2e-5, ("mlp", "bfloat16"): 5e-2,
        ("ssd", "float32"): 1e-4}


def jnp_dtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def inputs(kind, dtype, shape, seed=0):
    """NumPy inputs: the differentiable arrays (cast to ``dtype`` where the
    kernel takes it), the non-differentiable arguments, a cotangent seed."""
    rng = np.random.default_rng(seed)
    if kind == "attention":
        B, S, KV, G, hd, win = shape
        arrs = [rng.standard_normal(s).astype(np.float32)
                for s in ((B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        return arrs, (pos, pos, win, 1.0 / np.sqrt(hd))
    if kind == "mlp":
        N, d, F, act = shape
        arrs = [rng.standard_normal((N, d)).astype(np.float32),
                (rng.standard_normal(d) * 0.1).astype(np.float32),
                (rng.standard_normal((d, F)) / np.sqrt(d)).astype(np.float32),
                (rng.standard_normal((d, F)) / np.sqrt(d)).astype(np.float32)]
        return arrs, (act, 1e-5)
    B, L, nh, hd, st, chunk = shape
    arrs = [rng.standard_normal((B, L, nh, hd)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(
                np.float32),
            -np.exp(rng.standard_normal(nh) * 0.2).astype(np.float32),
            rng.standard_normal((B, L, st)).astype(np.float32),
            rng.standard_normal((B, L, st)).astype(np.float32),
            np.ones(nh, np.float32)]
    return arrs, (chunk,)


def jit_vjp(f):
    """``(xs, cotangents) -> (f(*xs), the vjp)``, traced once (op by op
    the oracles' vjps take seconds)."""
    @jax.jit
    def run(xs, cts):
        y, vjp = jax.vjp(f, *xs)
        return y, vjp(cts)
    return run


def ref_fns(kind, rest):
    """(reference ops function, reference oracle) of the arrays alone."""
    if kind == "attention":
        qpos, kpos, win, scale = (jnp.asarray(rest[0]), jnp.asarray(rest[1]),
                                  rest[2], rest[3])
        return (lambda q, k, v: ROPS.flash_attention(q, k, v, qpos, kpos,
                                                     win, scale),
                lambda q, k, v: RREF.flash_attention_ref(
                    q, k, v, qpos, kpos, scale=scale, window=win))
    if kind == "mlp":
        act, eps = rest
        return (lambda *a: ROPS.fused_rmsnorm_mlp(*a, act, eps),
                lambda *a: RREF.fused_rmsnorm_mlp_ref(*a, act=act, eps=eps))
    chunk, = rest
    return (lambda *a: ROPS.ssd_scan(*a, chunk),
            lambda *a: RREF.ssd_scan_ref(*a, chunk=chunk))


def port_fn(kind, rest):
    if kind == "attention":
        qpos, kpos = torch.from_numpy(rest[0]), torch.from_numpy(rest[1])
        return lambda q, k, v: POPS.flash_attention(q, k, v, qpos, kpos,
                                                    rest[2], rest[3])
    if kind == "mlp":
        return lambda *a: POPS.fused_rmsnorm_mlp(*a, *rest)
    return lambda *a: POPS.ssd_scan(*a, *rest)


CASES = [
    ("attention", "float32", (2, 64, 1, 4, 16, 24)),     # MQA, window
    ("attention", "bfloat16", (1, 64, 2, 2, 32, 0)),
    ("mlp", "float32", (16, 32, 64, "gelu")),
    ("mlp", "bfloat16", (32, 64, 128, "silu")),
    ("ssd", "float32", (2, 64, 3, 16, 8, 16)),
]
# which arrays are cast to the case's dtype (SSD and the MLP scale: no)
CAST = {"attention": (0, 1, 2), "mlp": (0, 1, 2, 3), "ssd": ()}


@pytest.fixture(scope="module")
def reference():
    """The reference's forward outputs and input gradients, per case."""
    out = {}
    for kind, dtype, shape in CASES:
        arrs, rest = inputs(kind, dtype, shape)
        jd = jnp_dtype(dtype)
        xs = [jnp.asarray(a).astype(jd) if i in CAST[kind] else
              jnp.asarray(a) for i, a in enumerate(arrs)]
        opsf, oracle = ref_fns(kind, rest)
        rng = np.random.default_rng(99)
        cts = jax.tree_util.tree_map(
            lambda y: jnp.asarray(rng.standard_normal(y.shape)).astype(
                y.dtype), jax.eval_shape(opsf, *xs))
        y_ops, g_ops = jit_vjp(opsf)(xs, cts)
        y_ref, g_ref = jit_vjp(oracle)(xs, cts)
        out[(kind, dtype, shape)] = dict(
            arrs=[np.asarray(x) for x in xs], rest=rest,
            y_ops=jax.tree_util.tree_map(np.asarray, y_ops),
            y_ref=jax.tree_util.tree_map(np.asarray, y_ref),
            cts=jax.tree_util.tree_map(np.asarray, cts),
            g_ops=[np.asarray(g) for g in g_ops],
            g_ref=[np.asarray(g) for g in g_ref])
    return out


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kind,dtype,shape", CASES,
                         ids=[f"{k}-{d}-{i}" for i, (k, d, _)
                              in enumerate(CASES)])
def test_ops_forward_and_grads_match_the_reference(reference, kind, dtype,
                                                    shape):
    r = reference[(kind, dtype, shape)]
    atol = ATOL[(kind, dtype)]
    leaves = [to_torch(a).requires_grad_(True) for a in r["arrs"]]
    fn = POPS.FUNCTIONS[FUNCTION[kind]]
    b0 = fn.backward_calls
    outs = _tuple(port_fn(kind, r["rest"])(*leaves))
    for o, yo, yr in zip(outs, _tuple(r["y_ops"]), _tuple(r["y_ref"])):
        close(o, yo, atol)            # the Pallas kernel (interpret)
        close(o, yr, atol)            # the oracle
    grads = torch.autograd.grad(outs, leaves,
                                [to_torch(c) for c in _tuple(r["cts"])])
    assert fn.backward_calls == b0 + 1
    for g, leaf, go, gr in zip(grads, leaves, r["g_ops"], r["g_ref"]):
        assert g.dtype == leaf.dtype
        scale = max(1.0, float(np.abs(np.asarray(gr, np.float32)).max()))
        close(g, go, atol * scale)
        close(g, gr, atol * scale)


def test_ops_outputs_carry_their_function():
    q = torch.randn(1, 16, 1, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    pos = torch.arange(16).expand(1, 16)
    out = POPS.flash_attention(q, k, v, pos, pos, 0, 0.3)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    y, h = POPS.ssd_scan(*[torch.randn(s, requires_grad=True) for s in
                           ((1, 8, 1, 4), (1, 8, 1), (1,), (1, 8, 2),
                            (1, 8, 2), (1,))], 8)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    x = torch.randn(4, 8, requires_grad=True)
    out = POPS.fused_rmsnorm_mlp(x, torch.zeros(8), torch.randn(8, 6),
                                 torch.randn(8, 6))
    assert type(out.grad_fn).__name__ == "FusedRMSNormMLPBackward"


@pytest.mark.parametrize("budget_heads", [1, 2, 3])
def test_attention_backward_by_kv_head_groups(budget_heads):
    """The attention oracle's backward over groups of kv heads
    (``budget_heads`` heads at a time, a 3-head group leaving a ragged last
    one) gives the whole-tensor backward's gradients to float32 rounding,
    and the Function's backward (off the card every head at once) gives
    the same."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 12, 4, 2, 8, generator=gen)
    k, v = (torch.randn(2, 12, 4, 8, generator=gen) for _ in range(2))
    g = torch.randn(2, 12, 4, 2, 8, generator=gen)
    pos = torch.arange(12).expand(2, 12)
    whole = POPS.attention_grads(q, k, v, pos, pos, g, 0.3, 5, heads=4)
    for a, b in zip(POPS.attention_grads(q, k, v, pos, pos, g, 0.3, 5,
                                         heads=budget_heads), whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert POPS.heads_that_fit(q, k) == 4
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    POPS.flash_attention(*leaves, pos, pos, 5, 0.3).backward(g)
    for t, b in zip(leaves, whole):
        torch.testing.assert_close(t.grad, b, rtol=1e-6, atol=1e-6)


def test_ssd_oracle_gradient_is_finite_where_the_reference_is_nan():
    """A chunk whose decay passes e^88: the reference's select after the
    exp gives the masked entries inf, and its gradient 0 * inf = NaN in dt
    and A; the port zeroes them before the exp as well, so the same
    forward has a finite gradient."""
    B, L, nh, hd, st = 1, 256, 2, 8, 8
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((B, L, nh, hd)).astype(np.float32),
            np.full((B, L, nh), 0.7, np.float32),
            np.full(nh, -1.0, np.float32),
            rng.standard_normal((B, L, st)).astype(np.float32),
            rng.standard_normal((B, L, st)).astype(np.float32),
            np.ones(nh, np.float32)]
    xs = [jnp.asarray(a) for a in arrs]
    oracle = lambda *a: RREF.ssd_scan_ref(*a, chunk=256)  # noqa: E731
    ones = jax.tree_util.tree_map(lambda s: jnp.ones(s.shape, s.dtype),
                                  jax.eval_shape(oracle, *xs))
    y_ref, g_ref = jit_vjp(oracle)(xs, ones)
    assert np.isnan(np.asarray(g_ref[1])).any()      # the reference's NaN
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = POPS.ssd_scan(*leaves, 256)
    close(y, y_ref[0], 1e-4, 1e-4)
    grads = torch.autograd.grad((y, h), leaves,
                                (torch.ones_like(y), torch.ones_like(h)))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # where the reference's gradient is finite (xs, B, C, D), they agree
    for i in (0, 3, 4, 5):
        scale = max(1.0, float(np.abs(np.asarray(g_ref[i])).max()))
        close(grads[i], g_ref[i], 1e-4 * scale, 1e-4)


def test_ref_oracles_are_the_plain_versions():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 2, 8)).astype(
        np.float32))
    ck = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(
        np.float32))
    cv = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(
        np.float32))
    qpos = torch.tensor([4], dtype=torch.int32)
    kpos = torch.arange(6, dtype=torch.int32)[None]
    dec = PREF.flash_decode_ref(q[:, 0], ck, cv, qpos, kpos, scale=0.3)
    full = PFA.flash_attention_plain(q, ck, cv, qpos[:, None], kpos, 0, 0.3)
    close(dec, full[:, 0].numpy(), 1e-6)
    x = torch.randn(4, 8)
    w = torch.randn(8, 6)
    assert torch.equal(PREF.fused_rmsnorm_mlp_ref(x, torch.zeros(8), w, w),
                       PFM.fused_rmsnorm_mlp_plain(x, torch.zeros(8), w, w))


# ------------------------------------------------------- the silent detach
@pytest.fixture
def fake_card(monkeypatch):
    """Every wrapper believes its tensors lie on the card, and each launch
    is a stub that writes the plain version's output (as the kernel would:
    into a fresh tensor, outside autograd)."""
    launched = []
    for mod in (PFA, PFM, PSS):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)

    def stub(plain, name):
        def launch(*a, variant=None):
            launched.append(name)
            with torch.no_grad():
                out = plain(*[t.detach() if torch.is_tensor(t) else t
                              for t in a])
            return out
        return launch
    monkeypatch.setattr(PFA, "_launch",
                        stub(PFA.flash_attention_plain, "flash_attention"))
    monkeypatch.setattr(PFM, "_launch",
                        stub(PFM.fused_rmsnorm_mlp_plain, "fused_mlp"))
    monkeypatch.setattr(PSS, "_launch", stub(PSS.ssd_scan_plain, "ssd_scan"))
    return launched


def _attn_args(requires_grad):
    q = torch.randn(1, 16, 1, 2, 8, requires_grad=requires_grad)
    k, v = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    pos = torch.arange(16).expand(1, 16)
    return q, k, v, pos, pos, 0, 0.35


def test_raw_wrappers_refuse_a_grad_requiring_card_input(fake_card):
    """The fault: the raw wrapper's output would be cut off from the graph
    (no ``grad_fn``), so ``wq`` / ``wk`` / ``wv`` would get no gradient and
    nothing would say so.  Now the wrapper raises and names ``ops``."""
    with pytest.raises(RuntimeError, match="kernels.ops.flash_attention"):
        PFA.flash_attention(*_attn_args(True))
    with pytest.raises(RuntimeError, match="kernels.ops.fused_rmsnorm_mlp"):
        PFM.fused_rmsnorm_mlp(torch.randn(4, 8), torch.zeros(8),
                              torch.randn(8, 6, requires_grad=True),
                              torch.randn(8, 6))
    with pytest.raises(RuntimeError, match="kernels.ops.ssd_scan"):
        PSS.ssd_scan(torch.randn(1, 8, 1, 4, requires_grad=True),
                     torch.rand(1, 8, 1), -torch.ones(1),
                     torch.randn(1, 8, 2), torch.randn(1, 8, 2),
                     torch.ones(1), 8)
    assert fake_card == []                         # nothing launched
    # without grad (serving) and under no_grad the wrappers launch
    PFA.flash_attention(*_attn_args(False))
    with torch.no_grad():
        PFA.flash_attention(*_attn_args(True))
    assert fake_card == ["flash_attention"] * 2


def test_ops_launch_the_kernel_and_keep_the_graph(fake_card):
    q, k, v, qpos, kpos, win, scale = _attn_args(True)
    out = POPS.flash_attention(q, k, v, qpos, kpos, win, scale)
    assert fake_card == ["flash_attention"]
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    g, = torch.autograd.grad(out.sum(), q)
    ref, = torch.autograd.grad(PFA.flash_attention_plain(
        q, k, v, qpos, kpos, win, scale).sum(), q)
    assert torch.allclose(g, ref, atol=1e-5)
    x = torch.randn(4, 8, requires_grad=True)
    h = POPS.fused_rmsnorm_mlp(x, torch.zeros(8), torch.randn(8, 6),
                               torch.randn(8, 6))
    assert type(h.grad_fn).__name__ == "FusedRMSNormMLPBackward"
    assert fake_card[-1] == "fused_mlp"


def test_refusal_helper_reads_grad_mode():
    t = torch.randn(2, requires_grad=True)
    with pytest.raises(RuntimeError):
        _common.refuse_grad("x", t)
    with torch.no_grad():
        _common.refuse_grad("x", t)
    _common.refuse_grad("x", t.detach())


# ----------------------------------------- chip_smoke's checks, on the CPU
@pytest.mark.parametrize("case", chip_smoke().TRAIN_KERNEL_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_chip_smoke_train_kernel_check_on_the_cpu(case):
    """``train_kernel_check`` passes the plain path on the CPU (no launch
    expected there), and its planted backward fault is rejected."""
    res = chip_smoke().train_kernel_check(*case, device="cpu")
    assert res["ok"], res


def test_chip_smoke_train_kernel_faults_rejected_on_the_cpu():
    assert chip_smoke().train_kernel_faults(device="cpu") == {
        "backward_zeroes_dk": True}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs these comparisons on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,shape",
                         chip_smoke().TRAIN_KERNEL_CASES)
def test_cuda_ops_match_plain_under_autograd(cuda_device, name, dtype,
                                             shape):
    chip_smoke().card_case("test_cuda_ops_match_plain_under_autograd", name,
                           dtype, shape)
