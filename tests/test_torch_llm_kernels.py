"""The LLM kernels of the port against the reference's Pallas kernels.

Each plain PyTorch version (what a wrapper runs on CPU tensors) is held
against the reference's ``*_pallas(..., interpret=True)`` and against its
``kernels/ref.py`` oracle, on the same inputs made with NumPy from a seed.
Tolerances are those of ``tests/test_kernels.py``: atol 2e-5 in float32,
3e-2 (attention) and 5e-2 (MLP) in bfloat16.  The CUDA kernels themselves
are held against the plain versions by the ``gpu``-marked tests at the end
(skipped without a card) and by ``chip_smoke.py``.
"""
import importlib.util
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as REF
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.fused_mlp import fused_rmsnorm_mlp_pallas
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import ops as port_ops
from repro_torch.models import layers as L

ATOL = {("attention", "float32"): 2e-5, ("attention", "bfloat16"): 3e-2,
        ("mlp", "float32"): 2e-5, ("mlp", "bfloat16"): 5e-2}
DTYPES = ("float32", "bfloat16")


def both(a, dtype):
    """One NumPy float array -> (jax array, torch tensor) of ``dtype``; both
    sides round float32 to bfloat16 the same way (to nearest even)."""
    a = np.asarray(a, np.float32)
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(a).to(getattr(torch, dtype))


def ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def close(port, ref, atol, rows=None):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    if rows is not None:
        p, r = p[rows], r[rows]
    np.testing.assert_allclose(p, r, atol=atol, rtol=0)


def ring_kpos(pos, W):
    """The reference's ring positions (``layers.py:338-342``), per row."""
    idx = np.arange(W)
    out = []
    for p in pos:
        slot, wraps = p % W, p // W
        kp = np.where(idx <= slot, wraps * W + idx, (wraps - 1) * W + idx)
        out.append(np.where(kp >= 0, kp, 1_000_000_000))
    return np.stack(out).astype(np.int32)


# ------------------------------------------------------------ flash attention
ATTN_CASES = [
    # B, S, KV, G, hd_qk, hd_v, window, block
    (2, 64, 2, 2, 16, 16, 0, 16),
    (1, 48, 1, 4, 80, 80, 16, 16),       # h2o-danube's head dim, a window
    (1, 32, 4, 1, 24, 16, 0, 8),         # separate qk / v head dims
    (2, 40, 2, 2, 80, 80, 12, 8),
    (1, 24, 2, 2, 20, 12, 0, 8),         # head dims not multiples of 8
]


def attn_inputs(B, S, KV, G, hdq, hdv, dtype, seed=0, qshift=0):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((B, S, KV, G, hdq)), dtype)
    k = both(rng.standard_normal((B, S, KV, hdq)), dtype)
    v = both(rng.standard_normal((B, S, KV, hdv)), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    return q, k, v, ints(pos + qshift), ints(pos)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,KV,G,hdq,hdv,win,blk", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_and_oracle(B, S, KV, G, hdq,
                                                         hdv, win, blk,
                                                         dtype):
    q, k, v, qp, kp = attn_inputs(B, S, KV, G, hdq, hdv, dtype)
    scale = 1 / np.sqrt(hdq)
    port = FA.flash_attention_plain(q[1], k[1], v[1], qp[1], kp[1], win,
                                    scale)
    assert port.dtype == q[1].dtype and port.shape == (B, S, KV, G, hdv)
    pallas = flash_attention_pallas(q[0], k[0], v[0], qp[0], kp[0],
                                    scale=scale, window=win, q_block=blk,
                                    kv_block=blk, interpret=True)
    oracle = REF.flash_attention_ref(q[0], k[0], v[0], qp[0], kp[0],
                                     scale=scale, window=win)
    atol = ATOL[("attention", dtype)]
    close(port, pallas, atol)
    close(port, oracle, atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_row_without_live_key_gives_zero(dtype):
    """Queries placed before every key: the Pallas kernel and the plain
    version give 0 on those rows; the reference's oracle (a softmax over a
    constant row) gives the mean of ``v`` there, and agrees elsewhere."""
    B, S, KV, G, hd = 1, 32, 2, 2, 80
    q, k, v, qp, kp = attn_inputs(B, S, KV, G, hd, hd, dtype, seed=3,
                                  qshift=-8)
    scale = 1 / np.sqrt(hd)
    port = FA.flash_attention_plain(q[1], k[1], v[1], qp[1], kp[1], 0, scale)
    pallas = flash_attention_pallas(q[0], k[0], v[0], qp[0], kp[0],
                                    scale=scale, q_block=8, kv_block=8,
                                    interpret=True)
    oracle = REF.flash_attention_ref(q[0], k[0], v[0], qp[0], kp[0],
                                     scale=scale)
    atol = ATOL[("attention", dtype)]
    dead = np.arange(S) < 8
    close(port, pallas, atol)
    assert torch.all(port[:, dead] == 0)
    close(port, oracle, atol, rows=(slice(None), ~dead))
    mean_v = np.asarray(v[0], np.float32).mean(axis=1)         # (B,KV,hd)
    np.testing.assert_allclose(np.asarray(oracle, np.float32)[0, 0, :, 0],
                               mean_v[0], atol=atol)


# --------------------------------------------------------------- flash decode
DECODE_CASES = [
    # B, W, KV, G, hd, window, kv_block, positions (ring wraps, unwritten)
    (3, 32, 2, 4, 80, 16, 8, (5, 31, 50)),
    (2, 32, 1, 8, 16, 0, 16, (0, 95)),
    (2, 24, 4, 1, 32, 0, 8, (11, 23)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,KV,G,hd,win,blk,pos", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_and_oracle(B, W, KV, G, hd, win,
                                                      blk, pos, dtype):
    rng = np.random.default_rng(1)
    q = both(rng.standard_normal((B, KV, G, hd)), dtype)
    ck = both(rng.standard_normal((B, W, KV, hd)), dtype)
    cv = both(rng.standard_normal((B, W, KV, hd)), dtype)
    qp, kp = ints(pos), ints(ring_kpos(pos, W))
    assert (kp[1] == 1_000_000_000).any() or max(pos) >= W - 1
    scale = 1 / np.sqrt(hd)
    port = FD.flash_decode_plain(q[1], ck[1], cv[1], qp[1], kp[1], win,
                                 scale, blk)
    assert port.dtype == q[1].dtype and port.shape == (B, KV, G, hd)
    pallas = flash_decode_pallas(q[0], ck[0], cv[0], qp[0], kp[0],
                                 scale=scale, window=win, kv_block=blk,
                                 interpret=True)
    oracle = REF.flash_decode_ref(q[0], ck[0], cv[0], qp[0], kp[0],
                                  scale=scale, window=win)
    atol = ATOL[("attention", dtype)]
    close(port, pallas, atol)
    close(port, oracle, atol)


# ------------------------------------------------------------------ fused MLP
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("N,d,F,tb,fb", [(32, 64, 96, 16, 32),
                                         (4, 80, 64, 4, 64)])
def test_fused_mlp_plain_matches_pallas_and_oracle(N, d, F, tb, fb, act,
                                                   dtype):
    rng = np.random.default_rng(2)
    x = both(rng.standard_normal((N, d)), dtype)
    s = both(0.1 * rng.standard_normal(d), dtype)
    wg = both(rng.standard_normal((d, F)) / np.sqrt(d), dtype)
    wu = both(rng.standard_normal((d, F)) / np.sqrt(d), dtype)
    port = FM.fused_rmsnorm_mlp_plain(x[1], s[1], wg[1], wu[1], act, 1e-5)
    assert port.dtype == x[1].dtype and port.shape == (N, F)
    pallas = fused_rmsnorm_mlp_pallas(x[0], s[0], wg[0], wu[0], act=act,
                                      eps=1e-5, token_block=tb, ff_block=fb,
                                      interpret=True)
    oracle = REF.fused_rmsnorm_mlp_ref(x[0], s[0], wg[0], wu[0], act=act,
                                       eps=1e-5)
    atol = ATOL[("mlp", dtype)]
    close(port, pallas, atol)
    close(port, oracle, atol)


# -------------------------------------------------------------- the wrappers
@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "fused_rmsnorm_mlp"])
def test_ops_have_the_reference_signatures(name):
    ref = inspect.signature(getattr(ref_ops, name))
    port = inspect.signature(getattr(port_ops, name))
    assert list(port.parameters) == list(ref.parameters)
    for p in ref.parameters.values():
        assert port.parameters[p.name].default == p.default


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    q, k, v, qp, kp = attn_inputs(1, 16, 1, 2, 16, 16, "float32")
    args = (q[1], k[1], v[1], qp[1], kp[1], 4, 0.25)
    counts = (FA.flash_attention.launches, FD.flash_decode.launches,
              FM.fused_rmsnorm_mlp.launches)
    assert torch.equal(port_ops.flash_attention(*args),
                       FA.flash_attention_plain(*args))
    dargs = (q[1][:, 0], k[1], v[1], qp[1][:, -1], kp[1], 0, 0.25)
    assert torch.equal(port_ops.flash_decode(*dargs),
                       FD.flash_decode_plain(*dargs))
    x = torch.randn(3, 16)
    margs = (x, torch.zeros(16), torch.randn(16, 8), torch.randn(16, 8),
             "gelu", 1e-5)
    assert torch.equal(port_ops.fused_rmsnorm_mlp(*margs),
                       FM.fused_rmsnorm_mlp_plain(*margs))
    assert counts == (FA.flash_attention.launches, FD.flash_decode.launches,
                      FM.fused_rmsnorm_mlp.launches)


def test_wrappers_refuse_bad_inputs_before_any_launch():
    """The checks a launch makes first (shape, dtype, contiguity) raise
    before the CUDA build or the card is touched."""
    f32 = torch.float32
    q = torch.zeros(1, 8, 1, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="5-d"):
        FA._launch(q[0], k, k, pos, pos, 0, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        FA._launch(q, k.to(torch.float16), k, pos, pos, 0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        FA._launch(q, torch.zeros(1, 8, 1, 32)[..., ::2], k, pos, pos, 0,
                   1.0)
    with pytest.raises(ValueError, match="head dims"):
        FA._launch(torch.zeros(1, 8, 1, 1, 300), torch.zeros(1, 8, 1, 300),
                   k, pos, pos, 0, 1.0)
    with pytest.raises(ValueError, match="kv_block"):
        FD._launch(q[:, 0], k, k, pos[:, 0], pos, 0, 1.0, 0)
    with pytest.raises(ValueError, match="G \\* hd_v"):
        FD._launch(torch.zeros(1, 1, 16, 256), torch.zeros(1, 8, 1, 256),
                   torch.zeros(1, 8, 1, 256), pos[:, 0], pos, 0, 1.0, 8)
    with pytest.raises(ValueError, match="scale"):
        FM._launch(torch.zeros(4, 16), torch.zeros(8), torch.zeros(16, 8),
                   torch.zeros(16, 8), "silu", 1e-5)
    with pytest.raises(TypeError, match="dtype"):
        FM._launch(torch.zeros(4, 16), torch.zeros(16, dtype=torch.bfloat16),
                   torch.zeros(16, 8, dtype=f32), torch.zeros(16, 8), "silu",
                   1e-5)
    with pytest.raises(ValueError, match="act"):
        FM.fused_rmsnorm_mlp(torch.zeros(4, 16), torch.zeros(16),
                             torch.zeros(16, 8), torch.zeros(16, 8), "relu")
    with pytest.raises(ValueError, match="device"):
        FM.fused_rmsnorm_mlp(torch.zeros(4, 16, device="meta"),
                             torch.zeros(16, device="meta"),
                             torch.zeros(16, 8, device="meta"),
                             torch.zeros(16, 8, device="meta"))


# ------------------------------------------- the check chip_smoke.py applies
def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["flash_decode", "flash_attention"])
def test_row_check_rejects_planted_faults_on_long_rows(name):
    """Rows over thousands of live keys output ~sqrt(e / n), so an absolute
    limit of 3e-2 cannot tell a wrong window edge from a right answer.  The
    row-relative check of ``chip_smoke.py`` passes a correct answer computed
    another way (``attention_chunked``: online softmax in kv blocks) and
    rejects every planted fault."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    opts = L.AttnOptions(backend="chunked", q_block=256, kv_block=512)
    if name == "flash_decode":
        B, W, KV, G, hd, win = 4, 4096, 8, 4, 80, 4096
        q = torch.randn(B, KV, G, hd, generator=g).to(bf16)
        ck, cv = (torch.randn(B, W, KV, hd, generator=g).to(bf16)
                  for _ in range(2))
        pos = torch.tensor([4095, 4096, 6000, 9000], dtype=torch.int32)
        args = (q, ck, cv, pos, L.ring_kpos(pos, W), win, hd ** -0.5)
        plain = FD.flash_decode_plain
        other = L.attention_chunked(q[:, None], *args[1:3], pos[:, None],
                                    *args[4:], opts)[:, 0]
    else:
        B, S, KV, G, hd, win = 1, 2048, 2, 2, 80, 1024
        q = torch.randn(B, S, KV, G, hd, generator=g).to(bf16)
        k, v = (torch.randn(B, S, KV, hd, generator=g).to(bf16)
                for _ in range(2))
        p = torch.arange(S, dtype=torch.int32)[None]
        args = (q, k, v, p, p, win, hd ** -0.5)
        plain = FA.flash_attention_plain
        other = L.attention_chunked(*args, opts)
    ref = plain(*args)
    assert cs.llm_check("attention", other, ref, bf16)["ok"]
    faults = cs.planted_faults(name, args, plain, ref)
    assert len(faults) == 3
    for fault, out in faults.items():
        res = cs.llm_check("attention", out, ref, bf16)
        assert not res["ok"], fault
        assert res["max_row_rel_err"] > cs.LLM_ROW_RTOL[bf16], fault
    if name == "flash_decode":       # the blind spot of the absolute limit
        short = cs._err(faults["window_one_short"], ref)
        assert short <= ATOL[("attention", "bfloat16")]


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs these comparisons on the "
                    "card)")
    return torch.device("cuda")


def _cuda(*ts):
    return tuple(t.cuda() if torch.is_tensor(t) else t for t in ts)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,KV,G,hdq,hdv,win,blk", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(B, S, KV, G, hdq, hdv, win, blk,
                                            dtype, cuda_device):
    q, k, v, qp, kp = attn_inputs(B, S, KV, G, hdq, hdv, dtype, qshift=-3)
    args = _cuda(q[1], k[1], v[1], qp[1], kp[1]) + (win, 1 / np.sqrt(hdq))
    before = FA.flash_attention.launches
    out = FA.flash_attention(*args)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    ref = FA.flash_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[("attention", dtype)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,KV,G,hd,win,blk,pos", DECODE_CASES)
def test_cuda_flash_decode_matches_plain(B, W, KV, G, hd, win, blk, pos,
                                         dtype, cuda_device):
    rng = np.random.default_rng(1)
    t = getattr(torch, dtype)
    q, ck, cv = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  ).to(t).cuda()
                 for s in ((B, KV, G, hd), (B, W, KV, hd), (B, W, KV, hd)))
    qp = torch.tensor(pos, dtype=torch.int32).cuda()
    kp = torch.from_numpy(ring_kpos(pos, W)).cuda()
    before = FD.flash_decode.launches
    out = FD.flash_decode(q, ck, cv, qp, kp, win, 1 / np.sqrt(hd), blk)
    torch.cuda.synchronize()
    assert FD.flash_decode.launches == before + 1
    ref = FD.flash_decode_plain(q, ck, cv, qp, kp, win, 1 / np.sqrt(hd))
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[("attention", dtype)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("N,d,F", [(32, 64, 96), (4, 80, 64), (70, 300, 130),
                                   (12, 64, 130), (3, 100, 77)])
def test_cuda_fused_mlp_matches_plain(N, d, F, act, dtype, cuda_device):
    rng = np.random.default_rng(2)
    t = getattr(torch, dtype)
    x, s, wg, wu = (torch.from_numpy(a.astype(np.float32)).to(t).cuda()
                    for a in (rng.standard_normal((N, d)),
                              0.1 * rng.standard_normal(d),
                              rng.standard_normal((d, F)) / np.sqrt(d),
                              rng.standard_normal((d, F)) / np.sqrt(d)))
    before = FM.fused_rmsnorm_mlp.launches
    out = FM.fused_rmsnorm_mlp(x, s, wg, wu, act)
    torch.cuda.synchronize()
    assert FM.fused_rmsnorm_mlp.launches == before + 1
    ref = FM.fused_rmsnorm_mlp_plain(x, s, wg, wu, act)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[("mlp", dtype)])
