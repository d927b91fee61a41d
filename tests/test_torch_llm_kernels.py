"""The LLM kernels of the port against the reference's Pallas kernels.

Each plain PyTorch version (what a wrapper runs on CPU tensors) is held
against the reference's ``*_pallas(..., interpret=True)`` and against its
``kernels/ref.py`` oracle, on the same inputs made with NumPy from a seed.
Tolerances are those of ``tests/test_kernels.py``: atol 2e-5 in float32,
3e-2 (attention) and 5e-2 (MLP) in bfloat16.  The CUDA kernels themselves
are held against the plain versions by the ``gpu``-marked tests (skipped
without a card), whose cases run in ``chip_smoke.py`` (``card_case``: the
card's machine has no jax, which this file imports), and there by its own
phases.  On the card the bf16 MLP is held to max(5e-2, one bf16 ulp of
|ref|): both versions round their outputs to bf16.

Each side gets inputs of its own: ``both`` / ``ints`` copy the NumPy
array into a fresh JAX array and a fresh torch tensor, so neither package
can see the other's buffer (a 64-byte aligned NumPy array would otherwise
back the JAX array without a copy, and ``torch.from_numpy`` always shares
it).  The attention and decode comparisons also measure the port, the
Pallas kernel and the oracle against the same attention in float64 on the
host, and a failure names each side's distance from it, so the side that
moved is in the report.
"""
import inspect

import jax
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
from repro_torch.kernels._common import aligned16
from repro_torch.models import layers as L

from _torch_port_helpers import chip_smoke

ATOL = {("attention", "float32"): 2e-5, ("attention", "bfloat16"): 3e-2,
        ("mlp", "float32"): 2e-5, ("mlp", "bfloat16"): 5e-2}
DTYPES = ("float32", "bfloat16")


def both(a, dtype):
    """One NumPy float array -> (jax array, torch tensor) of ``dtype``, each
    on a buffer of its own (copies, never views of ``a`` or of each other);
    both sides round float32 to bfloat16 the same way (to nearest even)."""
    a = np.asarray(a, np.float32)
    j = jnp.array(np.array(a, copy=True)).astype(getattr(jnp, dtype))
    return j, torch.tensor(a).to(getattr(torch, dtype))


def ints(a):
    a = np.asarray(a, np.int32)
    return jnp.array(np.array(a, copy=True)), torch.tensor(a)


def attention64(q, k, v, qpos, kpos, window, scale):
    """The attention the kernels compute, in float64 on the host from the
    torch inputs: masked softmax over the key axis (a row with no live key
    gives 0, as the kernels do).  q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd)."""
    q, k, v = (x.double().numpy() for x in (q, k, v))
    qp, kp = qpos.numpy()[:, :, None], kpos.numpy()[:, None, :]
    mask = kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = np.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    s = np.where(mask[:, None, None], s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    e = np.where(mask[:, None, None], np.exp(s - np.where(np.isfinite(m), m,
                                                          0.0)), 0.0)
    w = e / np.maximum(e.sum(axis=-1, keepdims=True), 1e-300)
    return np.einsum("bkgqs,bskh->bqkgh", w, v)


def close(port, ref, atol, rows=None, sides=None):
    """``port`` within ``atol`` of ``ref``.  ``sides`` (name -> output) and
    a float64 truth under ``"float64"``: the failure message then gives each
    side's largest distance from the truth, naming the side that moved."""
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    if rows is not None:
        p, r = p[rows], r[rows]
    msg = ""
    if sides is not None:
        truth = np.asarray(sides["float64"])
        msg = "max |side - float64|: " + ", ".join(
            f"{name} {np.max(np.abs(np.asarray(out, np.float64) - truth)):.3e}"
            for name, out in sides.items() if name != "float64")
    np.testing.assert_allclose(p, r, atol=atol, rtol=0, err_msg=msg)


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
    (1, 40, 2, 1, 112, 112, 24, 8),      # zamba2's head dim, G 1, a window
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
    sides = {"port": port.float().numpy(),
             "pallas": np.asarray(jax.block_until_ready(pallas), np.float32),
             "oracle": np.asarray(jax.block_until_ready(oracle), np.float32),
             "float64": attention64(q[1], k[1], v[1], qp[1], kp[1], win,
                                    scale)}
    close(port, pallas, atol, sides=sides)
    close(port, oracle, atol, sides=sides)


def test_inputs_are_copies_and_a_moved_side_is_named():
    """The two packages never share an input buffer, even where the NumPy
    source is 64-byte aligned (the JAX CPU client then backs an array with
    it without a copy); and a comparison that fails names the side that
    moved from the float64 attention."""
    raw = np.zeros(8192 + 16, np.float32)
    off = (-raw.ctypes.data % 64) // 4
    src = raw[off:off + 8192].reshape(2, 64, 2, 2, 16)
    assert src.ctypes.data % 64 == 0
    src[...] = np.random.default_rng(0).standard_normal(src.shape)
    for dtype in DTYPES:
        j, t = both(src, dtype)
        ptrs = {j.unsafe_buffer_pointer(), t.data_ptr(), src.ctypes.data}
        assert len(ptrs) == 3, dtype
    qi = ints(np.arange(64, dtype=np.int32))
    assert qi[0].unsafe_buffer_pointer() != qi[1].data_ptr()
    q, k, v, qp, kp = attn_inputs(2, 64, 2, 2, 16, 16, "float32")
    port = FA.flash_attention_plain(q[1], k[1], v[1], qp[1], kp[1], 0, 0.25)
    truth = attention64(q[1], k[1], v[1], qp[1], kp[1], 0, 0.25)
    assert np.max(np.abs(port.double().numpy() - truth)) < 2e-6
    moved = port.float().numpy().copy()
    moved[0, 3, 1, 0, :4] += 7e-5                   # a planted shift
    with pytest.raises(AssertionError, match=r"pallas 7\.0\d*e-05"):
        close(port, moved, 2e-5,
              sides={"port": port.float().numpy(), "pallas": moved,
                     "float64": truth})


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
    (2, 24, 2, 1, 112, 0, 8, (7, 40)),   # zamba2's head dim, G 1, wrapped
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
    truth = attention64(q[1][:, None], ck[1], cv[1], qp[1][:, None], kp[1],
                        win, scale)[:, 0]
    sides = {"port": port.float().numpy(),
             "pallas": np.asarray(jax.block_until_ready(pallas), np.float32),
             "oracle": np.asarray(jax.block_until_ready(oracle), np.float32),
             "float64": truth}
    close(port, pallas, atol, sides=sides)
    close(port, oracle, atol, sides=sides)


def lse64(q, k, qpos, kpos, window, scale):
    """Each decode row's log-sum-exp of its scaled live scores in float64
    (-inf without a live key).  q (B,KV,G,hd), k (B,W,KV,hd)."""
    s = np.einsum("bkgh,bskh->bkgs", q.double().numpy(),
                  k.double().numpy()) * scale
    qp, kp = qpos.numpy()[:, None], kpos.numpy()
    live = kp <= qp
    if window:
        live &= (qp - kp) < window
    s = np.where(live[:, None, None], s, -np.inf)
    m = np.max(s, axis=-1)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return safe + np.log(np.sum(np.exp(s - safe[..., None]), axis=-1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,KV,G,hd,win,blk,pos", DECODE_CASES)
def test_flash_decode_plain_lse_halves_combine_to_pallas(B, W, KV, G, hd, win,
                                                         blk, pos, dtype):
    """``return_lse``: each window half's (out, lse), merged by the lse as
    placed decode merges its ranks' slices (``layers.merge_by_lse``: the
    max with a finite floor, then the weighted sum), equals the
    reference's kernel over the whole
    window (interpret mode) at the file's tolerance; each lse is its half's
    float64 log-sum-exp (1e-5 in float32, 1e-2 in bf16, whose q / k round
    to 8 bits), and a half with no live key gives lse -inf and 0."""
    rng = np.random.default_rng(1)
    q = both(rng.standard_normal((B, KV, G, hd)), dtype)
    ck = both(rng.standard_normal((B, W, KV, hd)), dtype)
    cv = both(rng.standard_normal((B, W, KV, hd)), dtype)
    qp, kp = ints(pos), ints(ring_kpos(pos, W))
    scale = 1 / np.sqrt(hd)
    h = W // 2
    halves = [FD.flash_decode_plain(q[1], ck[1][:, sl], cv[1][:, sl], qp[1],
                                    kp[1][:, sl], win, scale, blk,
                                    return_lse=True)
              for sl in (slice(0, h), slice(h, W))]
    tol = 1e-5 if dtype == "float32" else 1e-2
    for (out, lse), sl in zip(halves, (slice(0, h), slice(h, W))):
        assert lse.dtype == torch.float32 and lse.shape == (B, KV, G)
        want = lse64(q[1], ck[1][:, sl], qp[1], kp[1][:, sl], win, scale)
        dead = np.isneginf(want)
        assert np.array_equal(np.isneginf(lse.numpy()), dead)
        np.testing.assert_allclose(lse.numpy()[~dead], want[~dead], rtol=0,
                                   atol=tol * max(1.0, np.abs(want[~dead])
                                                  .max(initial=0)))
        assert torch.all(out.float()[torch.from_numpy(dead)] == 0)
    lses = torch.stack([lse for _, lse in halves])
    merged = L.merge_by_lse(torch.stack([o for o, _ in halves]), lses)
    assert torch.isfinite(merged).all()
    pallas = flash_decode_pallas(q[0], ck[0], cv[0], qp[0], kp[0],
                                 scale=scale, window=win, kv_block=blk,
                                 interpret=True)
    close(merged.to(getattr(torch, dtype)), np.asarray(
        jax.block_until_ready(pallas), np.float32), ATOL[("attention", dtype)])
    whole = FD.flash_decode(q[1], ck[1], cv[1], qp[1], kp[1], win, scale, blk,
                            return_lse=True)
    torch.testing.assert_close(whole[1], torch.logaddexp(*lses),
                               rtol=0, atol=tol)


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
@pytest.mark.parametrize("name", ["flash_decode", "flash_attention"])
def test_row_check_rejects_planted_faults_on_long_rows(name):
    """Rows over thousands of live keys output ~sqrt(e / n), so an absolute
    limit of 3e-2 cannot tell a wrong window edge from a right answer.  The
    row-relative check of ``chip_smoke.py`` passes a correct answer computed
    another way (``attention_chunked``: online softmax in kv blocks) and
    rejects every planted fault."""
    cs = chip_smoke()
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


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode"])
def test_row_check_rejects_head_tail_faults_at_hd_112(name):
    """At zamba2's head dim 112 each row is loaded as two 64-column TMA
    boxes (the second zero-filled past 112): the row check of
    ``chip_smoke.py`` must reject the scores without their last 16 dims
    (Q K^T's last k step lost) and the output past column 64 at zero (P V's
    second box lost), over a prefill of 1,024 keys and a ring cache."""
    cs = chip_smoke()
    g = torch.Generator().manual_seed(7)
    bf16, hd = torch.bfloat16, 112
    if name == "flash_decode":
        B, W, KV, G = 4, 1024, 4, 1
        q = torch.randn(B, KV, G, hd, generator=g).to(bf16)
        ck, cv = (torch.randn(B, W, KV, hd, generator=g).to(bf16)
                  for _ in range(2))
        pos = torch.tensor([1023, 1500, 600, 2047], dtype=torch.int32)
        args = (q, ck, cv, pos, L.ring_kpos(pos, W), 0, hd ** -0.5)
        plain = FD.flash_decode_plain
    else:
        B, S, KV, G = 1, 1024, 4, 1
        q = torch.randn(B, S, KV, G, hd, generator=g).to(bf16)
        k, v = (torch.randn(B, S, KV, hd, generator=g).to(bf16)
                for _ in range(2))
        p = torch.arange(S, dtype=torch.int32)[None]
        args = (q, k, v, p, p, 0, hd ** -0.5)
        plain = FA.flash_attention_plain
    ref = plain(*args)
    faults = cs.head_tail_faults(args, plain, ref)
    assert sorted(faults) == ["out_second_box_zero", "scores_tail_dropped"]
    for fault, out in faults.items():
        res = cs.llm_check("attention", out, ref, bf16)
        assert not res["ok"], fault
        assert res["max_row_rel_err"] > cs.LLM_ROW_RTOL[bf16], fault


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs these comparisons on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,KV,G,hdq,hdv,win,blk", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(B, S, KV, G, hdq, hdv, win, blk,
                                            dtype, cuda_device):
    """The kernel against the plain version (atol by dtype) on
    ``attn_inputs`` with queries 3 positions back; the case runs in
    ``chip_smoke.py`` (``card_flash_attention``), which the card's machine
    can run."""
    chip_smoke().card_case("test_cuda_flash_attention_matches_plain", B, S,
                            KV, G, hdq, hdv, win, blk, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,KV,G,hd,win,blk,pos", DECODE_CASES)
def test_cuda_flash_decode_matches_plain(B, W, KV, G, hd, win, blk, pos,
                                         dtype, cuda_device):
    """The kernel against the plain version (atol by dtype) over a ring
    cache; runs as ``chip_smoke.py``'s ``card_flash_decode``."""
    chip_smoke().card_case("test_cuda_flash_decode_matches_plain", B, W, KV,
                            G, hd, win, blk, pos, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("N,d,F", [(32, 64, 96), (4, 80, 64), (70, 300, 130),
                                   (12, 64, 130), (3, 100, 77)])
def test_cuda_fused_mlp_matches_plain(N, d, F, act, dtype, cuda_device):
    """The kernel the rule picks against the plain version (``llm_check``:
    atol 2e-5 in float32; in bf16 max(5e-2, one bf16 ulp of |ref|)); runs
    as ``chip_smoke.py``'s ``card_fused_mlp``."""
    chip_smoke().card_case("test_cuda_fused_mlp_matches_plain", N, d, F,
                            act, dtype)


# ------------------------------------------------- which device kernel runs
def test_attention_dispatch_rule():
    """``_variant`` is a function of dtype, head dims and alignment alone:
    every dense config of the port gets the wgmma/TMA kernel at its head
    dim in bfloat16 except gemma-2b's 256 (the WMMA kernel); float32 gets
    the CUDA-core kernel; a misaligned view never gets a TMA path."""
    from repro_torch.configs import get_config, list_configs
    bf16, f32 = torch.bfloat16, torch.float32
    dense = [get_config(n) for n in list_configs()
             if get_config(n).family == "dense"]
    assert {c.head_dim for c in dense} == {64, 80, 128, 256}
    for cfg in dense:
        hd = cfg.head_dim
        want = "wmma" if hd == 256 else "wgmma_tma"
        assert FA._variant(bf16, hd, hd, True) == want, cfg.name
        assert FA._variant(bf16, hd, hd, False) == "wmma", cfg.name
        assert FA._variant(f32, hd, hd, True) == "cuda_cores", cfg.name
    # the hybrid family's shared tile (zamba2-7b: hd 112) since its slice
    assert FA._variant(bf16, get_config("zamba2-7b").head_dim, 112,
                       True) == "wgmma_tma"
    assert FA._variant(bf16, 80, 64, True) == "wmma"      # unequal dims
    assert FA._variant(bf16, 96, 96, True) == "wmma"      # uncovered dim
    assert set(FA.VARIANTS) == {"cuda_cores", "wmma", "wgmma_tma"}
    buf = torch.zeros(1 + 2 * 8 * 80, dtype=bf16)
    view = buf[1:].view(1, 8, 2, 1, 80)
    assert view.is_contiguous() and not aligned16(view)
    assert aligned16(buf)


def test_mlp_dispatch_rule():
    """``_variant`` of the fused MLP: at most 8 bfloat16 rows (decode) with
    d and F multiples of 8 and aligned operands take the gemv/TMA kernel at
    every dense config's widths; other rows <= 8 (float32, odd widths, a
    misaligned view) the weight-streaming rows kernel; more rows take the
    CUDA-core kernel in float32, and in bfloat16 the wgmma/TMA pair at
    every dense config's widths (d, F multiples of 8), the WMMA kernel for
    odd widths or a misaligned view."""
    from repro_torch.configs import get_config, list_configs
    bf16, f32 = torch.bfloat16, torch.float32
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family != "dense":
            continue
        d, F = cfg.d_model, cfg.d_ff
        assert FM._variant(bf16, 4608, d, F, True) == "wgmma_tma", name
        assert FM._variant(bf16, 9, d, F, True) == "wgmma_tma", name
        assert FM._variant(bf16, 4608, d, F, False) == "wmma", name
        assert FM._variant(f32, 4608, d, F, True) == "cuda_cores", name
        for N in range(1, 9):        # decode, up to 8 slots
            assert FM._variant(bf16, N, d, F, True) == "gemv_tma", name
        if 4 * 4 * d <= FM.ROWS_MAX_SMEM:    # the 4-slot decode otherwise
            assert FM._variant(bf16, 4, d, F, False) == "rows", name
            assert FM._variant(f32, 4, d, F, True) == "rows", name
    assert FM._variant(bf16, 100, 100, 77, True) == "wmma"   # F % 8 != 0
    assert FM._variant(bf16, 100, 300, 64, True) == "wmma"   # d % 8 != 0
    assert FM._variant(bf16, 4, 100, 77, True) == "rows"     # F % 8 != 0
    assert FM._variant(bf16, 4, 300, 64, True) == "rows"     # d % 8 != 0
    # the rows kernel keeps its float32 rows in 160 KB of shared memory
    assert FM._variant(f32, 8, 5120, 64, True) == "rows"
    assert FM._variant(f32, 8, 5128, 64, True) == "cuda_cores"
    # gemv_tma keeps its bf16 rows and the scale beside two ring stages:
    # a wide enough d falls through to the other kernels
    widest = max(d for d in range(64, 20000, 64) if FM.gemv_stages(8, d) >= 2)
    assert 8192 <= widest < 19000
    assert FM._variant(bf16, 8, widest, 64, True) == "gemv_tma"
    assert FM._variant(bf16, 8, widest + 64, 64, True) == "wgmma_tma"
    assert FM._variant(bf16, 1, widest + 64, 64, True) == "gemv_tma"
    assert set(FM.VARIANTS) == {"cuda_cores", "wmma", "rows", "wgmma_tma",
                                "gemv_tma"}


@pytest.mark.parametrize("d,F", [(2048, 16384), (4096, 14336), (2560, 6912),
                                 (2048, 8192), (5120, 17920), (8192, 22016),
                                 (200, 1000), (64, 8)])
@pytest.mark.parametrize("n_sm", [132, 114, 7])
def test_gemv_split_covers_every_chunk_once(d, F, n_sm):
    """``gemv_plan``: block b's run of chunks [b * total / blocks, (b + 1) *
    total / blocks) covers every chunk once, the runs differ by at most
    one chunk (every SM streams the same bytes), and no strip is shared by
    more than ``maxseg`` blocks (the partials' scratch)."""
    blocks, strips, maxseg = FM.gemv_plan(d, F, n_sm)
    cols, krows = 64 * FM.GEMV_BOXES, FM.GEMV_KROWS
    assert strips == -(-F // cols)
    kc = -(-d // krows)
    total = strips * kc
    assert blocks == min(n_sm, total)
    runs = [(b * total // blocks, (b + 1) * total // blocks)
            for b in range(blocks)]
    assert runs[0][0] == 0 and runs[-1][1] == total
    assert all(runs[i][1] == runs[i + 1][0] for i in range(blocks - 1))
    sizes = [hi - lo for lo, hi in runs]
    assert max(sizes) - min(sizes) <= 1
    for s in range(strips):
        owners = {b for b, (lo, hi) in enumerate(runs)
                  if lo < (s + 1) * kc and hi > s * kc}
        assert 1 <= len(owners) <= maxseg


# ------------------------------------------- the wgmma/TMA paths' edges, card
# B, Sq, Sk, KV, G, hd, window, q positions (kind, first), k positions
EDGE_ATTN = [
    (2, 200, 200, 2, 2, 80, 0, ("arange", 0), "arange"),    # ragged tiles
    (1, 150, 400, 2, 4, 128, 0, ("arange", 250), "arange"),  # Sk > Sq
    (1, 150, 400, 1, 2, 64, 100, ("arange", 250), "arange"),  # + window
    (1, 300, 300, 2, 2, 64, 0, ("perm", 0), "perm"),        # non-monotone
    (1, 260, 260, 1, 2, 128, 90, ("perm", 0), "perm"),
    (1, 512, 512, 2, 2, 80, 130, ("arange", 0), "arange"),  # live by window
    (1, 300, 300, 2, 2, 80, 0, ("arange", -40), "arange"),  # rows no key
    (2, 1000, 1000, 2, 4, 80, 300, ("arange", 0), "arange"),  # full tiles
    (1, 384, 384, 1, 1, 128, 0, ("arange", 0), "arange"),   # exact tiles
    # zamba2's head dim 112 (two TMA boxes, 16 columns of zero fill), G 1
    (2, 200, 330, 2, 1, 112, 0, ("arange", 130), "arange"),  # ragged, offset
    (1, 300, 300, 4, 1, 112, 100, ("arange", 0), "arange"),  # a window
    (1, 260, 260, 2, 2, 112, 0, ("perm", 0), "perm"),       # non-monotone
    (1, 300, 300, 2, 1, 112, 0, ("arange", -40), "arange"),  # rows no key
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,win,qk,kk", EDGE_ATTN)
def test_cuda_flash_attention_wgmma_edges(B, Sq, Sk, KV, G, hd, win, qk, kk,
                                          cuda_device):
    """The wgmma/TMA kernel against the plain version (bf16) at its edges:
    ragged query and key tiles, a prefix in the cache, non-monotone
    positions, a kv tile live only through the window, rows with no live
    key, full tiles, head dims 64 / 80 / 112 / 128; atol 3e-2 and 2e-2 of each
    output row's largest value (``chip_smoke.py``,
    ``card_flash_attention_wgmma_edges``)."""
    chip_smoke().card_case("test_cuda_flash_attention_wgmma_edges", B, Sq,
                            Sk, KV, G, hd, win, qk, kk)


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,F,act", [
    (200, 256, 384, "silu"),        # N not a multiple of 128
    (300, 2560, 6912, "silu"),      # h2o-danube's widths
    (150, 2048, 5632, "gelu"),
    (130, 512, 1000, "gelu"),       # F not a multiple of 128
    (100, 200, 136, "silu"),        # d not a multiple of 64
])
def test_cuda_fused_mlp_wgmma_edges(N, d, F, act, cuda_device):
    """The wgmma/TMA pair against the plain version (bf16, the MLP limit of
    ``llm_check``) at ragged row, column and depth tiles, silu and gelu
    (``card_fused_mlp_wgmma_edges``)."""
    chip_smoke().card_case("test_cuda_fused_mlp_wgmma_edges", N, d, F, act)


@pytest.mark.gpu
def test_cuda_misaligned_views_take_the_wmma_kernels(cuda_device):
    """A contiguous view that starts 2 bytes into its buffer is not a TMA
    operand: the wrappers launch the WMMA kernels, which agree with the
    plain versions (``card_misaligned_views``)."""
    chip_smoke().card_case(
        "test_cuda_misaligned_views_take_the_wmma_kernels")


# --------------------------------------- the gemv/TMA decode kernel's edges
# N, d, F, act: N from 1 to 8 at every dense config's (d, F), silu and
# gelu; F off the strip and d off the chunk (chip_smoke.py EDGE_MLP_ROWS
# holds the same)
DENSE_WIDTHS = [(2048, 16384), (4096, 14336), (2560, 6912), (2048, 8192),
                (5120, 17920), (8192, 22016)]
EDGE_MLP_ROWS = [(N, d, F, "gelu" if N in (1, 3) else "silu")
                 for d, F in DENSE_WIDTHS for N in (1, 3, 4, 8)] + [
    (4, 2560, 1000, "gelu"),        # F not a multiple of the strip
    (3, 200, 1000, "silu"),         # and d not a multiple of the chunk
]


def test_edge_mlp_rows_cases_matchchip_smoke():
    """The gpu test's list is chip_smoke.py's, and it holds every dense
    config's (d, F) (``configs/*.py``), N = 1, 3, 4 and 8, silu and gelu,
    and a width off the strip."""
    from repro_torch.configs import get_config, list_configs
    cs = chip_smoke()
    assert [tuple(c) for c in EDGE_MLP_ROWS] == list(cs.EDGE_MLP_ROWS)
    widths = {(get_config(n).d_model, get_config(n).d_ff)
              for n in list_configs() if get_config(n).family == "dense"}
    assert widths == set(DENSE_WIDTHS) == set(cs.DENSE_WIDTHS)
    for d, F in widths:
        assert {N for N, dd, FF, _ in EDGE_MLP_ROWS
                if (dd, FF) == (d, F)} == {1, 3, 4, 8}
    assert {act for *_, act in EDGE_MLP_ROWS} == {"silu", "gelu"}
    assert any(F % (64 * FM.GEMV_BOXES) for _, _, F, _ in EDGE_MLP_ROWS)
    assert any(d % FM.GEMV_KROWS for _, d, _, _ in EDGE_MLP_ROWS)
    bf16 = torch.bfloat16
    assert all(FM._variant(bf16, N, d, F, True) == "gemv_tma"
               for N, d, F, _ in EDGE_MLP_ROWS)
    N, d, F, _ = cs.MISALIGNED_MLP_ROWS
    assert FM._variant(bf16, N, d, F, False) == "rows"


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,F,act", EDGE_MLP_ROWS)
def test_cuda_fused_mlp_gemv_edges(N, d, F, act, cuda_device):
    """The gemv/TMA kernel against the plain version (bf16, the MLP limit)
    at every dense width and N from 1 to 8, and the check rejects each
    planted fault there (``card_fused_mlp_gemv_edges``)."""
    chip_smoke().card_case("test_cuda_fused_mlp_gemv_edges", N, d, F, act)


@pytest.mark.gpu
def test_cuda_misaligned_decode_mlp_takes_the_rows_kernel(cuda_device):
    """A decode x that is no TMA operand takes the rows kernel, which
    agrees with the plain version (``card_misaligned_decode_mlp``)."""
    chip_smoke().card_case(
        "test_cuda_misaligned_decode_mlp_takes_the_rows_kernel")


# ------------------------------------- the MLP check chip_smoke.py applies
def test_mlp_limit_is_one_bf16_ulp_above_8_and_5e2_below():
    """``llm_check``'s bf16 MLP limit is max(5e-2, one bf16 ulp of |ref|):
    an output one ulp off at |ref| in [8, 16) passes (2^-4 > 5e-2), 5e-2
    plus a little at |ref| < 8 fails, and the limit is never a constant
    above 5e-2 for |ref| < 8."""
    cs = chip_smoke()
    bf16 = torch.bfloat16
    ref = torch.tensor([[8.0, 9.5, 15.875, 3.0, -12.0]]).to(bf16)
    ulp = torch.tensor([[2 ** -4, 2 ** -4, 2 ** -4, 2 ** -6, 2 ** -4]])
    assert torch.equal(cs.bf16_ulp(ref), ulp)
    out = (ref.float() + ulp).to(bf16)
    assert out.float().sub(ref.float()).abs().max() == 2 ** -4
    assert cs.llm_check("mlp", out, ref, bf16)["ok"]
    small = torch.tensor([[7.5, 0.25, -3.0, 0.0]])
    lim = cs.mlp_limit(small, 5e-2)
    assert torch.all(lim == 5e-2)
    bad = small.clone()
    bad[0, 1] += 5e-2 + 2e-3
    assert not cs.llm_check("mlp", bad, small, torch.bfloat16)["ok"]
    assert cs.llm_check("mlp", small + 4e-2, small, torch.bfloat16)["ok"]
    # float32 and attention keep their constant limits
    assert not cs.llm_check("mlp", ref.float() + 1e-4, ref.float(),
                            torch.float32)["ok"]
    assert not cs.llm_check("attention", out, ref, bf16)["ok"]


def test_mlp_check_rejects_planted_faults():
    """At a decode shape of real width the MLP check passes the plain
    version's own answer computed another way (float64 products, rounded
    once) and rejects each planted fault: a 64-row k range of one strip
    left out, one strip's outputs zero, gate and up swapped."""
    cs = chip_smoke()
    g = torch.Generator().manual_seed(8)
    bf16 = torch.bfloat16
    N, d, F = 2, 2048, 1024
    x = torch.randn(N, d, generator=g).to(bf16)
    s = (0.1 * torch.randn(d, generator=g)).to(bf16)
    wg, wu = ((0.02 * torch.randn(d, F, generator=g)).to(bf16)
              for _ in range(2))
    args = (x, s, wg, wu, "silu", 1e-5)
    ref = FM.fused_rmsnorm_mlp_plain(*args)
    xn = L.rms_norm(x, s, 1e-5).double()
    other = (torch.nn.functional.silu(xn @ wg.double())
             * (xn @ wu.double())).to(bf16)
    assert cs.llm_check("mlp", other, ref, bf16)["ok"]
    faults = cs.mlp_planted_faults(args, ref)
    assert set(faults) == {"dropped_k_range", "dropped_strip",
                           "gate_up_swapped"}
    for fault, out in faults.items():
        assert not cs.llm_check("mlp", out, ref, bf16)["ok"], fault
    assert all(f["rejected"] for f in cs.mlp_faults_rejected(args, ref)
               .values())


# ----------------------------------------- the cp_async decode sweep (rule)
def test_decode_dispatch_rule():
    """``flash_decode._variant`` is a function of the cache dtype, head
    dims, G and alignment alone: every dense config of the port gets the
    cp_async sweep for its bf16 cache at its head dim except gemma-2b's 256
    (the CUDA-core sweep); a float32 cache, odd head dims, G > 16 or a
    misaligned view never get it."""
    from repro_torch.configs import get_config, list_configs
    bf16, f32 = torch.bfloat16, torch.float32
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family != "dense":
            continue
        hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        want = "cuda_cores" if hd > 128 else "cp_async"
        assert FD._variant(bf16, hd, hd, G, True) == want, name
        assert FD._variant(bf16, hd, hd, G, False) == "cuda_cores", name
        assert FD._variant(f32, hd, hd, G, True) == "cuda_cores", name
    assert FD._variant(bf16, 72, 72, 16, True) == "cp_async"
    assert FD._variant(bf16, 80, 76, 4, True) == "cuda_cores"   # hd_v % 8
    assert FD._variant(bf16, 20, 16, 4, True) == "cuda_cores"   # hd % 8
    assert FD._variant(bf16, 64, 64, 17, True) == "cuda_cores"  # G > 16
    assert FD._variant(bf16, 64, 136, 2, True) == "cuda_cores"  # hd_v > 128
    assert FD._variant(bf16, 64, 64, 2, True, 2 ** 18) == "cp_async"
    assert FD._variant(bf16, 64, 64, 2, True, 2 ** 18 + 1) == "cuda_cores"
    assert set(FD.VARIANTS) == {"cuda_cores", "cp_async"}


@pytest.mark.parametrize("bkv,W,kv_block,n_sm", [
    (32, 4096, 512, 132),        # the dense serving shape: 32 x 8 blocks
    (32, 4096, 128, 132),        # kv_block caps the split
    (2, 32, 8, 132),             # a split shorter than a warp step
    (1, 100, 512, 132),          # one short row: the whole row in one block
    (6, 1000, 512, 132),         # W not a multiple of the split
    (256, 32768, 4096, 132),     # a large batch: the split's upper limit
    (8, 4096, 512, 114),         # another SM count
    (1, 40000, 8, 132),          # more than MAX_SPLITS partials
])
def test_decode_split_rule(bkv, W, kv_block, n_sm):
    """``decode_split``: at most ``kv_block``, ``MAX_SPLIT`` and W slots;
    otherwise the fewest whole 64-slot warp steps with which
    ``BLOCKS_PER_SM`` blocks per SM hold every row, so the grid ``bkv x
    ceil(W / split)`` covers the SMs several times over; never more than
    ``MAX_SPLITS`` splits of a row."""
    split = FD.decode_split(bkv, W, kv_block, n_sm)
    assert -(-W // split) * FD.PARTS_PER_SPLIT <= FD.MAX_SPLITS
    if W * FD.PARTS_PER_SPLIT <= kv_block * FD.MAX_SPLITS:
        assert 1 <= split <= min(kv_block, FD.MAX_SPLIT, W)
    target = FD.BLOCKS_PER_SM * n_sm
    capped = split in (kv_block, FD.MAX_SPLIT, W,
                       -(-W * FD.PARTS_PER_SPLIT // FD.MAX_SPLITS))
    if not capped:
        assert split % FD.SPLIT_STEP == 0
        assert split * target >= bkv * W                  # enough slots
        assert split == FD.SPLIT_STEP or \
            (split - FD.SPLIT_STEP) * target < bkv * W    # the fewest
    blocks = bkv * -(-W // split)
    assert blocks >= n_sm or capped or split == FD.SPLIT_STEP
    if (bkv, W, kv_block, n_sm) == (32, 4096, 512, 132):
        assert split == 512 and blocks == 256


def test_decode_launch_refusals_and_split_record():
    """On CPU tensors the wrapper runs the plain version and leaves the
    launch count, ``last_variant`` and ``last_split`` alone; ``_launch``
    refuses bad shapes before touching the build."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 64)).astype(
        np.float32)).to(torch.bfloat16)
    ck = torch.zeros(2, 100, 2, 64, dtype=torch.bfloat16)
    pos = torch.tensor([10, 99], dtype=torch.int32)
    kp = L.ring_kpos(pos, 100)
    before = (FD.flash_decode.launches, FD.flash_decode.last_variant,
              FD.flash_decode.last_split, FD._FN)
    out = FD.flash_decode(q, ck, ck, pos, kp, 0, 0.125, 32)
    assert out.shape == (2, 2, 4, 64)
    with pytest.raises(ValueError, match="does not match"):
        FD._launch(q, ck[:, :, :1].contiguous(), ck, pos, kp, 0, 0.125, 32)
    with pytest.raises(ValueError, match="kv_block"):
        FD._launch(q, ck, ck, pos, kp, 0, 0.125, 0)
    assert (FD.flash_decode.launches, FD.flash_decode.last_variant,
            FD.flash_decode.last_split, FD._FN) == before


@pytest.mark.parametrize("split", [512, 64])
def test_row_check_rejects_a_dropped_split_at_the_kernels_split(split):
    """At the dense serving shape the cp_async sweep splits the 4,096 ring
    into 512-slot blocks (``decode_split``); the row check must still see
    one such split left out, and one of 64 slots (the smallest split the
    rule makes from whole warp steps) on a short ring where it is a large
    share of the live slots."""
    cs = chip_smoke()
    g = torch.Generator().manual_seed(6)
    bf16 = torch.bfloat16
    if split == 512:
        B, W, KV, G, hd, win = 4, 4096, 8, 4, 80, 4096
        pos = torch.tensor([4638, 4639, 3103, 2300], dtype=torch.int32)
        assert FD.decode_split(B * KV, W, 512, 132) == split
    else:
        B, W, KV, G, hd, win = 2, 256, 2, 4, 80, 0
        pos = torch.tensor([255, 300], dtype=torch.int32)
        assert FD.decode_split(B * KV, W, 512, 132) == split
    q = torch.randn(B, KV, G, hd, generator=g).to(bf16)
    ck, cv = (torch.randn(B, W, KV, hd, generator=g).to(bf16)
              for _ in range(2))
    args = (q, ck, cv, pos, L.ring_kpos(pos, W), win, hd ** -0.5)
    ref = FD.flash_decode_plain(*args)
    faults = cs.planted_faults("flash_decode", args, FD.flash_decode_plain,
                               ref, split=split)
    res = cs.llm_check("attention", faults["dropped_split"], ref, bf16)
    assert not res["ok"]
    assert res["max_row_rel_err"] > cs.LLM_ROW_RTOL[bf16]


# B, W, KV, G, hd, hd_v, window, positions, kv_block, q dtype, ring
EDGE_DECODE = [
    (3, 1000, 2, 4, 64, 64, 0, (5, 999, 2500), 512, "bf16", "ring"),  # W % 64
    (2, 333, 1, 8, 128, 128, 100, (50, 700), 37, "bf16", "ring"),  # window
    (2, 2048, 2, 4, 80, 80, 0, (3000, 3000), 512, "bf16", "perm"),  # wrapped
    (2, 2048, 2, 4, 80, 80, 0, (100, 100), 512, "bf16", "ring"),  # dead split
    (2, 4096, 1, 16, 128, 128, 0, (10, 5000), 512, "bf16", "ring"),  # 2,048
    (2, 500, 2, 2, 72, 72, 0, (100, 900), 512, "bf16", "ring"),  # hd % 16 = 8
    (2, 500, 2, 5, 128, 64, 200, (499, 900), 512, "f32", "ring"),  # f32 q
    (4, 4096, 8, 4, 80, 80, 4096, (4638, 4639, 3103, 2300), 512, "bf16",
     "ring"),                                                     # serving
]


def test_edge_decode_cases_matchchip_smoke():
    assert [tuple(c) for c in EDGE_DECODE] == sorted(
        chip_smoke().EDGE_DECODE, key=lambda c: [tuple(x) for x in
                                                  EDGE_DECODE].index(c))


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,KV,G,hd,hdv,win,pos,blk,qd,ring", EDGE_DECODE)
def test_cuda_flash_decode_cp_async_edges(B, W, KV, G, hd, hdv, win, pos,
                                          blk, qd, ring, cuda_device):
    """The cp_async sweep against the plain version at its edges: W not a
    multiple of the split or of a warp step, a window, a ring wrapped with
    slots and positions permuted and an unwritten run, all-dead splits,
    G * hd_v = MAX_GROUP_OUT, hd 64 / 72 / 80 / 128, a float32 q over the
    bf16 cache; abs limit by q's dtype and the row check
    (``card_flash_decode_cp_async_edges``)."""
    chip_smoke().card_case("test_cuda_flash_decode_cp_async_edges", B, W,
                            KV, G, hd, hdv, win, pos, blk, qd, ring)


# B, W, KV, G, hd, window, positions, part (-1 a ring of W, 0 / 1 a half
# of a ring of 2 W), dtype
CARD_DECODE_LSE = [
    (3, 32, 2, 4, 80, 16, (5, 31, 50), -1, "float32"),
    (2, 64, 1, 8, 16, 0, (3, 10), 1, "float32"),              # no live key
    (2, 500, 2, 2, 72, 0, (100, 900), 0, "bfloat16"),
    (2, 256, 2, 4, 80, 0, (3, 100), 1, "bfloat16"),           # no live key
    (4, 2048, 8, 4, 80, 4096, (4638, 4639, 3103, 2300), 1,
     "bfloat16"),                                             # danube's
    (4, 2048, 32, 1, 112, 0, (4608, 4000, 30, 1), 0, "bfloat16"),  # zamba2
]


def test_decode_lse_cases_match_chip_smoke():
    assert [tuple(c) for c in CARD_DECODE_LSE] == list(
        chip_smoke().CARD_DECODE_LSE)


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,KV,G,hd,win,pos,part,dtype", CARD_DECODE_LSE)
def test_cuda_flash_decode_lse_matches_plain(B, W, KV, G, hd, win, pos, part,
                                             dtype, cuda_device):
    """``flash_decode(return_lse=True)`` on the card against its plain
    version, out and lse: both sweeps (a float32 cache takes
    ``cuda_cores``, bf16 ``cp_async``), a window, a wrapped ring and a
    slice with no live key (lse -inf, output 0) (``card_flash_decode_lse``)."""
    chip_smoke().card_case("test_cuda_flash_decode_lse_matches_plain", B, W,
                            KV, G, hd, win, pos, part, dtype)


def test_chip_smoke_misaligned_cases_pick_the_older_kernels():
    """chip_smoke.py's misaligned cases: ``misaligned`` keeps the values in
    a contiguous view that is not 16-byte aligned, and on such a cache
    (decode) or xs (the scan) each wrapper's rule picks its older kernels,
    which ``llm_kernels`` then holds against the plain versions."""
    from repro_torch.kernels import ssd_scan as SS
    cs = chip_smoke()
    B, W, KV, G, hd, hdv = cs.MISALIGNED_DECODE[:6]
    ck = torch.randn(B, W, KV, hd).to(torch.bfloat16)
    m = cs.misaligned(ck)
    assert m.is_contiguous() and torch.equal(m, ck) and not aligned16(m)
    q = torch.zeros(B, KV, G, hd, dtype=torch.bfloat16)
    assert FD._variant(ck.dtype, hd, hdv, G, aligned16(q, ck, ck),
                       W) == "cp_async"
    assert FD._variant(ck.dtype, hd, hdv, G, aligned16(q, m, ck),
                       W) == "cuda_cores"
    Bs, Ls, nh, hds, st = cs.MISALIGNED_SSD[:5]
    xs = torch.randn(Bs, Ls, nh, hds)
    assert SS._variant(hds, st, aligned16(xs)) == "tf32x3"
    assert SS._variant(hds, st, aligned16(cs.misaligned(xs))) == "cuda_cores"
    assert Ls // SS.chunk_len(Ls, cs.MISALIGNED_SSD[5]) > 1


@pytest.mark.gpu
def test_cuda_misaligned_decode_cache_takes_the_cuda_core_sweep(cuda_device):
    """A cache view that starts 2 bytes into its buffer is no cp.async
    operand: the wrapper launches the ``cuda_cores`` sweep (split =
    kv_block); so does a q view that does
    (``card_misaligned_decode_cache``)."""
    chip_smoke().card_case(
        "test_cuda_misaligned_decode_cache_takes_the_cuda_core_sweep")
