"""MLA attention (DeepSeek-V2) and the deepseek-v2-lite-16b LM of the port
against the reference's, on the CPU.

``mla_apply`` (the prefill: K and V expanded from the latent, MHA at hd_qk
``nope + rope`` and hd_v ``v_head_dim``), ``mla_decode`` (the absorbed
products over the latent cache, bf16 / float32 / int8), ``quant_kv`` /
``dequant_kv``, the folded attention schedule and the reduced deepseek LM
(one dense prelude layer, one MoE layer with a shared expert, 4 heads,
latent rank 32, rope 8, nope 16, v 16) get the same NumPy inputs and
weights on both sides (carried with ``convert.lm_params_from_numpy``).
float32 is held to rtol 1e-4 (atol 1e-6 where values cross zero, 1e-5 for
logits), bfloat16 to atol 5e-2, the folded schedule to the reference's
atol 2e-5 (``tests/test_attention.py::test_chunked_matches_naive``); int8
values and the quantiser are held bit for bit.

Two reference behaviours the port does not copy (ROADMAP queue C): the
decode mask ``idx <= slot`` sees only ``slot + 1`` keys of a wrapped ring
(``test_mla_decode_mask_is_the_ring_not_idx_le_slot``), and the engine's
int8 admission truncates the latent
(``tests/test_torch_serve_mla.py::test_int8_admission_quantises_where_the_reference_truncates``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as RL
import repro.models.params as ref_params
import repro.models.transformer as RT
import repro_torch.configs as port_configs
import repro_torch.models.layers as PL
import repro_torch.models.params as port_params
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy

ARCH = "deepseek-v2-lite-16b"
RTOL, ATOL = 1e-4, 1e-6
S, N_DECODE = 40, 4


def np32(x):
    return np.array(x, np.float32)


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np32(ref),
                               rtol=rtol, atol=atol)


def cfgs():
    return (ref_configs.get_config(ARCH).reduced(),
            port_configs.get_config(ARCH).reduced())


def spec_fields(s):
    dt = (str(s.dtype).split(".")[-1] if isinstance(s.dtype, torch.dtype)
          else np.dtype(s.dtype).name)
    return (tuple(s.shape), tuple(s.axes), dt, s.init, s.scale)


def mla_layer(seed=0, dtype=jnp.float32, unit=False):
    """One MLA layer of the reduced config: the reference's params in
    ``dtype`` and the port's copy.  ``unit`` draws every weight at 1 /
    sqrt of its fan-in (the norm at 0), so bf16 outputs are O(1)."""
    rcfg, pcfg = cfgs()
    if unit:
        rng = np.random.default_rng(seed)
        rp = {k: rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
              for k, s in RL.mla_spec(rcfg).items() if k != "kv_norm"}
        rp["kv_norm"] = np.zeros(rcfg.kv_lora_rank)
        rp = {k: jnp.asarray(a, dtype) for k, a in rp.items()}
    else:
        rp = ref_params.init_params(RL.mla_spec(rcfg),
                                    jax.random.PRNGKey(seed))
        rp = jax.tree_util.tree_map(lambda a: a.astype(dtype), rp)
    return rcfg, pcfg, rp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp), "cpu")


# ------------------------------------------------- configs and param specs
def test_config_equals_the_reference():
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(r.reduced())
    assert p.n_params() == r.n_params()
    assert p.n_active_params() == r.n_active_params()
    assert (p.family, p.attn_type, p.n_layers, p.d_model, p.n_heads,
            p.kv_lora_rank, p.qk_rope_dim, p.qk_nope_dim, p.v_head_dim,
            p.n_experts, p.top_k, p.n_shared_experts, p.d_ff_expert,
            p.n_dense_layers, p.d_ff, p.vocab_size, p.tie_embeddings) == (
        "moe", "mla", 27, 2048, 16, 512, 64, 128, 128, 64, 6, 2, 1408, 1,
        10_944, 102_400, False)


@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_param_specs_match_the_reference(variant):
    """Every leaf's shape, logical axes, dtype, init and scale, and the
    parameter count (1.5706e10 at full width); the prelude is one dense
    block with MLA attention."""
    if variant == "full":
        r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    else:
        r, p = cfgs()
    rspec, pspec = RT.LM(r).param_specs(), PT.LM(p).param_specs()
    assert (port_params.tree_map(spec_fields, pspec)
            == jax.tree_util.tree_map(spec_fields, rspec,
                                      is_leaf=ref_params.is_spec))
    n = port_params.count_params(pspec)
    assert n == ref_params.count_params(rspec)
    assert sorted(pspec["blocks"]["attn"]) == ["kv_norm", "w_dkv", "w_uk",
                                               "w_uv", "wo", "wq"]
    assert sorted(pspec["prelude"][0]) == ["attn", "attn_norm", "mlp",
                                           "mlp_norm"]
    if variant == "full":
        assert n == 15_706_484_224
        assert pspec["blocks"]["moe"]["wi_gate"].shape == (26, 64, 2048,
                                                           1408)


# ----------------------------------------------------- int8 quantisation
def exact_ties(ks):
    """float32 x whose float32 product with 127/8 is exactly k + 0.5."""
    s = np.float32(127.0 / RL.KV_QUANT_RANGE)
    out = []
    for k in ks:
        x = np.float32((k + 0.5) / float(s))
        for _ in range(8):
            if np.float32(x * s) == np.float32(k + 0.5):
                out.append(x)
                break
            x = np.nextafter(x, np.float32(np.inf if x * s < k + 0.5
                                           else -np.inf))
    return np.array(out, np.float32)


def test_quant_kv_rounds_half_to_even_and_clips_bit_for_bit():
    ties = exact_ties(range(-20, 20))
    s = np.float32(127.0 / RL.KV_QUANT_RANGE)
    halves = np.float32(ties * s)
    assert ties.size >= 30 and np.all(halves - np.floor(halves) == 0.5)
    clip = np.array([8.0, -8.0, 8.03, -8.03, 8.04, -8.04, 1e6, -1e6,
                     np.inf, -np.inf], np.float32)
    rnd = np.random.default_rng(0).standard_normal(4096).astype(
        np.float32) * 3
    x = np.concatenate([ties, clip, rnd, np.float32([0.0, -0.0])])
    ref = np.asarray(RL.quant_kv(jnp.asarray(x)))
    port = PL.quant_kv(torch.from_numpy(x))
    assert port.dtype == torch.int8
    np.testing.assert_array_equal(port.numpy(), ref)
    q = port.numpy()[:ties.size].astype(np.int64)
    assert np.all(q % 2 == 0)                             # half to even
    np.testing.assert_array_equal(
        port.numpy()[ties.size:ties.size + clip.size],
        [127, -127, 127, -127, 127, -127, 127, -127, 127, -127])
    # bf16 input: the same values through float32
    xb = torch.from_numpy(rnd).bfloat16()
    np.testing.assert_array_equal(
        PL.quant_kv(xb).numpy(),
        np.asarray(RL.quant_kv(jnp.asarray(xb.float().numpy(),
                                           jnp.bfloat16))))


def test_dequant_kv_bit_for_bit():
    q = np.arange(-128, 128, dtype=np.int8)
    ref = np.asarray(RL.dequant_kv(jnp.asarray(q)))
    port = PL.dequant_kv(torch.from_numpy(q))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), ref)


# ------------------------------------------------------------- mla_apply
@pytest.mark.parametrize("backend", ["naive", "chunked", "fused"])
def test_mla_apply_matches_the_reference(backend):
    """float32: the output and the compressed cache (ckv (B,S,r), k_rope
    (B,S,rope)); the port's ``chunked`` runs 8-token blocks (5 x 5), its
    ``fused`` the attention kernel's plain version."""
    rcfg, pcfg, rp, pp = mla_layer()
    x = np.random.default_rng(3).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    ref, (rc, rk) = RL.mla_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                 RL.AttnOptions(backend="naive"),
                                 return_cache=True)
    po = PL.AttnOptions(backend=backend, q_block=8, kv_block=8)
    port, (pc, pk) = PL.mla_apply(pp, pcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), po,
                                  return_cache=True)
    assert tuple(pc.shape) == (2, S, 32) and tuple(pk.shape) == (2, S, 8)
    close(port, ref)
    close(pc, rc)
    close(pk, rk)
    assert torch.equal(PL.mla_apply(pp, pcfg, torch.from_numpy(x),
                                    torch.from_numpy(pos), po), port)


def test_mla_apply_bf16_matches_the_reference_pallas_path():
    """bfloat16 weights and activations at unit scale: the port's
    ``fused`` (the kernel's plain version on the CPU) against the
    reference's ``"pallas"`` (its Pallas kernel in interpret mode), the
    output within atol 5e-2 and the cache within it too."""
    rcfg, pcfg, rp, pp = mla_layer(1, jnp.bfloat16, unit=True)
    x = np.random.default_rng(4).standard_normal(
        (1, 32, rcfg.d_model)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)[None]
    ref, (rc, rk) = RL.mla_apply(
        rp, rcfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        RL.AttnOptions(backend="pallas"), return_cache=True)
    port, (pc, pk) = PL.mla_apply(
        pp, pcfg, torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
        PL.AttnOptions(backend="fused"), return_cache=True)
    assert port.dtype == pc.dtype == torch.bfloat16
    assert float(np.abs(np32(ref)).max()) > 0.5
    close(port, ref, rtol=0, atol=5e-2)
    close(pc, rc, rtol=0, atol=5e-2)
    close(pk, rk, rtol=0, atol=5e-2)


def test_mla_apply_fused_calls_flash_attention_at_mla_shapes(monkeypatch):
    """Under ``fused`` the prefill reaches ``flash_attention`` once, as MHA:
    q (B,S,H,1,nope+rope), k (B,S,H,nope+rope), v (B,S,H,vh), causal, no
    window, scale 1/sqrt(nope+rope), every operand contiguous (the kernel
    refuses strided ones).  ``attention_core`` reaches it through
    ``kernels.ops`` (the autograd Function)."""
    import repro_torch.kernels.ops as FA
    calls, real = [], FA.flash_attention

    def spy(q, k, v, qpos, kpos, window, scale):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      window, scale, q.is_contiguous() and
                      k.is_contiguous() and v.is_contiguous()))
        return real(q, k, v, qpos, kpos, window, scale)

    monkeypatch.setattr(FA, "flash_attention", spy)
    _, pcfg, _, pp = mla_layer()
    x = torch.randn(1, 12, pcfg.d_model)
    PL.mla_apply(pp, pcfg, x, torch.arange(12)[None],
                 PL.AttnOptions(backend="fused"))
    assert calls == [((1, 12, 4, 1, 24), (1, 12, 4, 24), (1, 12, 4, 16), 0,
                      1.0 / np.sqrt(24), True)]


# ------------------------------------------------------- folded schedule
def ref_inputs(B, S_, KV, G, hd, hd_v=None):
    """``tests/test_attention.py``'s ``_mk`` (its key, its draws), as
    NumPy; ``hd_v`` draws v at its own head dim (MLA)."""
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    q = jax.random.normal(ks[0], (B, S_, KV, G, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S_, KV, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S_, KV, hd_v or hd), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S_, dtype=jnp.int32), (B, S_))
    return [np.asarray(a) for a in (q, k, v, pos)]


@pytest.mark.parametrize("qb", [32, 64])
def test_folded_chunked_matches_naive(qb):
    """The reference's ``test_chunked_matches_naive[True-*]`` cases on the
    port: the folded schedule against the reference's oracle at its atol
    2e-5, and against the reference's own folded schedule."""
    q, k, v, pos = ref_inputs(2, 256, 2, 3, 32)
    scale = 1 / np.sqrt(32)
    ref = RL.attention_naive(*map(jnp.asarray, (q, k, v, pos, pos)), 0,
                             scale)
    ref_folded = RL.attention_chunked(
        *map(jnp.asarray, (q, k, v, pos, pos)), 0, scale,
        RL.AttnOptions(q_block=qb, kv_block=qb, folded=True))
    out = PL.attention_chunked(
        *map(torch.from_numpy, (q, k, v, pos, pos)), 0, scale,
        PL.AttnOptions(q_block=qb, kv_block=qb, folded=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_folded),
                               atol=2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_folded_chunked_at_mla_head_dims(window):
    """hd_qk 24 and hd_v 16 (the reduced MLA's), 4 blocks of 32, with and
    without a window, against the reference's folded schedule."""
    q, k, v, pos = ref_inputs(1, 128, 4, 1, 24, hd_v=16)
    args = (q, k, v, pos, pos)
    ref = RL.attention_chunked(*map(jnp.asarray, args), window, 0.2,
                               RL.AttnOptions(q_block=32, kv_block=32,
                                              folded=True))
    out = PL.attention_chunked(*map(torch.from_numpy, args), window, 0.2,
                               PL.AttnOptions(q_block=32, kv_block=32,
                                              folded=True))
    assert tuple(out.shape) == (1, 128, 4, 1, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("Sq,Sk,blk", [(96, 96, 32), (128, 64, 32)])
def test_folded_schedule_keeps_the_reference_asserts(Sq, Sk, blk):
    """An odd block grid (3 x 3) and an unequal one (4 x 2) are refused,
    as the reference refuses them."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, Sq, 1, 1, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, Sk, 1, 8)).astype(
        np.float32))
    qp, kp = torch.arange(Sq)[None], torch.arange(Sk)[None]
    opts = dict(q_block=blk, kv_block=blk, folded=True)
    with pytest.raises(AssertionError, match="even block grid"):
        PL.attention_chunked(q, k, k, qp, kp, 0, 0.3, PL.AttnOptions(**opts))
    with pytest.raises(AssertionError, match="even block grid"):
        RL.attention_chunked(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                k.numpy(), qp.numpy(),
                                                kp.numpy())), 0, 0.3,
                             RL.AttnOptions(**opts))


# ------------------------------------------------------------- mla_decode
def latent_cache(rcfg, B, W, dtype, seed=0):
    """A latent cache (ckv (B,W,r), k_rope (B,W,rope)) of random values,
    as NumPy arrays in ``dtype`` (int8: ``quant_kv`` of them)."""
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((B, W, rcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, W, rcfg.qk_rope_dim)).astype(np.float32)
    if dtype == "int8":
        return [np.asarray(RL.quant_kv(jnp.asarray(a))) for a in (ckv, kr)]
    return [np.asarray(jnp.asarray(a, dtype)) for a in (ckv, kr)]


def port_cache(arrs):
    return [lm_params_from_numpy(a, "cpu") for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mla_decode_matches_the_reference_per_row(dtype):
    """Three rows at their own positions below W (3, 17, 30 of 32): each
    row against the reference's decode of that row alone at its scalar
    position; the output and the cache row written in place (int8: bit
    for bit, the latent through ``quant_kv``)."""
    rcfg, pcfg, rp, pp = mla_layer(2)
    W, positions = 32, [3, 17, 30]
    B = len(positions)
    cache = latent_cache(rcfg, B, W, dtype)
    x = np.random.default_rng(5).standard_normal(
        (B, 1, rcfg.d_model)).astype(np.float32)
    pc = port_cache(cache)
    held = list(pc)
    out, c0, c1 = PL.mla_decode(pp, pcfg, torch.from_numpy(x), pc[0], pc[1],
                                torch.tensor(positions, dtype=torch.int32),
                                PL.AttnOptions())
    assert c0 is held[0] and c1 is held[1]                 # in place
    assert c0.dtype == torch.int8 if dtype == "int8" else True
    for b, p in enumerate(positions):
        ro, r0, r1 = RL.mla_decode(
            rp, rcfg, jnp.asarray(x[b:b + 1]), jnp.asarray(cache[0][b:b + 1]),
            jnp.asarray(cache[1][b:b + 1]), jnp.asarray(p, jnp.int32),
            RL.AttnOptions())
        close(out[b:b + 1], ro)
        for port, ref in ((c0, r0), (c1, r1)):
            if dtype == "int8":
                np.testing.assert_array_equal(port[b:b + 1].numpy(),
                                              np.asarray(ref))
            else:
                close(port[b:b + 1], ref)


def test_mla_decode_mask_is_the_ring_not_idx_le_slot():
    """The reference masks decode by ``idx <= slot`` (``models/layers.py``,
    "no wrap: W == S_max"), so past the wrap it sees ``slot + 1`` of the W
    keys its ring holds; the port masks by ``ring_kpos(pos, W) <= pos`` and
    sees all W, as its GQA decode does.  Below W the two are equal.  Past
    it, the port's decode at position P over a ring holding P-W+1..P-1
    equals its own prefill over those W positions (last row), and the
    reference's does not (ROADMAP queue C)."""
    rcfg, pcfg, rp, pp = mla_layer(3, unit=True)
    W, T = 16, 23
    P = T - 1                                     # slot P % W = 6
    x = np.random.default_rng(6).standard_normal(
        (1, T, rcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    _, (ckv, kr) = PL.mla_apply(pp, pcfg, xt[:, :P], torch.arange(P)[None],
                                PL.AttnOptions(backend="naive"),
                                return_cache=True)
    ring = [torch.zeros(1, W, a.shape[-1]) for a in (ckv, kr)]
    for p in range(P - W + 1, P):                 # the W - 1 before P
        for r, a in zip(ring, (ckv, kr)):
            r[:, p % W] = a[:, p]
    ref_ring = [r.numpy().copy() for r in ring]
    out, _, _ = PL.mla_decode(pp, pcfg, xt[:, P:P + 1], ring[0], ring[1],
                              torch.tensor([P], dtype=torch.int32),
                              PL.AttnOptions())
    fwd = PL.mla_apply(pp, pcfg, xt[:, P - W + 1:P + 1],
                       torch.arange(P - W + 1, P + 1)[None],
                       PL.AttnOptions(backend="naive"))
    close(out, fwd[:, -1:].numpy(), rtol=1e-4, atol=1e-6)
    ro, _, _ = RL.mla_decode(rp, rcfg, jnp.asarray(x[:, P:P + 1]),
                             jnp.asarray(ref_ring[0]),
                             jnp.asarray(ref_ring[1]),
                             jnp.asarray(P, jnp.int32), RL.AttnOptions())
    gap = np.abs(np32(ro) - fwd[:, -1:].numpy()).max()
    assert gap > 100 * (1e-6 + 1e-4 * np.abs(np32(ro)).max())
    # below the wrap the masks agree: position 9 of a fresh ring
    ring = [torch.zeros(1, W, a.shape[-1]) for a in (ckv, kr)]
    for r, a in zip(ring, (ckv, kr)):
        r[:, :9] = a[:, :9]
    rr = [r.numpy().copy() for r in ring]
    out, _, _ = PL.mla_decode(pp, pcfg, xt[:, 9:10], ring[0], ring[1],
                              torch.tensor([9], dtype=torch.int32),
                              PL.AttnOptions())
    ro, _, _ = RL.mla_decode(rp, rcfg, jnp.asarray(x[:, 9:10]),
                             jnp.asarray(rr[0]), jnp.asarray(rr[1]),
                             jnp.asarray(9, jnp.int32), RL.AttnOptions())
    close(out, ro)


def test_mla_decode_takes_a_scalar_position():
    """A scalar ``pos`` is broadcast over the rows, as the reference's."""
    rcfg, pcfg, rp, pp = mla_layer(4)
    cache = latent_cache(rcfg, 2, 16, "float32", seed=1)
    x = np.random.default_rng(8).standard_normal(
        (2, 1, rcfg.d_model)).astype(np.float32)
    pc = port_cache(cache)
    out, _, _ = PL.mla_decode(pp, pcfg, torch.from_numpy(x), pc[0], pc[1],
                              torch.tensor(7, dtype=torch.int32),
                              PL.AttnOptions())
    ro, _, _ = RL.mla_decode(rp, rcfg, jnp.asarray(x), jnp.asarray(cache[0]),
                             jnp.asarray(cache[1]), jnp.asarray(7, jnp.int32),
                             RL.AttnOptions())
    close(out, ro)


# ----------------------------------------------------- LM prefill / decode
def ref_lm(rcfg, **kw):
    kw.setdefault("kv_cache_dtype", jnp.float32)
    return RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False,
                 **kw)


def port_lm(pcfg, attn="fused", **kw):
    opts = PL.AttnOptions() if attn == "default" else PL.AttnOptions(
        backend=attn)
    kw.setdefault("kv_cache_dtype", torch.float32)
    return PT.LM(pcfg, opts=opts, **kw)


def folded(ref_cache):
    """The reference's (ckv, k_rope): the prelude's layer in front."""
    pre = ref_cache.get("prelude") or []
    return [np.concatenate([np.stack([np.asarray(c[j]) for c in pre]),
                            np.asarray(ref_cache["blocks"][j])])
            for j in range(2)]


@pytest.fixture(scope="module")
def ds_lm():
    """Reduced deepseek: the reference LM with float32 weights and cache,
    its prefill at cache lengths 64 (decode stays below the window) and
    24 (the 40-token history rotated into the ring), and 4 decode steps
    at 64."""
    rcfg, pcfg = cfgs()
    rlm = ref_lm(rcfg)
    rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                rlm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, size=(2, S)).astype(np.int32)
    nxt = rng.integers(0, rcfg.vocab_size,
                       size=(N_DECODE, 2, 1)).astype(np.int32)
    ref = {}
    for cl in (64, 24):
        lg, cache = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=cl)
        ref[cl] = {"prefill": np32(lg),
                   "cache": jax.tree_util.tree_map(np.asarray, cache)}
    cache, dec = ref[64]["cache"], []
    for t in nxt:
        lg, cache = rlm.decode_step(rp, cache, tokens=jnp.asarray(t))
        dec.append(np32(lg))
    ref[64].update(decode=dec,
                   decode_cache=jax.tree_util.tree_map(np.asarray, cache))
    return dict(rlm=rlm, rp=rp, rcfg=rcfg, pcfg=pcfg,
                nump=jax.tree_util.tree_map(np.asarray, rp), toks=toks,
                nxt=nxt, ref=ref)


def params_of(m):
    return lm_params_from_numpy(m["nump"], "cpu")


@pytest.mark.parametrize("attn", ["default", "fused"])
@pytest.mark.parametrize("cache_len", [64, 24])
def test_lm_prefill_and_decode_match_the_reference(ds_lm, cache_len, attn):
    """Prefill logits and the latent cache of every layer (the dense
    prelude's first, then the MoE layer with its shared expert); at 64,
    four decode steps (logits, the cache written in place).  At 24 the
    ring holds the last 24 positions, rotated as the reference rotates
    them."""
    m = ds_lm
    ref = m["ref"][cache_len]
    lm, params = port_lm(m["pcfg"], attn), params_of(m)
    assert "prelude" in params and "shared" in params["blocks"]["moe"]
    lg, cache = lm.prefill(params, torch.from_numpy(m["toks"]).long(),
                           cache_len=cache_len)
    close(lg, ref["prefill"], atol=1e-5)
    assert cache["pos"].tolist() == [S, S]
    assert sorted(cache) == ["blocks", "pos"]
    for p, r, w in zip(cache["blocks"], folded(ref["cache"]), (32, 8)):
        assert tuple(p.shape) == r.shape == (2, 2, cache_len, w)
        close(p, r)
    if cache_len != 64:
        return
    held = list(cache["blocks"])
    for t, want in zip(m["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)
    assert all(a is b for a, b in zip(cache["blocks"], held))   # in place
    assert cache["pos"].tolist() == [S + N_DECODE] * 2
    for p, r in zip(cache["blocks"], folded(ref["decode_cache"])):
        close(p, r)


def test_lm_prefill_then_decode_equals_the_reference_forward(ds_lm):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port: prefill of 32 tokens then one decode step give the reference's
    training forward at positions 31 and 32."""
    m = ds_lm
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, size=(2, 33)).astype(np.int32)
    full = np32(m["rlm"].forward(m["rp"], tokens=jnp.asarray(toks))[0])
    lm, params = port_lm(m["pcfg"]), params_of(m)
    t = torch.from_numpy(toks).long()
    lg, cache = lm.prefill(params, t[:, :32], cache_len=37)
    close(lg, full[:, 31], atol=1e-5)
    lg, _ = lm.decode_step(params, cache, t[:, 32:33])
    close(lg, full[:, 32], atol=1e-5)


def test_lm_decode_past_the_window_sees_the_last_w_positions(ds_lm,
                                                             monkeypatch):
    """Past the wrap (prefill of 40 tokens into a 24-slot ring, then 3
    decode steps) each decode logit equals a full-sequence pass of the
    port's own LM whose attention is causal at the prompt's positions and
    sees the last 24 keys at each later one: the ring holds the prompt's
    latents as its prefill made them and the decode reads all 24 slots.
    The reference's decode masks ``idx <= slot`` there instead
    (``test_mla_decode_mask_is_the_ring_not_idx_le_slot``)."""
    m = ds_lm
    W, P = 24, 40
    toks = np.random.default_rng(9).integers(0, 256, size=(1, P + 3)).astype(
        np.int32)
    lm, params = port_lm(m["pcfg"]), params_of(m)
    t = torch.from_numpy(toks).long()
    _, cache = lm.prefill(params, t[:, :P], cache_len=W)
    got = []
    for i in range(P, P + 3):
        lg, cache = lm.decode_step(params, cache, t[:, i:i + 1])
        got.append(lg)

    def spliced(q, k, v, qpos, kpos, window, opts, scale=None):
        live = PL._window_mask(qpos, kpos, 0) & (
            (qpos[..., :, None] < P)
            | (qpos[..., :, None] - kpos[..., None, :] < W))
        s = torch.where(live[:, None, None], PL._gqa_scores(q, k) * scale,
                        PL.NEG_INF)
        return PL._gqa_out(torch.softmax(s, dim=-1), v).to(q.dtype)

    monkeypatch.setattr(PL, "attention_core", spliced)
    for i, lg in zip(range(P, P + 3), got):
        want, _ = lm.prefill(params, t[:, :i + 1])
        close(lg, want.numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompts_follow_the_reference_forward(ds_lm, n):
    """A prompt of 1 or 2 tokens at B = 1: prefill + three decode steps give
    the reference's ``LM.forward`` at every position."""
    m = ds_lm
    rng = np.random.default_rng(10 + n)
    toks = rng.integers(0, 256, size=(1, n + 3)).astype(np.int32)
    full = np32(m["rlm"].forward(m["rp"], tokens=jnp.asarray(toks))[0])
    lm, params = port_lm(m["pcfg"]), params_of(m)
    t = torch.from_numpy(toks).long()
    lg, cache = lm.prefill(params, t[:, :n], cache_len=8)
    close(lg, full[:, n - 1], atol=1e-5)
    for i in range(n, n + 3):
        lg, cache = lm.decode_step(params, cache, t[:, i:i + 1])
        close(lg, full[:, i], atol=1e-5)


def test_decode_from_a_carried_reference_cache(ds_lm):
    """``convert.lm_cache_from_numpy`` carries the reference's MLA cache
    (one scalar position; the prelude's ``(ckv, k_rope)`` list folded in
    front of ``blocks``); ``lm_params_from_numpy`` the MLA leaves
    (``wq``, ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``, ``kv_norm``) exactly;
    decode from the carried cache equals the reference's."""
    m = ds_lm
    params = params_of(m)
    for tree, src in ((params["prelude"][0]["attn"],
                       m["nump"]["prelude"][0]["attn"]),
                      (params["blocks"]["attn"], m["nump"]["blocks"]["attn"])):
        assert sorted(tree) == ["kv_norm", "w_dkv", "w_uk", "w_uv", "wo",
                                "wq"]
        for k, a in tree.items():
            np.testing.assert_array_equal(a.numpy(), src[k])
    ref = m["ref"][64]
    cache = lm_cache_from_numpy(ref["cache"], "cpu")
    assert sorted(cache) == ["blocks", "pos"]
    assert cache["pos"].tolist() == [S, S]
    for p, r in zip(cache["blocks"], folded(ref["cache"])):
        np.testing.assert_array_equal(p.numpy(), r)
    lm = port_lm(m["pcfg"], "default")
    for t, want in zip(m["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_init_cache_matches_the_reference(dtype):
    """The latent cache: one stacked (ckv, k_rope) over both layers, the
    reference's ``blocks`` and ``prelude`` together, zero, in the cache
    dtype."""
    rcfg, pcfg = cfgs()
    rc = RT.LM(rcfg, kv_cache_dtype=getattr(jnp, dtype)).init_cache(3, 64)
    pc = PT.LM(pcfg, kv_cache_dtype=getattr(torch, dtype)).init_cache(3, 64)
    assert sorted(pc) == ["blocks", "pos"] and "prelude" in rc
    for p, r, w in zip(pc["blocks"],
                       folded(jax.tree_util.tree_map(np.asarray, rc)),
                       (32, 8)):
        assert tuple(p.shape) == r.shape == (2, 3, 64, w)
        assert p.dtype == getattr(torch, dtype) and str(r.dtype) == dtype
        assert float(p.float().abs().max()) == 0.0


def test_lm_int8_cache_matches_the_reference_decode(ds_lm):
    """``kv_cache_dtype=torch.int8``: prefill returns the latent quantised
    with ``quant_kv`` (equal, bit for bit, to the reference's ``quant_kv``
    of its float latent), and four decode steps from it equal the
    reference's int8 decode from that quantised cache (logits rtol 1e-4,
    caches bit for bit)."""
    m = ds_lm
    ref = m["ref"][64]
    rlm = ref_lm(m["rcfg"], kv_cache_dtype=jnp.int8)
    rcache = jax.tree_util.tree_map(
        lambda a: RL.quant_kv(jnp.asarray(a)) if a.ndim > 1 else
        jnp.asarray(a), ref["cache"])
    lm, params = port_lm(m["pcfg"], kv_cache_dtype=torch.int8), params_of(m)
    _, cache = lm.prefill(params, torch.from_numpy(m["toks"]).long(),
                          cache_len=64)
    for p, r in zip(cache["blocks"], folded(rcache)):
        assert p.dtype == torch.int8
        np.testing.assert_array_equal(p.numpy(), r)
    for t in m["nxt"]:
        rl, rcache = rlm.decode_step(m["rp"], rcache, tokens=jnp.asarray(t))
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, rl, atol=1e-5)
    for p, r in zip(cache["blocks"], folded(rcache)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_lm_bf16_logits_match_the_reference():
    """bfloat16 weights (the reference's init) and caches: prefill and one
    decode step within atol 5e-2 of the reference's Pallas path; the port
    runs ``fused`` (on the CPU: the kernels' plain versions and the
    per-expert loop)."""
    rcfg, pcfg = cfgs()
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="pallas"), remat=False)
    rp = rlm.init(jax.random.PRNGKey(1))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    assert params["blocks"]["attn"]["w_uk"].dtype == torch.bfloat16
    lm = PT.LM(pcfg, opts=PL.AttnOptions(backend="fused"))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size,
                                             size=(1, 24)).astype(np.int32)
    rl, rc = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=32)
    pl_, pc = lm.prefill(params, torch.from_numpy(toks).long(), cache_len=32)
    close(pl_, rl, rtol=0, atol=5e-2)
    assert pc["blocks"][0].dtype == torch.bfloat16
    nt = np.array([[7]], np.int32)
    rl, _ = rlm.decode_step(rp, rc, tokens=jnp.asarray(nt))
    pl_, _ = lm.decode_step(params, pc, torch.from_numpy(nt).long())
    close(pl_, rl, rtol=0, atol=5e-2)
