"""The port's LLM model stack against the reference's, on the CPU.

Layers, attention backends, the cache-fitting rule and ``LM.prefill`` /
``LM.decode_step`` get the same NumPy inputs (and the same weights, carried
across with ``convert.lm_params_from_numpy``) on both sides.  float32 runs
are held to rtol 1e-4 (atol 1e-6 where values cross zero); the bfloat16
logits to atol 5e-2.  Also here: the config registry, the tile plan and the
C3 counters that the serving engine charges.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.monitor as ref_mon
import repro.core.tiles as ref_tiles
import repro.models.layers as RL
import repro.models.params as ref_params
import repro.models.transformer as RT
import repro_torch.configs as port_configs
import repro_torch.core.monitor as port_mon
import repro_torch.core.tiles as port_tiles
import repro_torch.models.layers as PL
import repro_torch.models.params as port_params
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy

RTOL, ATOL = 1e-4, 1e-6
ARCHS = ("h2o-danube-1.8b", "gemma-2b")     # SWA + GQA; tied + MQA + GeGLU


def np32(x):
    return np.asarray(x, np.float32)


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np32(ref),
                               rtol=rtol, atol=atol)


def rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, s = rand((3, 5, 64)), rand(64, 1, 0.1)
    ref = RL.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(s), 1e-5)
    port = PL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(s), 1e-5)
    assert port.dtype == getattr(torch, dtype)
    close(port, ref, atol=1e-6 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("hd", [16, 80])
def test_apply_rope(hd):
    x = rand((2, 7, 3, hd))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    port = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         10_000.0)
    close(port, ref, atol=1e-5)


def attn_args(B=2, S=64, KV=2, G=2, hd=16, seed=0, kshift=0):
    q = rand((B, S, KV, G, hd), seed)
    k = rand((B, S, KV, hd), seed + 1)
    v = rand((B, S, KV, hd), seed + 2)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return [q, k, v, pos, pos + kshift]


@pytest.mark.parametrize("window", [0, 24])
def test_attention_naive(window):
    a = attn_args()
    ref = RL.attention_naive(*map(jnp.asarray, a), window, 0.25)
    port = PL.attention_naive(*map(torch.from_numpy, a), window, 0.25)
    close(port, ref)


@pytest.mark.parametrize("window,blk", [(0, 16), (24, 16), (0, 32)])
def test_attention_chunked(window, blk):
    a = attn_args()
    ro = RL.AttnOptions(backend="chunked", q_block=blk, kv_block=blk)
    po = PL.AttnOptions(backend="chunked", q_block=blk, kv_block=blk)
    ref = RL.attention_chunked(*map(jnp.asarray, a), window, 0.25, ro)
    port = PL.attention_chunked(*map(torch.from_numpy, a), window, 0.25, po)
    close(port, ref)
    close(port, RL.attention_naive(*map(jnp.asarray, a), window, 0.25))


def test_attention_options_refuse_what_is_not_ported():
    with pytest.raises(ValueError, match="fused"):
        PL.AttnOptions(backend="pallas")
    a = [torch.from_numpy(t) for t in attn_args()]
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        PL.attention_chunked(*a, 0, 0.25,
                             PL.AttnOptions(q_block=16, folded=True))
    for fn in (PL.mla_spec, PL.mla_apply, PL.mla_decode, PL.quant_kv):
        with pytest.raises(NotImplementedError, match="MLA"):
            fn()


def gqa_pair(arch, seed=0):
    """The reference's and the port's attention params of one layer."""
    cfg = ref_configs.get_config(arch).reduced()
    specs = RL.gqa_spec(cfg)
    p = ref_params.init_params(specs, jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
    return (cfg, p, port_configs.get_config(arch).reduced(),
            lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 "cpu"))


@pytest.mark.parametrize("backend", ["naive", "chunked", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_apply(arch, backend):
    rcfg, rp, pcfg, pp = gqa_pair(arch)
    x = rand((2, 40, rcfg.d_model), 3)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    ro = RL.AttnOptions(backend="naive")
    po = PL.AttnOptions(backend=backend, q_block=8, kv_block=8)
    ref, (rk, rv) = RL.gqa_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                 ro, return_cache=True)
    port, (pk, pv) = PL.gqa_apply(pp, pcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), po,
                                  return_cache=True)
    close(port, ref)
    close(pk, rk)
    close(pv, rv)


@pytest.mark.parametrize("backend", ["naive", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_per_row_positions_match_the_reference(arch, backend):
    """The port decodes a batch whose rows sit at different positions (a
    wrapped ring among them); each row equals the reference's decode of
    that row alone at its scalar position."""
    rcfg, rp, pcfg, pp = gqa_pair(arch, seed=1)
    W, KV, hd = 16, rcfg.n_kv_heads, rcfg.head_dim
    pos = np.array([3, 15, 37], np.int32)
    ck, cv = rand((3, W, KV, hd), 4), rand((3, W, KV, hd), 5)
    x = rand((3, 1, rcfg.d_model), 6)
    pck, pcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, nk, nv = PL.gqa_decode(pp, pcfg, torch.from_numpy(x), pck, pcv,
                                torch.from_numpy(pos),
                                PL.AttnOptions(backend=backend))
    assert nk is pck and nv is pcv                 # written in place
    for b in range(3):
        r_out, r_k, r_v = RL.gqa_decode(
            rp, rcfg, jnp.asarray(x[b:b + 1]), jnp.asarray(ck[b:b + 1]),
            jnp.asarray(cv[b:b + 1]), jnp.asarray(pos[b]),
            RL.AttnOptions(backend="naive"))
        close(out[b:b + 1], r_out)
        close(nk[b:b + 1], r_k)
        close(nv[b:b + 1], r_v)


def test_ring_kpos_matches_the_reference_rule():
    W = 8
    for p in (0, 5, 7, 8, 13, 30):
        idx = np.arange(W)
        slot, wraps = p % W, p // W
        exp = np.where(idx <= slot, wraps * W + idx, (wraps - 1) * W + idx)
        exp = np.where(exp >= 0, exp, 1_000_000_000)
        got = PL.ring_kpos(torch.tensor([p], dtype=torch.int32), W)[0]
        assert got.tolist() == exp.tolist()


@pytest.mark.parametrize("W", [6, 10, 14])          # W < S, W = S, W > S
def test_pad_attn_cache(W):
    S = 10
    cfg = ref_configs.get_config("h2o-danube-1.8b").reduced()
    a = rand((3, 2, S, 2, 4), 7)                     # stacked (L,B,S,...)
    ref = RT.LM(cfg)._pad_attn_cache((jnp.asarray(a), jnp.asarray(a[0])),
                                     W, S)
    port = PT.LM(port_configs.get_config("h2o-danube-1.8b").reduced()
                 )._pad_attn_cache((torch.from_numpy(a),
                                    torch.from_numpy(a[0])), W, S)
    for p, r in zip(port, ref):
        assert tuple(p.shape) == tuple(r.shape)
        np.testing.assert_array_equal(p.numpy(), np32(r))


# ------------------------------------------------------------------- the LM
@pytest.fixture(scope="module", params=ARCHS)
def lm_pair(request):
    """Reference LM with float32 weights and the port LM with the same."""
    arch = request.param
    rcfg = ref_configs.get_config(arch).reduced()
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False,
                kv_cache_dtype=jnp.float32)
    rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                rlm.init(jax.random.PRNGKey(0)))
    nump = jax.tree_util.tree_map(np.asarray, rp)
    pcfg = port_configs.get_config(arch).reduced()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, size=(2, 40)).astype(np.int32)
    nxt = rng.integers(0, rcfg.vocab_size, size=(3, 2, 1)).astype(np.int32)
    # the reference's prefill + three decode steps, once per module
    lg, cache = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=32)
    ref = {"prefill": np32(lg), "k": np32(cache["blocks"][0]),
           "v": np32(cache["blocks"][1]), "cache": jax.tree_util.tree_map(
               np.asarray, cache), "decode": []}
    for t in nxt:
        lg, cache = rlm.decode_step(rp, cache, tokens=jnp.asarray(t))
        ref["decode"].append(np32(lg))
    return dict(arch=arch, rlm=rlm, rp=rp, nump=nump, pcfg=pcfg, toks=toks,
                nxt=nxt, ref=ref)


@pytest.mark.parametrize("backend", ["naive", "chunked", "fused"])
def test_lm_prefill_and_decode_match_the_reference(lm_pair, backend):
    pr = lm_pair
    lm = PT.LM(pr["pcfg"], opts=PL.AttnOptions(backend=backend, q_block=8,
                                                kv_block=8),
               kv_cache_dtype=torch.float32)
    params = lm_params_from_numpy(pr["nump"], "cpu")
    lg, cache = lm.prefill(params, torch.from_numpy(pr["toks"]).long(),
                           cache_len=32)
    ref = pr["ref"]
    close(lg, ref["prefill"])
    close(cache["blocks"][0], ref["k"])
    close(cache["blocks"][1], ref["v"])
    assert cache["pos"].tolist() == [40, 40]
    for t, exp in zip(pr["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, exp)
    assert cache["pos"].tolist() == [43, 43]


def test_lm_decode_from_a_carried_reference_cache(lm_pair):
    """``lm_cache_from_numpy`` carries the reference's prefill cache (one
    scalar position) into the port's per-row layout."""
    pr = lm_pair
    lm = PT.LM(pr["pcfg"], opts=PL.AttnOptions(backend="naive"))
    params = lm_params_from_numpy(pr["nump"], "cpu")
    cache = lm_cache_from_numpy(pr["ref"]["cache"], "cpu")
    assert cache["pos"].tolist() == [40, 40]
    lg, _ = lm.decode_step(params, cache, torch.from_numpy(pr["nxt"][0]).long())
    close(lg, pr["ref"]["decode"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bf16_logits_match_the_reference(arch):
    rcfg = ref_configs.get_config(arch).reduced()
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False)
    rp = rlm.init(jax.random.PRNGKey(1))                   # bfloat16 weights
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    assert params["embed"].dtype == torch.bfloat16
    lm = PT.LM(port_configs.get_config(arch).reduced(),
               opts=PL.AttnOptions(backend="fused"))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size,
                                             size=(1, 24)).astype(np.int32)
    rl, rc = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=32)
    pl_, pc = lm.prefill(params, torch.from_numpy(toks).long(), cache_len=32)
    close(pl_, rl, rtol=0, atol=5e-2)
    nt = np.array([[7]], np.int32)
    rl, _ = rlm.decode_step(rp, rc, tokens=jnp.asarray(nt))
    pl_, _ = lm.decode_step(params, pc, torch.from_numpy(nt).long())
    close(pl_, rl, rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_counts_match_the_reference(arch):
    rlm = RT.LM(ref_configs.get_config(arch).reduced())
    plm = PT.LM(port_configs.get_config(arch).reduced())
    rshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rlm.abstract())
    pshapes = port_params.tree_map(lambda a: tuple(a.shape), plm.abstract(),
                                   is_leaf=torch.is_tensor)
    assert pshapes == rshapes
    assert (port_params.count_params(plm.param_specs())
            == ref_params.count_params(rlm.param_specs()))
    assert all(t.device.type == "meta" for t in port_params.tree_leaves(
        plm.abstract(), is_leaf=torch.is_tensor))


def test_init_params_scales_and_generator():
    plm = PT.LM(port_configs.get_config("h2o-danube-1.8b"))  # full width
    specs = plm.param_specs()
    blocks = port_params.init_params(
        {"wo": specs["blocks"]["mlp"]["wo"], "norm": specs["final_norm"]},
        torch.Generator().manual_seed(0))
    assert blocks["wo"].dtype == torch.bfloat16
    assert float(blocks["norm"].abs().max()) == 0.0          # "zeros"
    # "small": 0.02 / int(sqrt(prod of all but the last dim)), as the
    # reference (the stacked layer dim included)
    L, F, d = blocks["wo"].shape
    want = 0.02 / int(np.sqrt(L * F))
    assert abs(float(blocks["wo"].float().std()) / want - 1) < 0.01
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    small = {"a": port_params.spec((4, 3), (None, None)),
             "b": port_params.spec((2,), (None,))}
    a, b = port_params.init_params(small, g1), port_params.init_params(
        small, g2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unported_families_and_entry_points_raise():
    with pytest.raises(NotImplementedError,
                       match=r"attn_type 'mla'.*ROADMAP queue A item 10\.3"):
        port_configs.get_config("deepseek-v2-lite-16b")
    # the ssm, hybrid and moe families are ported: mamba2-370m, zamba2-7b,
    # granite-moe-1b-a400m, family="ssm", "hybrid" and "moe" build
    assert port_configs.get_config("mamba2-370m").family == "ssm"
    assert port_configs.get_config("zamba2-7b").family == "hybrid"
    assert port_configs.get_config("granite-moe-1b-a400m").family == "moe"
    PT.LM(port_configs.get_config("zamba2-7b"))
    PT.LM(port_configs.get_config("granite-moe-1b-a400m"))
    cfg = port_configs.get_config("granite-8b").reduced()
    PT.LM(dataclasses.replace(cfg, family="ssm"))
    PT.LM(dataclasses.replace(cfg, family="hybrid", shared_attn_every=2))
    PT.LM(dataclasses.replace(cfg, family="moe", n_experts=4, top_k=2,
                              d_ff_expert=64))
    for change in (dict(attn_type="mla"),
                   dict(family="moe", attn_type="mla", n_experts=4, top_k=2,
                        d_ff_expert=64)):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP queue A item 10\.3"):
            PT.LM(dataclasses.replace(cfg, **change))
    lm = PT.LM(cfg)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        lm.forward({}, tokens=None)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        lm.loss_fn({}, {})
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


# ------------------------------------------- configs, plans and counters
def test_ported_configs_equal_the_reference():
    names = port_configs.list_configs()
    assert "h2o-danube-1.8b" in names
    assert set(names) | set(port_configs.base.UNPORTED) == set(
        ref_configs.ASSIGNED_ARCHS)
    for name in names:
        r, p = ref_configs.get_config(name), port_configs.get_config(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(
            r.reduced())
        assert p.n_params() == r.n_params()
        assert list(port_configs.shapes_for(p)) == list(
            ref_configs.shapes_for(r))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_default_plan_matches_the_reference(family):
    r = dataclasses.replace(ref_configs.get_config("granite-8b"),
                            family=family, n_dense_layers=1)
    p = port_configs.ArchConfig(**dataclasses.asdict(r))
    rp, pp = ref_tiles.default_plan(r), port_tiles.default_plan(p)
    assert [dataclasses.asdict(t) for t in pp.tiles] == [
        dataclasses.asdict(t) for t in rp.tiles]
    port_tiles.validate_plan(pp, p)
    bad = pp.with_replication("mem", 2)
    with pytest.raises(AssertionError):
        port_tiles.validate_plan(bad, p)


def test_counters_follow_the_reference_semantics():
    cfg = ref_configs.get_config("h2o-danube-1.8b")
    rplan = ref_tiles.default_plan(cfg)
    pplan = port_tiles.default_plan(port_configs.get_config(cfg.name))
    rc, pc = ref_mon.init_counters(rplan), port_mon.init_counters(pplan,
                                                                  "cpu")
    payload = np.zeros((3, 700), np.float32)
    steps = [("charge", "attn", dict(exec_time=5.0, pkts_in=2.0)),
             ("charge", "attn", dict(exec_time=3.0, pkts_in=1.5)),
             ("charge", "mem", dict(rtt=4.0, pkts_out=1.0)),
             ("charge", "io", dict(pkts_in=9.0)),      # disabled: skipped
             ("charge", "nope", dict(rtt=1.0)),        # no such tile
             ("boundary", ("mem", "attn"), None),
             ("reset", ["attn"], None)]
    for kind, tile, kw in steps:
        if kind == "charge":
            rc = ref_mon.charge(rc, tile, **kw)
            pc = port_mon.charge(pc, tile, **kw)
        elif kind == "boundary":
            rc = ref_mon.charge_boundary(rc, *tile, jnp.asarray(payload))
            pc = port_mon.charge_boundary(pc, *tile,
                                          torch.from_numpy(payload))
        else:
            rc = ref_mon.manual_reset(rc, tiles=tile)
            pc = port_mon.manual_reset(pc, tiles=tile)
        assert {t: {k: float(v) for k, v in row.items()}
                for t, row in pc.items()} == {
            t: {k: float(v) for k, v in row.items()} for t, row in rc.items()}
    assert all(v.dtype == torch.float32 for row in pc.values()
               for v in row.values())
    client = port_mon.MonitorClient(max_samples=2)
    for step in range(3):
        pc = port_mon.charge(pc, "mem", pkts_in=1.0)
        client.read(pc, step)
    assert len(client.samples) == 2
    assert client.samples[-1].counters["mem"]["pkts_in"] == float(
        pc["mem"]["pkts_in"])
    assert "mem" in client.table()
    assert port_mon.bytes_of({"a": [torch.zeros(3, dtype=torch.bfloat16)],
                              "b": None}) == 6.0
