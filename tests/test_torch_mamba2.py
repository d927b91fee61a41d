"""The port's Mamba-2 mixer and ``ssm`` family against the reference's, on
the CPU.

``models/mamba2.py`` (``ssm_apply`` with the ``"torch"`` and ``"fused"``
backends, ``ssm_decode``, ``ssm_cache_init``) and ``LM`` of the ``ssm``
family (``prefill``, ``decode_step``, ``init_cache``) get the same NumPy
inputs and the same float32 weights (carried with
``convert.lm_params_from_numpy``) as the reference's, on reduced
mamba2-370m (``ssm_chunk`` 32).  float32 runs are held to rtol 1e-4 (atol
1e-6 where values cross zero; 1e-5 for the logits, whose sums run over the
vocabulary-sized product), as ``tests/test_torch_models.py`` holds the
dense LM; bfloat16 logits to atol 5e-2.  Also here: prompts shorter than
the conv (the reference keeps a cache of fewer than ``ssm_conv - 1`` rows
there; the port the zero-padded tail, ROADMAP queue C), the backend knob,
the configs and the tile plan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.tiles as ref_tiles
import repro.models.mamba2 as RM
import repro.models.params as ref_params
import repro.models.transformer as RT
import repro_torch.configs as port_configs
import repro_torch.core.tiles as port_tiles
import repro_torch.models.mamba2 as PM
import repro_torch.models.params as port_params
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy

ARCH = "mamba2-370m"
RTOL, ATOL = 1e-4, 1e-6
LEAVES = ("conv_B", "conv_C", "conv_x", "state")


def np32(x):
    return np.array(x, np.float32)


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np32(ref),
                               rtol=rtol, atol=atol)


def rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def cfgs():
    return (ref_configs.get_config(ARCH).reduced(),
            port_configs.get_config(ARCH).reduced())


def block_pair(seed=0):
    """One Mamba-2 block's params: the reference's (float32) and the port's
    (the same values)."""
    rcfg, pcfg = cfgs()
    p = ref_params.init_params(RM.ssm_spec(rcfg), jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
    return rcfg, p, pcfg, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), "cpu")


# ------------------------------------------------------------------- mixer
@pytest.mark.parametrize("L", [3, 32, 40, 64])   # 40: pads within a chunk
@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"),
                                                 ("fused", "pallas")])
def test_ssm_apply_matches_the_reference(L, backend, ref_backend):
    rcfg, rp, pcfg, pp = block_pair()
    x = rand((2, L, rcfg.d_model), 3)
    ref, rc = RM.ssm_apply(rp, rcfg, jnp.asarray(x), backend=ref_backend,
                           return_cache=True)
    port, pc = PM.ssm_apply(pp, pcfg, torch.from_numpy(x), backend=backend,
                            return_cache=True)
    close(port, ref)
    assert sorted(pc) == sorted(rc)
    for k in LEAVES:
        assert tuple(pc[k].shape) == tuple(rc[k].shape), k
        close(pc[k], rc[k])
    assert pc["state"].dtype == torch.float32
    assert torch.equal(PM.ssm_apply(pp, pcfg, torch.from_numpy(x),
                                    backend=backend), port)


def test_ssm_decode_and_cache_init_match_the_reference():
    rcfg, rp, pcfg, pp = block_pair(1)
    B = 3
    rc0 = RM.ssm_cache_init(rcfg, B, jnp.float32)
    pc0 = PM.ssm_cache_init(pcfg, B, torch.float32)
    assert sorted(pc0) == sorted(rc0)
    for k in LEAVES:
        assert tuple(pc0[k].shape) == tuple(rc0[k].shape), k
        assert float(pc0[k].abs().sum()) == 0.0
    assert PM.ssm_cache_init(pcfg, B)["conv_x"].dtype == torch.bfloat16
    assert PM.ssm_cache_init(pcfg, B)["state"].dtype == torch.float32
    cache = {k: rand(tuple(pc0[k].shape), 10 + i, 0.5)
             for i, k in enumerate(LEAVES)}
    x = rand((B, 1, rcfg.d_model), 4)
    ref, rnew = RM.ssm_decode(rp, rcfg, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in cache.items()})
    pcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    port, pnew = PM.ssm_decode(pp, pcfg, torch.from_numpy(x), pcache)
    close(port, ref)
    for k in LEAVES:
        close(pnew[k], rnew[k])
        # ssm_decode leaves the given cache as it was
        np.testing.assert_array_equal(pcache[k].numpy(), cache[k])


def test_ssm_backend_knob():
    _, pcfg = cfgs()
    with pytest.raises(ValueError, match="fused"):
        PT.LM(pcfg, ssm_backend="pallas")
    with pytest.raises(ValueError, match="'xla' and 'pallas'"):
        PT.LM(pcfg, ssm_backend="xla")
    rcfg, _, _, pp = block_pair()
    with pytest.raises(ValueError, match="fused"):
        PM.ssm_apply(pp, pcfg, torch.zeros(1, 4, pcfg.d_model),
                     backend="pallas")
    assert PT.LM(pcfg).ssm_backend == "torch"


# ------------------------------------------------------------------- the LM
@pytest.fixture(scope="module")
def lm_pair():
    """The reference LM (float32 weights and cache) and the inputs, with
    its prefill + three decode steps and its training forward, once."""
    rcfg, pcfg = cfgs()
    rlm = RT.LM(rcfg, remat=False, kv_cache_dtype=jnp.float32)
    rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                rlm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, size=(2, 40)).astype(np.int32)
    nxt = rng.integers(0, rcfg.vocab_size, size=(3, 2, 1)).astype(np.int32)
    lg, cache = rlm.prefill(rp, tokens=jnp.asarray(toks))
    ref = {"prefill": np32(lg), "cache": jax.tree_util.tree_map(
        np.asarray, cache), "decode": [], "decode_cache": None}
    for t in nxt:
        lg, cache = rlm.decode_step(rp, cache, tokens=jnp.asarray(t))
        ref["decode"].append(np32(lg))
    ref["decode_cache"] = jax.tree_util.tree_map(np.asarray, cache)
    full33 = rng.integers(0, rcfg.vocab_size, size=(2, 33)).astype(np.int32)
    ref["full33"] = np32(rlm.forward(rp, tokens=jnp.asarray(full33))[0])
    return dict(rlm=rlm, rp=rp, nump=jax.tree_util.tree_map(np.asarray, rp),
                pcfg=pcfg, toks=toks, nxt=nxt, full33=full33, ref=ref)


def port_lm(pr, backend="fused"):
    return (PT.LM(pr["pcfg"], ssm_backend=backend,
                  kv_cache_dtype=torch.float32),
            lm_params_from_numpy(pr["nump"], "cpu"))


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_lm_prefill_and_decode_match_the_reference(lm_pair, backend):
    pr = lm_pair
    lm, params = port_lm(pr, backend)
    lg, cache = lm.prefill(params, torch.from_numpy(pr["toks"]).long())
    ref = pr["ref"]
    close(lg, ref["prefill"], atol=1e-5)
    assert cache["pos"].tolist() == [40, 40]
    assert sorted(cache["blocks"]) == sorted(ref["cache"]["blocks"])
    for k in LEAVES:
        close(cache["blocks"][k], ref["cache"]["blocks"][k])
    blocks = cache["blocks"]
    for t, exp in zip(pr["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, exp, atol=1e-5)
        assert all(cache["blocks"][k] is blocks[k] for k in LEAVES)  # in place
    assert cache["pos"].tolist() == [43, 43]
    for k in LEAVES:
        close(cache["blocks"][k], ref["decode_cache"]["blocks"][k])


def test_lm_prefill_then_decode_equals_the_reference_forward(lm_pair):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port: S = 33 crosses a chunk of 32."""
    pr = lm_pair
    lm, params = port_lm(pr)
    toks = torch.from_numpy(pr["full33"]).long()
    full = pr["ref"]["full33"]
    scale = float(np.abs(full).max())
    lg, cache = lm.prefill(params, toks[:, :32])
    assert float((lg - torch.from_numpy(full[:, 31])).abs().max()) / scale \
        < 1e-4
    lg, _ = lm.decode_step(params, cache, toks[:, 32:33])
    assert float((lg - torch.from_numpy(full[:, 32])).abs().max()) / scale \
        < 1e-4


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_cache_and_decode(lm_pair, S):
    """A prompt shorter than ssm_conv - 1 = 3 tokens: the port keeps the
    left-zero-padded last 3 pre-conv inputs, so prefill + one decode step
    equals the reference's LM.forward at that position (its causal conv
    pads with zeros).  The reference's own prefill keeps 1 row there
    (models/mamba2.py:169-172; ROADMAP queue C)."""
    pr = lm_pair
    rlm, rp = pr["rlm"], pr["rp"]
    lm, params = port_lm(pr)
    toks = pr["full33"][:, :S + 1]
    full = np32(rlm.forward(rp, tokens=jnp.asarray(toks))[0])
    scale = float(np.abs(full).max())
    lg, cache = lm.prefill(params, torch.from_numpy(toks[:, :S]).long())
    c = pr["pcfg"].ssm_conv
    for k in ("conv_x", "conv_B", "conv_C"):
        a = cache["blocks"][k]
        assert a.shape[2] == c - 1, k
        assert float(a[:, :, :c - 1 - S].abs().max()) == 0.0    # the padding
    assert float((lg - torch.from_numpy(full[:, S - 1])).abs().max()) \
        / scale < 1e-4
    lg, _ = lm.decode_step(params, cache,
                           torch.from_numpy(toks[:, S:S + 1]).long())
    assert float((lg - torch.from_numpy(full[:, S])).abs().max()) / scale \
        < 1e-4
    # the reference's fault, as evidence: a 1-row conv cache
    _, rc = rlm.prefill(rp, tokens=jnp.asarray(toks[:, :S]))
    assert np.asarray(rc["blocks"]["conv_x"]).shape[2] == 1


def test_lm_decode_from_a_carried_reference_cache(lm_pair):
    """``lm_cache_from_numpy`` carries the reference's ssm prefill cache
    (one scalar position, a dict of leaves) into the port's layout."""
    pr = lm_pair
    lm, params = port_lm(pr, "torch")
    cache = lm_cache_from_numpy(pr["ref"]["cache"], "cpu")
    assert cache["pos"].tolist() == [40, 40]
    assert sorted(cache["blocks"]) == sorted(LEAVES)
    lg, _ = lm.decode_step(params, cache,
                           torch.from_numpy(pr["nxt"][0]).long())
    close(lg, pr["ref"]["decode"][0], atol=1e-5)


def test_init_cache_matches_the_reference():
    rcfg, pcfg = cfgs()
    rc = RT.LM(rcfg).init_cache(3, 64)
    pc = PT.LM(pcfg).init_cache(3, 64)
    assert pc["pos"].tolist() == [0, 0, 0]
    for k in LEAVES:
        r = np.asarray(rc["blocks"][k])
        assert tuple(pc["blocks"][k].shape) == r.shape, k
        assert str(pc["blocks"][k].dtype).split(".")[-1] == str(r.dtype), k
    assert pc["blocks"]["state"].dtype == torch.float32
    f32 = PT.LM(pcfg, kv_cache_dtype=torch.float32).init_cache(1, 8)
    assert f32["blocks"]["conv_x"].dtype == torch.float32


def test_lm_bf16_logits_match_the_reference():
    rcfg, pcfg = cfgs()
    rlm = RT.LM(rcfg, remat=False, ssm_backend="pallas")
    rp = rlm.init(jax.random.PRNGKey(1))                   # bfloat16 weights
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    assert params["blocks"]["ssm"]["w_x"].dtype == torch.bfloat16
    assert params["blocks"]["ssm"]["A_log"].dtype == torch.float32
    lm = PT.LM(pcfg, ssm_backend="fused")
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size,
                                             size=(1, 24)).astype(np.int32)
    rl, rc = rlm.prefill(rp, tokens=jnp.asarray(toks))
    pl_, pc = lm.prefill(params, torch.from_numpy(toks).long())
    close(pl_, rl, rtol=0, atol=5e-2)
    assert pc["blocks"]["conv_x"].dtype == torch.bfloat16
    nt = np.array([[7]], np.int32)
    rl, _ = rlm.decode_step(rp, rc, tokens=jnp.asarray(nt))
    pl_, _ = lm.decode_step(params, pc, torch.from_numpy(nt).long())
    close(pl_, rl, rtol=0, atol=5e-2)


# ------------------------------------------- configs, specs and the plan
def test_config_and_param_specs_match_the_reference():
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.n_params() == r.n_params()
    for rcfg, pcfg in ((r, p), cfgs()):
        rlm, plm = RT.LM(rcfg), PT.LM(pcfg)
        rshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                         rlm.abstract())
        pshapes = port_params.tree_map(lambda a: tuple(a.shape),
                                       plm.abstract(),
                                       is_leaf=torch.is_tensor)
        assert pshapes == rshapes
        rdt = jax.tree_util.tree_map(lambda a: str(a.dtype), rlm.abstract())
        pdt = port_params.tree_map(lambda a: str(a.dtype).split(".")[-1],
                                   plm.abstract(), is_leaf=torch.is_tensor)
        assert pdt == rdt
        assert (port_params.count_params(plm.param_specs())
                == ref_params.count_params(rlm.param_specs()))


def test_default_plan_of_mamba2_matches_the_reference():
    """core/tiles.default_plan places an ``ssm`` tile and no attention tile
    for the attention-free model, as the reference does."""
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    rp, pp = ref_tiles.default_plan(r), port_tiles.default_plan(p)
    assert [dataclasses.asdict(t) for t in pp.tiles] == [
        dataclasses.asdict(t) for t in rp.tiles]
    assert "ssm" in [t.name for t in pp.tiles]
    port_tiles.validate_plan(pp, p)
