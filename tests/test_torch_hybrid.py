"""The port's ``hybrid`` family (Zamba-2) against the reference's, on the
CPU.

``LM`` of the hybrid family runs a Mamba-2 backbone and one shared
attention + MLP tile, applied before every ``shared_attn_every``-th block
with one KV history per application site.  On reduced zamba2-7b (4
layers, the tile every 2 blocks: 2 sites; head dim 16, ``ssm_chunk`` 32)
the port and the reference get the same NumPy inputs and the same float32
weights (carried with ``convert.lm_params_from_numpy``).  The reference
runs its oracle attention (``backend="naive"``) and its XLA scan; the port
runs ``AttnOptions()`` and ``backend="fused"`` (the kernels' plain
versions on the CPU) with ``ssm_backend`` ``"torch"`` and ``"fused"``.
float32 is held to rtol 1e-4 (atol 1e-6 for cache leaves, whose values
cross zero; 1e-5 for the logits), as ``tests/test_torch_models.py`` holds
the dense LM; bfloat16 logits to atol 5e-2.

Two reference behaviours show here, and each is pinned: a prompt of one
token prefilled at B = 1 gets its shared-tile cache padded along the batch
axis (``_pad_attn_cache`` takes the first axis of size S after axis 0 as the
sequence axis, and the stacked cache is ``(n_apps, B, S, ...)``), after
which its ``decode_step`` raises; and a prompt shorter than ``ssm_conv - 1``
keeps a short conv tail (ROADMAP queue C).  The port fits each site's
``(B, S, KV, hd)`` on its own and keeps the zero-padded conv tail, so both
follow the reference's ``LM.forward``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.tiles as ref_tiles
import repro.models.layers as RL
import repro.models.params as ref_params
import repro.models.transformer as RT
import repro_torch.configs as port_configs
import repro_torch.core.tiles as port_tiles
import repro_torch.models.layers as PL
import repro_torch.models.params as port_params
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy

ARCH = "zamba2-7b"
RTOL, ATOL = 1e-4, 1e-6
LEAVES = ("conv_B", "conv_C", "conv_x", "state")
S, N_DECODE = 40, 5


def np32(x):
    return np.array(x, np.float32)


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np32(ref),
                               rtol=rtol, atol=atol)


def cfgs():
    return (ref_configs.get_config(ARCH).reduced(),
            port_configs.get_config(ARCH).reduced())


def ref_lm(rcfg):
    return RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False,
                 kv_cache_dtype=jnp.float32)


def attn_opts(attn):
    return PL.AttnOptions() if attn == "default" else PL.AttnOptions(
        backend=attn)


def port_lm(pcfg, attn="fused", ssm="fused"):
    return PT.LM(pcfg, opts=attn_opts(attn), ssm_backend=ssm,
                 kv_cache_dtype=torch.float32)


def close_cache(port, ref):
    """Every leaf of a hybrid cache: the stacked SSM leaves and each
    site's K / V history."""
    assert sorted(port) == sorted(ref)
    assert sorted(port["blocks"]) == sorted(LEAVES)
    for k in LEAVES:
        assert tuple(port["blocks"][k].shape) == np.shape(ref["blocks"][k])
        close(port["blocks"][k], ref["blocks"][k])
    for p, r in zip(port["shared_attn"], ref["shared_attn"]):
        assert tuple(p.shape) == np.shape(r)
        close(p, r)


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def hyb():
    """The reference LM (float32 weights and cache) and its prefill and
    five decode steps at cache lengths above (64) and below (24) the
    40-token prompt, so the second rotates each site's history into its
    ring and wraps it in decode; once per module."""
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
        r = {"prefill": np32(lg),
             "cache": jax.tree_util.tree_map(np.asarray, cache),
             "decode": []}
        for t in nxt:
            lg, cache = rlm.decode_step(rp, cache, tokens=jnp.asarray(t))
            r["decode"].append(np32(lg))
        r["decode_cache"] = jax.tree_util.tree_map(np.asarray, cache)
        ref[cl] = r
    return dict(rlm=rlm, rp=rp, nump=jax.tree_util.tree_map(np.asarray, rp),
                pcfg=pcfg, toks=toks, nxt=nxt, ref=ref)


def params_of(h):
    return lm_params_from_numpy(h["nump"], "cpu")


# ------------------------------------------------- configs and param specs
def test_config_equals_the_reference():
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(r.reduced())
    assert p.n_params() == r.n_params()
    assert (p.n_layers, p.d_model, p.head_dim, p.ssm_state,
            p.shared_attn_every) == (81, 3584, 112, 64, 6)
    assert PT.LM(p).n_apps == 14
    assert PT.LM(p.reduced()).n_apps == 2


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_the_reference(reduced):
    """Shapes, logical axes, dtypes, init kinds and scales of every leaf,
    and the parameter count; the shared tile is one unstacked dense
    block."""
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    if reduced:
        r, p = r.reduced(), p.reduced()
    rspec, pspec = RT.LM(r).param_specs(), PT.LM(p).param_specs()

    def fields(s):
        return (tuple(s.shape), tuple(s.axes), np.dtype(s.dtype).name
                if not isinstance(s.dtype, torch.dtype)
                else str(s.dtype).split(".")[-1], s.init, s.scale)

    assert (port_params.tree_map(fields, pspec)
            == jax.tree_util.tree_map(fields, rspec,
                                      is_leaf=ref_params.is_spec))
    assert (port_params.count_params(pspec)
            == ref_params.count_params(rspec))
    assert sorted(pspec) == ["blocks", "embed", "final_norm", "lm_head",
                             "shared_attn"]


def test_hybrid_shared_tile_param_sharing():
    """tests/test_models.py::test_hybrid_shared_tile_param_sharing on the
    port: one physical shared-attention tile (params not per layer)."""
    _, cfg = cfgs()
    params = PT.LM(cfg).init(torch.Generator().manual_seed(0))
    assert "shared_attn" in params
    assert params["shared_attn"]["attn"]["wq"].ndim == 2
    assert params["blocks"]["ssm"]["w_x"].shape[0] == cfg.n_layers


def test_default_plan_of_zamba2_matches_the_reference():
    """core/tiles.default_plan places the ssm tiles and the shared
    attention tile of the hybrid model as the reference does."""
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    rp, pp = ref_tiles.default_plan(r), port_tiles.default_plan(p)
    assert [dataclasses.asdict(t) for t in pp.tiles] == [
        dataclasses.asdict(t) for t in rp.tiles]
    port_tiles.validate_plan(pp, p)


# ------------------------------------------------------- prefill and decode
@pytest.mark.parametrize("ssm", ["torch", "fused"])
@pytest.mark.parametrize("attn", ["default", "fused"])
@pytest.mark.parametrize("cache_len", [64, 24])
def test_lm_prefill_and_decode_match_the_reference(hyb, cache_len, attn,
                                                   ssm):
    """Prefill logits and every cache leaf, then five decode steps (logits
    and the final cache); decode writes the SSM leaves and each site's
    history in place."""
    h = hyb
    ref = h["ref"][cache_len]
    lm, params = port_lm(h["pcfg"], attn, ssm), params_of(h)
    lg, cache = lm.prefill(params, torch.from_numpy(h["toks"]).long(),
                           cache_len=cache_len)
    close(lg, ref["prefill"], atol=1e-5)
    assert cache["pos"].tolist() == [S, S]
    assert tuple(cache["shared_attn"][0].shape) == (2, 2, cache_len, 4, 16)
    close_cache({k: v for k, v in cache.items() if k != "pos"},
                {k: v for k, v in ref["cache"].items() if k != "pos"})
    held = [cache["blocks"][k] for k in LEAVES] + list(cache["shared_attn"])
    for t, want in zip(h["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)
    now = [cache["blocks"][k] for k in LEAVES] + list(cache["shared_attn"])
    assert all(a is b for a, b in zip(now, held))                # in place
    assert cache["pos"].tolist() == [S + N_DECODE] * 2
    close_cache({k: v for k, v in cache.items() if k != "pos"},
                {k: v for k, v in ref["decode_cache"].items()
                 if k != "pos"})


def test_lm_prefill_then_decode_equals_the_reference_forward(hyb):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port: S = 33 crosses a chunk of 32; prefill of 32 then one decode step
    give the reference's training forward at positions 31 and 32."""
    h = hyb
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, size=(2, 33)).astype(np.int32)
    full = np32(h["rlm"].forward(h["rp"], tokens=jnp.asarray(toks))[0])
    scale = float(np.abs(full).max())
    lm, params = port_lm(h["pcfg"]), params_of(h)
    t = torch.from_numpy(toks).long()
    lg, cache = lm.prefill(params, t[:, :32], cache_len=37)
    assert float((lg - torch.from_numpy(full[:, 31])).abs().max()) / scale \
        < 1e-4
    lg, _ = lm.decode_step(params, cache, t[:, 32:33])
    assert float((lg - torch.from_numpy(full[:, 32])).abs().max()) / scale \
        < 1e-4


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompts_follow_the_reference_forward(hyb, n):
    """A prompt of 1 or 2 tokens at B = 1 (the serving engine's prefill):
    each site's history is fitted to the window on its own, the conv tail
    is zero-padded, and prefill + three decode steps give the reference's
    ``LM.forward`` at every position."""
    h = hyb
    rng = np.random.default_rng(10 + n)
    toks = rng.integers(0, 256, size=(1, n + 3)).astype(np.int32)
    full = np32(h["rlm"].forward(h["rp"], tokens=jnp.asarray(toks))[0])
    scale = float(np.abs(full).max())
    lm, params = port_lm(h["pcfg"]), params_of(h)
    t = torch.from_numpy(toks).long()
    lg, cache = lm.prefill(params, t[:, :n], cache_len=8)
    assert tuple(cache["shared_attn"][0].shape) == (2, 1, 8, 4, 16)
    assert float(cache["shared_attn"][0][:, :, n:].abs().max()) == 0.0
    assert float((lg - torch.from_numpy(full[:, n - 1])).abs().max()) \
        / scale < 1e-4
    for i in range(n, n + 3):
        lg, cache = lm.decode_step(params, cache, t[:, i:i + 1])
        assert float((lg - torch.from_numpy(full[:, i])).abs().max()) \
            / scale < 1e-4, i


def test_reference_pads_the_batch_axis_of_a_one_token_prompt(hyb):
    """A recorded reference behaviour, not a port fault: the reference's
    prefill of one token at B = 1 stacks the tile's histories as
    (n_apps, B, S, KV, hd) = (2, 1, 1, 4, 16) and ``_pad_attn_cache`` pads
    the first axis of size S after axis 0, the batch axis, to the window;
    its next ``decode_step`` then fails to reshape.  The port's cache has
    the window on the sequence axis."""
    h = hyb
    tok = np.array([[5]], np.int32)
    _, rc = h["rlm"].prefill(h["rp"], tokens=jnp.asarray(tok), cache_len=8)
    assert [np.shape(a) for a in rc["shared_attn"]] == [(2, 8, 1, 4, 16)] * 2
    with pytest.raises(TypeError, match="cannot reshape"):
        h["rlm"].decode_step(h["rp"], rc, tokens=jnp.asarray(tok))
    lm, params = port_lm(h["pcfg"]), params_of(h)
    _, pc = lm.prefill(params, torch.from_numpy(tok).long(), cache_len=8)
    assert [tuple(a.shape) for a in pc["shared_attn"]] == [
        (2, 1, 8, 4, 16)] * 2


def test_decode_from_a_carried_reference_cache(hyb):
    """``lm_cache_from_numpy`` carries the reference's hybrid cache (one
    scalar position, ``blocks`` a dict of leaves, ``shared_attn`` a pair)
    into the port's layout; decode from it equals the reference's."""
    h = hyb
    ref = h["ref"][24]
    cache = lm_cache_from_numpy(ref["cache"], "cpu")
    assert cache["pos"].tolist() == [S, S]
    assert sorted(cache) == ["blocks", "pos", "shared_attn"]
    assert sorted(cache["blocks"]) == sorted(LEAVES)
    assert tuple(cache["shared_attn"][1].shape) == (2, 2, 24, 4, 16)
    lm, params = port_lm(h["pcfg"], "default", "torch"), params_of(h)
    for t, want in zip(h["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)


def test_init_cache_matches_the_reference():
    rcfg, pcfg = cfgs()
    rc = RT.LM(rcfg).init_cache(3, 64)
    pc = PT.LM(pcfg).init_cache(3, 64)
    assert sorted(pc) == sorted(rc)
    assert pc["pos"].tolist() == [0, 0, 0]
    for k in LEAVES:
        r = np.asarray(rc["blocks"][k])
        assert tuple(pc["blocks"][k].shape) == r.shape, k
        assert str(pc["blocks"][k].dtype).split(".")[-1] == str(r.dtype), k
    for p, r in zip(pc["shared_attn"], rc["shared_attn"]):
        assert tuple(p.shape) == np.shape(r) == (2, 3, 64, 4, 16)
        assert p.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16"
        assert float(p.abs().max()) == 0.0
    f32 = PT.LM(pcfg, kv_cache_dtype=torch.float32).init_cache(1, 8)
    assert f32["shared_attn"][0].dtype == torch.float32
    assert "shared_attn" not in PT.LM(
        dataclasses.replace(pcfg, shared_attn_every=0)).init_cache(1, 8)


def test_lm_bf16_logits_match_the_reference():
    """bfloat16 weights (the reference's init) and caches: prefill and one
    decode step within atol 5e-2 of the reference's Pallas path."""
    rcfg, pcfg = cfgs()
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="pallas"), remat=False,
                ssm_backend="pallas")
    rp = rlm.init(jax.random.PRNGKey(1))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    assert params["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    lm = PT.LM(pcfg, opts=PL.AttnOptions(backend="fused"),
               ssm_backend="fused")
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size,
                                             size=(1, 24)).astype(np.int32)
    rl, rc = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=32)
    pl_, pc = lm.prefill(params, torch.from_numpy(toks).long(), cache_len=32)
    close(pl_, rl, rtol=0, atol=5e-2)
    assert pc["shared_attn"][0].dtype == torch.bfloat16
    nt = np.array([[7]], np.int32)
    rl, _ = rlm.decode_step(rp, rc, tokens=jnp.asarray(nt))
    pl_, _ = lm.decode_step(params, pc, torch.from_numpy(nt).long())
    close(pl_, rl, rtol=0, atol=5e-2)
