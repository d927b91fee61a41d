"""The port's ``moe`` family (granite-moe-1b-a400m) against the reference's,
on the CPU.

``models/moe.py`` routes each token to its top-k experts (ties to the lower
expert index, as ``jax.lax.top_k``), sorts the ``(token, slot)`` rows by
expert, runs the expert products as grouped products and sums each token's
k rows back in float32.  The port and the reference get the same NumPy
inputs and the same float32 weights (carried with
``convert.lm_params_from_numpy``); float32 is held to rtol 1e-4 (atol 1e-6
where values cross zero, 1e-5 for logits), bfloat16 logits to atol 5e-2, as
``tests/test_torch_models.py`` holds the dense family.  Expert ids and their
order are held exactly, on tied rows too.

The reduced granite-moe has 2 layers, d 64, head dim 16, 4 experts, top 2;
the full width's 32 experts / top 8 is held at the layer.  A prelude
variant (``n_dense_layers=1``, ``n_shared_experts=1``) covers the dense
first layers and the shared experts that deepseek-v2-lite (item 10.3)
will need.  The gpu-marked test runs ``chip_smoke.py``'s
``card_grouped_matmul`` on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as RL
import repro.models.moe as RM
import repro.models.params as ref_params
import repro.models.transformer as RT
import repro_torch.configs as port_configs
import repro_torch.models.layers as PL
import repro_torch.models.moe as PM
import repro_torch.models.params as port_params
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy

from _torch_port_helpers import chip_smoke

ARCH = "granite-moe-1b-a400m"
RTOL, ATOL = 1e-4, 1e-6
S, N_DECODE = 40, 4
# (E, k): the full width's and the reduced config's
ROUTINGS = ((32, 8), (4, 2))


def np32(x):
    return np.array(x, np.float32)


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np32(ref),
                               rtol=rtol, atol=atol)


def cfgs(**change):
    r = ref_configs.get_config(ARCH).reduced()
    p = port_configs.get_config(ARCH).reduced()
    if change:
        r, p = (dataclasses.replace(c, **change) for c in (r, p))
    return r, p


def prelude_change():
    """The prelude variant: one dense layer before two MoE layers, one
    shared expert."""
    return dict(n_layers=3, n_dense_layers=1, n_shared_experts=1)


def spec_fields(s):
    dt = (str(s.dtype).split(".")[-1] if isinstance(s.dtype, torch.dtype)
          else np.dtype(s.dtype).name)
    return (tuple(s.shape), tuple(s.axes), dt, s.init, s.scale)


def moe_layer(E, k, shared, seed=0, dtype=jnp.float32):
    """One MoE layer's config (the reduced one at ``E`` / ``k``) and its
    reference params in ``dtype`` (the router stays float32)."""
    rcfg, pcfg = cfgs(n_experts=E, top_k=k, n_shared_experts=shared)
    p = ref_params.init_params(RM.moe_spec(rcfg), jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
    p["router"] = p["router"].astype(jnp.float32)
    return rcfg, pcfg, p, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), "cpu")


# ------------------------------------------------- configs and param specs
def test_config_equals_the_reference():
    r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(r.reduced())
    assert p.n_params() == r.n_params()
    assert p.n_active_params() == r.n_active_params()
    assert (p.family, p.n_layers, p.d_model, p.head_dim, p.n_experts,
            p.top_k, p.d_ff_expert, p.vocab_size) == (
        "moe", 24, 1024, 64, 32, 8, 512, 49_155)


@pytest.mark.parametrize("variant", ["full", "reduced", "prelude"])
def test_param_specs_match_the_reference(variant):
    """Shapes, logical axes, dtypes (the router float32), init kinds and
    scales of every leaf and the parameter count; the prelude is a list of
    unstacked dense blocks before the stacked MoE blocks."""
    if variant == "full":
        r, p = ref_configs.get_config(ARCH), port_configs.get_config(ARCH)
    else:
        r, p = cfgs(**(prelude_change() if variant == "prelude" else {}))
    rspec, pspec = RT.LM(r).param_specs(), PT.LM(p).param_specs()
    assert (port_params.tree_map(spec_fields, pspec)
            == jax.tree_util.tree_map(spec_fields, rspec,
                                      is_leaf=ref_params.is_spec))
    assert (port_params.count_params(pspec)
            == ref_params.count_params(rspec))
    assert pspec["blocks"]["moe"]["router"].dtype == torch.float32
    want = ["blocks", "embed", "final_norm"]
    if variant == "prelude":
        want.append("prelude")
        assert len(pspec["prelude"]) == 1
        assert "shared" in pspec["blocks"]["moe"]
    assert sorted(pspec) == want


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_spec_matches_the_reference(shared):
    r, p = cfgs(n_shared_experts=shared)
    rs, ps = RM.moe_spec(r), PM.moe_spec(p)
    assert (port_params.tree_map(spec_fields, ps)
            == jax.tree_util.tree_map(spec_fields, rs,
                                      is_leaf=ref_params.is_spec))
    assert ("shared" in ps) == bool(shared)


# ------------------------------------------------------------------ routing
def route_inputs(kind, E, d=64, N=24, seed=0):
    """(router (d, E), x (N, d)) float32.  ``random``: normal draws;
    ``zeros``: every row all zero (all E logits tie at 0); ``duplicated``:
    router columns copied onto others (exact ties between those experts);
    ``integer``: small integers, so the logits are exact integers with
    many ties whatever the order of the sum."""
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((d, E)).astype(np.float32)
    x = rng.standard_normal((N, d)).astype(np.float32)
    if kind == "zeros":
        x[:] = 0.0
    elif kind == "duplicated":
        for dst in range(1, E, 3):
            router[:, dst] = router[:, dst - 1]
        router[:, E - 1] = router[:, 0]
    elif kind == "integer":
        router = rng.integers(-1, 2, size=(d, E)).astype(np.float32)
        x = rng.integers(-1, 2, size=(N, d)).astype(np.float32)
        x[0] = 0.0
    return router, x


@pytest.mark.parametrize("kind", ["random", "zeros", "duplicated",
                                  "integer"])
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_route_ids_and_order_are_exact(E, k, kind):
    router, x = route_inputs(kind, E)
    rg, rids, rlog = RM._route(jnp.asarray(router), jnp.asarray(x), k)
    pg, pids, plog = PM._route(torch.from_numpy(router), torch.from_numpy(x),
                               k)
    rlog = np32(rlog)
    if kind == "duplicated":     # the ties are exact on both sides
        for lg in (rlog, plog.numpy()):
            assert np.array_equal(lg[:, 0], lg[:, E - 1])
    np.testing.assert_array_equal(pids.numpy(), np.asarray(rids))
    assert pids.dtype == torch.int64
    close(plog, rlog, atol=1e-5)
    close(pg, rg, atol=1e-6)
    if kind == "zeros":          # lax.top_k: the lowest indices, in order
        assert pids.tolist() == [list(range(k))] * x.shape[0]


def test_top_k_breaks_ties_as_lax_top_k():
    """Rows with heavy ties (integers 0-3 over 32 experts): ``top_k`` gives
    ``jax.lax.top_k``'s indices in its order; ``torch.topk`` is not held to
    that order (on an all-zero row it does not give 0..k-1)."""
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 4, size=(64, 32)).astype(np.float32)
    logits[0] = 0.0
    for k in (1, 2, 8, 32):
        rv, ri = jax.lax.top_k(jnp.asarray(logits), k)
        pv, pi = PM.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    _, topk_ids = torch.topk(torch.zeros(1, 32), 8)
    assert PM.top_k(torch.zeros(1, 32), 8)[1].tolist() == [list(range(8))]
    assert topk_ids.tolist() != [list(range(8))]


# -------------------------------------------------------------- moe_apply
@pytest.mark.parametrize("experts", ["grouped", "loop"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_moe_apply_matches_the_reference(E, k, shared, experts):
    """float32: the output (routed + shared experts) and the aux loss."""
    rcfg, pcfg, rp, pp = moe_layer(E, k, shared)
    x = np.random.default_rng(1).standard_normal(
        (2, 13, rcfg.d_model)).astype(np.float32)
    ro, raux = RM.moe_apply(rp, rcfg, jnp.asarray(x))
    po, paux = PM.moe_apply(pp, pcfg, torch.from_numpy(x), experts=experts)
    assert po.shape == (2, 13, rcfg.d_model) and po.dtype == torch.float32
    close(po, ro)
    close(paux, raux)
    assert PM.moe_apply(pp, pcfg, torch.from_numpy(x), aux=False)[1] is None


@pytest.mark.parametrize("E,k", ROUTINGS)
def test_moe_apply_bf16_matches_the_reference(E, k):
    """bfloat16 weights and activations (the router float32): the reference
    adds a token's k rows in bf16, the port in float32 (ROADMAP queue C),
    so they agree to a few bf16 ulps.  The weights are drawn at 1 / sqrt
    of their fan-in, so every product is O(1) (the init's small ``wo``
    would leave outputs of O(1e-3), below any bf16 limit)."""
    rcfg, pcfg = cfgs(n_experts=E, top_k=k, n_shared_experts=1)
    rng = np.random.default_rng(2)
    d, f = rcfg.d_model, rcfg.d_ff_expert
    rp = {"router": rng.standard_normal((d, E)).astype(np.float32)}
    for name, shape in (("wi_gate", (E, d, f)), ("wi_up", (E, d, f)),
                        ("wo", (E, f, d))):
        rp[name] = rng.standard_normal(shape) / np.sqrt(shape[1])
    rp["shared"] = {n: rng.standard_normal(sh) / np.sqrt(sh[0]) for n, sh in
                    (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), rp)
    rp["router"] = rp["router"].astype(jnp.float32)
    pp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    x = rng.standard_normal((1, 16, d)).astype(np.float32)
    ro, raux = RM.moe_apply(rp, rcfg, jnp.asarray(x, jnp.bfloat16))
    po, paux = PM.moe_apply(pp, pcfg, torch.from_numpy(x).bfloat16())
    assert po.dtype == torch.bfloat16
    assert float(np.abs(np32(ro)).max()) > 0.5
    close(po, ro, rtol=0, atol=5e-2)
    close(paux, raux)


def test_moe_apply_refuses_a_mesh_and_expert_parallelism():
    _, pcfg, _, pp = moe_layer(4, 2, 0)
    x = torch.zeros(1, 2, pcfg.d_model)
    for kw in (dict(mesh=object()), dict(ep=True), dict(model_axes="model")):
        with pytest.raises(NotImplementedError, match="queue A item 12"):
            PM.moe_apply(pp, pcfg, x, **kw)
    with pytest.raises(ValueError, match="experts"):
        PM.moe_apply(pp, pcfg, x, experts="ragged")


def test_group_count_makes_no_host_sync_call(monkeypatch):
    """The dispatch counts groups with ``scatter_add_``: ``torch.bincount``
    (which reads the input's max to the host on a card) and
    ``repeat_interleave`` are never called."""
    def refuse(*a, **kw):
        raise AssertionError("a host-syncing call in the MoE dispatch")

    for name in ("bincount", "repeat_interleave"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    rcfg, pcfg, rp, pp = moe_layer(32, 8, 0)
    x = np.random.default_rng(4).standard_normal(
        (1, 5, rcfg.d_model)).astype(np.float32)
    po, _ = PM.moe_apply(pp, pcfg, torch.from_numpy(x))
    close(po, RM.moe_apply(rp, rcfg, jnp.asarray(x))[0])
    flat = torch.tensor([3, 0, 3, 1, 3, 0])
    assert PM.group_offsets(flat, 5).tolist() == [2, 3, 3, 6, 6]
    assert PM.group_offsets(flat, 5).dtype == torch.int32


# ------------------------------------------------------- grouped products
def grouped_case(sizes, K=24, N=40, seed=0, dtype=torch.float32):
    """Rows sorted by group (``sizes`` rows per group, empty groups
    included), weights (E, K, N) and the int32 cumulative group ends."""
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randn(sum(sizes), K, generator=gen).to(dtype)
    w = torch.randn(len(sizes), K, N, generator=gen).to(dtype)
    offsets = torch.cumsum(torch.tensor(sizes), 0).to(torch.int32)
    return xs, w, offsets


def per_group(xs, w, sizes):
    rows, start = [], 0
    for e, n in enumerate(sizes):
        rows.append(xs[start:start + n].float() @ w[e].float())
        start += n
    return torch.cat(rows)


GROUPS = ((3, 0, 5, 0, 0, 2), (0, 0, 7), (4,), (1, 1, 1, 1), (0, 6, 0, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", GROUPS)
def test_grouped_matmul_with_empty_groups_matches_its_loop(sizes, dtype):
    """On the CPU ``grouped_matmul`` runs the per-expert loop (recorded as
    ``last_variant``); empty groups are skipped, and each group's rows
    equal its rows times its expert's weights.  ``torch._grouped_mm``'s
    own CPU version, given the same offsets, computes the same rows: the
    offsets mean to it what they mean to the loop."""
    dt = getattr(torch, dtype)
    xs, w, offsets = grouped_case(sizes, dtype=dt)
    out = PM.grouped_matmul(xs, w, offsets)
    assert PM.grouped_matmul.last_variant == "loop"
    assert out.dtype == dt and out.shape == (sum(sizes), w.shape[-1])
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(
        rtol=1e-2, atol=5e-2)
    torch.testing.assert_close(out.float(), per_group(xs, w, sizes), **tol)
    assert torch.equal(out, PM.grouped_matmul_plain(xs, w, offsets))
    lib = torch._grouped_mm(xs, w, offs=offsets)
    torch.testing.assert_close(lib.float(), out.float(), **tol)


@pytest.mark.parametrize("E,k", ROUTINGS)
def test_expert_ffn_matches_ragged_dot(E, k):
    """The three grouped products over rows sorted by expert, against the
    reference's three ``jax.lax.ragged_dot`` calls on the same rows."""
    rcfg, pcfg, rp, pp = moe_layer(E, k, 0, seed=5)
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, E, size=3 * k))
    xs = rng.standard_normal((ids.size, rcfg.d_model)).astype(np.float32)
    gs = np.bincount(ids, minlength=E).astype(np.int32)
    h = jax.nn.silu(jax.lax.ragged_dot(jnp.asarray(xs), rp["wi_gate"], gs))
    h = h * jax.lax.ragged_dot(jnp.asarray(xs), rp["wi_up"], gs)
    ref = jax.lax.ragged_dot(h, rp["wo"], gs)
    out = PM.expert_ffn(torch.from_numpy(xs), pp,
                        torch.from_numpy(np.cumsum(gs).astype(np.int32)),
                        pcfg.act)
    close(out, ref)


# ----------------------------------------------------- LM prefill / decode
def ref_lm(rcfg):
    return RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False,
                 kv_cache_dtype=jnp.float32)


def port_lm(pcfg, attn="fused"):
    opts = PL.AttnOptions() if attn == "default" else PL.AttnOptions(
        backend=attn)
    return PT.LM(pcfg, opts=opts, kv_cache_dtype=torch.float32)


def ref_run(rlm, rp, toks, nxt, cache_len):
    """The reference's prefill and decode steps: logits and caches."""
    lg, cache = rlm.prefill(rp, tokens=jnp.asarray(toks), cache_len=cache_len)
    out = {"prefill": np32(lg),
           "cache": jax.tree_util.tree_map(np.asarray, cache), "decode": []}
    for t in nxt:
        lg, cache = rlm.decode_step(rp, cache, tokens=jnp.asarray(t))
        out["decode"].append(np32(lg))
    out["decode_cache"] = jax.tree_util.tree_map(np.asarray, cache)
    return out


def folded(ref_cache):
    """The reference's (k, v): the prelude's layers in front of blocks'."""
    pre = ref_cache.get("prelude") or []
    return [np.concatenate([np.stack([np.asarray(c[j]) for c in pre]),
                            np.asarray(ref_cache["blocks"][j])])
            if pre else np.asarray(ref_cache["blocks"][j]) for j in range(2)]


@pytest.fixture(scope="module", params=["granite", "prelude"])
def moe_lm(request):
    """Reduced granite-moe (and its prelude variant): the reference LM with
    float32 weights and cache, its prefill and decode steps at cache
    lengths above (64) and below (24) the 40-token prompt (the second
    rotates the history into its ring and wraps it in decode)."""
    change = prelude_change() if request.param == "prelude" else {}
    rcfg, pcfg = cfgs(**change)
    rlm = ref_lm(rcfg)
    rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                rlm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, size=(2, S)).astype(np.int32)
    nxt = rng.integers(0, rcfg.vocab_size,
                       size=(N_DECODE, 2, 1)).astype(np.int32)
    ref = {cl: ref_run(rlm, rp, toks, nxt, cl) for cl in (64, 24)}
    return dict(variant=request.param, rlm=rlm, rp=rp, rcfg=rcfg, pcfg=pcfg,
                nump=jax.tree_util.tree_map(np.asarray, rp), toks=toks,
                nxt=nxt, ref=ref)


def params_of(m):
    return lm_params_from_numpy(m["nump"], "cpu")


@pytest.mark.parametrize("attn", ["default", "fused"])
@pytest.mark.parametrize("cache_len", [64, 24])
def test_lm_prefill_and_decode_match_the_reference(moe_lm, cache_len, attn):
    """Prefill logits and the K / V of every layer (the prelude's first),
    then decode steps: logits and the final cache, written in place."""
    m = moe_lm
    ref = m["ref"][cache_len]
    lm, params = port_lm(m["pcfg"], attn), params_of(m)
    assert ("prelude" in params) == (m["variant"] == "prelude")
    lg, cache = lm.prefill(params, torch.from_numpy(m["toks"]).long(),
                           cache_len=cache_len)
    close(lg, ref["prefill"], atol=1e-5)
    assert cache["pos"].tolist() == [S, S]
    assert sorted(cache) == ["blocks", "pos"]
    n = m["pcfg"].n_layers
    for p, r in zip(cache["blocks"], folded(ref["cache"])):
        assert tuple(p.shape) == r.shape == (n, 2, cache_len, 2, 16)
        close(p, r)
    held = list(cache["blocks"])
    for t, want in zip(m["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)
    assert all(a is b for a, b in zip(cache["blocks"], held))   # in place
    assert cache["pos"].tolist() == [S + N_DECODE] * 2
    for p, r in zip(cache["blocks"], folded(ref["decode_cache"])):
        close(p, r)


def test_lm_prefill_then_decode_equals_the_reference_forward(moe_lm):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port: prefill of 32 tokens then one decode step give the reference's
    training forward at positions 31 and 32."""
    m = moe_lm
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, size=(2, 33)).astype(np.int32)
    full = np32(m["rlm"].forward(m["rp"], tokens=jnp.asarray(toks))[0])
    lm, params = port_lm(m["pcfg"]), params_of(m)
    t = torch.from_numpy(toks).long()
    lg, cache = lm.prefill(params, t[:, :32], cache_len=37)
    close(lg, full[:, 31], atol=1e-5)
    lg, _ = lm.decode_step(params, cache, t[:, 32:33])
    close(lg, full[:, 32], atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompts_follow_the_reference_forward(moe_lm, n):
    """A prompt of 1 or 2 tokens at B = 1 (the serving engine's prefill;
    one token hits k of the E experts): prefill + three decode steps give
    the reference's ``LM.forward`` at every position."""
    m = moe_lm
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


def test_decode_from_a_carried_reference_cache(moe_lm):
    """``lm_cache_from_numpy`` carries the reference's cache (one scalar
    position; the prelude's ``(k, v)`` list folded in front of
    ``blocks``) into the port's layout; decode from it equals the
    reference's."""
    m = moe_lm
    ref = m["ref"][24]
    assert ("prelude" in ref["cache"]) == (m["variant"] == "prelude")
    cache = lm_cache_from_numpy(ref["cache"], "cpu")
    assert sorted(cache) == ["blocks", "pos"]
    assert cache["pos"].tolist() == [S, S]
    for p, r in zip(cache["blocks"], folded(ref["cache"])):
        assert tuple(p.shape) == (m["pcfg"].n_layers, 2, 24, 2, 16)
        np.testing.assert_array_equal(p.numpy(), r)
    lm, params = port_lm(m["pcfg"], "default"), params_of(m)
    for t, want in zip(m["nxt"], ref["decode"]):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(t).long())
        close(lg, want, atol=1e-5)


@pytest.mark.parametrize("variant", ["granite", "prelude"])
def test_init_cache_matches_the_reference(variant):
    """One stacked (k, v) over every attention layer, the reference's
    ``blocks`` and ``prelude`` together, zero and bf16."""
    rcfg, pcfg = cfgs(**(prelude_change() if variant == "prelude" else {}))
    rc = RT.LM(rcfg).init_cache(3, 64)
    pc = PT.LM(pcfg).init_cache(3, 64)
    assert sorted(pc) == ["blocks", "pos"]
    assert ("prelude" in rc) == (variant == "prelude")
    assert pc["pos"].tolist() == [0, 0, 0]
    for p, r in zip(pc["blocks"], folded(jax.tree_util.tree_map(np.asarray,
                                                                 rc))):
        assert tuple(p.shape) == r.shape == (pcfg.n_layers, 3, 64, 2, 16)
        assert p.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16"
        assert float(p.abs().max()) == 0.0


@pytest.mark.parametrize("variant", ["granite", "prelude"])
def test_lm_bf16_logits_match_the_reference(variant):
    """bfloat16 weights (the reference's init) and caches: prefill and one
    decode step within atol 5e-2 of the reference's Pallas path; the port
    runs ``fused`` (on the CPU: the kernels' plain versions and the
    per-expert loop)."""
    rcfg, pcfg = cfgs(**(prelude_change() if variant == "prelude" else {}))
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="pallas"), remat=False)
    rp = rlm.init(jax.random.PRNGKey(1))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    assert params["blocks"]["moe"]["wi_up"].dtype == torch.bfloat16
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
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


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._grouped_mm runs on the "
                    "card only (chip_smoke.py runs this comparison there)")
    return torch.device("cuda")


# rows, E, K, N, seed: chip_smoke.py's CARD_GROUPED
GROUPED_CASES = ((8, 32, 1024, 512, 0), (32, 32, 1024, 512, 1),
                 (36864, 32, 1024, 512, 2), (40, 4, 64, 64, 3),
                 (64, 32, 512, 1024, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,E,K,N,seed", GROUPED_CASES)
def test_cuda_grouped_matmul_matches_plain(rows, E, K, N, seed, cuda_device):
    """``grouped_matmul`` on CUDA bf16 operands (``torch._grouped_mm``)
    against the per-expert loop on the same inputs (the bf16 MLP rule:
    max(5e-2, one bf16 ulp)); runs as ``chip_smoke.py``'s
    ``card_grouped_matmul``."""
    chip_smoke().card_case("test_cuda_grouped_matmul_matches_plain", rows, E,
                           K, N, seed)
