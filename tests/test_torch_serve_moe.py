"""The port's serving engine on the ``moe`` family against the reference's,
on the CPU.

``repro_torch.runtime.serve.ServeEngine`` (device "cpu", attention
``"fused"``: the kernels' plain versions; the expert products through
``grouped_matmul``, the per-expert loop on the CPU) and the reference
``ServeEngine`` (``"pallas"``: the Pallas kernels in interpret mode, the
experts through ``ragged_dot``; its decode run slot by slot, since this
jax cannot ``vmap`` ``ragged_dot`` over the slots) serve the same requests on reduced
granite-moe-1b-a400m (2 layers, 4 experts, top 2) with 2 slots and a
32-token window, so prompts of 40 and 70 tokens rotate the history into
the ring, decode wraps it, and later requests wait for a slot; both hold
the same float32 weights and float32 caches.  Greedy tokens, ``stats()``,
ticks and the ``mem.rtt`` counter must be equal, and the K / V of every
layer slot for slot.  ``ServeEngine`` itself has no MoE code: the moe
cache is the dense family's one stacked ``(k, v)``.

A prompt of one token is held to the reference's ``LM.forward`` instead:
the reference's prefill of one token at B = 1 fits its stacked cache on the
batch axis and its next decode step fails (ROADMAP queue C, pinned here).
The launcher's granite-moe case is in ``tests/test_torch_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as RL
import repro.models.transformer as RT
import repro.runtime.serve as ref_serve
import repro_torch.configs as port_configs
import repro_torch.models.layers as PL
import repro_torch.models.moe as PM
import repro_torch.runtime.serve as port_serve
from repro_torch.convert import lm_params_from_numpy

ARCH = "granite-moe-1b-a400m"
PROMPTS = (40, 2, 70, 12)
MAX_NEW = 6


def prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def f32_params(params):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)


def port_engine(params, **kw):
    eng = port_serve.ServeEngine(
        port_configs.get_config(ARCH).reduced(), batch_slots=2, window=32,
        lm_kwargs=dict(opts=PL.AttnOptions(backend="fused"),
                       kv_cache_dtype=torch.float32),
        device="cpu", **kw)
    eng.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return eng


def ref_engine():
    return ref_serve.ServeEngine(
        ref_configs.get_config(ARCH).reduced(), batch_slots=2, window=32,
        lm_kwargs=dict(opts=RL.AttnOptions(backend="pallas"), remat=False,
                       kv_cache_dtype=jnp.float32))


def decode_slot_by_slot(ref_eng):
    """Give the reference engine a decode of each slot in turn, at B = 1,
    in place of its ``jax.vmap`` over the slots, which computes the same
    but which this jax cannot trace through ``ragged_dot``
    (``test_reference_engine_cannot_vmap_the_experts``).  Admission, ticks,
    counters and stats stay the reference engine's own."""
    step = jax.jit(lambda p, c, t: ref_eng.lm.decode_step(p, c, tokens=t))

    def decode_all(params, cache_stack, tokens):
        outs = [step(params, jax.tree_util.tree_map(lambda a: a[s],
                                                    cache_stack), tokens[s])
                for s in range(ref_eng.slots)]
        return (jnp.stack([lg for lg, _ in outs]),
                jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                       *[c for _, c in outs]))

    ref_eng._decode = decode_all
    return ref_eng


@pytest.fixture(scope="module")
def moe_pair():
    ref_eng = decode_slot_by_slot(ref_engine())
    rcfg = ref_eng.cfg
    ref_eng.params = f32_params(ref_eng.params)
    port_eng = port_engine(ref_eng.params)
    for eng, pkg in ((ref_eng, ref_serve), (port_eng, port_serve)):
        for i, p in enumerate(prompts(rcfg, PROMPTS)):
            eng.submit(pkg.Request(rid=i, prompt=p, max_new=MAX_NEW))
        eng.run(20)
    return ref_eng, port_eng


def test_serve_moe_tokens_equal_the_reference_engine(moe_pair):
    ref_eng, port_eng = moe_pair
    assert len(port_eng.done) == len(PROMPTS)
    assert ([(r.rid, r.out) for r in port_eng.done]
            == [(r.rid, r.out) for r in ref_eng.done])
    assert all(len(r.out) == MAX_NEW for r in port_eng.done)


def test_serve_moe_stats_ticks_and_counters_equal_the_reference(moe_pair):
    ref_eng, port_eng = moe_pair
    assert port_eng.stats() == ref_eng.stats()
    assert port_eng.tick == ref_eng.tick
    assert ([(r.submitted_tick, r.first_token_tick, r.done_tick)
             for r in port_eng.done]
            == [(r.submitted_tick, r.first_token_tick, r.done_tick)
                for r in ref_eng.done])
    for tile in ("mem", "io"):
        assert ({k: float(v) for k, v in port_eng.counters[tile].items()}
                == {k: float(v) for k, v in ref_eng.counters[tile].items()})
    assert float(port_eng.counters["mem"]["rtt"]) > 0
    assert port_eng.timings["prefill_tokens"] == sum(PROMPTS)


def test_serve_moe_caches_equal_the_reference_slot_for_slot(moe_pair):
    """The port's stacked (L, slots, W, KV, hd) K / V hold, slot for slot,
    what the reference keeps per vmap lane (slots, L, 1, W, KV, hd)."""
    ref_eng, port_eng = moe_pair
    assert port_eng.cache["pos"].tolist() == np.asarray(
        ref_eng.cache["pos"]).tolist()
    assert sorted(port_eng.cache) == sorted(ref_eng.cache) == ["blocks",
                                                               "pos"]
    for port, ref in zip(port_eng.cache["blocks"], ref_eng.cache["blocks"]):
        assert tuple(port.shape) == (2, 2, 32, 2, 16)
        assert port.dtype == torch.float32
        np.testing.assert_allclose(port.transpose(0, 1).numpy(),
                                   np.asarray(ref)[:, :, 0], rtol=1e-4,
                                   atol=1e-6)


def test_serve_moe_decode_matches_offline_prefill_and_decode():
    """tests/test_runtime.py::test_serve_decode_matches_offline_forward on
    the moe family: engine greedy decode == offline prefill (at the
    engine's window) + greedy loop, the port's own LM and bf16 weights,
    attention and experts ``fused``."""
    cfg = port_configs.get_config(ARCH).reduced()
    eng = port_serve.ServeEngine(
        cfg, batch_slots=2, window=32, device="cpu", seed=3,
        lm_kwargs=dict(opts=PL.AttnOptions(backend="fused")))
    prompt = prompts(cfg, (37,), seed=1)[0]
    eng.submit(port_serve.Request(rid=0, prompt=prompt, max_new=5))
    eng.run(10)
    assert PM.grouped_matmul.last_variant == "loop"
    got = eng.done[0].out
    lm = eng.lm
    lg, cache = lm.prefill(eng.params, torch.from_numpy(prompt[None]).long(),
                           cache_len=32)
    exp = [int(torch.argmax(lg, -1)[0])]
    for _ in range(4):
        lg, cache = lm.decode_step(eng.params, cache,
                                   torch.tensor([[exp[-1]]]))
        exp.append(int(torch.argmax(lg, -1)[0]))
    assert got == exp


def test_serve_one_token_prompt_follows_the_reference_forward():
    """A prompt of one token (k of the E experts hit): the port's engine
    emits the greedy tokens of the reference's ``LM.forward`` recomputed
    over the whole sequence at every step, beside a second request that
    decodes in the other slot."""
    rcfg = ref_configs.get_config(ARCH).reduced()
    rlm = RT.LM(rcfg, remat=False)
    params = f32_params(rlm.init(jax.random.PRNGKey(4)))
    eng = port_engine(params)
    short, other = prompts(rcfg, (1, 9), seed=5)
    eng.submit(port_serve.Request(rid=0, prompt=short, max_new=4))
    eng.submit(port_serve.Request(rid=1, prompt=other, max_new=4))
    eng.run(8)
    forward = jax.jit(lambda t: rlm.forward(params, tokens=t)[0])
    for req, prompt in zip(sorted(eng.done, key=lambda r: r.rid),
                           (short, other)):
        seq = list(prompt)
        for _ in range(4):
            lg = forward(jnp.asarray(np.array(seq, np.int32)[None]))
            seq.append(int(jnp.argmax(lg[0, -1])))
        assert req.out == seq[len(prompt):], req.rid


def test_reference_pads_the_batch_axis_of_a_one_token_prompt():
    """A recorded reference behaviour, not a port fault: the reference's
    prefill of one token at B = 1 (its engine's prefill) stacks the cache
    as (L, B, S, KV, hd) = (2, 1, 1, 2, 16), and ``_pad_attn_cache`` pads
    the first axis of size S after axis 0, the batch axis, to the window;
    its next ``decode_step`` then fails to reshape.  The port's cache has
    the window on the sequence axis."""
    rcfg = ref_configs.get_config(ARCH).reduced()
    rlm = RT.LM(rcfg, opts=RL.AttnOptions(backend="naive"), remat=False)
    rp = rlm.init(jax.random.PRNGKey(0))
    tok = np.array([[5]], np.int32)
    _, rc = rlm.prefill(rp, tokens=jnp.asarray(tok), cache_len=8)
    assert [np.shape(a) for a in rc["blocks"]] == [(2, 8, 1, 2, 16)] * 2
    with pytest.raises(TypeError, match="cannot reshape"):
        rlm.decode_step(rp, rc, tokens=jnp.asarray(tok))
    eng = port_engine(rp)
    _, pc = eng.lm.prefill(eng.params, torch.from_numpy(tok).long(),
                           cache_len=8)
    assert [tuple(a.shape) for a in pc["blocks"]] == [(2, 1, 8, 2, 16)] * 2


def test_reference_engine_cannot_vmap_the_experts():
    """A recorded reference behaviour, not a port fault: the reference's
    ``ServeEngine`` decodes all slots through ``jax.vmap`` of
    ``decode_step``, and this jax refuses to batch ``ragged_dot`` (the MoE's
    expert products) over a dim other than 0.  So the reference engine
    admits a moe request but cannot decode it; the tests above run its
    decode slot by slot (``decode_slot_by_slot``)."""
    ref_eng = ref_engine()
    ref_eng.params = f32_params(ref_eng.params)
    prompt = prompts(ref_eng.cfg, (6,))[0]
    ref_eng.submit(ref_serve.Request(rid=0, prompt=prompt, max_new=3))
    with pytest.raises(NotImplementedError, match="ragged_dot vmap"):
        ref_eng.step()
