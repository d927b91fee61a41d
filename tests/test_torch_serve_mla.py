"""The port's serving engine on MLA (deepseek-v2-lite-16b) against the
reference's, on the CPU.

``repro_torch.runtime.serve.ServeEngine`` (device "cpu", attention
``"fused"``: the kernels' plain versions; the experts through the
per-expert loop) and the reference ``ServeEngine`` (``"pallas"``: the
Pallas kernels in interpret mode; its decode run slot by slot,
``decode_slot_by_slot``, since this jax cannot ``vmap`` ``ragged_dot``)
serve the same requests on reduced deepseek-v2-lite (a dense prelude
layer and an MoE layer with a shared expert, latent rank 32) with 2 slots
and a 64-token window; both hold the same float32 weights and float32
latent caches.  Every position stays below the window: past the wrap the
reference's MLA decode masks ``idx <= slot`` (ROADMAP queue C;
``tests/test_torch_mla.py`` holds the port's ring there).  Greedy tokens,
``stats()``, ticks and the ``mem.rtt`` counter must be equal, and the
latent cache of every layer slot for slot (rtol 1e-4).

Also here: a one-token prompt (held to the reference's ``LM.forward``, as
the reference's own prefill of one token at B = 1 cannot be decoded), the
int8 admission repair (the reference's engine copies the float latent
into its int8 slot by a cast, which truncates; the port's prefill
quantises it with ``quant_kv``), and the launcher.
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
import repro_torch.runtime.serve as port_serve
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as port_launch

from test_torch_serve_moe import decode_slot_by_slot

ARCH = "deepseek-v2-lite-16b"
PROMPTS = (40, 2, 30, 12)
MAX_NEW = 6
WINDOW = 64


def prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def f32_params(params):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)


def port_engine(params, kv=torch.float32, **kw):
    eng = port_serve.ServeEngine(
        port_configs.get_config(ARCH).reduced(), batch_slots=2,
        window=WINDOW, lm_kwargs=dict(opts=PL.AttnOptions(backend="fused"),
                                      kv_cache_dtype=kv),
        device="cpu", **kw)
    eng.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return eng


def ref_engine(kv=jnp.float32):
    return ref_serve.ServeEngine(
        ref_configs.get_config(ARCH).reduced(), batch_slots=2, window=WINDOW,
        lm_kwargs=dict(opts=RL.AttnOptions(backend="pallas"), remat=False,
                       kv_cache_dtype=kv))


@pytest.fixture(scope="module")
def mla_pair():
    ref_eng = decode_slot_by_slot(ref_engine())
    rcfg = ref_eng.cfg
    ref_eng.params = f32_params(ref_eng.params)
    port_eng = port_engine(ref_eng.params)
    for eng, pkg in ((ref_eng, ref_serve), (port_eng, port_serve)):
        for i, p in enumerate(prompts(rcfg, PROMPTS)):
            eng.submit(pkg.Request(rid=i, prompt=p, max_new=MAX_NEW))
        eng.run(20)
    return ref_eng, port_eng


def test_serve_mla_tokens_equal_the_reference_engine(mla_pair):
    ref_eng, port_eng = mla_pair
    assert len(port_eng.done) == len(PROMPTS)
    assert ([(r.rid, r.out) for r in port_eng.done]
            == [(r.rid, r.out) for r in ref_eng.done])
    assert all(len(r.out) == MAX_NEW for r in port_eng.done)


def test_serve_mla_stats_ticks_and_counters_equal_the_reference(mla_pair):
    ref_eng, port_eng = mla_pair
    assert port_eng.stats() == ref_eng.stats()
    assert port_eng.tick == ref_eng.tick
    assert ([(r.submitted_tick, r.first_token_tick, r.done_tick)
             for r in port_eng.done]
            == [(r.submitted_tick, r.first_token_tick, r.done_tick)
                for r in ref_eng.done])
    for tile in ("mem", "io"):
        assert ({k: float(v) for k, v in port_eng.counters[tile].items()}
                == {k: float(v) for k, v in ref_eng.counters[tile].items()})
    assert port_eng.timings["prefill_tokens"] == sum(PROMPTS)


def test_serve_mla_latent_caches_equal_the_reference_slot_for_slot(
        mla_pair):
    """The port's stacked (L, slots, W, r) / (L, slots, W, rope) latent
    cache holds, slot for slot, what the reference keeps per vmap lane:
    the prelude's (slots, 1, W, r) list and the blocks' (slots, L-1, 1, W,
    r)."""
    ref_eng, port_eng = mla_pair
    assert port_eng.cache["pos"].tolist() == np.asarray(
        ref_eng.cache["pos"]).tolist()
    assert sorted(port_eng.cache) == ["blocks", "pos"]
    assert sorted(ref_eng.cache) == ["blocks", "pos", "prelude"]
    for j, w in enumerate((32, 8)):
        port = port_eng.cache["blocks"][j]
        assert tuple(port.shape) == (2, 2, WINDOW, w)
        assert port.dtype == torch.float32
        pre = np.asarray(ref_eng.cache["prelude"][0][j])[:, 0]
        blk = np.asarray(ref_eng.cache["blocks"][j])[:, 0, 0]
        np.testing.assert_allclose(port[0].numpy(), pre, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(port[1].numpy(), blk, rtol=1e-4,
                                   atol=1e-6)


def test_serve_mla_decode_matches_offline_prefill_and_decode():
    """tests/test_runtime.py::test_serve_decode_matches_offline_forward on
    MLA: engine greedy decode == offline prefill (at the engine's window)
    + greedy loop, the port's own LM and bf16 weights, attention
    ``fused``; a 40-token prompt in a 32-token window, so the history is
    rotated into the ring and decode reads it whole."""
    cfg = port_configs.get_config(ARCH).reduced()
    eng = port_serve.ServeEngine(
        cfg, batch_slots=2, window=32, device="cpu", seed=3,
        lm_kwargs=dict(opts=PL.AttnOptions(backend="fused")))
    prompt = prompts(cfg, (40,), seed=1)[0]
    eng.submit(port_serve.Request(rid=0, prompt=prompt, max_new=5))
    eng.run(10)
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
    """A prompt of one token: the port's engine emits the greedy tokens of
    the reference's ``LM.forward`` recomputed over the whole sequence at
    every step, beside a second request that decodes in the other slot
    (the reference's own prefill of one token at B = 1 pads the batch
    axis of its stacked cache, ROADMAP queue C)."""
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


def test_int8_admission_quantises_where_the_reference_truncates():
    """``kv_cache_dtype=int8``: the reference's engine copies the prefill's
    float latent into its int8 slot with ``astype`` (``runtime/serve.py``,
    the admission), which truncates toward zero ([1.09, 0.56, -1.16] ->
    [1, 0, -1], read back through ``dequant_kv`` as 0.063 x those); only
    its decode's own writes go through ``quant_kv``.  The port's prefill
    returns the latent quantised with ``quant_kv``, so its slot holds the
    reference's ``quant_kv`` of the reference's own latent, bit for bit,
    and reads back within half a quantisation step."""
    ref_eng = ref_engine(jnp.int8)
    ref_eng.params = f32_params(ref_eng.params)
    port_eng = port_engine(ref_eng.params, kv=torch.int8)
    prompt = prompts(ref_eng.cfg, (20,), seed=7)[0]
    ref_eng.submit(ref_serve.Request(rid=0, prompt=prompt, max_new=3))
    port_eng.submit(port_serve.Request(rid=0, prompt=prompt, max_new=3))
    ref_eng._admit()
    port_eng._admit()
    _, latent = ref_eng._prefill(ref_eng.params,
                                 jnp.asarray(prompt[None, :], jnp.int32))
    lat = np.asarray(latent["prelude"][0][0])[0]             # (W, r)
    ref_slot = np.asarray(ref_eng.cache["prelude"][0][0])[0, 0]
    port_slot = port_eng.cache["blocks"][0][0, 0].numpy()
    assert ref_slot.dtype == port_slot.dtype == np.int8
    np.testing.assert_array_equal(ref_slot, lat.astype(np.int8))  # cast
    np.testing.assert_array_equal(port_slot,
                                  np.asarray(RL.quant_kv(jnp.asarray(lat))))
    live = lat[:20]
    step = RL.KV_QUANT_RANGE / 127.0
    assert np.abs(PL.dequant_kv(torch.from_numpy(port_slot[:20])).numpy()
                  - live).max() <= step / 2 + 1e-6
    assert np.abs(np.asarray(RL.dequant_kv(jnp.asarray(ref_slot[:20])))
                  - live).max() > 10 * step
    for j, (ref_leaf, port_leaf) in enumerate(zip(
            latent["blocks"], port_eng.cache["blocks"])):
        want = np.asarray(RL.quant_kv(jnp.asarray(ref_leaf)))[:, 0]
        np.testing.assert_array_equal(port_leaf[1:, 0].numpy(), want)


def test_serve_int8_engine_matches_its_offline_lm():
    """The port's engine with an int8 latent cache emits the greedy tokens
    of its own LM's int8 prefill + decode loop, and its logits stay
    finite."""
    cfg = port_configs.get_config(ARCH).reduced()
    eng = port_serve.ServeEngine(
        cfg, batch_slots=2, window=32, device="cpu", seed=6,
        lm_kwargs=dict(opts=PL.AttnOptions(backend="fused"),
                       kv_cache_dtype=torch.int8))
    prompt = prompts(cfg, (21,), seed=2)[0]
    eng.submit(port_serve.Request(rid=0, prompt=prompt, max_new=5))
    eng.run(10)
    assert eng.cache["blocks"][0].dtype == torch.int8
    lm = eng.lm
    lg, cache = lm.prefill(eng.params, torch.from_numpy(prompt[None]).long(),
                           cache_len=32)
    exp = [int(torch.argmax(lg, -1)[0])]
    for _ in range(4):
        lg, cache = lm.decode_step(eng.params, cache,
                                   torch.tensor([[exp[-1]]]))
        assert bool(torch.isfinite(lg).all())
        exp.append(int(torch.argmax(lg, -1)[0]))
    assert eng.done[0].out == exp


def test_launcher_serves_deepseek_on_the_cpu(capsys):
    port_launch.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                      "--slots", "2", "--window", "32", "--prompt-len", "6",
                      "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3/3 requests (9 tokens)" in out and "on cpu" in out
