"""The port's serving engine on the ``ssm`` family against the reference's,
on the CPU.

``repro_torch.runtime.serve.ServeEngine`` (device "cpu",
``ssm_backend="fused"``: the ``ssd_scan`` kernel's plain version) and the
reference ``ServeEngine`` (``ssm_backend="pallas"``: the Pallas kernel in
interpret mode) serve the same requests on reduced mamba2-370m
(``ssm_chunk`` 32) with 2 slots, so prompts of 40 and 70 tokens cross and
pad chunks and the third request waits for a slot; both hold the same
float32 weights and float32 caches.  Greedy tokens, ``stats()``, ticks and
the ``mem.rtt`` counter must be equal, and the conv buffers and states
equal slot for slot.  Every prompt here has at least ``ssm_conv - 1`` = 3
tokens: for a shorter one the reference keeps a conv cache of fewer rows,
which its engine broadcasts into all three slots and decodes from wrong
inputs (ROADMAP queue C), so the two engines must differ there; the port's
engine is held to the reference's ``LM.forward`` on such a prompt instead.
The reference engines are built once per module (each costs seconds of
jit).  Also the launcher on mamba2-370m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as RT
import repro.runtime.serve as ref_serve
import repro_torch.configs as port_configs
import repro_torch.runtime.serve as port_serve
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as port_launch

ARCH = "mamba2-370m"
PROMPTS = (40, 12, 70)
MAX_NEW = 6
LEAVES = ("conv_B", "conv_C", "conv_x", "state")


def prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def f32_params(eng):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), eng.params)


def port_engine(params, **kw):
    eng = port_serve.ServeEngine(
        port_configs.get_config(ARCH).reduced(), batch_slots=2, window=32,
        lm_kwargs=dict(ssm_backend="fused", kv_cache_dtype=torch.float32),
        device="cpu", **kw)
    eng.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return eng


@pytest.fixture(scope="module")
def ssm_pair():
    rcfg = ref_configs.get_config(ARCH).reduced()
    ref_eng = ref_serve.ServeEngine(
        rcfg, batch_slots=2, window=32,
        lm_kwargs=dict(ssm_backend="pallas", remat=False,
                       kv_cache_dtype=jnp.float32))
    ref_eng.params = f32_params(ref_eng)
    port_eng = port_engine(ref_eng.params)
    for eng, pkg in ((ref_eng, ref_serve), (port_eng, port_serve)):
        for i, p in enumerate(prompts(rcfg, PROMPTS)):
            eng.submit(pkg.Request(rid=i, prompt=p, max_new=MAX_NEW))
        eng.run(20)
    return ref_eng, port_eng


def test_serve_ssm_tokens_equal_the_reference_engine(ssm_pair):
    ref_eng, port_eng = ssm_pair
    assert len(port_eng.done) == len(PROMPTS)
    assert ([(r.rid, r.out) for r in port_eng.done]
            == [(r.rid, r.out) for r in ref_eng.done])
    assert all(len(r.out) == MAX_NEW for r in port_eng.done)


def test_serve_ssm_stats_ticks_and_counters_equal_the_reference(ssm_pair):
    ref_eng, port_eng = ssm_pair
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


def test_serve_ssm_caches_equal_the_reference_slot_for_slot(ssm_pair):
    """The port's stacked (L, slots, ...) conv buffers and states hold, slot
    for slot, what the reference keeps per vmap lane (slots, L, 1, ...)."""
    ref_eng, port_eng = ssm_pair
    assert port_eng.cache["pos"].tolist() == np.asarray(
        ref_eng.cache["pos"]).tolist()
    assert sorted(port_eng.cache["blocks"]) == sorted(LEAVES)
    for k in LEAVES:
        port = port_eng.cache["blocks"][k].transpose(0, 1).numpy()
        ref = np.asarray(ref_eng.cache["blocks"][k])[:, :, 0]
        assert port.shape == ref.shape, k
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)
    assert port_eng.cache["blocks"]["state"].dtype == torch.float32


def test_serve_ssm_decode_matches_offline_prefill_and_decode():
    """tests/test_runtime.py::test_serve_decode_matches_offline_forward on
    the ssm family: engine greedy decode == offline prefill + greedy loop
    (the port's own LM, default plain scan)."""
    cfg = port_configs.get_config(ARCH).reduced()
    eng = port_serve.ServeEngine(cfg, batch_slots=2, window=32,
                                 device="cpu", seed=3)
    prompt = prompts(cfg, (37,), seed=1)[0]
    eng.submit(port_serve.Request(rid=0, prompt=prompt, max_new=5))
    eng.run(10)
    got = eng.done[0].out
    lm = eng.lm
    lg, cache = lm.prefill(eng.params, torch.from_numpy(prompt[None]).long())
    exp = [int(torch.argmax(lg, -1)[0])]
    for _ in range(4):
        lg, cache = lm.decode_step(eng.params, cache,
                                   torch.tensor([[exp[-1]]]))
        exp.append(int(torch.argmax(lg, -1)[0]))
    assert got == exp


@pytest.mark.parametrize("n", [1, 2])
def test_serve_short_prompt_follows_the_reference_forward(n):
    """A prompt shorter than the conv (1 or 2 tokens): the port's engine
    emits the greedy tokens of the reference's ``LM.forward`` recomputed
    over the whole sequence at every step (its causal conv pads with
    zeros), beside a second request that decodes in the other slot."""
    rcfg = ref_configs.get_config(ARCH).reduced()
    rlm = RT.LM(rcfg, remat=False)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    rlm.init(jax.random.PRNGKey(4)))
    eng = port_engine(params)
    short, other = prompts(rcfg, (n, 9), seed=5)
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


def test_launcher_walks_the_cli_on_the_cpu(capsys):
    port_launch.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                      "--max-new", "4", "--prompt-len", "40"])
    out = capsys.readouterr().out
    assert "served 3/3 requests (12 tokens)" in out
    assert "on cpu" in out and "mem.rtt=" in out
