"""The port's serving engine on the ``hybrid`` family against the
reference's, on the CPU.

``repro_torch.runtime.serve.ServeEngine`` (device "cpu", attention and
``ssm_backend`` ``"fused"``: the kernels' plain versions) and the reference
``ServeEngine`` (``"pallas"`` both: the Pallas kernels in interpret mode)
serve the same requests on reduced zamba2-7b (4 Mamba-2 blocks, the shared
tile before blocks 0 and 2) with 2 slots and a 32-token window, so prompts
of 40 and 70 tokens rotate each site's history into its ring, decode wraps
it, and the third request waits for a slot; both hold the same float32
weights and float32 caches.  Greedy tokens, ``stats()``, ticks and the
``mem.rtt`` counter must be equal, and every cache leaf (the conv buffers,
the states and each site's K / V history) equal slot for slot.  Every
prompt there has at least ``ssm_conv - 1`` = 3 tokens: below that the
reference's engine keeps a short conv tail (ROADMAP queue C) and, at one
token, pads its shared-tile cache along the batch axis and cannot decode
(``tests/test_torch_hybrid.py``); the port's engine is held to the
reference's ``LM.forward`` on such prompts instead.  Also the launcher on
zamba2-7b.
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

ARCH = "zamba2-7b"
PROMPTS = (40, 12, 70)
MAX_NEW = 6
LEAVES = ("conv_B", "conv_C", "conv_x", "state")


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
                       ssm_backend="fused", kv_cache_dtype=torch.float32),
        device="cpu", **kw)
    eng.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return eng


@pytest.fixture(scope="module")
def hybrid_pair():
    rcfg = ref_configs.get_config(ARCH).reduced()
    ref_eng = ref_serve.ServeEngine(
        rcfg, batch_slots=2, window=32,
        lm_kwargs=dict(opts=RL.AttnOptions(backend="pallas"),
                       ssm_backend="pallas", remat=False,
                       kv_cache_dtype=jnp.float32))
    ref_eng.params = f32_params(ref_eng.params)
    port_eng = port_engine(ref_eng.params)
    for eng, pkg in ((ref_eng, ref_serve), (port_eng, port_serve)):
        for i, p in enumerate(prompts(rcfg, PROMPTS)):
            eng.submit(pkg.Request(rid=i, prompt=p, max_new=MAX_NEW))
        eng.run(20)
    return ref_eng, port_eng


def test_serve_hybrid_tokens_equal_the_reference_engine(hybrid_pair):
    ref_eng, port_eng = hybrid_pair
    assert len(port_eng.done) == len(PROMPTS)
    assert ([(r.rid, r.out) for r in port_eng.done]
            == [(r.rid, r.out) for r in ref_eng.done])
    assert all(len(r.out) == MAX_NEW for r in port_eng.done)


def test_serve_hybrid_stats_ticks_and_counters_equal_the_reference(
        hybrid_pair):
    ref_eng, port_eng = hybrid_pair
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


def test_serve_hybrid_caches_equal_the_reference_slot_for_slot(hybrid_pair):
    """The port's stacked (L, slots, ...) SSM leaves and (n_apps, slots, W,
    KV, hd) site histories hold, slot for slot, what the reference keeps
    per vmap lane (slots, L or n_apps, 1, ...)."""
    ref_eng, port_eng = hybrid_pair
    assert port_eng.cache["pos"].tolist() == np.asarray(
        ref_eng.cache["pos"]).tolist()
    assert sorted(port_eng.cache) == sorted(ref_eng.cache)
    assert sorted(port_eng.cache["blocks"]) == sorted(LEAVES)
    pairs = [(port_eng.cache["blocks"][k], ref_eng.cache["blocks"][k])
             for k in LEAVES]
    pairs += list(zip(port_eng.cache["shared_attn"],
                      ref_eng.cache["shared_attn"]))
    assert tuple(port_eng.cache["shared_attn"][0].shape) == (2, 2, 32, 4, 16)
    for port, ref in pairs:
        port = port.transpose(0, 1).numpy()
        ref = np.asarray(ref)[:, :, 0]
        assert port.shape == ref.shape
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)
    assert port_eng.cache["shared_attn"][0].dtype == torch.float32


def test_serve_hybrid_decode_matches_offline_prefill_and_decode():
    """tests/test_runtime.py::test_serve_decode_matches_offline_forward on
    the hybrid family: engine greedy decode == offline prefill (at the
    engine's window) + greedy loop, the port's own LM and bf16 weights."""
    cfg = port_configs.get_config(ARCH).reduced()
    eng = port_serve.ServeEngine(cfg, batch_slots=2, window=32,
                                 device="cpu", seed=3)
    prompt = prompts(cfg, (37,), seed=1)[0]
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


@pytest.mark.parametrize("n", [1, 2])
def test_serve_short_prompt_follows_the_reference_forward(n):
    """A prompt of 1 or 2 tokens (one token is the S == B case of the
    reference's cache fit): the port's engine emits the greedy tokens of
    the reference's ``LM.forward`` recomputed over the whole sequence at
    every step, beside a second request that decodes in the other slot."""
    rcfg = ref_configs.get_config(ARCH).reduced()
    rlm = RT.LM(rcfg, remat=False)
    params = f32_params(rlm.init(jax.random.PRNGKey(4)))
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
