"""The port's serving engine against the reference's, on the CPU.

``repro_torch.runtime.serve.ServeEngine`` (device "cpu", backend "fused":
the kernels' plain versions) and the reference ``ServeEngine`` (backend
"pallas": the Pallas kernels in interpret mode) serve the same requests on
reduced h2o-danube with a 32-token window, so the prefill's window mask, the
cache roll and the ring wrap in decode all run; both hold the same float32
weights.  Greedy tokens, ``stats()`` and the ``mem.rtt`` counter must be
equal.  The reference engines are built once per module (each costs seconds
of jit).  Also the two serving cases of ``tests/test_runtime.py``, the
launcher, and the weight converter.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as RL
import repro.runtime.serve as ref_serve
import repro_torch.configs as port_configs
import repro_torch.models.layers as PL
import repro_torch.runtime.serve as port_serve
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as port_launch

PROMPTS = (40, 12, 24)
MAX_NEW = 6


def prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def run_both(ref_eng, port_eng, lengths, max_new, ticks, seed=0):
    for eng, pkg in ((ref_eng, ref_serve), (port_eng, port_serve)):
        for i, p in enumerate(prompts(ref_eng.cfg, lengths, seed)):
            eng.submit(pkg.Request(rid=i, prompt=p, max_new=max_new))
        eng.run(ticks)


@pytest.fixture(scope="module")
def h2o_pair():
    rcfg = ref_configs.get_config("h2o-danube-1.8b").reduced()
    ref_eng = ref_serve.ServeEngine(
        rcfg, batch_slots=2, window=32,
        lm_kwargs=dict(opts=RL.AttnOptions(backend="pallas"), remat=False,
                       kv_cache_dtype=jnp.float32))
    ref_eng.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                            ref_eng.params)
    port_eng = port_serve.ServeEngine(
        port_configs.get_config("h2o-danube-1.8b").reduced(), batch_slots=2,
        window=32, lm_kwargs=dict(opts=PL.AttnOptions(backend="fused"),
                                  kv_cache_dtype=torch.float32),
        device="cpu")
    port_eng.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_eng.params), "cpu")
    run_both(ref_eng, port_eng, PROMPTS, MAX_NEW, 20)
    return ref_eng, port_eng


def test_serve_tokens_equal_the_reference_engine(h2o_pair):
    ref_eng, port_eng = h2o_pair
    assert len(port_eng.done) == len(PROMPTS)
    assert ([(r.rid, r.out) for r in port_eng.done]
            == [(r.rid, r.out) for r in ref_eng.done])
    assert all(len(r.out) == MAX_NEW for r in port_eng.done)


def test_serve_stats_and_counters_equal_the_reference_engine(h2o_pair):
    ref_eng, port_eng = h2o_pair
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


def test_serve_cache_and_positions_equal_the_reference_engine(h2o_pair):
    """The port's one batched cache holds, row for row, what the reference
    keeps per slot (vmap lanes with a per-slot scalar position)."""
    ref_eng, port_eng = h2o_pair
    assert port_eng.cache["pos"].tolist() == np.asarray(
        ref_eng.cache["pos"]).tolist()
    for port, ref in zip(port_eng.cache["blocks"], ref_eng.cache["blocks"]):
        ref = np.asarray(ref)[:, :, 0]              # (slots, L, W, KV, hd)
        np.testing.assert_allclose(port.transpose(0, 1).numpy(), ref,
                                   rtol=1e-4, atol=1e-6)


def test_serve_timings_and_host_stamps(h2o_pair):
    _, port_eng = h2o_pair
    tm = port_eng.timings
    assert tm["prefill_tokens"] == sum(PROMPTS)
    assert tm["decode_steps"] > 0 and tm["decode_s"] > 0
    for r in port_eng.done:
        assert r.t_submit <= r.t_first <= r.t_done


def test_serve_engine_continuous_batching():
    """tests/test_runtime.py::test_serve_engine_continuous_batching, on the
    port."""
    cfg = port_configs.get_config("granite-8b").reduced()
    eng = port_serve.ServeEngine(
        cfg, batch_slots=2, window=64,
        lm_kwargs=dict(opts=PL.AttnOptions(backend="naive")), device="cpu")
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(port_serve.Request(
            rid=i, max_new=6,
            prompt=rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)))
    eng.run(40)
    s = eng.stats()
    assert s["completed"] == 5.0
    rtts = [r.rtt for r in eng.done]
    assert max(rtts) > min(rtts)
    assert float(eng.counters["mem"]["rtt"]) > 0


@pytest.mark.parametrize("backend", ["naive", "fused"])
def test_serve_decode_matches_offline_forward(backend):
    """tests/test_runtime.py::test_serve_decode_matches_offline_forward, on
    the port: engine greedy decode == offline prefill + greedy loop."""
    cfg = port_configs.get_config("musicgen-large").reduced()
    lm_kwargs = dict(opts=PL.AttnOptions(backend=backend))
    eng = port_serve.ServeEngine(cfg, batch_slots=2, window=32,
                                 lm_kwargs=lm_kwargs, device="cpu")
    prompt = prompts(cfg, (8,), seed=1)[0]
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


def test_serve_engine_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_configs.get_config("h2o-danube-1.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.ServeEngine(cfg)


def test_launcher_walks_the_cli_on_the_cpu(capsys):
    port_launch.main(["--device", "cpu", "--arch", "h2o-danube-1.8b",
                      "--requests", "3", "--max-new", "4", "--window", "16",
                      "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert "served 3/3 requests (12 tokens)" in out
    assert "on cpu" in out and "mem.rtt=" in out


def test_bf16_weights_are_carried_exactly():
    a = np.random.default_rng(0).standard_normal((3, 4)).astype(
        ml_dtypes.bfloat16)
    tree = {"blocks": {"w": a}, "norm": np.zeros(4, np.float32)}
    out = lm_params_from_numpy(tree, "cpu")
    assert out["blocks"]["w"].dtype == torch.bfloat16
    assert out["norm"].dtype == torch.float32
    np.testing.assert_array_equal(out["blocks"]["w"].float().numpy(),
                                  a.astype(np.float32))
