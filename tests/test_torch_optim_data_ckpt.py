"""The port's AdamW, gradient compression, data pipeline and checkpoint
store, on the CPU: the reference's ``tests/test_optim_data_ckpt.py`` cases
against the port, and the port against the reference.

* AdamW ``update`` against the reference's on a random tree of float32 and
  bfloat16 parameters with clipping active, 5 steps (float32 within rtol
  1e-5 of the largest |value|; bfloat16 parameters within one bf16 ulp);
  ``lr_at`` for the three schedules; ``global_norm`` in the reference's
  leaf order whatever order the dict was built in.
* ``batch_at`` bit-equal to the reference's.
* A bfloat16 checkpoint round trip bit for bit; restore casts to the
  template's dtypes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.optim import adamw as radamw
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim.compress import (compressed_allreduce,
                                        compressed_psum_leaf,
                                        dequantize_int8, quantize_int8)


# ------------------------------------------------------------------- AdamW
def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    st_ = adamw.init(params)
    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum((w - 1.0) ** 2), w)
        params, st_, _ = adamw.update(cfg, {"w": g}, st_, params)
    np.testing.assert_allclose(params["w"].numpy(), np.ones(2), atol=1e-2)


def test_grad_clip_bounds_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(adamw.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 100.0


def test_lr_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    assert float(adamw.lr_at(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(adamw.lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(adamw.lr_at(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_opt_state_is_f32_regardless_of_param_dtype():
    params = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
    st_ = adamw.init(params)
    assert st_.mu["w"].dtype == torch.float32
    assert st_.step.dtype == torch.int32


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_the_reference(schedule):
    kw = dict(lr=6e-4, warmup_steps=7, total_steps=40, schedule=schedule,
              min_lr_ratio=0.1)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for s in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        got = adamw.lr_at(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(radamw.lr_at(
            rc, jnp.asarray(s, jnp.int32))), rtol=1e-6)


def _random_tree(rng):
    """Leaves of both dtypes, keys deliberately out of sorted order."""
    return {"z_b": rng.standard_normal((5, 3)).astype(np.float32),
            "a_w": {"k": rng.standard_normal((4,)).astype(np.float32),
                    "bf": rng.standard_normal((2, 6)).astype(np.float32)},
            "m_list": [rng.standard_normal((3,)).astype(np.float32)]}


BF16_LEAVES = ("bf",)


def _ref_tree(np_tree):
    def cast(path, a):
        key = getattr(path[-1], "key", None)
        x = jnp.asarray(a)
        return x.astype(jnp.bfloat16) if key in BF16_LEAVES else x
    return jax.tree_util.tree_map_with_path(cast, np_tree)


def test_adamw_update_matches_the_reference_for_5_steps():
    rng = np.random.default_rng(0)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
                  weight_decay=0.1)
    rcfg, pcfg = radamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rp = _ref_tree(_random_tree(rng))
    rs = radamw.init(rp)
    pp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    ps = adamw.init(pp)
    for step in range(5):
        grads_np = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, rp))
        rg = _ref_tree(grads_np)
        rp, rs, rm = radamw.update(rcfg, rg, rs, rp)
        pg = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rg),
                                  "cpu")
        pp, ps, pm = adamw.update(pcfg, pg, ps, pp)
        assert float(rm["grad_norm"]) > pcfg.grad_clip     # clipping on
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(ps.step) == int(rs.step) == step + 1
        for a, b in zip(tree_leaves(pp, torch.is_tensor),
                        jax.tree_util.tree_leaves(rp)):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                               else torch.float32)
            ref = np.asarray(b, np.float32)
            tol = (2.0 ** -7 * np.abs(ref).max() if b.dtype == jnp.bfloat16
                   else 1e-5 * np.abs(ref).max())
            np.testing.assert_allclose(a.float().numpy(), ref, atol=tol)
        for tree_p, tree_r in ((ps.mu, rs.mu), (ps.nu, rs.nu)):
            for a, b in zip(tree_leaves(tree_p, torch.is_tensor),
                            jax.tree_util.tree_leaves(tree_r)):
                assert a.dtype == torch.float32
                ref = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), ref,
                                           atol=1e-5 * np.abs(ref).max())


def test_global_norm_sums_in_the_reference_leaf_order():
    """The dict's insertion order does not matter: leaves are taken with
    keys sorted, as ``jax.tree_util`` flattens."""
    a, b, c = (torch.tensor([1e8]), torch.tensor([1.0]),
               torch.tensor([-1e8]))
    one = adamw.global_norm({"a": a, "b": b, "c": c})
    two = adamw.global_norm({"c": c, "b": b, "a": a})
    assert torch.equal(one, two)
    ref = radamw.global_norm({"c": jnp.asarray([-1e8]),
                              "b": jnp.asarray([1.0]),
                              "a": jnp.asarray([1e8])})
    np.testing.assert_allclose(float(one), float(ref), rtol=1e-6)


def test_adamw_state_carried_from_the_reference():
    rng = np.random.default_rng(1)
    rp = _ref_tree(_random_tree(rng))
    rs = radamw.init(rp)
    rg = jax.tree_util.tree_map(jnp.ones_like, rp)
    _, rs, _ = radamw.update(radamw.AdamWConfig(), rg, rs, rp)
    ps = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, tuple(rs)), "cpu")
    assert isinstance(ps, adamw.AdamWState)
    assert int(ps.step) == 1 and ps.step.dtype == torch.int32
    for a, b in zip(tree_leaves(ps.mu, torch.is_tensor),
                    jax.tree_util.tree_leaves(rs.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ gradient compression
@settings(max_examples=25, deadline=None)
@given(scale=st.floats(1e-4, 1e3), n=st.integers(8, 512))
def test_int8_quantization_error_bound(scale, n):
    rng = np.random.default_rng(42)
    g = torch.from_numpy((rng.standard_normal(n) * scale).astype(np.float32))
    q, s = quantize_int8(g)
    back = dequantize_int8(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-6
    rel = float(torch.linalg.norm(back - g) / (torch.linalg.norm(g) + 1e-9))
    assert rel < 0.02


def test_int8_wire_bytes_4x_smaller():
    g = torch.zeros((1024,), dtype=torch.float32)
    q, s = quantize_int8(g)
    assert q.numel() * q.element_size() * 4 == g.numel() * g.element_size()


def test_int8_quantization_equals_the_reference():
    from repro.optim.compress import quantize_int8 as rq
    g = np.random.default_rng(2).standard_normal(300).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(g))
    rq_, rs_ = rq(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq_))
    assert float(s) == float(rs_)


def test_compressed_reduce_waits_for_a_mesh():
    """Ported (queue A item 12b; run over a gloo mesh in
    ``tests/test_torch_parallel.py``): with no mesh, given or ambient, the
    all-gather has nothing to run over and says so."""
    with pytest.raises(RuntimeError, match="needs a mesh"):
        compressed_psum_leaf(torch.ones(3), "pod")
    with pytest.raises(RuntimeError, match="needs a mesh"):
        compressed_allreduce({"a": torch.ones(3)}, None)


# ------------------------------------------------------------ data pipeline
def test_data_deterministic_and_resumable():
    p = SyntheticLM(DataConfig(seed=3, vocab_size=100, seq_len=17,
                               global_batch=4))
    a = p.batch_at(12)
    b = p.batch_at(12)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.batch_at(13)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_shards_disjoint_and_partition():
    p = SyntheticLM(DataConfig(seed=3, vocab_size=1000, seq_len=9,
                               global_batch=8))
    s0 = p.batch_at(5, shard=0, n_shards=2)
    s1 = p.batch_at(5, shard=1, n_shards=2)
    assert s0["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_data_labels_are_shifted_tokens():
    p = SyntheticLM(DataConfig(seed=0, vocab_size=50, seq_len=10,
                               global_batch=2))
    b = p.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("kw", [
    dict(seed=0, vocab_size=32_000, seq_len=4097, global_batch=2),
    dict(seed=7, vocab_size=256, seq_len=65, global_batch=4),
    dict(seed=1, vocab_size=100, seq_len=9, global_batch=2,
         modality="audio", d_model=16)])
def test_batch_at_bit_equal_to_the_reference(kw):
    port, ref = SyntheticLM(DataConfig(**kw)), RSyntheticLM(RDataConfig(**kw))
    for step in (0, 3, 1000):
        for shard, n in ((0, 1), (1, 2)):
            a = port.batch_at(step, shard=shard, n_shards=n)
            b = ref.batch_at(step, shard=shard, n_shards=n)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    it_a, it_b = iter(port), iter(ref)
    np.testing.assert_array_equal(next(it_a)["tokens"],
                                  next(it_b)["tokens"])


def test_to_device_on_the_cpu_keeps_the_values():
    b = SyntheticLM(DataConfig(vocab_size=50, seq_len=9,
                               global_batch=2)).batch_at(0)
    t = to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["labels"].numpy(), b["labels"])


# ---------------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": torch.ones((4,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(3, t)
    out = store.restore(t)
    for a, b in zip(tree_leaves(t, torch.is_tensor),
                    tree_leaves(out, torch.is_tensor)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_bf16_roundtrip_bit_for_bit(tmp_path):
    """bfloat16 leaves go to disk as their raw 2-byte words (NumPy has no
    bfloat16), NaN, inf, subnormals and signed zeros included."""
    words = torch.tensor([0x7FC0, 0x7F80, 0xFF80, 0x0001, 0x8000, 0x3F80,
                          0xC2F7, 0x0080], dtype=torch.int32).to(torch.int16)
    rnd = torch.randn(3, 5).to(torch.bfloat16)
    t = {"w": words.view(torch.bfloat16), "r": rnd}
    store = CheckpointStore(str(tmp_path))
    res = store.save(1, t)
    assert res.nbytes == 2 * (8 + 15)
    out = store.restore(t)
    for k in t:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16), t[k].view(torch.int16))
    with open(os.path.join(res.path, "manifest.json")) as f:
        man = json.load(f)
    assert {leaf["dtype"] for leaf in man["leaves"]} == {"bfloat16"}


def test_checkpoint_async_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save_async(1, _tree())
    store.save_async(2, _tree())
    store.wait()
    assert store.latest_step() == 2


def test_checkpoint_async_snapshot_is_not_changed_by_the_next_update(
        tmp_path):
    """``save_async`` on CPU tensors copies them before it returns: the
    writer thread is held until the next AdamW update has written the
    moments in place, and the checkpoint still holds the saved step's."""
    import threading
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 5, generator=g),
              "b": torch.randn(5, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    state = adamw.init(params)
    params, state, _ = adamw.update(cfg, grads, state, params)
    saved = {k: [t.clone() for t in (state.mu[k], state.nu[k])]
             for k in params}
    store = CheckpointStore(str(tmp_path))
    go = threading.Event()
    write = store._write

    def held_write(*a):
        go.wait(timeout=60)
        return write(*a)
    store._write = held_write
    store.save_async(1, {"mu": state.mu, "nu": state.nu})
    params, state, _ = adamw.update(cfg, grads, state, params)
    assert not torch.equal(state.mu["w"], saved["w"][0])
    go.set()
    store.wait()
    out = store.restore({"mu": state.mu, "nu": state.nu}, step=1)
    for k in params:
        assert torch.equal(out["mu"][k], saved[k][0])
        assert torch.equal(out["nu"][k], saved[k][1])


def test_checkpoint_gc_keeps_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _tree())
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_000003", "step_000004"]


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(9, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_restore_casts_to_the_template(tmp_path):
    """Restore takes the template's dtypes and device (``meta`` templates
    with an explicit ``device``), whatever the checkpoint holds."""
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(1, t)
    like = {"a": torch.empty((2, 3), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty((), dtype=torch.int64, device="meta"),
                  "d": torch.empty((4,), dtype=torch.float32,
                                   device="meta")}}
    out = store.restore(like, device="cpu")
    assert out["a"].dtype == torch.bfloat16 and out["a"].device.type == "cpu"
    assert torch.equal(out["a"], t["a"].to(torch.bfloat16))
    assert out["b"]["c"].dtype == torch.int64 and int(out["b"]["c"]) == 7
    assert torch.equal(out["b"]["d"], torch.ones(4))


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path)).restore(_tree())
