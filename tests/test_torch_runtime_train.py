"""The port's training runtime (``runtime.train.Trainer``, the trainer half
of ``runtime.fault``, ``launch.train``) on the CPU: the reference's
``tests/test_runtime.py`` trainer cases and ``tests/test_system.py``'s
full Vespa loop against the port, and the port against the reference.

* 3 steps of the port's ``Trainer`` against the reference's on
  granite-moe (reduced), float32 parameters and moments carried across:
  loss, nll, aux, grad_norm and lr within rtol 1e-4 (``accum`` 1, and 2 on
  danube).
* ``accum=2`` against ``accum=1`` on the same batch within rtol 1e-5: the
  microbatches' gradients are summed in float32 buffers.
* A resumed run equal bit for bit to the uninterrupted one (CPU).
* No host read inside a step: the metrics and counters stay tensors until
  ``run`` logs them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.models.layers import AttnOptions as RAttnOptions
from repro.optim import adamw as radamw
from repro.runtime.train import TrainConfig as RTrainConfig
from repro.runtime.train import Trainer as RTrainer
import repro_torch.core as C
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.core.dfs import TileTelemetry
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultSupervisor
from repro_torch.runtime.serve import Request, ServeEngine
from repro_torch.runtime.train import TrainConfig, Trainer

SHAPE = ShapeConfig("tiny", 64, 4, "train")
LM_KW = dict(opts=AttnOptions(backend="naive"), remat=True)
KEYS = ("loss", "nll", "aux", "grad_norm", "lr")


def _trainer(tmp, arch="granite-moe-1b-a400m", **kw):
    cfg = get_config(arch).reduced()
    tc = TrainConfig(log_every=1, ckpt_every=kw.pop("ckpt_every", 0),
                     ckpt_dir=str(tmp), monitor_every=2,
                     accum=kw.pop("accum", 1),
                     opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=100))
    return Trainer(cfg, kw.pop("shape", SHAPE), tc=tc,
                   lm_kwargs=kw.pop("lm_kwargs", LM_KW), device="cpu", **kw)


def _f32(tr):
    tr.params = tree_map(lambda a: a.float(), tr.params, torch.is_tensor)
    tr.opt_state = adamw.init(tr.params)
    return tr


# ------------------------------------------- the reference's trainer cases
def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, arch="h2o-danube-1.8b")
    hist = tr.run(30)
    first = np.mean([m["loss"] for _, m in hist[:5]])
    last = np.mean([m["loss"] for _, m in hist[-5:]])
    assert last < first - 0.05, (first, last)


def test_checkpoint_resume_bitwise(tmp_path):
    tr = _trainer(tmp_path, ckpt_every=5)
    hist = tr.run(10)                          # saves at 5 and 10
    tr.store().wait()
    loss10 = [m["loss"] for s, m in hist if s == 10][0]

    tr2 = _trainer(tmp_path)
    tr2.restore(step=5)
    assert tr2.step == 5
    h2 = tr2.run(5)
    loss10b = [m["loss"] for s, m in h2 if s == 10][0]
    assert loss10 == loss10b                   # bitwise deterministic resume


def test_monitor_counters_progress(tmp_path):
    tr = _trainer(tmp_path)
    tr.run(4)
    s = tr.monitor.read(tr.counters, tr.step)
    assert s.counters["mem"]["pkts_in"] > 0
    assert s.counters["io"]["exec_time"] > 0


def test_dfs_commit_between_steps(tmp_path):
    tr = _trainer(tmp_path)
    tr.actuator.reconfigure({"noc_mem": 0.5})
    tr.run(1)                                  # commit happens between steps
    assert tr.islands.rate_of("noc") == 0.5
    assert tr.actuator.swaps == 1


def test_fault_supervisor_recovers_from_nan(tmp_path):
    tr = _trainer(tmp_path, ckpt_every=2)
    sup = FaultSupervisor(tr)
    tr.run(4)
    tr.store().wait()
    # inject a poisoned parameter tree (simulated chip corruption)
    tr.params = tree_map(lambda a: a * float("nan")
                         if a.dtype == torch.bfloat16 else a, tr.params,
                         torch.is_tensor)
    kind = sup.check_metrics(5, {"loss": float("nan")})
    assert kind == "nan"
    resumed = sup.recover()
    assert resumed == 4                        # back to the last checkpoint
    h = tr.run(1)
    assert np.isfinite(h[-1][1]["loss"])


def test_straggler_mitigation_derates(tmp_path):
    tr = _trainer(tmp_path)
    sup = FaultSupervisor(tr)
    tel = {t.name: TileTelemetry(1.0, 0, 0, 0, 0.5) for t in tr.plan.tiles}
    tel["attn"] = TileTelemetry(10.0, 0, 0, 0, 0.5)
    rates = sup.check_stragglers(tel, tr.islands, tr.actuator)
    assert rates is not None and rates["attn"] == 1.0
    assert tr.actuator.swaps == 1              # hitless commit happened
    assert any(e.kind == "straggler" for e in sup.events)


def test_supervised_run_restarts_on_a_nan_loss(tmp_path):
    """``run_supervised`` restarts from the latest checkpoint when a logged
    loss is NaN, and goes on."""
    tr = _trainer(tmp_path, ckpt_every=2)
    sup = FaultSupervisor(tr)
    tr.run(2)
    tr.store().wait()
    tr.params = tree_map(lambda a: a * float("nan"), tr.params,
                         torch.is_tensor)
    hist = sup.run_supervised(3)
    assert [e.kind for e in sup.events] == ["nan", "restart"]
    assert sup.restarts == 1 and np.isfinite(hist[-1][1]["loss"])


# ------------------------------------------------ the port vs the reference
def _ref_trainer(tmp, arch, accum):
    tc = RTrainConfig(log_every=1, ckpt_dir=str(tmp), monitor_every=2,
                      accum=accum,
                      opt=radamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=100))
    tr = RTrainer(ref_get_config(arch).reduced(),
                  RShapeConfig("tiny", 64, 4, "train"), tc=tc,
                  lm_kwargs=dict(opts=RAttnOptions(backend="naive"),
                                 remat=True))
    tr.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                       tr.params)
    tr.opt_state = radamw.init(tr.params)
    return tr


@pytest.mark.parametrize("arch,accum", [("granite-moe-1b-a400m", 1),
                                        ("h2o-danube-1.8b", 2)])
def test_trainer_matches_the_reference_for_3_steps(tmp_path, arch, accum):
    ref = _ref_trainer(tmp_path / "r", arch, accum)
    port = _trainer(tmp_path / "p", arch=arch, accum=accum)
    port.params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), "cpu")
    port.opt_state = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, tuple(ref.opt_state)), "cpu")
    hr, hp = ref.run(3), port.run(3)
    assert [s for s, _ in hr] == [s for s, _ in hp] == [1, 2, 3]
    for (_, a), (_, b) in zip(hr, hp):
        for k in KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-12,
                                       err_msg=k)


def test_accum_2_equals_accum_1(tmp_path):
    """Two microbatches of 2 against one batch of 4 (a dense model, whose
    loss is a mean over tokens): the metrics of 2 steps (step 2's loss
    is taken at step 1's update)."""
    one = _f32(_trainer(tmp_path / "a", arch="h2o-danube-1.8b"))
    two = _f32(_trainer(tmp_path / "b", arch="h2o-danube-1.8b", accum=2))
    two.params = tree_map(lambda a: a.clone(), one.params, torch.is_tensor)
    h1, h2 = one.run(2), two.run(2)
    for (_, a), (_, b) in zip(h1, h2):
        for k in KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-12,
                                       err_msg=k)


def test_accumulation_buffers_are_float32(tmp_path, monkeypatch):
    """With bf16 parameters and ``accum`` 2 the optimizer gets float32
    gradients (summed in float32, then halved)."""
    seen = []
    orig = adamw.update

    def spy(cfg, grads, state, params):
        seen.extend(g.dtype for g in grads)
        return orig(cfg, grads, state, params)
    import repro_torch.runtime.train as RTM
    monkeypatch.setattr(RTM.adamw, "update", spy)
    tr = _trainer(tmp_path, arch="h2o-danube-1.8b", accum=2)
    tr.run(1)
    assert seen and set(seen) == {torch.float32}
    assert {p.dtype for p in tree_leaves(tr.params, torch.is_tensor)} >= {
        torch.bfloat16}


def test_resume_after_state_loss_is_bitwise(tmp_path):
    """The chip phase ``train_resume`` on the CPU: 10 steps uninterrupted
    against 8 steps saving every 5, the state lost, ``recover()`` and 5
    more; steps 6-10 equal bit for bit (float32 parameters)."""
    ref = {s: m["loss"] for s, m in
           _f32(_trainer(tmp_path / "a", arch="h2o-danube-1.8b")).run(10)}
    tr = _f32(_trainer(tmp_path / "b", arch="h2o-danube-1.8b",
                       ckpt_every=5))
    sup = FaultSupervisor(tr)
    tr.run(8)
    tr.store().wait()
    tr.params = None
    tr.opt_state = None
    assert sup.recover() == 5
    assert all(p.dtype == torch.float32
               for p in tree_leaves(tr.params, torch.is_tensor))
    got = {s: m["loss"] for s, m in tr.run(5)}
    assert sorted(got) == [6, 7, 8, 9, 10]
    assert all(got[s] == ref[s] for s in got)


def test_step_reads_nothing_to_the_host(tmp_path, monkeypatch):
    """Inside ``_step`` no tensor is turned into a Python number (the
    metrics come back as tensors and ``run`` reads them at ``log_every``)."""
    tr = _trainer(tmp_path)
    reads = []
    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    batch = tr.place_batch(tr.data.batch_at(0))
    params, opt, counters, m = tr._step(tr.params, tr.opt_state, batch,
                                        tr.counters)
    monkeypatch.undo()
    # the loop experts read their group ends (one tolist a layer and
    # microbatch, forward and the remat recompute); nothing else does
    n_moe = tr.cfg.n_layers - tr.cfg.n_dense_layers
    assert reads == ["tolist"] * (2 * n_moe)
    assert all(torch.is_tensor(v) for v in m.values())
    assert sorted(m) == sorted(KEYS)


def test_counters_charged_on_the_device(tmp_path):
    tr = _trainer(tmp_path)
    tr.run(2)
    for tile, row in tr.counters.items():
        for v in row.values():
            assert v.device.type == "cpu" and v.dtype == torch.float32
    toks = SHAPE.global_batch * SHAPE.seq_len
    assert float(tr.counters["io"]["exec_time"]) == toks
    cfg = tr.cfg
    want = 2 * cfg.n_params() * (2 + 4 + 4) * 2 / 2 / 512
    np.testing.assert_allclose(float(tr.counters["mem"]["pkts_in"]), want,
                               rtol=1e-6)


def test_mesh_waits_for_item_12(tmp_path):
    """``Trainer(mesh=)`` is ported (item 12c): it takes a ``ProcessMesh``
    (``tests/test_torch_distributed.py`` trains on one); anything else is
    refused by name."""
    with pytest.raises(TypeError, match="ProcessMesh"):
        _trainer(tmp_path, mesh="host")


def test_grad_reduce_dtype_waits_for_item_12(tmp_path, monkeypatch):
    """``grad_reduce_dtype="bf16"`` is ported (item 12c): the gradients are
    cast before the (here absent) cross-device reduce, on one device too,
    as the reference's; other values are refused."""
    assert TrainConfig().grad_reduce_dtype == ""
    with pytest.raises(ValueError, match="bf16"):
        TrainConfig(grad_reduce_dtype="fp8")
    seen = []
    orig = adamw.update

    def spy(cfg, grads, state, params):
        seen.extend(g.dtype for g in grads)
        return orig(cfg, grads, state, params)
    import repro_torch.runtime.train as RTM
    monkeypatch.setattr(RTM.adamw, "update", spy)
    tr = _f32(_trainer(tmp_path, arch="h2o-danube-1.8b"))
    tr.tc = TrainConfig(grad_reduce_dtype="bf16", opt=tr.tc.opt)
    tr._step = RTM.make_train_step(tr.lm, tr.plan, None, tr.tc)
    tr.run(1)
    assert seen and set(seen) == {torch.bfloat16}


def test_serving_a_trainers_parameters(tmp_path):
    """``ServeEngine`` given a trainer's parameters serves them (its steps
    run under ``torch.inference_mode()``) and leaves them as they were."""
    tr = _trainer(tmp_path, arch="h2o-danube-1.8b")
    tr.run(2)
    eng = ServeEngine(tr.cfg, batch_slots=2, window=32,
                      lm_kwargs=dict(opts=AttnOptions(backend="fused")),
                      device="cpu")
    eng.params = tr.params
    before = [p.clone() for p in tree_leaves(tr.params, torch.is_tensor)]
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(rid=i, max_new=4, prompt=rng.integers(
            0, tr.cfg.vocab_size, size=6).astype(np.int32)))
    eng.run(20)
    assert len(eng.done) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves(tr.params, torch.is_tensor)))
    tr.run(1)                                  # and training goes on
    assert tr.step == 3


# ---------------------------------------------------- the full Vespa loop
def test_full_vespa_loop(tmp_path):
    """Train with monitoring, apply a DFS policy from telemetry, checkpoint,
    crash, recover, keep training — loss history stays consistent."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    shape = ShapeConfig("tiny", 48, 4, "train")
    tc = TrainConfig(log_every=1, ckpt_every=3, ckpt_dir=str(tmp_path),
                     monitor_every=1,
                     opt=adamw.AdamWConfig(lr=5e-4, warmup_steps=2,
                                           total_steps=100))
    tr = Trainer(cfg, shape, tc=tc, device="cpu",
                 lm_kwargs=dict(opts=AttnOptions(backend="naive"),
                                remat=True))
    sup = FaultSupervisor(tr)

    tr.run(6)
    assert len(tr.monitor.samples) >= 6

    # C3 -> C2: derive telemetry from counters, run the Fig.4 policy, commit
    sample = tr.monitor.samples[-1]
    tel = {}
    for t in tr.plan.tiles:
        row = sample.counters.get(t.name, {})
        tel[t.name] = TileTelemetry(
            exec_time=row.get("exec_time", 1.0) or 1.0,
            pkts_in=row.get("pkts_in", 0.0), pkts_out=row.get("pkts_out", 0.0),
            rtt=row.get("rtt", 0.0), boundness=0.9)
    rates = C.policy_memory_bound(tr.islands, tel)
    tr.actuator.reconfigure(rates)
    tr.run(1)                                  # hitless commit between steps
    assert tr.actuator.swaps >= 1

    # crash + recover
    tr.store().wait()
    before = tr.step
    tr.params = None                           # simulated total state loss
    sup.recover()
    assert tr.step <= before
    h2 = tr.run(2)
    assert np.isfinite(h2[-1][1]["loss"])


# ----------------------------------------------------------- the launcher
def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    launch.main(["--device", "cpu", "--steps", "3", "--seq-len", "32",
                 "--batch", "2", "--ckpt-every", "2",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done at step 3" in out and "on cpu" in out
    launch.main(["--device", "cpu", "--steps", "4", "--seq-len", "32",
                 "--batch", "2", "--ckpt-dir", str(tmp_path), "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out


def _torchrun(argv, nproc=4, limit_s=120):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train",
         "--device", "cpu"] + argv,
        capture_output=True, text=True, env=env, timeout=limit_s)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_launch_train_under_torchrun_on_a_mesh(tmp_path):
    """``launch/train.py --mesh`` on four gloo ranks under torchrun: two
    steps on (data 2, model 2) write their checkpoint (rank 0 alone
    prints), then a resume on (model 4) restores it onto the new mesh and
    takes the third step."""
    argv = ["--seq-len", "32", "--batch", "4", "--ckpt-dir", str(tmp_path)]
    out = _torchrun(["--mesh", "data=2,model=2", "--steps", "2"] + argv)
    assert out.count("done at step 2") == 1
    assert "ProcessMesh({'data': 2, 'model': 2}" in out
    assert (tmp_path / "step_000002" / "manifest.json").exists()
    out = _torchrun(["--mesh", "model=4", "--steps", "3", "--resume"]
                    + argv)
    assert "resumed from step 2" in out and "done at step 3" in out
    assert (tmp_path / "step_000003" / "manifest.json").exists()


def test_launch_train_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
