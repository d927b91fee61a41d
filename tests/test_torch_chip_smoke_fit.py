"""``chip_smoke.py``'s first-step check (``fit_one_batch``: the trainer's
first AdamW step from zero moments on one microbatch must descend each
leaf's gradient and lower the NLL by half its first-order prediction at
some scale of ``ARMIJO_SCALES``) on the CPU, with the reduced
h2o-danube-1.8b in float32.

The step starts from zero AdamW moments, so it does not depend on the
moments the run ended with; a correct update passes, and a zero, a reversed
and a misdirected one (one leaf's update written into another of its shape)
fail, planted in the trainer's update as the card phase plants them in the
step it read.  The premise is held against the reference: on granite-moe
reduced, the same weights and microbatch, the port's AdamW steps from zero
moments at the phase's learning rate give the reference's NLLs (``FIT``
steps, rtol 1e-4, float32), the first step's rise included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models.layers import AttnOptions as RAttnOptions
from repro.models.transformer import LM as RLM
from repro.optim import adamw as radamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw
from repro_torch.runtime.train import TrainConfig, Trainer, step_grads

from _torch_port_helpers import chip_smoke

CS = chip_smoke()
SPEC = {"lr": CS.TRAIN["lr"], "global_batch": 4, "accum": 2}
FIT = 6        # AdamW steps of the trajectory held against the reference


@pytest.fixture(scope="module")
def trained():
    """A reduced danube in float32 after 2 training steps (the check leaves
    its weights as they are, so the tests share it)."""
    return _trained()


def _trained(steps=2):
    """A reduced danube in float32 after ``steps`` training steps."""
    torch.manual_seed(0)
    cfg = get_config("h2o-danube-1.8b").reduced()
    tc = TrainConfig(accum=SPEC["accum"], log_every=1, ckpt_every=0,
                     monitor_every=0,
                     opt=adamw.AdamWConfig(lr=SPEC["lr"], warmup_steps=1,
                                           total_steps=steps))
    tr = Trainer(cfg, ShapeConfig("tiny", 64, SPEC["global_batch"], "train"),
                 tc=tc, seed=CS.SEED, device="cpu",
                 lm_kwargs=dict(opts=AttnOptions(backend="naive")))
    tr.params = tree_map(lambda a: a.float(), tr.params, torch.is_tensor)
    tr.opt_state = adamw.init(tr.params)
    tr.run(steps)
    return tr


def _copy(tree):
    return tree_map(lambda a: a.clone(), tree, torch.is_tensor)


def test_fit_starts_from_zero_moments_and_passes_its_gate():
    tr = _trained()
    params, state = _copy(tr.params), tr.opt_state
    fit = CS.fit_one_batch(tr, SPEC)
    assert fit["ok"], fit["why"]
    assert fit["gu"] < 0 and fit["leaf_max_ratio"] <= -CS.LEAF_DESCENT
    assert any(p["ok"] for p in fit["line"])
    assert all(fit["faults_rejected"].values()), fit["faults_rejected"]
    assert set(fit["faults_rejected"]) == {"zero", "reversed", "misdirected",
                                           "reversed_gradient"}
    # the reversed gradient's step passes (a) and (b): the line rejects it
    line = fit["reversed_gradient_line"]
    assert len(line) == len(CS.ARMIJO_SCALES)
    assert all(p["drop"] < p["need"] for p in line), line
    # the weights are left as the run ended them
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tr.params, torch.is_tensor),
        tree_leaves(params, torch.is_tensor)))
    # the same weights with other moments give the same check
    tr.opt_state = state._replace(
        mu=tree_map(lambda a: torch.full_like(a, 3.0), state.mu,
                    torch.is_tensor),
        nu=tree_map(lambda a: torch.full_like(a, 1e-6), state.nu,
                    torch.is_tensor))
    again = CS.fit_one_batch(tr, SPEC)
    assert again["line"] == fit["line"] and again["gu"] == fit["gu"]


def _faulty_update(fault):
    """``adamw.update`` whose new parameters move by a wrong step: none,
    the step reversed, or one leaf's step written into the first other
    leaf of its shape."""
    update = adamw.update

    def faulty(cfg, grads, state, params):
        new, st, m = update(cfg, grads, state, params)
        old = tree_leaves(params, torch.is_tensor)
        got = tree_leaves(new, torch.is_tensor)
        steps = [n - p for n, p in zip(got, old)]
        if fault == "zero":
            steps = [torch.zeros_like(d) for d in steps]
        elif fault == "reversed":
            steps = [-d for d in steps]
        else:
            i, j = next((i, j) for i in range(len(steps))
                        for j in range(i + 1, len(steps))
                        if steps[i].shape == steps[j].shape)
            steps[j] = steps[i]
        return tree_unflatten(new, [p + d for p, d in zip(old, steps)]), \
            st, m
    return faulty


@pytest.mark.parametrize("fault", ["zero", "reversed", "misdirected"])
def test_fit_gate_rejects_a_zero_or_reversed_update(fault, monkeypatch,
                                                   trained):
    tr = trained
    monkeypatch.setattr(adamw, "update", _faulty_update(fault))
    fit = CS.fit_one_batch(tr, SPEC)
    assert not fit["ok"], fit


def test_fit_gate_rejects_a_reversed_gradient(monkeypatch, trained):
    """A gradient of the wrong sign gives a step that descends it, leaf by
    leaf, but raises the loss: the line rejects it."""
    import repro_torch.runtime.train as RTM
    tr = trained
    good = RTM.step_grads

    def reversed_grads(*a, **k):
        loss, parts, grads = good(*a, **k)
        return loss, parts, [-g for g in grads]

    monkeypatch.setattr(RTM, "step_grads", reversed_grads)
    fit = CS.fit_one_batch(tr, SPEC)
    assert fit["leaf_max_ratio"] <= -CS.LEAF_DESCENT and fit["gu"] < 0
    assert not fit["ok"] and not any(p["ok"] for p in fit["line"]), fit


def test_fit_trajectory_matches_the_reference_adamw():
    """The study's CPU half: granite-moe reduced in float32, the
    reference's initial weights carried, ``FIT`` AdamW steps from zero
    moments at the phase's learning rate (constant) on one microbatch,
    through the port and through ``repro.optim.adamw``: each NLL before a
    step and after the last within rtol 1e-4.  Whatever the first step does
    (at full width it raises the NLL by ~0.6 nats) the reference's does."""
    arch = "granite-moe-1b-a400m"
    rcfg = ref_get_config(arch).reduced()
    rlm = RLM(rcfg, opts=RAttnOptions(backend="naive"), remat=False)
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32),
        rlm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (2, 32)),
             "labels": rng.integers(0, rcfg.vocab_size, (2, 32))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}

    ropt = radamw.AdamWConfig(lr=SPEC["lr"], warmup_steps=0,
                              schedule="constant")
    rp = jax.tree_util.tree_map(jnp.asarray, init)
    rs = radamw.init(rp)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.grad(lambda p: rlm.loss_fn(p, rb)[0]))
    nll = jax.jit(lambda p: rlm.loss_fn(p, rb)[1]["nll"])
    want = []
    for _ in range(FIT):
        want.append(float(nll(rp)))
        rp, rs, _ = radamw.update(ropt, grad(rp), rs, rp)
    want.append(float(nll(rp)))

    lm = LM(get_config(arch).reduced(), opts=AttnOptions(backend="naive"),
            remat=False)
    opt = adamw.AdamWConfig(lr=SPEC["lr"], warmup_steps=0,
                            schedule="constant")
    p = lm_params_from_numpy(init, "cpu")
    s = adamw.init(p)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(FIT):
        _, parts, grads = step_grads(lm, p, tb)
        got.append(float(parts["nll"]))
        p, s, _ = adamw.update(opt, grads, s, p)
    with torch.no_grad():
        got.append(float(lm.loss_fn(p, tb)[1]["nll"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
