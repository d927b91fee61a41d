"""``chip_smoke.py``'s one-batch fit check (``fit_one_batch`` and its gate
``FIT_MARGIN``) on the CPU, with the reduced h2o-danube-1.8b in float32.

The fit starts from zero AdamW moments, so its losses do not depend on the
moments the run ended with; a correct update passes the gate, and a zero or
reversed one fails it.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import tree_map
from repro_torch.optim import adamw
import repro_torch.runtime.train as RTM
from repro_torch.runtime.train import TrainConfig, Trainer

from _torch_port_helpers import chip_smoke

CS = chip_smoke()
SPEC = {"lr": CS.TRAIN["lr"], "global_batch": 4, "accum": 2}


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
    assert fit["steps"] == CS.FIT_STEPS and len(fit["losses"]) == \
        CS.FIT_STEPS + 1
    assert fit["drop"] >= CS.FIT_MARGIN, fit["losses"]
    # the same weights with other moments give the same fit
    tr.params = params
    tr.opt_state = state._replace(
        mu=tree_map(lambda a: torch.full_like(a, 3.0), state.mu,
                    torch.is_tensor),
        nu=tree_map(lambda a: torch.full_like(a, 1e-6), state.nu,
                    torch.is_tensor))
    again = CS.fit_one_batch(tr, SPEC)
    assert again["losses"] == fit["losses"]


@pytest.mark.parametrize("fault", ["zero", "reversed"])
def test_fit_gate_rejects_a_zero_or_reversed_update(fault, monkeypatch):
    tr = _trained()
    step_grads = RTM.step_grads
    scale = {"zero": 0.0, "reversed": -1.0}[fault]

    def faulty(*a, **k):
        loss, parts, grads = step_grads(*a, **k)
        return loss, parts, tree_map(lambda g: g * scale, grads,
                                     torch.is_tensor)

    monkeypatch.setattr(RTM, "step_grads", faulty)
    fit = CS.fit_one_batch(tr, SPEC)
    assert not fit["drop"] >= CS.FIT_MARGIN, fit["losses"]
