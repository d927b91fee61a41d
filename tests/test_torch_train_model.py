"""The port's training entry points ``LM.forward`` / ``LM.loss_fn`` against
the reference's, with gradients, on the CPU, for all five families:
danube (dense, sliding window), granite-moe (moe), deepseek-v2-lite (MLA +
MoE with a dense prelude layer and a shared expert), mamba2 (ssm) and
zamba2 (hybrid: the shared tile before every second block).

The reduced configs; float32 parameters drawn with NumPy from a seed by
the reference's specs (normal x scale, "small" over the fan-in, zeros,
ones) and carried across (``convert.lm_params_from_numpy``); one batch of
the reference's synthetic stream.  The loss and the aux loss within rtol
1e-5; every gradient leaf within 1e-4 of its largest |value|.  The port
runs attention ``naive`` and ``fused`` (on CPU tensors the kernels' plain
versions, through the ``kernels.ops`` Functions), the reference ``naive``.
In the port, ``remat`` on and off give the same bits.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as RL
import repro.models.params as ref_params
import repro.models.transformer as RT
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
import repro_torch.configs as port_configs
import repro_torch.models.layers as PL
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.params import tree_leaves

ARCHS = ("h2o-danube-1.8b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "mamba2-370m", "zamba2-7b")
SEQ, BATCH = 32, 2
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def numpy_params(lm, seed=3):
    """float32 parameters of the reference's spec tree, drawn with NumPy."""
    rng = np.random.default_rng(seed)

    def one(s):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        scale = s.scale
        if s.init == "small":
            scale /= max(1, int(np.sqrt(np.prod(s.shape[:-1]) or 1)))
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map(one, lm.param_specs(),
                                  is_leaf=ref_params.is_spec)


def batch_of(cfg):
    data = RSyntheticLM(RDataConfig(seed=5, vocab_size=cfg.vocab_size,
                                    seq_len=SEQ + 1, global_batch=BATCH))
    return data.batch_at(0)


@pytest.fixture(scope="module")
def reference():
    """Per arch: the float32 parameters (NumPy), the batch, the reference's
    loss, nll, aux, gradient leaves, and its forward's logits and aux."""
    out = {}
    for arch in ARCHS:
        cfg = ref_configs.get_config(arch).reduced()
        lm = RT.LM(cfg, opts=RL.AttnOptions(backend="naive"), remat=True)
        params = numpy_params(lm)
        batch = batch_of(cfg)
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            lm.loss_fn, has_aux=True))(params, batch)
        logits, aux = jax.jit(lambda p, t: lm.forward(p, tokens=t))(
            params, batch["tokens"])
        out[arch] = dict(
            params=params, batch=batch,
            loss=float(loss), nll=float(parts["nll"]),
            aux=float(parts["aux"]),
            grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            logits=np.asarray(logits), forward_aux=float(aux))
    return out


def port_lm(arch, backend="naive", **kw):
    cfg = port_configs.get_config(arch).reduced()
    return PT.LM(cfg, opts=PL.AttnOptions(backend=backend),
                 ssm_backend="fused" if backend == "fused" else "torch", **kw)


def port_loss_and_grads(lm, params_np, batch):
    params = lm_params_from_numpy(params_np, "cpu")
    leaves = tree_leaves(params, torch.is_tensor)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, parts = lm.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    return loss, parts, grads


@pytest.mark.parametrize("backend", ["naive", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(reference, arch, backend):
    r = reference[arch]
    loss, parts, grads = port_loss_and_grads(port_lm(arch, backend),
                                             r["params"], r["batch"])
    np.testing.assert_allclose(float(loss.detach()), r["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["nll"]), r["nll"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), r["aux"],
                               rtol=LOSS_RTOL, atol=1e-12)
    if port_configs.get_config(arch).family == "moe":
        assert r["aux"] > 0
    assert len(grads) == len(r["grads"])
    for g, gr in zip(grads, r["grads"]):
        assert tuple(g.shape) == gr.shape
        top = float(np.abs(gr).max())
        np.testing.assert_allclose(g.numpy(), gr, rtol=0,
                                   atol=GRAD_RTOL * max(top, 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(reference, arch):
    """``forward``'s float32 logits and the aux loss, on their own."""
    r = reference[arch]
    cfg = ref_configs.get_config(arch).reduced()
    plm = port_lm(arch)
    with torch.no_grad():
        logits, aux = plm.forward(lm_params_from_numpy(r["params"], "cpu"),
                                  torch.from_numpy(r["batch"]["tokens"]))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), r["logits"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), r["forward_aux"], rtol=LOSS_RTOL,
                               atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_bits(reference, arch):
    r = reference[arch]
    a = port_loss_and_grads(port_lm(arch, remat=True), r["params"],
                            r["batch"])
    b = port_loss_and_grads(port_lm(arch, remat=False), r["params"],
                            r["batch"])
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_embeds_in_place_of_tokens(reference):
    """``forward(embeds=...)`` takes the embeddings as they are (the
    reference's stub frontend): the token lookup's rows give the token
    path's logits."""
    arch = "h2o-danube-1.8b"
    r = reference[arch]
    lm = port_lm(arch)
    params = lm_params_from_numpy(r["params"], "cpu")
    toks = torch.from_numpy(r["batch"]["tokens"])
    with torch.no_grad():
        a, _ = lm.forward(params, tokens=toks)
        b, _ = lm.forward(params, embeds=params["embed"][toks.long()])
    assert torch.equal(a, b)


@pytest.mark.parametrize("knob", [dict(moe_ep=True), dict(moe_axes=("x",)),
                                  dict(block_pspecs={}),
                                  dict(onehot_loss=True)])
def test_sharding_knobs_name_their_roadmap_item(knob):
    """Every sharding knob is ported: the MoE knobs (item 12b) and the
    GSPMD ones (item 12c) leave the single-device forward and loss as they
    are without placed parameters (``tests/test_torch_parallel.py`` and
    ``tests/test_torch_distributed.py`` run them on a mesh); the
    iota-compare loss equals the gather's."""
    lm, plain = (port_lm("granite-moe-1b-a400m", **kw) for kw in (knob, {}))
    params = plain.init(torch.Generator().manual_seed(0))
    toks = torch.arange(8).reshape(1, 8)
    batch = {"tokens": toks, "labels": (toks + 1) % 7}
    with torch.no_grad():
        assert torch.equal(lm.forward(params, tokens=toks)[0],
                           plain.forward(params, tokens=toks)[0])
        got, want = lm.loss_fn(params, batch)[0], plain.loss_fn(params,
                                                                batch)[0]
    assert torch.allclose(got, want, rtol=1e-6, atol=0)


def test_layer_params_unbound_once_per_forward(reference, monkeypatch):
    """The stacked leaves are ``unbind``-ed once per forward (their
    backward is one ``stack``), not indexed layer by layer."""
    r = reference["h2o-danube-1.8b"]
    calls = []
    orig = torch.Tensor.unbind

    def counting(self, dim=0):
        calls.append(tuple(self.shape))
        return orig(self, dim)
    monkeypatch.setattr(torch.Tensor, "unbind", counting)
    port_loss_and_grads(port_lm("h2o-danube-1.8b"), r["params"], r["batch"])
    n_stacked = len(tree_leaves(r["params"]["blocks"], lambda x: isinstance(
        x, np.ndarray)))
    assert len(calls) == n_stacked
