"""Port vs reference: the explicit-collective bodies of the LLM stack on
``torch.distributed`` (``repro_torch.parallel``, ``optim/compress.py``,
``models/moe.py`` under a mesh, ``LM(moe_ep=)``, ``device_put_batch``).

Ranks run as subprocesses on the CPU in a gloo group joined through a file
store (``_torch_parallel_worker.py``); each launch has a hard limit and
kills every rank when it runs out.  Two groups run all the cases: four
ranks on a ``(stage 4)`` mesh and eight on ``(pod 2, data 4)`` /
``(data 2, model 4)`` meshes.  The inputs come from the reference where it
can run: its parameter init and its ``_moe_ffn_local``; its own
multi-device tests fail under jax 0.9.0 (ROADMAP queue C), so the port is
held to their intended behaviour.  Tolerances:

* ``pipeline_apply`` (S 4, M 4, L 8, d 16, B 8) against the sequential
  composition (the reference's, on one device): forward 1e-5, gradient
  1e-4 (the reference's own test), each stage's gradient in its slice only,
  the input's gradient whole on every stage (1e-4);
* ``compressed_psum_leaf`` / ``compressed_allreduce`` over ``pod``: within
  1e-6 of the sum of the reference's own ``quantize_int8`` /
  ``dequantize_int8`` of each leaf, within 0.02 relative of the exact sum;
* ``moe_apply`` on ``(data 2, model 4)``, granite-moe reduced, weights from
  the reference's ``init_params``: within 2e-4 of the reference's
  ``_moe_ffn_local``, ``aux`` within 15 % (the reference's test); with
  ``ep=True`` and ample capacity within 2e-4 of it too; at
  ``capacity_factor`` 1.25 the dropped ``(token, slot)`` set exactly that of
  a plain single-process GShard emulation, the output within 2e-4 of it;
* the gradients of the router, the expert weights and the tokens through
  ``moe_apply`` on that mesh (expert-TP, and EP with ample capacity) on
  every rank: within 2e-5 of max |g| of ``jax.grad`` of the reference's
  ``_moe_ffn_local``;
* ``LM(moe_ep=True)`` under the mesh: the unsharded forward within 2e-4;
* ``device_put_batch``: each rank's slice exact.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import moe as RM
from repro.models import params as ref_params
from repro.optim.compress import dequantize_int8, quantize_int8

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LIMIT_S = 120
ARCH = "granite-moe-1b-a400m"


def launch(group: str, world: int, workdir: str, inputs: dict) -> list:
    """Run ``world`` ranks of ``group``; every rank's RESULT record."""
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]), OMP_NUM_THREADS="1",
        CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
         group, str(r), str(world), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {group} group did not finish in {LIMIT_S} s")
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad
    return [json.loads(next(line[7:] for line in out.splitlines()
                            if line.startswith("RESULT ")))
            for out, _ in outs]


def _load(workdir, case, rank):
    return np.load(os.path.join(workdir, f"{case}_rank{rank}.npz"))


# ------------------------------------------------------------ the groups
@pytest.fixture(scope="module")
def pipe_group(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    W = np.asarray(jax.random.normal(key, (8, 16, 16)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (8, 16)))
    wd = str(tmp_path_factory.mktemp("pipe"))
    recs = launch("pipe", 4, wd, {"pipe_W": W, "pipe_x": x})
    return wd, recs, W, x


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def mesh8_group(tmp_path_factory):
    rcfg = ref_get_config(ARCH).reduced()
    p = ref_params.init_params(RM.moe_spec(rcfg), jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 16, rcfg.d_model)))
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 64)))
    rng = np.random.default_rng(3)
    cot = np.asarray(jax.random.normal(jax.random.PRNGKey(2), x.shape))
    inputs = {"moe_arch": np.asarray(ARCH), "moe_x": x, "comp_g": g,
              "moe_cot": cot,
              "lm_tokens": rng.integers(0, rcfg.vocab_size, (4, 8)),
              "batch_tokens": rng.integers(0, 100, (16, 5)),
              **_flat(p, "moe_p")}
    wd = str(tmp_path_factory.mktemp("mesh8"))
    recs = launch("mesh8", 8, wd, inputs)
    return wd, recs, rcfg, p, x, g, inputs


# ------------------------------------------------------------- the cases
def test_every_rank_ran_gloo_on_cpu_tensors(pipe_group, mesh8_group):
    for _, recs, *_ in (pipe_group, mesh8_group):
        for r in recs:
            assert r["backend"] == "gloo"
            assert r["used"] and all(k.endswith("/gloo/cpu")
                                     for k in r["used"]), r["used"]


def test_pipeline_matches_sequential_and_grads(pipe_group):
    wd, _, W, x = pipe_group

    def seq(W, x):
        for i in range(W.shape[0]):
            x = jnp.tanh(x @ W[i])
        return x

    y_seq = np.asarray(seq(jnp.asarray(W), jnp.asarray(x)))
    g_seq = np.asarray(jax.grad(lambda W: jnp.sum(seq(W, x) ** 2))(
        jnp.asarray(W))).reshape(4, 2, 16, 16)
    gx_seq = np.asarray(jax.grad(lambda x: jnp.sum(seq(W, x) ** 2))(
        jnp.asarray(x)))
    for s in range(4):
        out = _load(wd, "pipeline", s)
        assert float(np.max(np.abs(out["y"] - y_seq))) < 1e-5
        assert float(np.max(np.abs(out["grad"] - g_seq[s]))) < 1e-4, s
        assert not np.any(out["grad_other"])      # only its own stage
        # x, held alike by every stage: its whole gradient on each
        assert float(np.max(np.abs(out["x_grad"] - gx_seq))) < 1e-4, s
        assert float(out["bubble"]) == 3 / 7      # (S-1)/(M+S-1)


def test_compressed_psum_leaf_over_pod(mesh8_group):
    wd, _, _, _, _, g, _ = mesh8_group
    deq = [np.asarray(dequantize_int8(*quantize_int8(jnp.asarray(g[i]))))
           for i in range(2)]
    want = deq[0] + deq[1]
    exact = g.sum(0)
    for r in range(8):
        out = _load(wd, "compressed", r)
        np.testing.assert_allclose(out["out"], want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["a"], out["out"])
        np.testing.assert_allclose(out["exact"], exact, rtol=1e-6)
        rel = np.linalg.norm(out["out"] - exact) / np.linalg.norm(exact)
        assert rel < 0.02, rel
        c = [np.asarray(dequantize_int8(*quantize_int8(
            jnp.asarray(g[i][:8] * 3)))) for i in range(2)]
        np.testing.assert_allclose(out["c"], c[0] + c[1], atol=1e-6)


def _ref_local(rcfg, p, x):
    routed = {k: v for k, v in p.items() if k != "shared"}
    out, aux = RM._moe_ffn_local(routed, jnp.asarray(x).reshape(
        -1, rcfg.d_model), rcfg)
    return np.asarray(out).reshape(x.shape), float(aux)


def test_moe_shard_map_path_matches_local(mesh8_group):
    wd, _, rcfg, p, x, _, _ = mesh8_group
    ref, aux_l = _ref_local(rcfg, p, x)
    for r in range(8):
        out = _load(wd, "moe", r)
        assert float(np.max(np.abs(out["tp"] - ref))) < 2e-4, r
        assert abs(float(out["tp_aux"]) - aux_l) < 0.15 * abs(aux_l)


def test_moe_expert_parallel_with_ample_capacity_matches_local(mesh8_group):
    wd, _, rcfg, p, x, _, _ = mesh8_group
    ref, aux_l = _ref_local(rcfg, p, x)
    for r in range(8):
        out = _load(wd, "moe", r)
        assert float(np.max(np.abs(out["ep_big"] - ref))) < 2e-4, r
        assert abs(float(out["ep_aux"]) - aux_l) < 0.15 * abs(aux_l)


def _gshard_emulation(rcfg, p, x, m=4, n_shards=8):
    """A plain single-process GShard: each token shard routes its own
    tokens, fills each destination's ``C`` slots first come first served in
    flat (token, slot) order, and sums its kept rows' expert outputs."""
    d, E, k = rcfg.d_model, rcfg.n_experts, rcfg.top_k
    xf = np.asarray(x, np.float64).reshape(-1, d)
    n_loc = xf.shape[0] // n_shards
    cap = max(1, math.ceil(n_loc * k / m * rcfg.capacity_factor))
    e_loc = E // m
    pn = {kk: np.asarray(v, np.float64) for kk, v in p.items()
          if kk != "shared"}

    def silu(a):
        return a / (1.0 + np.exp(-a))

    out, keeps = np.zeros_like(xf), []
    for sh in range(n_shards):
        xs = xf[sh * n_loc:(sh + 1) * n_loc]
        logits = np.asarray(jnp.asarray(xs, jnp.float32)
                            @ jnp.asarray(pn["router"], jnp.float32))
        top_logits, top_ids = jax.lax.top_k(jnp.asarray(logits), k)
        gates = np.asarray(jax.nn.softmax(top_logits, axis=-1))
        top_ids = np.asarray(top_ids)
        used = np.zeros(m, dtype=np.int64)
        keep = np.zeros(n_loc * k, dtype=bool)
        for row, e in enumerate(top_ids.reshape(-1)):
            dest = e // e_loc
            keep[row] = used[dest] < cap
            used[dest] += 1
            if keep[row]:
                t = row // k
                h = silu(xs[t] @ pn["wi_gate"][e]) * (xs[t] @ pn["wi_up"][e])
                out[sh * n_loc + t] += gates.reshape(-1)[row] * (
                    h @ pn["wo"][e])
        keeps.append(keep)
    return out.reshape(np.shape(x)), keeps, cap


@pytest.mark.parametrize("path", ["tp", "ep"])
def test_moe_gradients_under_a_mesh_match_the_local_layer(mesh8_group, path):
    """Every rank's gradients of the router, the expert weights and the
    tokens through expert-TP / EP (ample capacity) equal ``jax.grad`` of
    the reference's local layer under the loss sum(out * R): the ranks'
    partial gradients are summed (``replicated``), not one rank's share."""
    wd, _, rcfg, p, x, _, inputs = mesh8_group
    routed = {k: jnp.asarray(v) for k, v in p.items() if k != "shared"}
    cot = jnp.asarray(inputs["moe_cot"])

    def loss(routed, x):
        out, _ = RM._moe_ffn_local(routed, x.reshape(-1, rcfg.d_model), rcfg)
        return jnp.sum(out.reshape(x.shape) * cot)

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(routed, jnp.asarray(x))
    want = {**{k: np.asarray(v) for k, v in g_p.items()},
            "x": np.asarray(g_x)}
    for r in range(8):
        out = _load(wd, "moe_grad", r)
        for k, w in want.items():
            got = out[f"{path}_{k}"]
            scale = float(np.max(np.abs(w)))
            assert scale > 0, k
            err = float(np.max(np.abs(got - w))) / scale
            assert err < 2e-5, (path, r, k, err)


def test_moe_expert_parallel_drops_exactly_gshard(mesh8_group):
    wd, _, rcfg, p, x, _, _ = mesh8_group
    want, keeps, cap = _gshard_emulation(rcfg, p, x)
    n_dropped = 0
    for r in range(8):
        out = _load(wd, "moe", r)
        assert int(out["cap"]) == cap
        np.testing.assert_array_equal(out["keep"], keeps[r])
        n_dropped += int((~keeps[r]).sum())
        assert float(np.max(np.abs(out["ep"] - want))) < 2e-4, r
    assert n_dropped > 0                 # capacity 1.25 does drop rows


def test_lm_moe_ep_forward_under_a_mesh_equals_unsharded(mesh8_group):
    wd = mesh8_group[0]
    for r in range(8):
        out = _load(wd, "lm", r)
        assert np.all(np.isfinite(out["sharded"]))
        assert float(np.max(np.abs(out["sharded"] - out["plain"]))) < 2e-4


def test_device_put_batch_slices(mesh8_group):
    wd, *_, inputs = mesh8_group
    toks = inputs["batch_tokens"]
    for r in range(8):
        pod, data = divmod(r, 4)
        out = _load(wd, "batch", r)
        np.testing.assert_array_equal(out["data"], toks[data * 4:
                                                        (data + 1) * 4])
        np.testing.assert_array_equal(out["both"], toks[r * 2:(r + 1) * 2])
        assert out["scale"].shape == () and float(out["scale"]) == 3.5
        assert out["scale_shape"].size == 0           # rank 0 stays rank 0
        assert str(out["device"]) == "cpu"
