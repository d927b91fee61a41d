"""One rank of the ``tests/test_torch_parallel.py`` process groups.

    python _torch_parallel_worker.py GROUP RANK WORLD WORKDIR [DEVICE]

joins a gloo group through a file store in WORKDIR, runs the cases of
GROUP on DEVICE (``cpu`` by default) and writes each case's outputs to
``WORKDIR/<case>_rank<RANK>.npz`` (inputs the launcher wrote to
``WORKDIR/inputs.npz``).  It imports torch and ``repro_torch`` only.
"""
import json
import math
import os
import sys
import time

import numpy as np
import torch

from repro_torch import parallel as P
from repro_torch.parallel import collectives as C


def _save(workdir, case, rank, **arrays):
    np.savez(os.path.join(workdir, f"{case}_rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _np(t):
    return t.detach().float().cpu().numpy()


def _unflat(inputs, prefix):
    """``prefix/a/b`` keys of the inputs file -> a nested dict."""
    out = {}
    for k in inputs.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inputs[k]
    return out


# ------------------------------------------------------------- cases
def case_pipeline(rank, inputs, dev, workdir):
    """pipeline_apply (S 4, M 4, L 8, d 16, B 8) forward and gradient."""
    S, M = 4, 4
    mesh = P.make_mesh((S,), ("stage",), device=dev)
    W = torch.tensor(inputs["pipe_W"], device=mesh.device)
    x = torch.tensor(inputs["pipe_x"], device=mesh.device
                     ).requires_grad_(True)

    def stage_fn(w_group, h):
        for i in range(w_group.shape[0]):
            h = torch.tanh(h @ w_group[i])
        return h

    Wst = P.stack_layer_groups(W, S).clone().requires_grad_(True)
    y = P.pipeline_apply(stage_fn, Wst, x, mesh=mesh, axis="stage",
                         n_micro=M)
    (y ** 2).sum().backward()
    s = C.axis_index("stage", mesh)
    _save(workdir, "pipeline", rank, y=_np(y), grad=_np(Wst.grad[s]),
          x_grad=_np(x.grad),
          grad_other=_np(torch.cat([Wst.grad[:s], Wst.grad[s + 1:]])),
          bubble=P.bubble_fraction(S, M))


def case_compressed(rank, inputs, dev, workdir):
    """compressed_psum_leaf / compressed_allreduce over pod on (pod 2,
    data 4): rank's pod slice of g (2, 64)."""
    mesh = P.make_mesh((2, 4), ("pod", "data"), device=dev)
    g = torch.tensor(inputs["comp_g"], device=mesh.device)
    pod = C.axis_index("pod", mesh)
    from repro_torch.optim.compress import (compressed_allreduce,
                                            compressed_psum_leaf)
    out = compressed_psum_leaf(g[pod], "pod", mesh)
    tree = compressed_allreduce({"a": g[pod], "b": {"c": g[pod][:8] * 3}},
                                mesh, "pod")
    exact = C.psum(g[pod], "pod", mesh)
    _save(workdir, "compressed", rank, out=_np(out), a=_np(tree["a"]),
          c=_np(tree["b"]["c"]), exact=_np(exact))


def _moe_inputs(inputs, dev, dtype):
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    cfg = get_config(str(inputs["moe_arch"])).reduced()
    p = lm_params_from_numpy(_unflat(inputs, "moe_p"), dev)
    p = {k: (v if k == "router" else v.to(dtype)) for k, v in p.items()}
    x = torch.tensor(inputs["moe_x"], device=dev).to(dtype)
    return cfg, p, x


def case_moe(rank, inputs, dev, workdir):
    """moe_apply on (data 2, model 4): expert-TP, EP with ample capacity,
    EP at capacity_factor 1.25 (with each rank's kept rows), LM(moe_ep)."""
    import dataclasses
    from repro_torch.models import moe as MoE
    mesh = P.make_mesh((2, 4), ("data", "model"), device=dev)
    cfg, p, x = _moe_inputs(inputs, mesh.device, torch.float32)
    with P.set_mesh(mesh):
        tp, tp_aux = MoE.moe_apply(p, cfg, x)
        big = dataclasses.replace(cfg, capacity_factor=8.0)
        ep_big, _ = MoE.moe_apply(p, big, x, ep=True)
        ep, ep_aux = MoE.moe_apply(p, cfg, x, ep=True)
    # this rank's kept rows at capacity_factor 1.25
    B, S, d = x.shape
    m = mesh.shape["model"]
    n_loc = B * S // mesh.size
    cap = max(1, math.ceil(n_loc * cfg.top_k / m * cfg.capacity_factor))
    xf = x.reshape(B * S, d)
    i = C.axis_index(("data", "model"), mesh)
    e0 = C.axis_index("model", mesh) * (cfg.n_experts // m)
    pp = {"router": p["router"],
          **{w: p[w][e0:e0 + cfg.n_experts // m]
             for w in ("wi_gate", "wi_up", "wo")}}
    _, _, keep = MoE._moe_ep_shard(pp, xf[i * n_loc:(i + 1) * n_loc], cfg,
                                   mesh=mesh, model_axis="model",
                                   capacity=cap)
    _save(workdir, "moe", rank, tp=_np(tp), tp_aux=_np(tp_aux),
          ep_big=_np(ep_big), ep=_np(ep), ep_aux=_np(ep_aux),
          keep=keep.cpu().numpy(), cap=cap)


def case_moe_grad(rank, inputs, dev, workdir):
    """Gradients through moe_apply on (data 2, model 4), expert-TP and EP
    with ample capacity: the loss sum(out * R) on every rank, then the
    router's, the expert weights' and the tokens' gradients."""
    import dataclasses
    from repro_torch.models import moe as MoE
    mesh = P.make_mesh((2, 4), ("data", "model"), device=dev)
    cfg, p, x = _moe_inputs(inputs, mesh.device, torch.float32)
    R = torch.tensor(inputs["moe_cot"], device=mesh.device)
    grads = {}
    for name, c, ep in (("tp", cfg, False),
                        ("ep", dataclasses.replace(cfg, capacity_factor=8.0),
                         True)):
        pg = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
        xg = x.detach().clone().requires_grad_(True)
        with P.set_mesh(mesh):
            out, _ = MoE.moe_apply(pg, c, xg, ep=ep)
        (out * R).sum().backward()
        grads.update({f"{name}_{k}": _np(v.grad) for k, v in pg.items()})
        grads[f"{name}_x"] = _np(xg.grad)
    _save(workdir, "moe_grad", rank, **grads)


def case_lm(rank, inputs, dev, workdir):
    """LM(moe_ep=True) forward under the (data 2, model 4) mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    mesh = P.make_mesh((2, 4), ("data", "model"), device=dev)
    cfg = get_config(str(inputs["moe_arch"])).reduced()
    lm = LM(cfg, moe_ep=True)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.tensor(inputs["lm_tokens"], device=mesh.device)
    params = _to(params, mesh.device)      # float32: the sums' order
    #                                        alone tells the paths apart
    with torch.no_grad():
        plain, _ = lm.forward(params, tokens=toks)
        with P.set_mesh(mesh):
            sharded, _ = lm.forward(params, tokens=toks)
    _save(workdir, "lm", rank, plain=_np(plain), sharded=_np(sharded))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    if torch.is_tensor(tree):
        tree = tree.to(dev)
        return tree.float() if tree.is_floating_point() else tree
    return tree


def case_batch(rank, inputs, dev, workdir):
    """device_put_batch over data (pod 2, data 4: the tuple of both)."""
    from repro_torch.data.pipeline import device_put_batch
    mesh = P.make_mesh((2, 4), ("pod", "data"), device=dev)
    batch = {"tokens": inputs["batch_tokens"],
             "scale": np.float32(3.5)}
    one = device_put_batch(batch, mesh, "data")
    both = device_put_batch(batch, mesh, ("pod", "data"))
    _save(workdir, "batch", rank, data=_np(one["tokens"]),
          both=_np(both["tokens"]), scale=_np(one["scale"]),
          scale_shape=np.asarray(one["scale"].shape, dtype=np.int64),
          device=str(one["tokens"].device))


GROUPS = {"pipe": (case_pipeline,),
          "mesh8": (case_compressed, case_moe, case_moe_grad, case_lm,
                    case_batch)}


def main():
    group, rank, world, workdir = sys.argv[1:5]
    dev = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"), device=dev)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    times = {}
    for fn in GROUPS[group]:
        t0 = time.perf_counter()
        fn(rank, inputs, dev, workdir)
        times[fn.__name__] = time.perf_counter() - t0
    import torch.distributed as dist
    dist.barrier()
    used = {"/".join(k): v for k, v in sorted(C.USED.items())}
    print("RESULT " + json.dumps({"rank": rank, "backend": backend,
                                  "used": used, "seconds": times}),
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
