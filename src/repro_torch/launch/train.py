"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs an end-to-end training job (reduced configs by default; ``--full``
takes the published config).  Wires the whole Vespa loop: data pipeline ->
train step -> monitor -> DFS actuator -> async checkpoints -> fault
supervisor.  The same flags as the reference's ``repro/launch/train.py``,
plus ``--device`` (default: the CUDA card, which raises without one;
``--device cpu`` runs it on the CPU).

``--mesh`` is ``none`` (one device), ``host`` (every launched rank on a 1-D
``data`` mesh) or named axes such as ``data=2,model=2``.  A mesh runs one
rank per position, under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --mesh data=2,model=2 --full --seq-len 4096 --batch 4

(``--device cpu`` runs the ranks on the CPU over gloo).  Rank ``r``'s device is
``cuda:<local rank % cards>``: every rank ``cuda:0`` when the ranks share
one card (gloo), a card a rank otherwise (NCCL;
``parallel.collectives.backend_for``).  Rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import AttnOptions
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultSupervisor
from repro_torch.runtime.train import TrainConfig, Trainer


def parse_mesh(text: str):
    """``none`` -> None; ``host`` -> "host"; ``a=2,b=4`` -> ((2, 4), ("a",
    "b"))."""
    if text in ("none", "host"):
        return None if text == "none" else "host"
    names, sizes = [], []
    for part in text.split(","):
        name, _, n = part.partition("=")
        if not name or not n.isdigit():
            raise ValueError(f"--mesh {text!r}: none, host or a=N,b=M")
        names.append(name)
        sizes.append(int(n))
    return tuple(sizes), tuple(names)


def _join(device: str):
    """Join the process group of the launched ranks; (mesh device, rank)."""
    import torch
    from repro_torch.parallel.collectives import init_process_group
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
    init_process_group(rank, world, "env://", device=dev)
    return dev, rank


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    choices=list_configs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "vespa_train_torch"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--mesh", default="none",
                    help="'none' (one device), 'host' (the launched ranks "
                         "on a data axis) or axes such as data=2,model=2")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mesh_arg = parse_mesh(args.mesh)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    tc = TrainConfig(log_every=10, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, monitor_every=10,
                     opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                           total_steps=args.steps))
    device, rank, mesh = args.device, 0, None
    if mesh_arg is not None:
        from repro_torch.launch.mesh import make_host_mesh, make_mesh
        device, rank = _join(args.device)
        mesh = make_host_mesh(device) if mesh_arg == "host" else \
            make_mesh(*mesh_arg, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    tr = Trainer(cfg, shape, mesh=mesh, tc=tc, device=device,
                 lm_kwargs=dict(opts=AttnOptions(backend="chunked",
                                                 q_block=64, kv_block=64),
                                remat=True))
    sup = FaultSupervisor(tr)
    if args.resume and tr.store().latest_step() is not None:
        tr.restore()
        say(f"resumed from step {tr.step}")

    where = tr.device if mesh is None else mesh
    say(f"training {args.arch} ({cfg.n_params()/1e6:.1f}M params) "
        f"for {args.steps} steps on {where}")
    sup.run_supervised(max(args.steps - tr.step, 0))
    tr.save(async_=False)
    say(tr.monitor.table())
    say(f"done at step {tr.step}; checkpoint in {args.ckpt_dir}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
