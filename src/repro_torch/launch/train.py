"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs an end-to-end training job on one device (reduced configs by default;
``--full`` takes the published config).  Wires the whole Vespa loop: data
pipeline -> train step -> monitor -> DFS actuator -> async checkpoints ->
fault supervisor.  The same flags as the reference's
``repro/launch/train.py``, plus ``--device`` (default: the CUDA card, which
raises without one; ``--device cpu`` runs it on the CPU).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import AttnOptions
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultSupervisor
from repro_torch.runtime.train import TrainConfig, Trainer


def main(argv=None) -> None:
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
                    help="'none' (one device); a mesh waits for ROADMAP "
                         "queue A item 12c")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    tc = TrainConfig(log_every=10, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, monitor_every=10,
                     opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                           total_steps=args.steps))
    tr = Trainer(cfg, shape, mesh=None if args.mesh == "none" else args.mesh,
                 tc=tc, device=args.device,
                 lm_kwargs=dict(opts=AttnOptions(backend="chunked",
                                                 q_block=64, kv_block=64),
                                remat=True))
    sup = FaultSupervisor(tr)
    if args.resume and tr.store().latest_step() is not None:
        tr.restore()
        print(f"resumed from step {tr.step}")

    print(f"training {args.arch} ({cfg.n_params()/1e6:.1f}M params) "
          f"for {args.steps} steps on {tr.device}")
    sup.run_supervised(max(args.steps - tr.step, 0))
    tr.save(async_=False)
    print(tr.monitor.table())
    print(f"done at step {tr.step}; checkpoint in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
