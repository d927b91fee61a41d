"""End-to-end training on the port: a ~100M-param model for a few hundred
steps (PyTorch, on the CUDA card by default).

The full production loop of ``examples/train_100m.py``: synthetic pipeline
-> train step (each block recomputed in the backward) -> AdamW -> async
checkpoints -> C3 monitoring -> a DFS hitless reconfiguration mid-run -> a
simulated failure + exact recovery.

    python examples/torch_train_100m.py --steps 300
    python examples/torch_train_100m.py --device cpu   # the host instead

(defaults to 60 steps; ``--seq-len``, ``--batch`` and ``--ckpt-every``
shrink a run, e.g. to walk it on the CPU in seconds.)
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.dfs import (TileTelemetry,  # noqa: E402
                                  policy_memory_bound)
from repro_torch.models.layers import AttnOptions  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault import FaultSupervisor  # noqa: E402
from repro_torch.runtime.train import TrainConfig, Trainer  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "vespa_100m_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # ~100M-param danube-family config (d=512, 12L, 32k vocab)
    cfg = dataclasses.replace(
        get_config("h2o-danube-1.8b"),
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, sliding_window=256)
    n = cfg.n_params()
    print(f"training {n/1e6:.0f}M params for {args.steps} steps")

    shape = ShapeConfig("train", seq_len=args.seq_len,
                        global_batch=args.batch, kind="train")
    tc = TrainConfig(
        log_every=10 if args.steps >= 20 else 1, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, monitor_every=10,
        opt=adamw.AdamWConfig(lr=6e-4, warmup_steps=20,
                              total_steps=args.steps))
    block = min(128, args.seq_len)
    tr = Trainer(cfg, shape, tc=tc, device=args.device,
                 lm_kwargs=dict(opts=AttnOptions(backend="chunked",
                                                 q_block=block,
                                                 kv_block=block),
                                remat=True))
    sup = FaultSupervisor(tr)

    losses = []
    tr.run(args.steps // 2,
           on_metrics=lambda s, m: losses.append((s, m["loss"])) or
           print(f"  step {s:4d} loss {m['loss']:.4f} lr {m['lr']:.2e}"))

    # mid-run DFS reconfiguration (hitless: swap between steps)
    tel = {t.name: TileTelemetry(1.0, 0, 0, 0, boundness=0.9)
           for t in tr.plan.tiles}
    tr.actuator.reconfigure(policy_memory_bound(tr.islands, tel))
    print("DFS: derating memory-bound islands (hitless commit next step)")

    # simulated failure + exact recovery
    if tr.store().latest_step() is not None:
        print("simulating node failure ...")
        tr.params = None
        sup.recover()
        print(f"recovered at step {tr.step}")

    tr.run(args.steps - tr.step,
           on_metrics=lambda s, m: losses.append((s, m["loss"])) or
           print(f"  step {s:4d} loss {m['loss']:.4f}"))

    first = np.mean([l for _, l in losses[:3]])
    last = np.mean([l for _, l in losses[-3:]])
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'OK' if last < first else 'NOT DECREASING'})")
    print(tr.monitor.table())


if __name__ == "__main__":
    main()
