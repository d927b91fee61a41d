"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Boots the continuous-batching ServeEngine on a reduced config, feeds it
synthetic request traffic at a configurable arrival rate, and reports
throughput + RTT percentiles (C3 monitoring end-to-end).  The same CLI as
the reference's ``repro/launch/serve.py``, plus ``--device`` (default: the
CUDA card; ``--device cpu`` walks it on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_configs
from repro_torch.models.layers import AttnOptions
from repro_torch.runtime.serve import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large",
                    choices=list_configs())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="submit one request every N ticks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    eng = ServeEngine(cfg, batch_slots=args.slots, window=args.window,
                      lm_kwargs=dict(opts=AttnOptions(backend="naive")),
                      device=args.device)
    rng = np.random.default_rng(0)
    submitted = 0
    tick_budget = args.requests * args.arrival_every + args.requests * (
        args.max_new + 4)
    for t in range(tick_budget):
        if submitted < args.requests and t % args.arrival_every == 0:
            eng.submit(Request(
                rid=submitted, max_new=args.max_new,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32)))
            submitted += 1
        eng.step()
        if len(eng.done) >= args.requests:
            break

    s = eng.stats()
    rtts = sorted(r.rtt for r in eng.done if r.rtt is not None)
    p50 = rtts[len(rtts) // 2] if rtts else 0
    p99 = rtts[min(len(rtts) - 1, int(len(rtts) * 0.99))] if rtts else 0
    print(f"served {int(s['completed'])}/{args.requests} requests "
          f"({int(s['tokens'])} tokens) in {eng.tick} ticks on {eng.device}")
    print(f"throughput {s['tokens_per_tick']:.2f} tok/tick; "
          f"RTT p50={p50} p99={p99} ticks")
    print(f"C3 counters: mem.rtt={float(eng.counters['mem']['rtt']):.0f} "
          f"io.exec={float(eng.counters['io']['exec_time']):.0f}")


if __name__ == "__main__":
    main()
