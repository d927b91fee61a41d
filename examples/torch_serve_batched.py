"""Serve a small model with batched requests + RTT monitoring, on the port
(PyTorch, on the CUDA card by default).

Continuous-batching engine over fixed slots; the C3 round-trip-time
counter (dispatch -> first token) is the paper's DMA RTT analogue.

    python examples/torch_serve_batched.py --requests 12
    python examples/torch_serve_batched.py --device cpu   # the host instead

Prints what ``examples/serve_batched.py`` prints: the schedule, and with
it every line, does not depend on the (random) weights.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import AttnOptions  # noqa: E402
from repro_torch.runtime.serve import Request, ServeEngine  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    eng = ServeEngine(cfg, batch_slots=args.slots, window=128,
                      lm_kwargs=dict(opts=AttnOptions(backend="naive"),
                                     remat=False), device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i, max_new=12,
            prompt=rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)))

    done = eng.run(ticks=80)
    s = eng.stats()
    print(f"completed {int(s['completed'])}/{args.requests} requests, "
          f"{int(s['tokens'])} tokens, {s['tokens_per_tick']:.2f} tok/tick")
    print(f"RTT ticks: mean={s['mean_rtt_ticks']:.1f} "
          f"per-request={[r.rtt for r in done]}")
    print(f"C3 mem.rtt counter: {float(eng.counters['mem']['rtt']):.0f}")


if __name__ == "__main__":
    main()
