"""Quickstart on the port: build any assigned architecture, run forward /
prefill / decode, and inspect the Vespa tile plan + monitoring counters
(PyTorch, on the CUDA card by default).

    python examples/torch_quickstart.py --arch gemma-2b
    python examples/torch_quickstart.py --device cpu      # the host instead

Prints what ``examples/quickstart.py`` prints.  The weights are random and
drawn from ``torch.Generator(device).manual_seed(0)`` (the reference draws
from ``jax.random.PRNGKey(0)``), so the next tokens differ; the shapes, the
tile plan, the islands and the counters do not.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import repro_torch.core as C  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models.layers import AttnOptions  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    device = resolve(args.device)

    cfg = get_config(args.arch).reduced()     # CPU-sized, same family
    print(f"arch={args.arch} family={cfg.family} "
          f"(full model: {get_config(args.arch).n_params()/1e9:.2f}B params)")

    lm = LM(cfg, opts=AttnOptions(backend="naive"), remat=False)
    params = lm.init(torch.Generator(device=device).manual_seed(0))

    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)), device=device)
    with torch.no_grad():
        logits, aux = lm.forward(params, tokens=toks)
        print(f"forward: logits {tuple(logits.shape)}, aux={float(aux):.3f}")

        lg, cache = lm.prefill(params, tokens=toks, cache_len=64)
        nxt = torch.argmax(lg, -1)[:, None]
        lg2, cache = lm.decode_step(params, cache, tokens=nxt)
    print(f"prefill+decode: next tokens {torch.argmax(lg2, -1).tolist()}")

    # the Vespa view: tiles, islands, counters
    plan = C.default_plan(cfg)
    islands = C.default_islands(plan)
    print("tiles:", [f"{t.name}(K={t.replication},{t.island})"
                     for t in plan.tiles])
    print("islands:", {i.name: i.rate for i in islands.islands})
    ctr = C.init_counters(plan, device)
    ctr = C.charge_boundary(ctr, "attn", "mem", logits)
    mc = C.MonitorClient()
    mc.read(ctr, step=1)
    print(mc.table())


if __name__ == "__main__":
    main()
