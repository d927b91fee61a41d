"""TPR001 — host sync in a hot function (the port's RPR001).

RPR001 guards JAX's tracer leak: Python control flow or a host coercion on
a traced value inside a jitted function.  The PyTorch counterpart of that
bug class is the host sync: eager PyTorch runs the Python, so a Python
``if`` on a tensor, ``float(t)``, ``.item()`` or ``.cpu()`` does not fail
to trace, it makes the host wait until the card has run every queued
kernel and then copies the value back.  Once a tick, a sweep block, a
decode step or a train step, that round trip is what keeps the card idle
(the port's replays, decode and mamba2 training are host-bound).

Inside every function :class:`~repro_torch.analysis.astutil.HotIndex`
marks hot (the declared entries, ``# repro: hot`` markers and what they
call, across modules), this rule flags:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.to("cpu")``
  / ``.to(device="cpu")`` on a value not known to live on the host;
* ``float()`` / ``int()`` / ``bool()`` of a tensor, and ``if`` / ``while``
  / ``assert`` / a conditional expression on one;
* ``torch.cuda.synchronize()`` and ``.synchronize()``;
* the calls whose output size depends on the data: ``torch.nonzero`` /
  ``.nonzero()``, one-argument ``torch.where``, ``torch.unique``,
  ``torch.masked_select``, ``torch.bincount``, ``torch.argwhere``,
  ``repeat_interleave`` with tensor repeats and no ``output_size``, and
  boolean-mask indexing ``x[mask]``.

Which values are tensors is :func:`~repro_torch.analysis.astutil.
taint_function`'s inference.  A deliberate read (the sequential engine's
one copy a control tick, the server's token read) is kept with
``# repro: noqa[TPR001] <why>``; the list of all of them is the map a
host-bound optimisation starts from.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR001"
SUMMARY = ("host syncs (.item/.cpu/.tolist, Python branches and coercions "
           "on tensors, data-dependent sizes) inside hot functions")


def check(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    hot = ctx.hotindex
    for rec, info in hot.functions(ctx.view):
        _, flags = astutil.taint_function(
            rec, ctx.imports, hot.resolver(ctx.view, rec))
        for flag in flags:
            if info.region is not None and \
                    not astutil.node_in(flag.node, info.region):
                continue
            out.append(ctx.finding(
                RULE_ID, flag.node,
                f"in `{rec.qualname}` (hot: {info.via}): {flag.detail}"))
    return out

