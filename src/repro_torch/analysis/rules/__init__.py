"""Rule registry.  Each rule module exposes ``RULE_ID``, ``SUMMARY``
and ``check(ctx)`` and/or ``check_project(ctxs)``; register new rules
here and they are picked up by the CLI, the baseline machinery and the
docs table alike."""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.rules import (tpr001_host_sync, tpr002_cache_key,
                                        tpr003_cache_bounds, tpr004_dtype,
                                        tpr005_kernel_wrappers,
                                        tpr006_parity)

RULES = (tpr001_host_sync, tpr002_cache_key, tpr003_cache_bounds,
         tpr004_dtype, tpr005_kernel_wrappers, tpr006_parity)


def get_rules(only: Optional[Sequence[str]] = None) -> List[object]:
    """All rules, or the subset whose RULE_ID is in ``only``."""
    if only is None:
        return list(RULES)
    wanted = {r.upper() for r in only}
    out = [m for m in RULES if m.RULE_ID in wanted]
    unknown = wanted - {m.RULE_ID for m in out}
    if unknown:
        raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
    return out
