"""``repro_torch.analysis`` — AST-based invariant linter for the port.

The counterpart of the reference linter (``src/repro/analysis/``): the
same layout, CLI, finding format, fingerprints, baseline format and
``# repro: noqa[ID] justification`` syntax, with each rule answering a
reference rule for the bug class it guards as that class shows up in
PyTorch/CUDA code.  It reads source as AST only: it imports neither
``jax`` nor ``repro``, nor ``torch`` nor any module it lints, so linting
initialises no CUDA and builds no kernel, and runs alike on any machine.

Rule passes (one module each under :mod:`repro_torch.analysis.rules`):

=======  ======  ========================================================
TPR      answers what it flags
=======  ======  ========================================================
TPR001   RPR001  host syncs inside hot functions (tick, sweep block,
                 decode step, train step, and what they call across
                 modules): ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                 ``.numpy()`` / ``.to("cpu")``, ``float()`` / ``int()`` /
                 ``bool()`` / ``if`` / ``while`` / ``assert`` on tensors,
                 ``torch.cuda.synchronize()``, data-dependent sizes
                 (``nonzero``, ``unique``, ``masked_select``,
                 ``bincount``, boolean masks, ``repeat_interleave``)
TPR002   RPR002  memo-cache key completeness: device-copy caches and the
                 content-addressed kernel build key every input of the
                 value they keep
TPR003   RPR003  unbounded caches: ``lru_cache(maxsize=None)``,
                 ``@cache``, module/instance dict caches with inserts
                 but no eviction (the reference rule, verbatim)
TPR004   RPR004  dtype discipline: no float32 in the declared float64
                 reference set; no silent float64 on the float32/bf16
                 device paths
TPR005   RPR005  kernel wrappers: ``refuse_grad`` and
                 ``refuse_counting`` before a launch, the plain version
                 only under ``not on_card(...)``, no fallback, no
                 import-time build, no host sync of their own
TPR006   RPR006  backend-surface parity: the engines' keyword surfaces
                 for shared knobs agree (the reference's matrix, its
                 backends mapped to the port's) or the fused path
                 explicitly raises NotImplementedError
=======  ======  ========================================================

CLI::

    python -m repro_torch.analysis [--format text|json] [--baseline FILE]
                                   [--changed-only] [--bench] [--out FILE]
                                   [paths...]

Findings carry ``file:line``, rule id, rationale, and a stable
fingerprint.  Pre-existing accepted findings live in the checked-in
baseline (``analysis/baseline_torch.json``) so they don't block CI while
any NEW finding fails it.  Inline suppression::

    offending_line  # repro: noqa[TPR001] justification text (required)

and an opt-in ``# repro: hot`` marker on a ``def`` line makes a function
hot (for a target the call graph cannot follow, the counterpart of the
reference's ``# repro: traced``).
"""
from repro_torch.analysis.engine import (AnalysisReport, ModuleContext,
                                         analyze_paths, iter_python_files)
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           save_baseline)
from repro_torch.analysis.rules import RULES, get_rules

__all__ = [
    "AnalysisReport", "ModuleContext", "analyze_paths",
    "iter_python_files", "Finding", "load_baseline", "save_baseline",
    "RULES", "get_rules",
]
