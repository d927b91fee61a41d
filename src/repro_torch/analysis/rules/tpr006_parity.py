"""TPR006 — backend-surface parity (the port's RPR006).

Three entry points drive the same co-simulation through different
engines: ``SimEngine`` (the float64 sequential reference),
``BatchSimEngine`` (the ``"torch"`` loop and the ``"fused"`` kernel) and
``core.dse.closed_loop_score`` (the DSE bridge), with ``grid_sweep``
beside them.  Their *keyword surfaces* for shared knobs must agree, as the
reference's do: a knob added to one surface and forgotten on another
silently no-ops.  The contract is the reference's :data:`PARITY` matrix
over the port's surfaces, knob for knob, with the reference's backends
mapped to the port's (:data:`BACKEND_MAP`: its float64 ``"numpy"``
ground truth is the port's ``"torch"`` loop, its Pallas kernel the port's
``"fused"`` one):

* ``accept`` — the signature must expose one of the listed aliases;
* ``absent`` — the signature must NOT expose it;
* the ``"fused"`` path (the reference's ``"pallas"`` one) must keep an
  explicit ``raise NotImplementedError`` for each of
  :data:`REQUIRED_REFUSALS` (``BatchSimEngine._refuse_unported``).

Drift in either direction is flagged.  Surfaces whose module is not
among the analyzed files are skipped, so single-file runs stay quiet.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR006"
SUMMARY = ("engine keyword surfaces for shared knobs must agree or "
           "explicitly refuse")

KNOB_ALIASES: Dict[str, Tuple[str, ...]] = {
    "observe": ("observe",),
    "devices": ("devices",),
    "flows": ("flows",),
    "balancer": ("balancer", "balancer_factory"),
    "faults": ("faults", "fault_schedule"),
    "slo": ("slo",),
    "backend": ("backend",),
    # physical DVFS: engines take one `tech` spec (node or (node,
    # variant) pair); the sweep grid splits it into two axes
    "tech": ("tech", "tech_node"),
    "tech_variant": ("tech_variant",),
}

# (module suffix, qualname, {knob: "accept" | "absent" | "refuse:<sub>"})
PARITY: Tuple[Tuple[str, str, Dict[str, str]], ...] = (
    ("sim/engine.py", "SimEngine.__init__", {
        "observe": "accept",
        "balancer": "accept",
        "faults": "accept",
        "slo": "accept",
        "tech": "accept",
        # single-design host reference: sharding/backend selection and
        # flow synthesis are meaningless here by design; the scaling
        # variant rides inside the (node, variant) `tech` spec
        "devices": "absent",
        "flows": "absent",
        "backend": "absent",
        "tech_variant": "absent",
    }),
    ("sim/batch.py", "BatchSimEngine.__init__", {
        "observe": "accept",
        "balancer": "accept",
        "faults": "accept",
        "slo": "accept",
        "devices": "accept",
        "backend": "accept",
        "tech": "accept",
        # flow topology arrives through the platform, not per-run;
        # the variant rides inside the (node, variant) `tech` spec
        "flows": "absent",
        "tech_variant": "absent",
    }),
    ("core/dse.py", "closed_loop_score", {
        "observe": "accept",
        "balancer": "accept",
        "faults": "accept",
        "slo": "accept",
        "devices": "accept",
        "backend": "accept",
        "flows": "accept",
        "tech": "accept",
        "tech_variant": "absent",
    }),
    # the sweep grid is the one surface where node and variant are
    # separate AXES (cross-product knobs), not a single spec
    ("core/dse.py", "grid_sweep", {
        "tech": "accept",
        "tech_variant": "accept",
        "devices": "accept",
        "backend": "accept",
    }),
)

# the reference's backends -> the port's
BACKEND_MAP: Dict[str, str] = {"numpy": "torch", "pallas": "fused"}

# loud refusals the fused path must keep: (module suffix, message
# substring of a `raise NotImplementedError`)
REQUIRED_REFUSALS: Tuple[Tuple[str, str], ...] = (
    ("sim/batch.py", "fault schedules"),
    ("sim/batch.py", "SLO semantics"),
    ("sim/batch.py", "load balancer"),
    ("sim/batch.py", "observer plane"),
)


def _find_def(ctx: ModuleContext, qualname: str) -> Optional[ast.AST]:
    for rec in ctx.funcindex.records:
        if rec.qualname == qualname:
            return rec.node
    return None


def _param_names(node: ast.AST) -> List[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _refusal_strings(ctx: ModuleContext) -> List[str]:
    out: List[str] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call):
                name = astutil.dotted_name(exc.func)
                parts = [a.value for a in ast.walk(exc)
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str)]
                msg = " ".join(parts)
            else:
                name = astutil.dotted_name(exc)
                msg = ""
            if name and name.rsplit(".", 1)[-1] == "NotImplementedError":
                out.append(msg)
    return out


def check_project(ctxs: Sequence[ModuleContext]) -> List[Finding]:
    out: List[Finding] = []
    by_suffix: Dict[str, ModuleContext] = {}
    for suffix, _, _ in PARITY:
        for ctx in ctxs:
            if ctx.relpath.endswith(suffix):
                by_suffix[suffix] = ctx
    for suffix, _sub in REQUIRED_REFUSALS:
        for ctx in ctxs:
            if ctx.relpath.endswith(suffix):
                by_suffix.setdefault(suffix, ctx)

    for suffix, qualname, spec in PARITY:
        ctx = by_suffix.get(suffix)
        if ctx is None:
            continue
        node = _find_def(ctx, qualname)
        if node is None:
            out.append(Finding(
                RULE_ID, ctx.relpath, 1,
                f"parity surface `{qualname}` not found in {suffix} — "
                "update the PARITY matrix in tpr006_parity.py"))
            continue
        params = set(_param_names(node))
        for knob, status in spec.items():
            aliases = KNOB_ALIASES[knob]
            present = [a for a in aliases if a in params]
            if status == "accept" and not present:
                out.append(Finding(
                    RULE_ID, ctx.relpath, node.lineno,
                    f"`{qualname}` must accept knob `{knob}` (one of "
                    f"{', '.join(aliases)}) to stay in parity with the "
                    "other engines — or declare it absent/refused in "
                    "the PARITY matrix"))
            elif status == "absent" and present:
                out.append(Finding(
                    RULE_ID, ctx.relpath, node.lineno,
                    f"`{qualname}` grew knob `{present[0]}` that the "
                    "parity matrix declares absent — update the PARITY "
                    "matrix and decide what the other surfaces do "
                    "with it"))
        # knobs present in the signature but missing from the spec row
        for knob, aliases in KNOB_ALIASES.items():
            if knob in spec:
                continue
            present = [a for a in aliases if a in params]
            if present:
                out.append(Finding(
                    RULE_ID, ctx.relpath, node.lineno,
                    f"`{qualname}` exposes shared knob "
                    f"`{present[0]}` that is not declared in the "
                    "PARITY matrix — declare it for every surface"))

    for suffix, substring in REQUIRED_REFUSALS:
        ctx = by_suffix.get(suffix)
        if ctx is None:
            continue
        fused = BACKEND_MAP["pallas"]
        if not any(substring in msg and fused in msg
                   for msg in _refusal_strings(ctx)):
            out.append(Finding(
                RULE_ID, ctx.relpath, 1,
                f"expected an explicit `raise NotImplementedError` "
                f"mentioning '{substring}' and the {fused!r} backend in "
                f"{suffix} — the fused "
                "path must refuse unsupported knobs loudly, not "
                "silently ignore them"))
    return out
