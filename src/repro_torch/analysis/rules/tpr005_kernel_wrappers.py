"""TPR005 — kernel-wrapper rules (the port's RPR005).

RPR005 remembers the Pallas constraints a kernel body must keep.  The
port's kernels are CUDA C++ behind ``ctypes``; what its authors have to
remember sits in the Python wrapper that launches them.  For every public
function of the kernel modules (:data:`KERNEL_MODULES`) that reaches a
build or a ``ctypes`` launch (a call of ``build.*``, a ``ctypes`` call or a
module-level ``_FN``, directly or through the module's own helpers):

* **It refuses what the launch would lose**: ``refuse_grad(...)`` (a raw
  launch writes its output through a pointer, so a CUDA input that
  requires grad would come back cut off from the graph: the silent detach
  the port fixed once) and ``refuse_counting(...)`` (dispatch never sees a
  ``ctypes`` launch, so a FLOP counter would miss its work), both before
  the launch.
* **The plain version runs only under** ``not on_card(...)``: the launch
  sits under ``if on_card(...)`` and the ``*_plain`` call after it (or in
  its ``else``), never inside.  On a CUDA tensor a wrapper launches the
  kernel or raises.
* **No fallback**: no ``try`` around a build or a launch whose handler
  runs the plain version.
* **Nothing built at import time**: no module-level statement calls the
  build, ``ctypes`` or a function that reaches them.
* **No host sync of its own**: TPR001's checks over the wrapper and the
  module helpers it reaches.

The ``torch.autograd.Function``\\ s of ``kernels/ops.py`` are held to the
last two points only (their forwards call the wrappers above).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR005"
SUMMARY = ("kernel wrappers: refuse grad and counting, plain version only "
           "off the card, no fallback, no import-time build, no host sync")

KERNEL_MODULES = ("kernels/tick_sim.py", "kernels/flash_attention.py",
                  "kernels/flash_decode.py", "kernels/ssd_scan.py",
                  "kernels/fused_mlp.py")
OPS_MODULE = "kernels/ops.py"


def _launches_directly(node: ast.AST, imports: astutil.ImportMap) -> bool:
    for c in ast.walk(node):
        if not isinstance(c, ast.Call):
            continue
        callee = imports.normalize(astutil.dotted_name(c.func)) or ""
        if callee.startswith("repro_torch.kernels.build.") or \
                callee.startswith("ctypes.") or \
                callee.split(".")[0] in ("build", "_FN") or \
                (isinstance(c.func, ast.Name) and c.func.id == "_FN"):
            return True
    return False


def _reaching(ctx: ModuleContext) -> Set[str]:
    """Module-level functions that reach a build or a launch."""
    recs = {r.name: r for r in ctx.funcindex.records if r.parent is None
            and r.cls is None}
    reach = {n for n, r in recs.items()
             if _launches_directly(r.node, ctx.imports)}
    changed = True
    while changed:
        changed = False
        for n, r in recs.items():
            if n in reach:
                continue
            for c in ast.walk(r.node):
                if isinstance(c, ast.Call) and \
                        isinstance(c.func, ast.Name) and \
                        c.func.id in reach:
                    reach.add(n)
                    changed = True
                    break
    return reach


def _calls_to(node: ast.AST, names: Set[str]) -> List[ast.Call]:
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name) and c.func.id in names]


def _is_on_card_test(test: ast.AST) -> bool:
    """``on_card(...)``, alone or as a term of an ``and``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_is_on_card_test(v) for v in test.values)
    return isinstance(test, ast.Call) and \
        astutil.dotted_name(test.func) in ("on_card", "_common.on_card")


def _plain_calls(node: ast.AST) -> List[ast.Call]:
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and (astutil.dotted_name(c.func) or "").endswith("_plain")]


def _check_wrapper(ctx: ModuleContext, rec: astutil.FunctionRecord,
                   reach: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    fn = rec.node
    launches = _calls_to(fn, reach)
    if not launches:
        return out
    first = min(c.lineno for c in launches)
    for must in ("refuse_grad", "refuse_counting"):
        calls = _calls_to(fn, {must})
        if not any(c.lineno < first for c in calls):
            out.append(ctx.finding(
                RULE_ID, fn,
                f"wrapper `{rec.qualname}` launches (line {first}) without "
                f"calling `{must}(...)` first — "
                + ("a CUDA input that requires grad would come back "
                   "detached from the graph" if must == "refuse_grad" else
                   "a FLOP counter would miss the launch's work")))
    # the launch under `if on_card(...)`, the plain version outside it
    guards = [n for n in ast.walk(fn)
              if isinstance(n, ast.If) and _is_on_card_test(n.test)]
    for c in launches:
        if not any(any(astutil.node_in(c, s) for s in g.body)
                   for g in guards):
            out.append(ctx.finding(
                RULE_ID, c,
                f"wrapper `{rec.qualname}` launches outside `if "
                "on_card(...)` — the plain version must be the CPU's, "
                "chosen only by where the tensors lie"))
    for c in _plain_calls(fn):
        inside = any(any(astutil.node_in(c, s) for s in g.body)
                     for g in guards)
        if inside or not guards:
            out.append(ctx.finding(
                RULE_ID, c,
                f"wrapper `{rec.qualname}` runs the plain version where "
                "the tensors may lie on the card — on CUDA tensors a "
                "wrapper launches the kernel or raises"))
    return out


def _check_fallbacks(ctx: ModuleContext, reach: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        body_launches = any(
            _calls_to(s, reach) or _launches_directly(s, ctx.imports)
            for s in node.body)
        if not body_launches:
            continue
        for h in node.handlers:
            if any(_plain_calls(s) for s in h.body):
                out.append(ctx.finding(
                    RULE_ID, node,
                    "a `try` around a build or a launch whose handler "
                    "runs the plain version — a failed kernel must raise, "
                    "not fall back without a word"))
    return out


def _check_import_time(ctx: ModuleContext, reach: Set[str]
                       ) -> List[Finding]:
    out: List[Finding] = []

    def walk(body):
        for stmt in body:
            if isinstance(stmt, (*astutil.FuncDef, ast.ClassDef)):
                if isinstance(stmt, ast.ClassDef):
                    walk([s for s in stmt.body
                          if not isinstance(s, astutil.FuncDef)])
                continue
            if _calls_to(stmt, reach) or \
                    _launches_directly(stmt, ctx.imports):
                out.append(ctx.finding(
                    RULE_ID, stmt,
                    "the module builds or loads a kernel at import time — "
                    "importing must not need nvcc or a card"))
            for child in ("body", "orelse", "finalbody"):
                if isinstance(getattr(stmt, child, None), list) and \
                        isinstance(stmt, (ast.If, ast.Try, ast.With)):
                    walk(getattr(stmt, child))
    walk(ctx.tree.body)
    return out


def _check_syncs(ctx: ModuleContext, recs: List[astutil.FunctionRecord]
                 ) -> List[Finding]:
    out: List[Finding] = []
    for rec in recs:
        _, flags = astutil.taint_function(
            rec, ctx.imports, ctx.hotindex.resolver(ctx.view, rec))
        for flag in flags:
            out.append(ctx.finding(
                RULE_ID, flag.node,
                f"kernel path `{rec.qualname}` has a host sync of its "
                f"own: {flag.detail}"))
    return out


def _module_helpers(ctx: ModuleContext, roots: List[astutil.FunctionRecord]
                    ) -> List[astutil.FunctionRecord]:
    """The roots and the module functions they call (transitively)."""
    recs: Dict[str, astutil.FunctionRecord] = {
        r.qualname: r for r in ctx.funcindex.records}
    out: List[astutil.FunctionRecord] = []
    work = list(roots)
    while work:
        r = work.pop()
        if r in out:
            continue
        out.append(r)
        for c in ast.walk(r.node):
            if isinstance(c, ast.Call):
                name = astutil.dotted_name(c.func)
                sub = (ctx.funcindex.lookup(r, name) if name and
                       "." not in name else None)
                if sub is not None and sub.qualname in recs and \
                        not sub.name.endswith("_plain"):
                    work.append(sub)
    return out


def check(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    if ctx.relpath.endswith(OPS_MODULE):
        reach = _reaching(ctx)
        out += _check_import_time(ctx, reach)
        fns = [r for r in ctx.funcindex.records
               if r.cls is not None and
               any(astutil.dotted_name(b) in (
                   "torch.autograd.Function", "Function")
                   for b in ctx.funcindex.classes[r.cls].bases)]
        return out + _check_syncs(ctx, fns)
    if not any(ctx.relpath.endswith(m) for m in KERNEL_MODULES):
        return out
    reach = _reaching(ctx)
    wrappers = [r for r in ctx.funcindex.records
                if r.parent is None and r.cls is None
                and not r.name.startswith("_") and r.name in reach]
    for rec in wrappers:
        out += _check_wrapper(ctx, rec, reach)
    out += _check_fallbacks(ctx, reach)
    out += _check_import_time(ctx, reach)
    # the wrappers and what they reach on the card's side (the plain
    # versions run on CPU tensors only)
    out += _check_syncs(ctx, _module_helpers(ctx, wrappers))
    return out
