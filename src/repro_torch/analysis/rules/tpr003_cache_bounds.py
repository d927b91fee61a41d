"""TPR003 — unbounded caches (the port's RPR003, rule for rule).

Long-lived engines (the serving target) must not pin memory per
configuration ever seen.  The reference bounded five module caches by
hand; this rule keeps the property mechanical.  It reads no framework
call, so it is the reference's rule copied with the port's rule id: on
the same files its raw findings are RPR003's.  Flagged shapes:

* ``@functools.lru_cache(maxsize=None)`` and bare ``@functools.cache``
  — memoization without eviction.
* A module-level ``dict``/``list`` that some function inserts into
  (``d[k] = v``, ``d.setdefault``, ``d.append``, ``d.update``) with no
  eviction site anywhere in the module (``pop``/``popitem``/``clear``/
  ``del d[...]``/reassignment) and no explicit bound check
  (``len(d)`` comparison).
* An instance dict initialized in ``__init__`` (``self.x = {}``) whose
  inserts use the memo idiom — ``setdefault(...)`` or an
  ``if k not in self.x:`` guard — with no eviction in the class.
  Plain state dicts (unconditional ``self.x[k] = v`` bookkeeping) are
  not flagged; the memo idiom is what marks a growing cache.

Intentional registries are suppressed in place::

    _REGISTRY = {}  # repro: noqa[TPR003] process-lifetime registry, bounded by source

``deque(maxlen=...)``, ``lru_cache(n)`` and the OrderedDict-LRU idiom
(insert followed by ``popitem``) all pass.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR003"
SUMMARY = "caches must be bounded (lru maxsize, LRU eviction, or maxlen)"

_EVICT_METHODS = {"pop", "popitem", "clear"}
_INSERT_METHODS = {"setdefault", "update", "append", "extend", "add"}
_DICTISH = {"dict", "OrderedDict", "defaultdict", "list"}


def _is_fresh_container(rhs: ast.AST) -> bool:
    if isinstance(rhs, (ast.Dict, ast.List)) and not (
            getattr(rhs, "keys", None) or getattr(rhs, "elts", None)):
        return True
    if isinstance(rhs, ast.Call) and not rhs.args and not rhs.keywords:
        callee = astutil.dotted_name(rhs.func)
        return bool(callee) and callee.rsplit(".", 1)[-1] in _DICTISH
    return False


def _name_usage(tree: ast.AST, name: str,
                attr_of_self: bool) -> Tuple[Set[str], bool, bool]:
    """(method names used on the target, subscript-store?, evicted?)."""
    methods: Set[str] = set()
    sub_store = False
    evicted = False

    def is_target(node: ast.AST) -> bool:
        if attr_of_self:
            return (isinstance(node, ast.Attribute) and node.attr == name
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self")
        return isinstance(node, ast.Name) and node.id == name

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                is_target(node.func.value):
            methods.add(node.func.attr)
            if node.func.attr in _EVICT_METHODS:
                evicted = True
        elif isinstance(node, ast.Subscript) and is_target(node.value):
            if isinstance(node.ctx, ast.Store):
                sub_store = True
            elif isinstance(node.ctx, ast.Del):
                evicted = True
        elif isinstance(node, ast.Call):
            callee = astutil.dotted_name(node.func)
            if callee == "len" and node.args and is_target(node.args[0]):
                evicted = True           # len() guard implies a bound
    return methods, sub_store, evicted


def _memo_guard_on(tree: ast.AST, name: str, attr_of_self: bool) -> bool:
    """``if k not in <target>:`` / ``if k in <target>`` guard present?"""
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.IfExp)) and \
                isinstance(node.test, ast.Compare) and \
                any(isinstance(op, (ast.In, ast.NotIn))
                    for op in node.test.ops):
            for comp in node.test.comparators:
                if attr_of_self:
                    if isinstance(comp, ast.Attribute) and \
                            comp.attr == name and \
                            isinstance(comp.value, ast.Name) and \
                            comp.value.id == "self":
                        return True
                elif isinstance(comp, ast.Name) and comp.id == name:
                    return True
    return False


def _check_lru_decorators(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for rec in ctx.funcindex.records:
        for dec in rec.node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            callee = ctx.imports.normalize(astutil.dotted_name(target))
            if not callee:
                continue
            last = callee.rsplit(".", 1)[-1]
            if last == "cache" and callee.startswith("functools"):
                out.append(ctx.finding(
                    RULE_ID, dec,
                    f"`@functools.cache` on `{rec.qualname}` never "
                    "evicts — use lru_cache(maxsize=N)"))
            elif last == "lru_cache" and isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "maxsize" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is None:
                        out.append(ctx.finding(
                            RULE_ID, dec,
                            f"`lru_cache(maxsize=None)` on "
                            f"`{rec.qualname}` never evicts — give it "
                            "a finite maxsize"))
                if dec.args and isinstance(dec.args[0], ast.Constant) \
                        and dec.args[0].value is None:
                    out.append(ctx.finding(
                        RULE_ID, dec,
                        f"`lru_cache(None)` on `{rec.qualname}` never "
                        "evicts — give it a finite maxsize"))
    return out


def _check_module_dicts(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for stmt in ctx.tree.body:
        targets: List[Tuple[str, ast.AST]] = []
        if isinstance(stmt, ast.Assign) and _is_fresh_container(stmt.value):
            targets = [(t.id, stmt) for t in stmt.targets
                       if isinstance(t, ast.Name)]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name) and \
                _is_fresh_container(stmt.value):
            targets = [(stmt.target.id, stmt)]
        for name, node in targets:
            methods, sub_store, evicted = _name_usage(
                ctx.tree, name, attr_of_self=False)
            inserts = sub_store or bool(methods & _INSERT_METHODS)
            if inserts and not evicted:
                out.append(ctx.finding(
                    RULE_ID, node,
                    f"module-level cache `{name}` grows without "
                    "eviction (inserts but no pop/popitem/clear/del/"
                    "len-bound) — bound it or mark the registry "
                    "intent with a justified noqa"))
    return out


def _check_instance_dicts(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        init = next((n for n in node.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            continue
        attrs: List[Tuple[str, ast.AST]] = []
        for stmt in ast.walk(init):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target])
                val = stmt.value
                if val is None or not _is_fresh_container(val):
                    continue
                for t in tgts:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        attrs.append((t.attr, stmt))
        for name, site in attrs:
            methods, sub_store, evicted = _name_usage(
                node, name, attr_of_self=True)
            if evicted:
                continue
            memo_style = ("setdefault" in methods or
                          _memo_guard_on(node, name, attr_of_self=True))
            inserts = sub_store or bool(methods & _INSERT_METHODS)
            if memo_style and inserts:
                out.append(ctx.finding(
                    RULE_ID, site,
                    f"instance memo-cache `self.{name}` in "
                    f"`{node.name}` grows without eviction — bound it "
                    "(LRU / maxlen) for long-lived instances"))
    return out


def check(ctx: ModuleContext) -> List[Finding]:
    return (_check_lru_decorators(ctx) + _check_module_dicts(ctx)
            + _check_instance_dicts(ctx))
