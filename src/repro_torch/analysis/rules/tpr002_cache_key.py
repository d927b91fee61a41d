"""TPR002 — memo-cache key completeness (the port's RPR002).

RPR002 holds a hand-rolled jit cache to keying every Python value its
traced closure bakes in (the bug it was written for: ``dt`` missing
from the scan cache's key reused stale compilations).  The port compiles no
closure, but it memoises: device copies of a platform's arrays
(``BatchSimEngine._dev_cache``), a balancer's group layout on a device
(``LoadBalancer._dev``), shard devices (``shard._DEVICE_CACHE``), the
built kernel libraries (``kernels/build.py``).  Each is only sound if its
key covers every input of the value it keeps.  The check applies the
reference's algorithm to two shapes:

1. **Guarded memo sites** — ``if K not in C:`` (or ``v = C.get(K)`` then
   ``if v is None``) guarding a store ``C[...] = V``, ``C`` a module-level
   container or an attribute of ``self``.  *Key closure*: the names ``K``
   reaches through tuple literals, aliases and helper calls, stopping at
   lossy expressions (an attribute read, arithmetic), as in RPR002.
   *Required set*: the names the stored value ``V`` reads, local helper
   functions expanded to their free names.  A required name is satisfied
   if it is keyed, or every derivation root is ``self`` / a module-level
   constant / itself satisfied; a value rooted in a parameter of the
   enclosing function that the key does not cover is a finding.
2. **Content-addressed files** — a function that returns a name made from
   ``hashlib`` digest's ``hexdigest()`` is a key; every parameter must
   reach the digest (``h.update(...)``, through method calls such as
   ``src.read_bytes()`` or ``" ".join(flags).encode()``), and so must the
   files the build reads that no parameter names (:data:`DIGEST_INPUTS`:
   every ``csrc/*.cuh`` header, which any source may include).  Where the
   digest function is called, the call that builds the cached value with
   its result (``_start(src, so, flags)``) may read only what was passed
   to the digest: ``flags`` built from ``NVCC_FLAGS`` and
   ``SOURCE_FLAGS`` is keyed because the same ``flags`` reaches both.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR002"
SUMMARY = ("memo caches and content-addressed builds must key every input "
           "of the value they keep")

# (module suffix, digest function, glob patterns whose files' bytes the
# digest must read)
DIGEST_INPUTS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("kernels/build.py", "_target", ("*.cuh",)),
)


def _key_closure(expr: ast.AST, assigns: Dict[str, List[ast.expr]],
                 ) -> Set[str]:
    """Names keyed by ``expr`` (transitive through injective shapes)."""
    keyed: Set[str] = set()
    work: List[ast.AST] = [expr]
    seen_names: Set[str] = set()
    while work:
        e = work.pop()
        if isinstance(e, ast.Name):
            if e.id in seen_names:
                continue
            seen_names.add(e.id)
            keyed.add(e.id)
            for rhs in assigns.get(e.id, ()):
                work.append(rhs)
        elif isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            work.extend(e.elts)
        elif isinstance(e, ast.Dict):
            work.extend(k for k in e.keys if k is not None)
            work.extend(e.values)
        elif isinstance(e, ast.Call):
            # digest/helper semantics: every argument fed to the helper
            # is considered keyed (the helper exists to fold it in), and
            # so is the receiver of a method (``src.read_bytes()``)
            work.extend(e.args)
            work.extend(kw.value for kw in e.keywords)
            if isinstance(e.func, ast.Attribute):
                work.append(e.func.value)
        elif isinstance(e, ast.Starred):
            work.append(e.value)
        elif isinstance(e, ast.JoinedStr):
            # an f-string of values with separators: each value keyed
            work.extend(v.value for v in e.values
                        if isinstance(v, ast.FormattedValue))
        elif isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add) and \
                all(isinstance(x, (ast.Name, ast.Tuple, ast.Call))
                    for x in (e.left, e.right)):
            # tuple concatenation of flags: each part keyed
            work.extend([e.left, e.right])
        # every other expression shape (Attribute, Subscript, arithmetic,
        # Compare, Constant, ...) is lossy: stop.
    return keyed


def _covered(name: str, keyed: Set[str],
             assigns: Dict[str, List[ast.expr]], params: Set[str],
             memo: Dict[str, bool], visiting: Set[str]) -> bool:
    if name in keyed or name == "self":
        return True
    if name in memo:
        return memo[name]
    if name in visiting:
        return True                      # cycle: optimistic
    if name in params:
        memo[name] = False               # un-keyed non-self parameter
        return False
    rhss = assigns.get(name)
    if not rhss:
        memo[name] = True                # module-level / import / builtin
        return True
    visiting.add(name)
    ok = all(
        _covered(r, keyed, assigns, params, memo, visiting)
        for rhs in rhss for r in sorted(astutil.name_loads(rhs)))
    visiting.discard(name)
    memo[name] = ok
    return ok


def _uncovered_roots(name: str, assigns: Dict[str, List[ast.expr]],
                     params: Set[str], keyed: Set[str]) -> Set[str]:
    """Human-readable culprit roots for the finding message."""
    bad: Set[str] = set()
    seen: Set[str] = set()
    work = [name]
    while work:
        n = work.pop()
        if n in seen or n in keyed or n == "self":
            continue
        seen.add(n)
        if n in params:
            bad.add(n)
            continue
        for rhs in assigns.get(n, ()):
            work.extend(astutil.name_loads(rhs))
    return bad


def _bare_assignments(func_node: ast.AST) -> Dict[str, List[ast.expr]]:
    """name -> RHS expressions bound to it as a name (``x = ...``,
    ``a, b = ...``); unlike ``assignments_of``, a store into ``C[key]``
    binds nothing to ``key``."""
    out: Dict[str, List[ast.expr]] = {}
    for node in ast.walk(func_node):
        if isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                isinstance(node.target, ast.Name) and node.value is not None:
            out.setdefault(node.target.id, []).append(node.value)
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                    else [t])
            vals = (node.value.elts
                    if isinstance(node.value, (ast.Tuple, ast.List))
                    and len(node.value.elts) == len(elts) and len(elts) > 1
                    else [node.value] * len(elts))
            for e, v in zip(elts, vals):
                if isinstance(e, ast.Name):
                    out.setdefault(e.id, []).append(v)
    return out


def _is_cache(target: ast.AST, module_names: Set[str]) -> Optional[str]:
    """``C`` (module-level) or ``self.C``: the cache's display name."""
    if isinstance(target, ast.Name) and target.id in module_names:
        return target.id
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and \
            target.value.id == "self":
        return f"self.{target.attr}"
    return None


def _same(a: ast.AST, b: ast.AST) -> bool:
    return ast.dump(a) == ast.dump(b)


def _module_containers(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target] if isinstance(stmt, ast.AnnAssign)
                   else [])
        value = getattr(stmt, "value", None)
        if isinstance(value, (ast.Dict, ast.Call)):
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _guards(fn: ast.AST, containers: Set[str]
            ) -> List[Tuple[ast.If, ast.AST, ast.AST]]:
    """(if-node, key expression, cache expression) of each memo guard in
    ``fn``: ``if K not in C`` and ``v = C.get(K)`` ... ``if v is None``."""
    gets: Dict[str, Tuple[ast.AST, ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                isinstance(node.value.func, ast.Attribute) and \
                node.value.func.attr == "get" and node.value.args and \
                _is_cache(node.value.func.value, containers):
            gets[node.targets[0].id] = (node.value.args[0],
                                        node.value.func.value)
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        tests = (node.test.values if isinstance(node.test, ast.BoolOp)
                 and isinstance(node.test.op, ast.Or) else [node.test])
        for t in tests:
            if not isinstance(t, ast.Compare) or len(t.ops) != 1:
                continue
            op, right = t.ops[0], t.comparators[0]
            if isinstance(op, ast.NotIn) and _is_cache(right, containers):
                out.append((node, t.left, right))
                break
            if isinstance(op, ast.Is) and isinstance(t.left, ast.Name) and \
                    isinstance(right, ast.Constant) and \
                    right.value is None and t.left.id in gets:
                key, cache = gets[t.left.id]
                out.append((node, key, cache))
                break
    return out


def _check_memo_sites(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    containers = _module_containers(ctx.tree)
    for rec in ctx.funcindex.records:
        for guard, key_expr, cache in _guards(rec.node, containers):
            stores = [(t, n.value) for body in (guard.body,)
                      for stmt in body for n in ast.walk(stmt)
                      if isinstance(n, ast.Assign)
                      for t in n.targets
                      if isinstance(t, ast.Subscript)
                      and _same(t.value, cache)]
            if not stores:
                continue
            assigns = _bare_assignments(rec.node)
            params = set(rec.all_params()) - {"self", "cls"}
            keyed = _key_closure(key_expr, assigns)
            # the guarded key is the site's; a chained store under
            # another key (an alias of the same entry) adds nothing
            required: Set[str] = set()
            for _, value in stores[:1]:
                work = list(astutil.name_loads(value))
                for stmt in guard.body:
                    if isinstance(stmt, ast.Assign) and any(
                            isinstance(t, ast.Name)
                            for t in stmt.targets):
                        work.extend(astutil.name_loads(stmt.value))
                seen: Set[str] = set()
                while work:
                    n = work.pop()
                    if n in seen:
                        continue
                    seen.add(n)
                    sub = ctx.funcindex.lookup(rec, n)
                    if sub is not None and sub.parent is rec:
                        work.extend(astutil.free_names(sub))
                    else:
                        required.add(n)
            memo: Dict[str, bool] = {}
            name = _is_cache(cache, containers) or "cache"
            for free in sorted(required):
                if not _covered(free, keyed, assigns, params, memo, set()):
                    roots = _uncovered_roots(free, assigns, params, keyed)
                    via = (f" (derived from parameter "
                           f"{', '.join(sorted(roots))})" if roots else "")
                    out.append(ctx.finding(
                        RULE_ID, stores[0][0],
                        f"`{free}` shapes the value `{name}` keeps in "
                        f"`{rec.qualname}` but is missing from its key"
                        f"{via} — a stale entry will be returned"))
    return out


def _digest_functions(ctx: ModuleContext
                      ) -> Dict[str, Tuple[astutil.FunctionRecord,
                                           Set[str]]]:
    """name -> (record, names its digest reads) of each function that
    returns a ``hexdigest()``-named key."""
    out = {}
    for rec in ctx.funcindex.records:
        if rec.parent is not None:
            continue
        returns_digest = any(
            isinstance(n, ast.Return) and n.value is not None and any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "hexdigest" for c in ast.walk(n.value))
            for n in ast.walk(rec.node))
        if not returns_digest:
            continue
        assigns = astutil.assignments_of(rec.node)
        keyed: Set[str] = set()
        for c in ast.walk(rec.node):
            callee = ctx.imports.normalize(astutil.dotted_name(c.func)) \
                if isinstance(c, ast.Call) else None
            if isinstance(c, ast.Call) and (
                    (isinstance(c.func, ast.Attribute)
                     and c.func.attr == "update")
                    or (callee or "").startswith("hashlib.")):
                for a in c.args:
                    keyed |= _key_closure(a, assigns)
        out[rec.name] = (rec, keyed)
    return out


def _globbed_reads(rec: astutil.FunctionRecord, keyed: Set[str]
                   ) -> Set[str]:
    """Glob patterns whose files' bytes reach the digest: ``for h in
    ...glob(PAT)`` with ``h`` keyed."""
    out: Set[str] = set()
    for node in ast.walk(rec.node):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                and node.target.id in keyed:
            for c in ast.walk(node.iter):
                if isinstance(c, ast.Call) and \
                        isinstance(c.func, ast.Attribute) and \
                        c.func.attr in ("glob", "rglob") and c.args and \
                        isinstance(c.args[0], ast.Constant):
                    out.add(c.args[0].value)
    return out


def _check_digests(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    digests = _digest_functions(ctx)
    for name, (rec, keyed) in sorted(digests.items()):
        for p in rec.all_params():
            if p not in keyed:
                out.append(ctx.finding(
                    RULE_ID, rec.node,
                    f"content key `{name}` never digests its parameter "
                    f"`{p}` — two builds that differ in it share a file"))
        for suffix, fn, pats in DIGEST_INPUTS:
            if fn == name and ctx.relpath.endswith(suffix):
                missing = set(pats) - _globbed_reads(rec, keyed)
                for pat in sorted(missing):
                    out.append(ctx.finding(
                        RULE_ID, rec.node,
                        f"content key `{name}` does not digest the files "
                        f"`{pat}` the build reads — a changed header "
                        "would load the stale library"))
    # callers: what builds the value under the key reads only keyed names
    for rec in ctx.funcindex.records:
        assigns = astutil.assignments_of(rec.node)
        for node in ast.walk(rec.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in digests):
                continue
            key_name = node.targets[0].id
            inputs = set()
            for a in node.value.args:
                inputs |= _key_closure(a, {})
            keyed = inputs | {key_name}
            # the build: a call handed the key's name and what was digested
            for c in ast.walk(rec.node):
                if not isinstance(c, ast.Call) or c is node.value:
                    continue
                names = {a.id for a in c.args if isinstance(a, ast.Name)}
                if key_name not in names or not names & inputs:
                    continue
                for a in c.args:
                    for n in sorted(astutil.name_loads(a) - keyed):
                        if n in rec.all_params() or n in assigns:
                            out.append(ctx.finding(
                                RULE_ID, node,
                                f"`{n}` builds what `{key_name}` names "
                                f"(line {c.lineno}) but is not passed to "
                                f"`{node.value.func.id}` — a build that "
                                "differs in it reuses the stale file"))
    return out


def check(ctx: ModuleContext) -> List[Finding]:
    return _check_memo_sites(ctx) + _check_digests(ctx)
