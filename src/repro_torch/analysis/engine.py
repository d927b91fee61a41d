"""Analysis driver: parse modules once, run every rule, collect findings.

Each rule module exposes ``RULE_ID``, ``SUMMARY`` and
``check(ctx: ModuleContext) -> list[Finding]`` plus optionally
``check_project(ctxs: list[ModuleContext]) -> list[Finding]`` for
cross-module rules (TPR006 parity needs several files at once).

Unlike the reference driver, the modules of one run share a
:class:`RunContext`: the hot scope (:class:`~repro_torch.analysis.astutil.
HotIndex`) follows calls from one module into another, so it is built once
over every analysed module and each ``ModuleContext.hotindex`` is that one
index.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import (Finding, apply_noqa,
                                           assign_fingerprints,
                                           extract_comments,
                                           split_by_baseline)

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist",
              ".eggs", "node_modules"}


def iter_python_files(paths: Sequence[Path]) -> Iterator[Path]:
    seen = set()
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            rp = p.resolve()
            if rp not in seen:
                seen.add(rp)
                yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # skip by the parts below ``p``: a checkout unpacked under
                # a ``build/`` directory is still analysed
                if any(part in _SKIP_DIRS
                       for part in f.relative_to(p).parts):
                    continue
                rf = f.resolve()
                if rf not in seen:
                    seen.add(rf)
                    yield f


class RunContext:
    """What the modules of one run share: every module, and the hot scope
    built over all of them on first use."""

    def __init__(self) -> None:
        self.modules: List["ModuleContext"] = []
        self._hot: Optional[astutil.HotIndex] = None

    @property
    def hotindex(self) -> astutil.HotIndex:
        if self._hot is None:
            self._hot = astutil.HotIndex([m.view for m in self.modules])
        return self._hot


@dataclass
class ModuleContext:
    """One parsed module plus the shared per-module indices rules use."""
    path: Path                # as given (absolute or relative)
    relpath: str              # repo-relative posix path used in findings
    source: str
    tree: ast.Module
    lines: List[str]
    imports: astutil.ImportMap
    funcindex: astutil.FunctionIndex
    module: str = ""          # dotted module name
    run: Optional[RunContext] = field(default=None, repr=False)
    _parents: Optional[Dict[ast.AST, ast.AST]] = field(default=None,
                                                       repr=False)
    _view: Optional[astutil.ModuleView] = field(default=None, repr=False)

    @property
    def view(self) -> astutil.ModuleView:
        if self._view is None:
            self._view = astutil.ModuleView(
                self.relpath, self.module, self.tree, self.lines,
                self.imports, self.funcindex, self.path)
        return self._view

    @property
    def hotindex(self) -> astutil.HotIndex:
        if self.run is None:              # a module analysed on its own
            self.run = RunContext()
            self.run.modules.append(self)
        return self.run.hotindex

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = astutil.build_parent_map(self.tree)
        return self._parents

    def enclosing_function(self, node: ast.AST
                           ) -> Optional[astutil.FunctionRecord]:
        return astutil.enclosing_function(self.parents, self.funcindex,
                                          node)

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 1))
        end = (0 if isinstance(node_or_line, int)
               else getattr(node_or_line, "end_lineno", 0) or 0)
        return Finding(rule=rule, path=self.relpath, line=line,
                       message=message, end_line=end)


def load_module(path: Path, root: Path) -> Optional[ModuleContext]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    module = astutil.module_name(path)
    return ModuleContext(
        path=path, relpath=rel, source=source, tree=tree,
        lines=source.splitlines(),
        imports=astutil.ImportMap(tree, module,
                                  is_package=path.stem == "__init__"),
        funcindex=astutil.FunctionIndex(tree), module=module)


def load_modules(paths: Sequence[Path], root: Path) -> List[ModuleContext]:
    """Parse every Python file under ``paths`` into one run's modules."""
    run = RunContext()
    for f in iter_python_files(list(paths)):
        ctx = load_module(f, root)
        if ctx is not None:
            ctx.run = run
            run.modules.append(ctx)
    return run.modules


@dataclass
class AnalysisReport:
    findings: List[Finding]          # fingerprinted, noqa applied
    new: List[Finding]               # not in baseline, not suppressed
    baselined: List[Finding]
    suppressed: List[Finding]
    modules: int

    @property
    def exit_code(self) -> int:
        return 1 if self.new else 0

    def to_dict(self) -> Dict[str, object]:
        return {
            "modules": self.modules,
            "counts": {
                "new": len(self.new),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
            },
            "new": [f.to_dict() for f in self.new],
            "baselined": [f.to_dict() for f in self.baselined],
            "suppressed": [
                dict(f.to_dict(), justification=f.justification)
                for f in self.suppressed
            ],
        }


def raw_findings(ctxs: Sequence[ModuleContext],
                 rules: Sequence[object]) -> List[Finding]:
    """Every rule's findings before fingerprints, noqa and baseline."""
    raw: List[Finding] = []
    for rule in rules:
        per_module = getattr(rule, "check", None)
        if per_module is not None:
            for ctx in ctxs:
                raw.extend(per_module(ctx))
        project_wide = getattr(rule, "check_project", None)
        if project_wide is not None:
            raw.extend(project_wide(ctxs))
    return raw


def partial_rules(ctxs: Sequence[ModuleContext]) -> List[str]:
    """Rules whose findings in this run may lack context: TPR001 when a
    declared hot entry's module was not analysed (a ``--changed-only``
    run), since the hot scope reaches across modules."""
    paths = [c.relpath for c in ctxs]
    missing = [e for e in astutil.HOT_ENTRIES
               if not any(p.endswith(e.path) for p in paths)]
    return ["TPR001"] if missing else []


def _rule_ids() -> List[str]:
    from repro_torch.analysis.rules import RULES
    return [r.RULE_ID for r in RULES]


def analyze_paths(paths: Sequence[Path], *, root: Optional[Path] = None,
                  baseline: Optional[Iterable[str]] = None,
                  rules: Optional[Sequence[object]] = None,
                  ) -> AnalysisReport:
    from repro_torch.analysis.rules import get_rules

    root = root or Path.cwd()
    active = list(rules) if rules is not None else get_rules()
    ctxs = load_modules(paths, root)
    raw = raw_findings(ctxs, active)

    lines_by_path = {c.relpath: c.lines for c in ctxs}
    comments_by_path = {c.relpath: extract_comments(c.source)
                        for c in ctxs}
    findings = assign_fingerprints(raw, lines_by_path)
    # rules that did not run (a --rules subset) suppress nothing here
    idle = set(_rule_ids()) - {getattr(r, "RULE_ID", "") for r in active}
    findings = apply_noqa(findings, comments_by_path,
                          partial=set(partial_rules(ctxs)) | idle)
    # TPR000 meta findings produced by apply_noqa need fingerprints too
    findings = assign_fingerprints(findings, lines_by_path)

    accepted = set(baseline or ())
    new, old = split_by_baseline(findings, accepted)
    suppressed = [f for f in findings if f.suppressed]
    return AnalysisReport(findings=findings, new=new, baselined=old,
                          suppressed=suppressed, modules=len(ctxs))
