"""Findings, fingerprints, noqa suppression, and baseline I/O.

A finding's *fingerprint* is content-addressed, not line-addressed:
``sha1(rule | relpath | stripped source line | occurrence index)``.
Inserting code above a baselined finding therefore does not invalidate
the baseline; editing the offending line does — which is exactly when a
human should re-look.

Inline suppression::

    something_flagged()  # repro: noqa[TPR003] registry by design

The justification text after the bracket is mandatory: a bare
``# repro: noqa[TPR003]`` is itself reported as TPR000 so suppressions
stay auditable.  The syntax, the fingerprint and the baseline format are
the reference linter's (``src/repro/analysis/findings.py``), copied here
so that the port imports nothing of the reference package; the noqa
parser reads the reference's ``RPR`` ids as well as the port's ``TPR``
ids, so one comment grammar serves both linters.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\[(?P<rules>[RT]PR\d{3}(?:\s*,\s*[RT]PR\d{3})*)\]"
    r"(?P<just>.*)$")


@dataclass(frozen=True)
class Finding:
    rule: str                # "TPR001" ... "TPR006", "TPR000", "BENCH001"
    path: str                # repo-relative, posix separators
    line: int                # 1-based
    message: str
    fingerprint: str = ""
    suppressed: bool = False
    justification: str = ""
    end_line: int = 0        # last line of the flagged expression (0: line)

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


def fingerprint(rule: str, relpath: str, line_text: str,
                occurrence: int) -> str:
    payload = f"{rule}|{relpath}|{line_text.strip()}|{occurrence}"
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()[:16]


def assign_fingerprints(findings: Sequence[Finding],
                        source_lines_by_path: Dict[str, Sequence[str]],
                        ) -> List[Finding]:
    """Fill the fingerprint field, disambiguating identical lines by
    occurrence order within (rule, path, stripped-line-text)."""
    counts: Dict[Tuple[str, str, str], int] = {}
    out: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines = source_lines_by_path.get(f.path, [])
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        key = (f.rule, f.path, text.strip())
        occ = counts.get(key, 0)
        counts[key] = occ + 1
        out.append(dataclasses.replace(
            f, fingerprint=fingerprint(f.rule, f.path, text, occ)))
    return out


def extract_comments(source: str) -> Dict[int, str]:
    """line number -> comment text (``#`` included) for *real* comment
    tokens only — noqa syntax quoted inside docstrings (e.g. this
    package's own documentation) must not act as a suppression."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def parse_noqa(comment: str) -> Optional[Tuple[Set[str], str]]:
    """``(rule ids, justification)`` for a ``# repro: noqa[...]``
    comment, or None.  Empty justification is returned as "" (caller
    flags it)."""
    m = NOQA_RE.search(comment)
    if not m:
        return None
    rules = {r.strip() for r in m.group("rules").split(",")}
    return rules, m.group("just").strip()


def apply_noqa(findings: Sequence[Finding],
               comments_by_path: Dict[str, Dict[int, str]],
               partial: Iterable[str] = (),
               ) -> List[Finding]:
    """Mark suppressed findings; emit TPR000 for justification-less or
    unused-rule noqa comments so suppressions stay honest.  A rule in
    ``partial`` ran without the modules its findings depend on (TPR001's
    hot scope spans modules), so a noqa of it that suppresses nothing in
    this run is not reported."""
    partial = set(partial)
    out: List[Finding] = []
    used: Set[Tuple[str, int, str]] = set()
    for f in findings:
        comment = comments_by_path.get(f.path, {}).get(f.line, "")
        parsed = parse_noqa(comment)
        if parsed and f.rule in parsed[0]:
            used.add((f.path, f.line, f.rule))
            out.append(dataclasses.replace(
                f, suppressed=True, justification=parsed[1]))
        else:
            out.append(f)
    # audit the noqa comments themselves
    for path, comments in comments_by_path.items():
        for i, comment in sorted(comments.items()):
            parsed = parse_noqa(comment)
            if not parsed:
                continue
            rules, just = parsed
            if not just:
                out.append(Finding(
                    rule="TPR000", path=path, line=i,
                    message="`# repro: noqa[...]` requires a "
                            "justification after the bracket"))
            for r in sorted(rules - partial):
                if (path, i, r) not in used and not any(
                        f.path == path and f.line == i and f.rule == r
                        for f in findings):
                    out.append(Finding(
                        rule="TPR000", path=path, line=i,
                        message=f"noqa[{r}] suppresses nothing on this "
                                "line — remove or fix the rule id"))
    return out


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: Path) -> Set[str]:
    """Fingerprints accepted by the checked-in baseline."""
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {BASELINE_VERSION}")
    return {f["fingerprint"] for f in data.get("findings", [])}


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    rows = [f.to_dict() for f in findings if not f.suppressed]
    rows.sort(key=lambda r: (r["path"], r["line"], r["rule"]))
    path.write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": rows},
        indent=2, sort_keys=False) + "\n")


def split_by_baseline(findings: Sequence[Finding], accepted: Set[str],
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) — suppressed findings are excluded from both."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if f.suppressed:
            continue
        (old if f.fingerprint and f.fingerprint in accepted
         else new).append(f)
    return new, old
