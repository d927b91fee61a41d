"""BENCH001 — benchmark trajectory guard (the port's).

Performance is tracked as append-only trajectory files (row lists, the
reference's ``BENCH_*.json`` schema).  This check — run as part of the
static-analysis CI gate — asserts that the *latest* row of every port
trajectory still passes the gates recorded inside it: each
``gates``/``gate`` entry whose dict carries ``enforced: true`` must also
carry ``pass: true`` (or ``ok``/``passed``).  A regression someone
appended but did not fix fails the gate exactly like a new lint finding.

The port's trajectories are the ``BENCH_torch_*.json`` files at the
repository root; the JAX package's ``BENCH_*.json`` files and its
``benchmarks/run.py`` belong to the reference linter and are never read.
With no port trajectory the check passes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding

RULE_ID = "BENCH001"
SUMMARY = "latest BENCH_*.json rows must pass their enforced gates"

TRAJECTORY_GLOB = "BENCH_torch_*.json"


def _trajectory_files(repo_root: Path) -> List[Path]:
    return sorted(repo_root.glob(TRAJECTORY_GLOB))


def _latest_row(path: Path) -> Optional[Dict]:
    try:
        rows = json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if isinstance(rows, list) and rows and \
            all(isinstance(r, dict) for r in rows):
        return rows[-1]
    return None


def _gate_entries(row: Dict) -> Dict[str, Dict]:
    """Gate dicts of a snapshot row.

    Both shapes in the wild are accepted: ``row["gate"]`` as a single
    gate dict carrying ``pass`` (BENCH_observe/BENCH_shard), and
    ``row["gates"]`` as a name->gate mapping.
    """
    out: Dict[str, Dict] = {}
    g = row.get("gate")
    if isinstance(g, dict):
        if "pass" in g or "ok" in g or "passed" in g:
            out["gate"] = g
        else:
            for name, entry in g.items():
                if isinstance(entry, dict):
                    out[name] = entry
    gs = row.get("gates")
    if isinstance(gs, dict):
        for name, entry in gs.items():
            if isinstance(entry, dict):
                out[name] = entry
    return out


def _gate_ok(entry: Dict) -> Optional[bool]:
    for key in ("pass", "ok", "passed"):
        if key in entry:
            return bool(entry[key])
    return None


def check_trajectories(repo_root: Path) -> List[Finding]:
    findings: List[Finding] = []
    files = _trajectory_files(repo_root)
    for path in files:
        rel = path.name
        row = _latest_row(path)
        if row is None:
            findings.append(Finding(
                RULE_ID, rel, 1,
                f"{rel} is not a row-list trajectory (a JSON list of "
                "row objects)"))
            continue
        for name, entry in _gate_entries(row).items():
            # a gate without an `enforced` field is enforced by default
            # (BENCH_observe); `enforced: false` is advisory-only
            if not entry.get("enforced", True):
                continue
            ok = _gate_ok(entry)
            if ok is False:
                findings.append(Finding(
                    RULE_ID, rel, 1,
                    f"latest row of {rel}: enforced gate `{name}` is "
                    "failing — the last appended benchmark regressed"))
    return findings
