"""CLI entry point: ``python -m repro_torch.analysis``.

Exit code 0 when every finding is baselined or suppressed; 1 when new
findings exist (this is what the CI gate keys on); 2 on usage errors.

Common invocations::

    python -m repro_torch.analysis src/repro_torch         # full run
    python -m repro_torch.analysis --format json --bench   # CI gate
    python -m repro_torch.analysis --changed-only          # fast local loop
    python -m repro_torch.analysis --write-baseline src/repro_torch
                                                           # accept current

The default baseline is ``analysis/baseline_torch.json``; the reference
linter's ``analysis/baseline.json`` is its own.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.engine import analyze_paths
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           save_baseline)

DEFAULT_BASELINE = "analysis/baseline_torch.json"
DEFAULT_PATHS = ("src/repro_torch",)


def _repo_root(start: Path) -> Path:
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / ".git").exists() or \
                (cand / DEFAULT_BASELINE).exists():
            return cand
    return start


def _changed_files(root: Path) -> Optional[List[Path]]:
    """Python files changed vs. HEAD (staged + unstaged + untracked)."""
    try:
        out = subprocess.run(
            ["git", "-C", str(root), "status", "--porcelain"],
            capture_output=True, text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    files: List[Path] = []
    for line in out.stdout.splitlines():
        name = line[3:].split(" -> ")[-1].strip().strip('"')
        p = root / name
        # untracked directories surface as one `?? dir/` entry — pass
        # them through whole; iter_python_files expands directories
        if (name.endswith(".py") or name.endswith("/")) and p.exists():
            files.append(p)
    return files


def _print_text(report, *, bench_findings: List[Finding]) -> None:
    def show(f: Finding, tag: str) -> None:
        print(f"{f.location()}: {f.rule} [{tag}] {f.message}")

    for f in report.new:
        show(f, "new")
    for f in bench_findings:
        show(f, "new")
    if report.baselined:
        print(f"-- {len(report.baselined)} baselined finding(s) "
              f"(see {DEFAULT_BASELINE})")
    if report.suppressed:
        print(f"-- {len(report.suppressed)} suppressed via "
              "# repro: noqa")
    total_new = len(report.new) + len(bench_findings)
    print(f"{report.modules} module(s) analyzed, {total_new} new, "
          f"{len(report.baselined)} baselined, "
          f"{len(report.suppressed)} suppressed")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based PyTorch/CUDA invariant linter "
                    "(rules TPR001-TPR006; see repro_torch.analysis docs)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to analyze (default: "
                         f"{' '.join(DEFAULT_PATHS)} under the repo "
                         "root)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "under the repo root; 'none' disables)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the "
                         "baseline file and exit 0")
    ap.add_argument("--changed-only", action="store_true",
                    help="analyze only files changed vs. git HEAD "
                         "(fast local loop; TPR006 parity checks run "
                         "only over the changed set)")
    ap.add_argument("--bench", action="store_true",
                    help="also run the BENCH001 trajectory gate over "
                         "the repo's BENCH_torch_*.json files")
    ap.add_argument("--out", default=None,
                    help="write the (JSON) report to this file as well")
    ap.add_argument("--root", default=None,
                    help="repo root override (defaults to the nearest "
                         "ancestor with .git or the baseline file)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(e.g. TPR001,TPR003)")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve() if args.root else \
        _repo_root(Path.cwd())

    if args.changed_only:
        changed = _changed_files(root)
        if changed is None:
            print("--changed-only: git unavailable, analyzing default "
                  "paths", file=sys.stderr)
            paths = [root / p for p in DEFAULT_PATHS]
        elif not changed:
            print("--changed-only: no changed python files")
            return 0
        else:
            paths = changed
    elif args.paths:
        paths = [Path(p) for p in args.paths]
    else:
        paths = [root / p for p in DEFAULT_PATHS]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path(s): "
              f"{', '.join(str(p) for p in missing)}", file=sys.stderr)
        return 2

    rules = None
    if args.rules:
        from repro_torch.analysis.rules import get_rules
        try:
            rules = get_rules(args.rules.split(","))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    baseline_path = None
    accepted = set()
    if args.baseline != "none":
        baseline_path = (Path(args.baseline) if args.baseline
                         else root / DEFAULT_BASELINE)
        try:
            accepted = load_baseline(baseline_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    report = analyze_paths(paths, root=root, baseline=accepted,
                           rules=rules)

    if args.write_baseline:
        if baseline_path is None:
            print("error: --write-baseline with --baseline none",
                  file=sys.stderr)
            return 2
        baseline_path.parent.mkdir(parents=True, exist_ok=True)
        keep = [f for f in report.findings if not f.suppressed]
        save_baseline(baseline_path, keep)
        print(f"wrote {len(keep)} finding(s) to {baseline_path}")
        return 0

    bench_findings: List[Finding] = []
    if args.bench:
        from repro_torch.analysis.bench import check_trajectories
        bench_findings = check_trajectories(root)

    if args.format == "json" or args.out:
        doc = report.to_dict()
        doc["bench"] = [f.to_dict() for f in bench_findings]
        doc["counts"]["new"] += len(bench_findings)
        payload = json.dumps(doc, indent=2)
        if args.format == "json":
            print(payload)
        if args.out:
            Path(args.out).write_text(payload + "\n")
    if args.format == "text":
        _print_text(report, bench_findings=bench_findings)

    return 1 if (report.new or bench_findings) else 0


if __name__ == "__main__":
    sys.exit(main())
