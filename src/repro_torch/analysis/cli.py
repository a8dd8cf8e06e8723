"""fslint command line.

Counterpart of ``repro/analysis/cli.py``, with the same contract:
exit codes 0 clean (baseline-known and stale entries allowed),
1 new findings, 2 usage error.

    python -m repro_torch.analysis src/repro_torch
    python -m repro_torch.analysis src/repro_torch --rule FS003 --format json
    python -m repro_torch.analysis src/repro_torch --update-baseline
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.core import Config
from repro_torch.analysis.driver import AnalysisResult, run_analysis
from repro_torch.analysis.rules import ALL_RULES

DEFAULT_BASELINE = "fslint-baseline.json"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="fslint: FastSwitch torch hot-path static analyzer")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan "
                         "(default: src/repro_torch)")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="FSxxx",
                    help="run only this rule (repeatable)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         f"next to the scanned tree when present)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    return ap


def _default_baseline(paths: List[str]) -> Optional[Path]:
    """Find a committed baseline next to the scanned tree: walk up
    from the first path looking for fslint-baseline.json."""
    cur = Path(paths[0]).resolve()
    if cur.is_file():
        cur = cur.parent
    for candidate in (cur, *cur.parents):
        p = candidate / DEFAULT_BASELINE
        if p.exists():
            return p
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id}  {cls.title}")
        return 0

    known_ids = {cls.id for cls in ALL_RULES} | {"FS000"}
    rules = tuple(args.rules) if args.rules else None
    if rules:
        bad = [r for r in rules if r not in known_ids]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}", file=sys.stderr)
            return 2

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    cfg = Config(rules=rules)
    result = run_analysis(args.paths, cfg)

    if args.baseline is not None:
        bl_path: Optional[Path] = Path(args.baseline)
    else:
        bl_path = _default_baseline(args.paths)
    baseline = Baseline.load(bl_path) if bl_path else Baseline(
        Path(DEFAULT_BASELINE))

    if args.update_baseline:
        baseline.save(result.findings)
        print(f"baseline written: {baseline.path} "
              f"({len(result.findings)} findings)")
        return 0

    new, known, stale = baseline.split(result.findings)

    if args.format == "json":
        print(json.dumps({
            "paths": args.paths,
            "rules": sorted(rules) if rules else "all",
            "new": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in known],
            "stale_baseline": stale,
            "suppressed": [f.to_json() for f in result.suppressed],
            "jit_degrees": result.jit_degrees,
            "exit": 1 if new else 0,
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for f in known:
            print(f"{f.render()}  [baselined]")
        for e in stale:
            print(f"stale baseline entry: {e.get('rule')} "
                  f"{e.get('path')} [{e.get('qualname')}] — prune it")
        n_sup = len(result.suppressed)
        print(f"fslint: {len(new)} new, {len(known)} baselined, "
              f"{len(stale)} stale, {n_sup} suppressed")
    return 1 if new else 0


# convenience for tests
def variant_bound(degrees: int, max_tokens: int) -> int:
    return AnalysisResult.variant_bound(degrees, max_tokens)
