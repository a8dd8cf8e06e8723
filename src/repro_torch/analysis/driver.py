"""Analysis driver: index the tree, run the rules, apply suppressions.

Counterpart of ``repro/analysis/driver.py``.  ``run_analysis`` is the
programmatic entry point used by the CLI, ``tests/test_torch_fslint.py``,
and ``launch/dryrun.py --audit-jit`` (which consumes the FS002
degrees-of-freedom table to bound the live counts of CUDA graphs and
padded shape keys).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.callgraph import Project
from repro_torch.analysis.core import BAD_SUPPRESSION, Config, Finding
from repro_torch.analysis.rules import GraphBucketBudget, make_rules


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    # FS002's static degrees-of-freedom per keyed function: the live
    # variant count (graphs, padded shape keys) of each must stay within
    # (log2(max_tokens) + 2) ** max(degrees, 2).
    jit_degrees: Dict[str, int] = field(default_factory=dict)
    project: Optional[Project] = None

    @staticmethod
    def variant_bound(degrees: int, max_tokens: int) -> int:
        base = max(1, max_tokens).bit_length() + 2
        return base ** max(degrees, 2)


def run_analysis(paths: List[str], config: Optional[Config] = None,
                 repo_root: Optional[str] = None) -> AnalysisResult:
    cfg = config or Config()
    root = Path(repo_root) if repo_root else Path.cwd()
    project = Project([Path(p) for p in paths], root, cfg)
    result = AnalysisResult(project=project)

    raw: List[Finding] = []
    for rule in make_rules(cfg.rules):
        raw.extend(rule.run(project))
        if isinstance(rule, GraphBucketBudget):
            result.jit_degrees = dict(rule.degrees)

    # malformed suppressions are findings themselves (not disableable)
    if cfg.rules is None or BAD_SUPPRESSION in cfg.rules:
        for mod in project.modules.values():
            for line, body in mod.suppressions.malformed:
                raw.append(Finding(
                    rule=BAD_SUPPRESSION, path=mod.rel_path, line=line,
                    col=0, qualname="<module>",
                    message=f"malformed fslint suppression "
                            f"'disable={body}'; the form is "
                            f"disable=FSxxx(reason), reason required"))

    mods_by_rel = {m.rel_path: m for m in project.modules.values()}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        mod = mods_by_rel.get(f.path)
        if f.rule != BAD_SUPPRESSION and mod is not None and \
                mod.suppressions.covers(f.line, f.rule):
            result.suppressed.append(f)
        else:
            result.findings.append(f)
    return result


def jit_budget(paths: List[str], config: Optional[Config] = None,
               repo_root: Optional[str] = None) -> Dict[str, int]:
    """Static degrees-of-freedom per hot keyed function (FS002)."""
    cfg = config or Config()
    cfg = Config(**{**cfg.__dict__, "rules": ("FS002",)})
    return run_analysis(paths, cfg, repo_root).jit_degrees
