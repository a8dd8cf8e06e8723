"""Baseline file handling: grandfathered findings.

Counterpart of ``repro/analysis/baseline.py``, unchanged (same file
format, so one baseline file serves both packages).

The baseline is a committed JSON file of finding fingerprints.  A
finding whose fingerprint appears in the baseline is reported as
``known`` and does not fail the gate; anything else is ``new`` and
does.  Baseline entries that no longer match any finding are ``stale``
— the gate still passes, but they are printed so the file can be
pruned and the count only ever goes down.

Fingerprints exclude line numbers (see ``Finding.fingerprint``), so
edits elsewhere in a file do not churn the baseline.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis.core import Finding

BASELINE_VERSION = 1


@dataclass
class Baseline:
    path: Path
    entries: Dict[str, dict] = field(default_factory=dict)  # fp -> entry

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        bl = cls(path=path)
        if not path.exists():
            return bl
        data = json.loads(path.read_text(encoding="utf-8"))
        for entry in data.get("findings", []):
            fp = entry.get("fingerprint")
            if fp:
                bl.entries[fp] = entry
        return bl

    def save(self, findings: List[Finding]) -> None:
        payload = {
            "version": BASELINE_VERSION,
            "findings": sorted(
                (f.to_json() for f in findings),
                key=lambda e: (e["rule"], e["path"], e["qualname"])),
        }
        self.path.write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n",
            encoding="utf-8")

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """(new, known, stale_entries)."""
        new: List[Finding] = []
        known: List[Finding] = []
        seen = set()
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                known.append(f)
                seen.add(fp)
            else:
                new.append(f)
        stale = [e for fp, e in sorted(self.entries.items())
                 if fp not in seen]
        return new, known, stale
