"""Findings and the committed baseline: the audit's currency (torch port of
``repro/analysis/findings.py``).

A ``Finding`` is one violation of a structural invariant, keyed by a
*stable* identifier (pass, target, detail slug — never line numbers or
numeric bounds, which drift) so a committed baseline can acknowledge known
violations while any NEW violation fails the gate. The model is a classic
ratchet lint: ``--write-baseline`` records the current findings,
``--gate`` fails on findings not in the baseline and reports baseline
entries that no longer fire (stale — safe to prune, never fatal).

The port's baseline holds the keys of both devices: a target that exists
only on the card (``tick:cuda:*``, the capture probe) is not audited on the
CPU, and a check that only the card runs (sync debug, kernel launches, the
launchers in ``kernels/*/kernel.py``, which the CPU's plain versions never
reach) cannot fire there, so a CPU run neither reports those keys stale
nor drops them when it rewrites the baseline (``Report.audited`` names the
targets a run covered, ``Report.device`` its device).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclass(frozen=True)
class Finding:
    """One structural violation.

    key: stable identity for baseline matching — ``pass:target:slug``.
    message: human diagnosis (bounds, dtypes, error text live here; the
        message may change without invalidating the baseline entry).
    """
    pass_name: str   # purity | dtype | overflow | constancy | donation | launch | lint
    target: str      # audit target name (e.g. tick:static:equilibria)
    slug: str        # stable detail (leaf path, op@file:function, ...)
    message: str

    @property
    def key(self) -> str:
        return f"{self.pass_name}:{self.target}:{self.slug}"

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.target} :: {self.slug}\n    {self.message}"


@dataclass
class Report:
    """All findings of one audit run plus baseline bookkeeping."""
    findings: List[Finding] = field(default_factory=list)
    # approximation notes (e.g. ops the interval analysis treated as
    # unbounded) — informational, never gated
    notes: List[str] = field(default_factory=list)
    # names of the targets this run audited
    audited: Set[str] = field(default_factory=set)
    device: str = "cuda"

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    def note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)

    def covers(self, key: str) -> bool:
        """Whether this run could raise ``key``: it audited the key's target
        (the lint runs on every device), and the key is not a card-only
        check on a CPU run."""
        if self.device != "cuda" and card_only(key):
            return False
        rest = key.split(":", 1)[1]
        return key.startswith("lint:") or any(
            rest.startswith(t + ":") for t in self.audited)

    def keys(self) -> List[str]:
        return sorted({f.key for f in self.findings})

    def new_vs(self, baseline: Sequence[str]) -> List[Finding]:
        """Findings whose key is not acknowledged by the baseline."""
        known = set(baseline)
        out, seen = [], set()
        for f in sorted(self.findings, key=lambda f: f.key):
            if f.key not in known and f.key not in seen:
                seen.add(f.key)
                out.append(f)
        return out

    def stale_vs(self, baseline: Sequence[str]) -> List[str]:
        """Baseline keys of audited targets that no longer fire
        (candidates for pruning)."""
        have = {f.key for f in self.findings}
        return sorted(k for k in baseline
                      if k not in have and self.covers(k))

    def to_json(self) -> dict:
        return {
            "findings": [
                {"pass": f.pass_name, "target": f.target, "slug": f.slug,
                 "message": f.message}
                for f in sorted(self.findings, key=lambda f: f.key)],
            "notes": list(self.notes),
        }


def card_only(key: str) -> bool:
    """A finding only a run on the card can raise."""
    return (key.startswith("launch:") or "/kernel.py:" in key
            or ":sync:" in key or ":sync@" in key or ":capture" in key)


def load_baseline(path: Optional[str] = None) -> List[str]:
    """Committed findings baseline -> list of acknowledged keys."""
    path = BASELINE_PATH if path is None else path
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    return list(data.get("accepted", []))


def write_baseline(report: Report, path: Optional[str] = None,
                   reasons: Optional[Dict[str, str]] = None) -> str:
    """Record the current findings as the accepted baseline. Accepted keys
    of targets this run did not audit (the other device's) are kept."""
    path = BASELINE_PATH if path is None else path
    old_keys: List[str] = []
    old_reasons: Dict[str, str] = {}
    if os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
        old_keys = list(data.get("accepted", []))
        old_reasons = data.get("reasons", {})
    kept = [k for k in old_keys if not report.covers(k)]
    keys = sorted(set(report.keys()) | set(kept))
    data = {
        "accepted": keys,
        # free-form per-key justification, preserved across rewrites
        "reasons": {k: (reasons or {}).get(k, old_reasons.get(k, ""))
                    for k in keys},
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path
