"""Findings of the port's static plan verifier, ported from
``repro/analysis/report.py``.

A :class:`Finding` is one violated invariant: the pass that found it, a
stable kebab-case rule name, the subject (a ``spec@p`` label) and a
message.  :class:`Report` gathers the findings of one
``python -m repro_torch.analysis`` run and renders them as JSON.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``pass_name`` is the emitting pass (``verify``); ``rule`` a stable
    kebab-case identifier, the reference's letter for letter; ``where``
    the subject (a ``spec@p`` label); ``message`` the explanation.
    """

    pass_name: str
    rule: str
    where: str
    message: str

    @property
    def key(self) -> str:
        """Location x rule, stable across reruns."""
        return f"{self.where}::{self.rule}"

    def render(self) -> str:
        return f"[{self.pass_name}/{self.rule}] {self.where}: {self.message}"


@dataclass
class Report:
    """Aggregated findings of one ``repro_torch.analysis`` run."""

    findings: list[Finding] = field(default_factory=list)
    passes_run: list[str] = field(default_factory=list)

    def extend(self, pass_name: str, findings: list[Finding]) -> None:
        self.passes_run.append(pass_name)
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "passes_run": self.passes_run,
            "n_findings": len(self.findings),
            "findings": [asdict(f) for f in self.findings],
        }

    def as_json(self) -> str:
        return json.dumps(self.as_dict(), indent=2)
